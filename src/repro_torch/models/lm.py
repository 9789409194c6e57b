"""Top-level language model: embeddings -> stack -> logits, and the
serving entry points (port of `repro.models.lm`), with the enc-dec
variant (`seamless-m4t-medium`: a bidirectional encoder over frame
embeddings, whose output every decoder layer cross-attends) and the
embedding input (`embeds`, the VLM and audio frontends' stub).

`params` is an `LM` module.  `init_params` draws it from an explicit
`torch.Generator`; `convert.lm_params_from_jax` carries the JAX package's
parameters across.  The training loss waits for ROADMAP queue 1 item
13.5.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.engine import resolve_device
from . import common, transformer

F32 = torch.float32


class LM(torch.nn.Module):
    """embed [V, d], final_norm [d] fp32, the stack, unembed [d, V] where
    the embeddings are untied, and for the enc-dec family the encoder's
    stack `enc_stack` (over `encoder_view(cfg)`) and `enc_norm` [d]
    fp32."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family not in ("decoder", "encdec"):
            raise ValueError(f"unknown family {cfg.family!r}")
        dtype = common.dtype_of(cfg)
        self.cfg = cfg
        self.embed = common.param((cfg.vocab_size, cfg.d_model), dtype,
                                  device)
        self.final_norm = common.param((cfg.d_model,), F32, device)
        self.stack = transformer.Stack(cfg, dtype, device)
        if not cfg.tie_embeddings:
            self.unembed = common.param((cfg.d_model, cfg.vocab_size), dtype,
                                        device)
        if cfg.family == "encdec":
            self.enc_stack = transformer.Stack(encoder_view(cfg), dtype,
                                               device)
            self.enc_norm = common.param((cfg.d_model,), F32, device)


def encoder_view(cfg: ModelConfig) -> ModelConfig:
    """The encoder half of an enc-dec config (bidirectional layers)."""
    return cfg.scaled(n_layers=cfg.n_encoder_layers,
                      pattern=(("bi", "dense"),), family="decoder")


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> LM:
    """An `LM` on `device` (None: the card), its weights drawn from
    `generator` (which must live on that device; None: a fresh one seeded
    0).  On the `meta` device the weights are left undrawn (shapes only,
    for counting)."""
    dev = torch.device("meta") if str(device) == "meta" else \
        resolve_device(device)
    p = LM(cfg, dev)
    if dev.type == "meta":
        return p
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    common.init_embed(p.embed, generator)
    with torch.no_grad():
        p.final_norm.fill_(1.0)
    transformer.init_stack(p.stack, generator)
    if not cfg.tie_embeddings:
        common.init_dense(p.unembed, generator)
    if cfg.family == "encdec":
        transformer.init_stack(p.enc_stack, generator)
        with torch.no_grad():
            p.enc_norm.fill_(1.0)
    return p


def param_count(params: LM) -> int:
    return sum(w.numel() for w in params.parameters())


def embed_tokens(cfg: ModelConfig, params: LM, tokens) -> torch.Tensor:
    # the scale is rounded to the model dtype before the multiply, as in
    # the JAX package (bf16: 50.596 -> 50.5)
    scale = torch.tensor(cfg.emb_scale, dtype=params.embed.dtype,
                         device=params.embed.device)
    return params.embed[tokens] * scale


def unembed(cfg: ModelConfig, params: LM, x) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ params.embed.T
    else:
        logits = x @ params.unembed
    return common.scale_by(logits, cfg.logit_scale)


class _EncOut:
    """Lazy cross-attention source understood by `attention.attention`:
    each layer projects `.enc_out` with its own `wk` / `wv`."""

    def __init__(self, enc_out):
        self.enc_out = enc_out


def encode(cfg: ModelConfig, params: LM, enc_embeds) -> torch.Tensor:
    """Run the (bidirectional) encoder over frontend embeddings [B, S, d]:
    cast to the model dtype, positions 0..S-1, then `enc_norm`."""
    x = enc_embeds.to(common.dtype_of(cfg))
    pos = torch.arange(x.shape[1], device=x.device)
    h, _, _ = transformer.apply_stack(encoder_view(cfg), params.enc_stack,
                                      x, pos)
    return common.rms_norm(h, params.enc_norm, cfg.norm_eps)


def _inputs(cfg: ModelConfig, params: LM, batch: Dict[str, Any]
            ) -> torch.Tensor:
    """The decoder's input [B, T, d]: `embeds` cast to the model dtype
    (no `emb_scale`) outside the enc-dec family, else embedded `tokens`."""
    if "embeds" in batch and cfg.family != "encdec":
        return batch["embeds"].to(common.dtype_of(cfg))
    return embed_tokens(cfg, params, batch["tokens"])


def hidden_states(cfg: ModelConfig, params: LM, batch: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embed -> stack -> final norm.  Returns (x [B,T,d], aux_loss): the
    MoE layers' load-balancing losses summed over the stack (fp32; 0
    without MoE layers)."""
    x = _inputs(cfg, params, batch)
    pos = torch.arange(x.shape[1], device=x.device)
    enc_kv = None
    if cfg.family == "encdec":
        enc_kv = _EncOut(encode(cfg, params, batch["enc_embeds"]))
    x, _, aux = transformer.apply_stack(cfg, params.stack, x, pos,
                                        enc_kv=enc_kv)
    return common.rms_norm(x, params.final_norm, cfg.norm_eps), aux


def forward(cfg: ModelConfig, params: LM, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill forward without a cache.  batch: {'tokens': [B, T]} or
    {'embeds': [B, T, d]}; the enc-dec family also 'enc_embeds' [B, S, d].
    Returns (logits [B, T, V], aux_loss)."""
    x, aux = hidden_states(cfg, params, batch)
    return unembed(cfg, params, x), aux


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               enc_out: Optional[torch.Tensor] = None,
               per_slot: bool = False, device=None) -> Dict[str, Any]:
    """{'layers': one cache dict per layer, 'enc_out': the encoder's output
    [B, S, d] that the 'xa' layers cross-attend (None: none), 'pos': int64
    position}.  per_slot=True gives 'pos' shape [batch]: each slot carries
    its own position (continuous batching with per-slot refill)."""
    dev = resolve_device(device)
    layers = transformer.init_caches(cfg, batch, s_max, common.dtype_of(cfg),
                                     dev)
    pos = torch.zeros((batch,) if per_slot else (), dtype=torch.int64,
                      device=dev)
    return {"layers": layers, "enc_out": enc_out, "pos": pos}


def _enc_kv(enc_out) -> Optional[_EncOut]:
    return None if enc_out is None else _EncOut(enc_out)


def prefill(cfg: ModelConfig, params: LM, cache, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Any]:
    """Process a whole prompt from cache['pos'] == 0: fill the caches and
    return only the last position's logits [B, V].  batch: 'tokens' or
    'embeds' as in `forward`; with 'enc_embeds' (enc-dec) the encoder runs
    and its output replaces the cache's 'enc_out'."""
    x = _inputs(cfg, params, batch)
    T = x.shape[1]
    enc_out = cache.get("enc_out")
    if cfg.family == "encdec" and "enc_embeds" in batch:
        enc_out = encode(cfg, params, batch["enc_embeds"])
    pos = cache["pos"] + torch.arange(T, device=x.device)
    x, new_layers, _ = transformer.apply_stack(
        cfg, params.stack, x, pos, caches=cache["layers"],
        cache_pos=cache["pos"], enc_kv=_enc_kv(enc_out))
    xl = common.rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    logits = unembed(cfg, params, xl)[:, 0]
    return logits, {"layers": new_layers, "enc_out": enc_out,
                    "pos": cache["pos"] + T}


def decode_step(cfg: ModelConfig, params: LM, cache, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Any]:
    """One decode step: tokens [B, Tq] (Tq = 1 usually; the serving engine
    also prefills a slot through here).  Positions and the cache offset
    come from cache['pos']: a 0-dim tensor (lockstep) or [B] (per slot).
    The 'xa' layers cross-attend cache['enc_out'].  Returns (logits
    [B, Tq, V], new cache)."""
    x = embed_tokens(cfg, params, tokens)
    pos = cache["pos"][..., None] + torch.arange(tokens.shape[1],
                                                 device=x.device)
    x, new_layers, _ = transformer.apply_stack(
        cfg, params.stack, x, pos, caches=cache["layers"],
        cache_pos=cache["pos"], enc_kv=_enc_kv(cache.get("enc_out")))
    x = common.rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = unembed(cfg, params, x)
    return logits, {"layers": new_layers, "enc_out": cache.get("enc_out"),
                    "pos": cache["pos"] + tokens.shape[1]}
