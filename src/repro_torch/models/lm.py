"""Top-level language model: embeddings -> stack -> logits, and the
serving entry points (port of `repro.models.lm`), with the enc-dec
variant (`seamless-m4t-medium`: a bidirectional encoder over frame
embeddings, whose output every decoder layer cross-attends) and the
embedding input (`embeds`, the VLM and audio frontends' stub).

`params` is an `LM` module.  `init_params` draws it from an explicit
`torch.Generator`; `convert.lm_params_from_jax` carries the JAX package's
parameters across.  `loss_fn` is the training loss (sequence-chunked
cross-entropy plus the MoE auxiliary loss).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.engine import resolve_device
from ..dist import lm_blocks as blk
from ..dist import sharding as shd
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
    return blk.use(params.embed)[tokens] * scale


def unembed(cfg: ModelConfig, params: LM, x) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = blk.linear(x, params.embed, transposed=True)
    else:
        logits = blk.linear(x, params.unembed)
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
    return common.rms_norm(h, blk.use(params.enc_norm), cfg.norm_eps)


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
    return common.rms_norm(x, blk.use(params.final_norm), cfg.norm_eps), aux


def forward(cfg: ModelConfig, params: LM, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill forward without a cache.  batch: {'tokens': [B, T]} or
    {'embeds': [B, T, d]}; the enc-dec family also 'enc_embeds' [B, S, d].
    Returns (logits [B, T, V], aux_loss)."""
    x, aux = hidden_states(cfg, params, batch)
    return unembed(cfg, params, x), aux


def _chunk_nll(cfg: ModelConfig, params: LM, h_c, y_c):
    """(sum of the chunk's token NLLs, its count of labels): the logits in
    the model dtype, cast to fp32, logsumexp minus the label's logit,
    labels of -100 masked (and clamped to 0 for the gather)."""
    logits = unembed(cfg, params, h_c).to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, y_c.clamp_min(0)[..., None])[..., 0]
    mask = y_c != -100
    return ((lse - ll) * mask).sum(), mask.sum()


def loss_fn(cfg: ModelConfig, params: LM, batch: Dict[str, Any],
            aux_weight: float = 0.01, xent_chunk: int = 512
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sequence-chunked cross entropy (`repro.models.lm.loss_fn`): the
    [B, T, V] fp32 logits are never materialized.  The chunk c is
    min(xent_chunk, T), lowered until it divides T; each chunk's logits are
    computed, reduced and, under `torch.utils.checkpoint`, recomputed in
    the backward; the chunks' sums add from 0 in order.  batch: the
    inputs of `forward` and 'labels' [B, T].  Returns (xent + aux_weight *
    aux, {'xent', 'aux'}).

    Over a bound mesh (`dist.sharding.use_mesh`) the batch is the rank's
    rows, and the loss is still the global batch's: the label count is
    summed over the 'batch' axes, the rank's loss is its rows' NLL over
    that count plus the (global) aux term, and the metrics carry the
    global 'xent', 'aux' and 'loss' (the value to report; the gradient of
    the rank's loss, summed over the ranks' rows by the blocks'
    backwards, is the global loss's)."""
    x, aux = hidden_states(cfg, params, batch)
    labels = batch["labels"].to(torch.int64)
    T = x.shape[1]
    c = min(xent_chunk, T)
    while T % c:
        c -= 1
    nll = torch.zeros((), dtype=F32, device=x.device)
    n = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(0, T, c):
        ds, dn = checkpoint(_chunk_nll, cfg, params, x[:, i:i + c],
                            labels[:, i:i + c], use_reentrant=False,
                            preserve_rng_state=False)
        nll, n = nll + ds, n + dn
    if shd.get_mesh() is None:
        loss = nll / n.clamp_min(1)
        return loss + aux_weight * aux, {"xent": loss, "aux": aux}
    own = nll / blk.batch_sum(n).clamp_min(1)
    xent = blk.batch_sum(own.detach())
    aux_d = aux.detach()
    return own + aux_weight * aux, {"xent": xent, "aux": aux_d,
                                    "loss": xent + aux_weight * aux_d}


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
