"""Top-level language model: embeddings -> stack -> logits, and the
serving entry points (port of `repro.models.lm`, decoder-only, token
input).

`params` is an `LM` module.  `init_params` draws it from an explicit
`torch.Generator`; `convert.lm_params_from_jax` carries the JAX package's
parameters across.  Enc-dec and embedding inputs wait for ROADMAP queue 1
item 13.4, the training loss for item 13.5.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.engine import resolve_device
from . import common, transformer

F32 = torch.float32


class LM(torch.nn.Module):
    """embed [V, d], final_norm [d] fp32, the stack, and unembed [d, V]
    where the embeddings are untied."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family != "decoder":
            raise NotImplementedError(
                f"family {cfg.family!r} is {common.NOT_PORTED}")
        dtype = common.dtype_of(cfg)
        self.cfg = cfg
        self.embed = common.param((cfg.vocab_size, cfg.d_model), dtype,
                                  device)
        self.final_norm = common.param((cfg.d_model,), F32, device)
        self.stack = transformer.Stack(cfg, dtype, device)
        if not cfg.tie_embeddings:
            self.unembed = common.param((cfg.d_model, cfg.vocab_size), dtype,
                                        device)


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


def _tokens(batch: Dict[str, Any]) -> torch.Tensor:
    if set(batch) != {"tokens"}:
        raise NotImplementedError(
            f"batch keys {sorted(batch)}: only 'tokens' input is ported "
            f"(embeds and enc-dec are {common.NOT_PORTED})")
    return batch["tokens"]


def hidden_states(cfg: ModelConfig, params: LM, batch: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embed -> stack -> final norm.  Returns (x [B,T,d], aux_loss): the
    MoE layers' load-balancing losses summed over the stack (fp32; 0
    without MoE layers)."""
    x = embed_tokens(cfg, params, _tokens(batch))
    pos = torch.arange(x.shape[1], device=x.device)
    x, _, aux = transformer.apply_stack(cfg, params.stack, x, pos)
    return common.rms_norm(x, params.final_norm, cfg.norm_eps), aux


def forward(cfg: ModelConfig, params: LM, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill forward without a cache.  batch: {'tokens': [B, T]}.
    Returns (logits [B, T, V], aux_loss)."""
    x, aux = hidden_states(cfg, params, batch)
    return unembed(cfg, params, x), aux


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               per_slot: bool = False, device=None) -> Dict[str, Any]:
    """{'layers': one cache dict per layer, 'pos': int64 position}.
    per_slot=True gives 'pos' shape [batch]: each slot carries its own
    position (continuous batching with per-slot refill)."""
    dev = resolve_device(device)
    layers = transformer.init_caches(cfg, batch, s_max, common.dtype_of(cfg),
                                     dev)
    pos = torch.zeros((batch,) if per_slot else (), dtype=torch.int64,
                      device=dev)
    return {"layers": layers, "pos": pos}


def prefill(cfg: ModelConfig, params: LM, cache, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Any]:
    """Process a whole prompt from cache['pos'] == 0: fill the caches and
    return only the last position's logits [B, V]."""
    x = embed_tokens(cfg, params, _tokens(batch))
    T = x.shape[1]
    pos = cache["pos"] + torch.arange(T, device=x.device)
    x, new_layers, _ = transformer.apply_stack(
        cfg, params.stack, x, pos, caches=cache["layers"],
        cache_pos=cache["pos"])
    xl = common.rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    logits = unembed(cfg, params, xl)[:, 0]
    return logits, {"layers": new_layers, "pos": cache["pos"] + T}


def decode_step(cfg: ModelConfig, params: LM, cache, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Any]:
    """One decode step: tokens [B, Tq] (Tq = 1 usually; the serving engine
    also prefills a slot through here).  Positions and the cache offset
    come from cache['pos']: a 0-dim tensor (lockstep) or [B] (per slot).
    Returns (logits [B, Tq, V], new cache)."""
    x = embed_tokens(cfg, params, tokens)
    pos = cache["pos"][..., None] + torch.arange(tokens.shape[1],
                                                 device=x.device)
    x, new_layers, _ = transformer.apply_stack(
        cfg, params.stack, x, pos, caches=cache["layers"],
        cache_pos=cache["pos"])
    x = common.rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = unembed(cfg, params, x)
    return logits, {"layers": new_layers,
                    "pos": cache["pos"] + tokens.shape[1]}
