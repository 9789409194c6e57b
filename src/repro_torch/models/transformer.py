"""The layer stack: pattern-expanded layers and their caches (port of
`repro.models.transformer`).

Layer structure (pre-norm residual):
    x = x + rs * Mixer(RMSNorm(x))        rs = cfg.residual_scale
    x = x + rs * MLP(RMSNorm(x))

The JAX package stacks each pattern unit's parameters on a leading
[n_units] axis and scans over it, then unrolls the remainder.  The port
holds one `Layer` per entry of `cfg.layers`, in order: layer
u * len(pattern) + i is the JAX package's `units/layer{i}[u]`, and layer
n_units * len(pattern) + r is its `rem[r]`.  Caches are a list with one
dict per layer.  Every kind is ported: mixers 'ga', 'la', 'rg', 'rwkv',
'bi' (the encoder's bidirectional attention, no cache) and 'xa' (causal
self-attention with its ring cache, then cross-attention over the
encoder's output with the layer's `cross` weights after `norm3`, no
cache); MLPs 'dense', 'moe', 'cmix' (the RWKV-6 channel mix, which
carries its token shift in the layer's 'rwkv' cache entry).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..dist import lm_blocks as blk
from . import attention, common, mlp as mlp_mod, moe as moe_mod, recurrent

F32 = torch.float32
MIXERS = ("ga", "la", "rg", "rwkv", "bi", "xa")
MLPS = ("dense", "moe", "cmix")


class Layer(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, kinds: Tuple[str, str], dtype,
                 device):
        super().__init__()
        mixer_kind, mlp_kind = kinds
        if mixer_kind not in MIXERS or mlp_kind not in MLPS:
            raise ValueError(f"unknown layer kind {kinds}")
        self.cfg, self.kinds = cfg, kinds
        self.norm1 = common.param((cfg.d_model,), F32, device)
        self.norm2 = common.param((cfg.d_model,), F32, device)
        if mixer_kind == "rg":
            self.mixer = recurrent.RGLRU(cfg, dtype, device)
        elif mixer_kind == "rwkv":
            self.mixer = recurrent.RWKV(cfg, dtype, device)
        else:
            self.mixer = attention.Attention(cfg, dtype, device)
        if mixer_kind == "xa":
            self.cross = attention.Attention(cfg, dtype, device)
            self.norm3 = common.param((cfg.d_model,), F32, device)
        if mlp_kind == "moe":
            self.mlp = moe_mod.MoE(cfg.d_model, cfg.moe, cfg.act, dtype,
                                   device)
        elif mlp_kind == "cmix":
            self.mlp = recurrent.RWKVCMix(cfg, dtype, device)
        else:
            self.mlp = mlp_mod.MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype,
                                   device)

    def forward(self, x, positions, cache=None, cache_pos=None,
                enc_kv=None):
        return _apply_layer(self.cfg, self.kinds, self, x, positions, cache,
                            cache_pos, enc_kv)


_INITS = {recurrent.RGLRU: recurrent.init_rglru,
          recurrent.RWKV: recurrent.init_rwkv,
          attention.Attention: attention.init_attn,
          mlp_mod.MLP: mlp_mod.init_mlp,
          moe_mod.MoE: moe_mod.init_moe,
          recurrent.RWKVCMix: recurrent.init_rwkv_cmix}


@torch.no_grad()
def init_layer(p: Layer, generator) -> None:
    p.norm1.fill_(1.0)
    p.norm2.fill_(1.0)
    _INITS[type(p.mixer)](p.mixer, generator)
    if p.kinds[0] == "xa":
        attention.init_attn(p.cross, generator)
        p.norm3.fill_(1.0)
    _INITS[type(p.mlp)](p.mlp, generator)


def _apply_layer(cfg: ModelConfig, kinds: Tuple[str, str], p: Layer, x,
                 positions, cache: Optional[dict], cache_pos,
                 enc_kv=None) -> Tuple:
    """Returns (x, new_cache, aux): aux is the MoE layer's load-balancing
    loss, None (no device work) for the other MLP kinds.  enc_kv is an
    'xa' layer's cross-attention source (`attention`'s kv_override; None
    attends over the layer's own normed states)."""
    mixer_kind, mlp_kind = kinds
    rs = cfg.residual_scale
    aux = None
    new_cache: Dict[str, Any] = {}

    h = common.rms_norm(x, blk.use(p.norm1), cfg.norm_eps)
    if mixer_kind in ("ga", "la", "bi", "xa"):
        window = cfg.window if mixer_kind == "la" else None
        kv_cache = cache.get("kv") if cache else None
        y, kv_new = attention.attention(
            cfg, p.mixer, h, positions, causal=(mixer_kind != "bi"),
            window=window, cache=kv_cache, cache_pos=cache_pos)
        if kv_new is not None:
            new_cache["kv"] = kv_new
        if mixer_kind == "xa":
            x = x + common.scale_by(y, rs)
            h = common.rms_norm(x, blk.use(p.norm3), cfg.norm_eps)
            y, _ = attention.attention(cfg, p.cross, h, positions,
                                       causal=False, kv_override=enc_kv)
    elif mixer_kind == "rg":
        st = cache.get("rg") if cache else None
        y, st_new = recurrent.rglru(cfg, p.mixer, h, st)
        if cache is not None:
            new_cache["rg"] = st_new
    else:
        st = cache.get("rwkv") if cache else None
        y, st_new = recurrent.rwkv_time_mix(cfg, p.mixer, h, st)
        if cache is not None:
            new_cache["rwkv"] = st_new
    x = x + common.scale_by(y, rs)

    h = common.rms_norm(x, blk.use(p.norm2), cfg.norm_eps)
    if mlp_kind == "dense":
        y = mlp_mod.mlp(p.mlp, h, cfg.act)
    elif mlp_kind == "moe":
        y, aux = moe_mod.moe(p.mlp, h, cfg.moe, cfg.act)
    else:
        # the channel mix reads xf from the old cache and writes it into
        # the 'rwkv' entry the time mix made
        st = cache.get("rwkv") if cache else None
        y, xf_new = recurrent.rwkv_channel_mix(cfg, p.mlp, h, st)
        if cache is not None and "rwkv" in new_cache:
            new_cache["rwkv"]["xf"] = xf_new
    x = x + common.scale_by(y, rs)
    return x, (new_cache if cache is not None else None), aux


class Stack(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            Layer(cfg, kinds, dtype, device) for kinds in cfg.layers)


def init_stack(p: Stack, generator) -> None:
    for layer in p.layers:
        init_layer(layer, generator)


def _recomputed(cfg: ModelConfig, kinds, layer: Layer, x, positions,
                enc_kv):
    """`_apply_layer` without a cache under `torch.utils.checkpoint`: the
    backward recomputes the layer from its input (the JAX package's
    per-layer `jax.checkpoint` with `nothing_saveable`).  No layer draws a
    random number, so no RNG state is kept."""
    return checkpoint(_apply_layer, cfg, kinds, layer, x, positions, None,
                      None, enc_kv, use_reentrant=False,
                      preserve_rng_state=False)


def apply_stack(cfg: ModelConfig, stack: Stack, x, positions, *,
                caches: Optional[List[dict]] = None, cache_pos=None,
                enc_kv=None):
    """Returns (x, new_caches, aux_sum): the MoE layers' auxiliary losses
    added in layer order (an fp32 0 without one).  enc_kv goes to every
    'xa' layer's cross-attention.

    Without caches, with gradients enabled and something to differentiate
    (training), every layer runs under `_recomputed`: the backward holds
    one residual a layer and recomputes each layer once, so a forward
    kernel runs twice a step (RG-LRU: `rg_lru_scan` twice, `rg_lru_scan_bwd`
    once a layer).  The JAX package also nests a checkpoint around each
    multi-layer pattern unit and leaves the remainder layers without one;
    nesting saves one residual a unit instead of one a layer, but under
    `torch.utils.checkpoint` it runs 8 layer forwards for a 3-layer unit
    instead of 6.  The port keeps the flat form for every layer, which
    computes the same numbers."""
    decode = caches is not None
    train = not decode and torch.is_grad_enabled() and (
        x.requires_grad or any(w.requires_grad for w in stack.parameters()))
    new_caches: Optional[List[dict]] = [] if decode else None
    aux_total = None
    for idx, layer in enumerate(stack.layers):
        c = caches[idx] if decode else None
        if train:
            x, nc, a = _recomputed(cfg, layer.kinds, layer, x, positions,
                                   enc_kv)
        else:
            x, nc, a = _apply_layer(cfg, layer.kinds, layer, x, positions, c,
                                    cache_pos, enc_kv)
        if a is not None:
            aux_total = a if aux_total is None else aux_total + a
        if decode:
            new_caches.append(nc)
    if aux_total is None:
        aux_total = torch.zeros((), dtype=F32, device=x.device)
    return x, new_caches, aux_total


def _layer_cache(cfg: ModelConfig, kinds, batch: int, s_max: int, dtype,
                 device):
    mixer_kind, mlp_kind = kinds
    c: Dict[str, Any] = {}
    if mixer_kind in ("ga", "la", "xa"):
        s_r = s_max
        if mixer_kind == "la" and cfg.window:
            s_r = min(s_max, cfg.window)   # ring buffer: O(window) memory
        shape = (batch, s_r, cfg.n_kv_heads, cfg.head_dim)
        c["kv"] = (torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
    if mixer_kind == "rg":
        c["rg"] = recurrent.init_rglru_state(cfg, batch, dtype, device)
    if mixer_kind == "rwkv" or mlp_kind == "cmix":
        c["rwkv"] = recurrent.init_rwkv_state(cfg, batch, dtype, device)
    return c


def init_caches(cfg: ModelConfig, batch: int, s_max: int,
                dtype=torch.bfloat16, device=None) -> List[dict]:
    """One cache dict per layer, in `cfg.layers` order."""
    return [_layer_cache(cfg, kinds, batch, s_max, dtype, device)
            for kinds in cfg.layers]
