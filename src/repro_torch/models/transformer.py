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
dict per layer.  Mixers 'rg', 'la' and 'ga' with dense MLPs are ported.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from . import attention, common, mlp as mlp_mod, recurrent

F32 = torch.float32
MIXERS = ("rg", "la", "ga")


class Layer(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, kinds: Tuple[str, str], dtype,
                 device):
        super().__init__()
        mixer_kind, mlp_kind = kinds
        if mixer_kind not in MIXERS or mlp_kind != "dense":
            raise NotImplementedError(
                f"layer kind {kinds} is {common.NOT_PORTED}")
        self.cfg, self.kinds = cfg, kinds
        self.norm1 = common.param((cfg.d_model,), F32, device)
        self.norm2 = common.param((cfg.d_model,), F32, device)
        if mixer_kind == "rg":
            self.mixer = recurrent.RGLRU(cfg, dtype, device)
        else:
            self.mixer = attention.Attention(cfg, dtype, device)
        self.mlp = mlp_mod.MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype, device)

    def forward(self, x, positions, cache=None, cache_pos=None):
        return _apply_layer(self.cfg, self.kinds, self, x, positions, cache,
                            cache_pos)


@torch.no_grad()
def init_layer(p: Layer, generator) -> None:
    p.norm1.fill_(1.0)
    p.norm2.fill_(1.0)
    if isinstance(p.mixer, recurrent.RGLRU):
        recurrent.init_rglru(p.mixer, generator)
    else:
        attention.init_attn(p.mixer, generator)
    mlp_mod.init_mlp(p.mlp, generator)


def _apply_layer(cfg: ModelConfig, kinds: Tuple[str, str], p: Layer, x,
                 positions, cache: Optional[dict], cache_pos) -> Tuple:
    """Returns (x, new_cache).  Only dense MLPs are ported, so a layer has
    no auxiliary loss (the JAX package's third return value is 0 here)."""
    mixer_kind, _ = kinds
    rs = cfg.residual_scale
    new_cache: Dict[str, Any] = {}

    h = common.rms_norm(x, p.norm1, cfg.norm_eps)
    if mixer_kind in ("ga", "la"):
        window = cfg.window if mixer_kind == "la" else None
        kv_cache = cache.get("kv") if cache else None
        y, kv_new = attention.attention(
            cfg, p.mixer, h, positions, causal=True, window=window,
            cache=kv_cache, cache_pos=cache_pos)
        if kv_new is not None:
            new_cache["kv"] = kv_new
    else:
        st = cache.get("rg") if cache else None
        y, st_new = recurrent.rglru(cfg, p.mixer, h, st)
        if cache is not None:
            new_cache["rg"] = st_new
    x = x + rs * y

    h = common.rms_norm(x, p.norm2, cfg.norm_eps)
    x = x + rs * mlp_mod.mlp(p.mlp, h, cfg.act)
    return x, (new_cache if cache is not None else None)


class Stack(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            Layer(cfg, kinds, dtype, device) for kinds in cfg.layers)


def init_stack(p: Stack, generator) -> None:
    for layer in p.layers:
        init_layer(layer, generator)


def apply_stack(cfg: ModelConfig, stack: Stack, x, positions, *,
                caches: Optional[List[dict]] = None, cache_pos=None):
    """Returns (x, new_caches)."""
    decode = caches is not None
    new_caches: Optional[List[dict]] = [] if decode else None
    for idx, layer in enumerate(stack.layers):
        c = caches[idx] if decode else None
        x, nc = _apply_layer(cfg, layer.kinds, layer, x, positions, c,
                             cache_pos)
        if decode:
            new_caches.append(nc)
    return x, new_caches


def _layer_cache(cfg: ModelConfig, kinds, batch: int, s_max: int, dtype,
                 device):
    mixer_kind, _ = kinds
    c: Dict[str, Any] = {}
    if mixer_kind in ("ga", "la"):
        s_r = s_max
        if mixer_kind == "la" and cfg.window:
            s_r = min(s_max, cfg.window)   # ring buffer: O(window) memory
        shape = (batch, s_r, cfg.n_kv_heads, cfg.head_dim)
        c["kv"] = (torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
    if mixer_kind == "rg":
        c["rg"] = recurrent.init_rglru_state(cfg, batch, dtype, device)
    return c


def init_caches(cfg: ModelConfig, batch: int, s_max: int,
                dtype=torch.bfloat16, device=None) -> List[dict]:
    """One cache dict per layer, in `cfg.layers` order."""
    return [_layer_cache(cfg, kinds, batch, s_max, dtype, device)
            for kinds in cfg.layers]
