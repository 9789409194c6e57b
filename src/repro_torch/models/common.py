"""Shared model building blocks: norms, rotary embedding, activations
(port of `repro.models.common`).

The JAX package draws every parameter from `fold_in(key, path-hash)`; the
port draws from an explicit `torch.Generator` (`init_dense`, `init_embed`)
with the same distributions.  The two cannot give the same bits: weights
are carried across with `models.convert` where bits matter.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

F32 = torch.float32


def dtype_of(cfg) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def param(shape, dtype, device) -> torch.nn.Parameter:
    """An uninitialised parameter (filled by `lm.init_params` or
    `convert.lm_params_from_jax`).  The port serves only, so it tracks no
    gradient."""
    return torch.nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                              requires_grad=False)


@torch.no_grad()
def init_dense(w: torch.Tensor, generator, scale: float = 1.0) -> None:
    """Truncated-normal (+-3 sigma) fan-in init, std scale/sqrt(shape[-2])
    (shape[0] for a vector), drawn in fp32 and cast (`common.dense_init`)."""
    fan_in = w.shape[-2] if w.dim() > 1 else w.shape[0]
    tmp = torch.empty(w.shape, dtype=F32, device=w.device)
    torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -3.0, 3.0, generator=generator)
    w.copy_(tmp * (scale / fan_in ** 0.5))


@torch.no_grad()
def init_embed(w: torch.Tensor, generator) -> None:
    """N(0, 1/d), drawn in fp32 and cast (`common.embed_init`)."""
    tmp = torch.empty(w.shape, dtype=F32, device=w.device)
    tmp.normal_(generator=generator)
    w.copy_(tmp * w.shape[-1] ** -0.5)


def scale_by(x: torch.Tensor, s: float) -> torch.Tensor:
    """x * s with the Python float rounded to x's dtype first, as a JAX
    weak-typed scalar is (bf16: 1.4 / 2 -> 0.69921875)."""
    if s == 1.0:
        return x
    return x * torch.tensor(s, dtype=x.dtype, device=x.device)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in fp32, cast back to x.dtype (gemma uses (1+gamma))."""
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xn = xf * torch.rsqrt(var + eps)
    g = gamma.to(F32)
    if plus_one:
        g = g + 1.0
    return (xn * g).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding.  x: [..., T, H, D]; positions: [T] (prefill) or
    [B, T] (per-slot decode)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                     / half)
    ang = positions[..., :, None, None].to(F32) * freq      # [..., T, 1, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf1, xf2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def activate(x: torch.Tensor, gate: Optional[torch.Tensor], kind: str
             ) -> torch.Tensor:
    if kind == "swiglu":
        if gate is None:
            raise ValueError("swiglu needs a gate")
        return F.silu(gate.to(F32)).to(x.dtype) * x
    if kind == "gelu":
        y = F.gelu(x.to(F32), approximate="tanh")
        return (y.to(x.dtype) * gate) if gate is not None else y.to(x.dtype)
    if kind == "relu2":
        return torch.square(F.relu(x.to(F32))).to(x.dtype)
    raise ValueError(kind)
