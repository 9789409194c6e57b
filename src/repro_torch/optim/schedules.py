"""LR schedules (port of `repro.optim.schedules`): WSD (warmup-stable-
decay, the MiniCPM arch's defining schedule), cosine and constant.

Each returns f(step) -> an fp32 0-dim tensor on the step's device, the step
an integer tensor.  They compute what the JAX package's jitted step
does: Python constants become fp32 (JAX's weak-typed scalars), and XLA
folds a division by a constant into a multiplication by its fp32
reciprocal (`peak * s / warmup` into `s * (peak * (1 / warmup))`).
`pow` (WSD's final_frac ** t) and `cos` are the device's, within an fp32
ulp of XLA-CPU's (`tests/test_torch_train_optim.py` counts the
differences)."""
from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.float32(x), dtype=F32, device=like.device)


def _recip(n: int) -> np.float32:
    return np.float32(1.0) / np.float32(n)


def wsd(peak_lr: float, warmup: int, stable: int, decay: int,
        final_frac: float = 0.1):
    """MiniCPM WSD: linear warmup -> flat -> exponential-ish decay."""
    def f(step):
        s = step.to(F32)
        warm = s * _f32(np.float32(peak_lr) * _recip(max(warmup, 1)), s)
        flat = _f32(peak_lr, s)
        t = torch.clamp((s - warmup - stable)
                        * _f32(_recip(max(decay, 1)), s), 0.0, 1.0)
        dec = torch.pow(_f32(final_frac, s), t) * flat
        return torch.where(s < warmup, warm,
                           torch.where(s < warmup + stable, flat, dec))
    return f


def cosine(peak_lr: float, warmup: int, total: int,
           final_frac: float = 0.1):
    def f(step):
        s = step.to(F32)
        warm = s * _f32(np.float32(peak_lr) * _recip(max(warmup, 1)), s)
        t = torch.clamp((s - warmup)
                        * _f32(_recip(max(total - warmup, 1)), s), 0.0, 1.0)
        cos = (torch.cos(t * _f32(math.pi, s)) + 1.0) * _f32(
            (1 - final_frac) * 0.5, s) + _f32(final_frac, s)
        return torch.where(s < warmup, warm, cos * _f32(peak_lr, s))
    return f


def constant(lr: float):
    return lambda step: _f32(lr, step)
