"""Izhikevich neuron dynamics (port of `repro.core.neuron`).

Canonical Izhikevich (2003) form with two half-steps for the membrane
equation (as in the published reference implementation the paper follows):

    v' = 0.04 v^2 + 5 v + 140 - u + I      (two dt/2 Euler substeps)
    u' = a (b v - u)                        (one dt step)
    if v >= v_peak:  record spike, v <- c, u <- u + d

State is fp32: the reset discontinuity makes the system stiff near
threshold, and bf16 perturbs spike timings enough to break the paper's
bit-identical-raster property.  Every constant enters as an fp32 tensor,
so the operations are the reference's fp32 operations in its order (the
engines run the same update through `kernels.ops.izhikevich_update` or
inside the phase-A kernel).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..kernels.ref import f32, izh_coefficients
from .params import IzhikevichParams


class NeuronState(NamedTuple):
    v: torch.Tensor      # [..., N] fp32 membrane potential (mV)
    u: torch.Tensor      # [..., N] fp32 recovery variable


def init_state(exc_mask: torch.Tensor, p: IzhikevichParams) -> NeuronState:
    """Paper/Izhikevich init: v = v_init, u = b * v."""
    dev = exc_mask.device
    v = torch.full(exc_mask.shape, float(f32(p.v_init, "cpu")),
                   dtype=torch.float32, device=dev)
    b = torch.where(exc_mask, f32(p.b_exc, dev), f32(p.b_inh, dev))
    return NeuronState(v=v, u=b * v)


def step(state: NeuronState, current: torch.Tensor, exc_mask: torch.Tensor,
         p: IzhikevichParams) -> Tuple[NeuronState, torch.Tensor]:
    """One dt step.  Returns (new_state, spiked [..., N] bool)."""
    dev = state.v.device
    v, u = state.v, state.u
    current = current.to(torch.float32)
    a, b, c, d = izh_coefficients(exc_mask, p)
    h = f32(p.dt / p.v_substeps, dev)
    for _ in range(p.v_substeps):
        v = v + h * (f32(0.04, dev) * v * v + f32(5.0, dev) * v
                     + f32(140.0, dev) - u + current)
    u = u + f32(p.dt, dev) * a * (b * v - u)

    spiked = v >= f32(p.v_peak, dev)
    v = torch.where(spiked, c, v)
    u = torch.where(spiked, u + d, u)
    return NeuronState(v=v, u=u), spiked
