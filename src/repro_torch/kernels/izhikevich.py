"""CUDA wrapper of the fused Izhikevich update (`csrc/izhikevich.cu`).

Replaces the Pallas TPU kernel `repro/kernels/izhikevich.py::
izhikevich_update`.  Memory-bound (37 B/neuron); at the 8x8 grid's
N = 64,000 it is bound by launch latency.  The main path runs the same
update inside the phase-A kernel (`stdp.stdp_phase_a`); this one is its
yardstick and the neuron half of a phase A split into parts.  The plain
version is `kernels.ref.izhikevich_update`.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build


def izhikevich_update(v, u, current, a, b, c, d, *, v_peak: float,
                      dt: float = 1.0, substeps: int = 2):
    """Same-shape contiguous fp32 CUDA tensors -> (v', u', spiked bool)."""
    _build.require("izhikevich_update", torch.float32, v.shape, v=v, u=u,
                   current=current, a=a, b=b, c=c, d=d)
    v_out, u_out = torch.empty_like(v), torch.empty_like(u)
    spiked = torch.empty(v.shape, dtype=torch.bool, device=v.device)
    n = v.numel()
    if n == 0:
        return v_out, u_out, spiked
    lib = _build.library()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_izhikevich_update(
            v.data_ptr(), u.data_ptr(), current.data_ptr(), a.data_ptr(),
            b.data_ptr(), c.data_ptr(), d.data_ptr(), v_out.data_ptr(),
            u_out.data_ptr(), spiked.data_ptr(), n, float(v_peak),
            float(np.float32(dt / substeps)), float(dt), int(substeps),
            stream)
    _build.check(err, "izhikevich_update")
    _build.counted("izhikevich_update")
    return v_out, u_out, spiked
