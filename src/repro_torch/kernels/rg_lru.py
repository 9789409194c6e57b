"""CUDA wrapper of the RG-LRU scan (`csrc/rg_lru.cu`).

Replaces the Pallas TPU kernel `repro/kernels/rg_lru.py::rg_lru_scan`.
One lane per (b, d) channel walks T with the carry in a register, a warp
of 32 channels a block, reading a and b from T-chunks that the warp
stages into shared memory ahead of the walk (cp.async, 4 bytes a copy, so
any fp32 view is aligned enough and none is refused for its offset).
Memory-bound (12 B per element), launch-bound at decode.  The plain
version is `kernels.ref.rg_lru_scan`.
"""
from __future__ import annotations

import torch

from . import _build


def rg_lru_scan(a, b, h0):
    """a, b [B, T, D] and h0 [B, D]: contiguous fp32 CUDA tensors ->
    h [B, T, D]."""
    B, T, D = a.shape
    _build.require("rg_lru_scan", torch.float32, (B, T, D), a=a, b=b)
    _build.require("rg_lru_scan", torch.float32, (B, D), h0=h0)
    if a.device != h0.device:
        raise ValueError(f"rg_lru_scan: a on {a.device}, h0 on {h0.device}")
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    lib = _build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_rg_lru_scan(a.data_ptr(), b.data_ptr(),
                                    h0.data_ptr(), h.data_ptr(), B, T, D,
                                    stream)
    _build.check(err, "rg_lru_scan")
    _build.counted("rg_lru_scan")
    return h
