"""CUDA wrapper of the RG-LRU scan (`csrc/rg_lru.cu`).

Replaces the Pallas TPU kernel `repro/kernels/rg_lru.py::rg_lru_scan`.
One lane per (b, d) channel walks T with the carry in a register, a warp
of 32 channels a block, reading a and b from T-chunks that the warp
stages into shared memory ahead of the walk (cp.async, 4 bytes a copy, so
any fp32 view is aligned enough and none is refused for its offset).
Memory-bound (12 B per element), launch-bound at decode.  The plain
version is `kernels.ref.rg_lru_scan`.

`rg_lru_scan_bwd` is the scan's backward (the JAX package has none: it
differentiates its oracle), the same design walking T downward: a lane a
channel, T-chunks of gh, a and h staged by the warp, 20 B per element.
Its plain version is `kernels.ref.rg_lru_scan_bwd`.
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


def rg_lru_scan_bwd(a, h0, h, gh):
    """a, h, gh [B, T, D] and h0 [B, D]: contiguous fp32 CUDA tensors ->
    (da, db [B, T, D], dh0 [B, D]), the gradients of h = rg_lru_scan(a, b,
    h0) given gh = dL/dh."""
    B, T, D = a.shape
    _build.require("rg_lru_scan_bwd", torch.float32, (B, T, D), a=a, h=h,
                   gh=gh)
    _build.require("rg_lru_scan_bwd", torch.float32, (B, D), h0=h0)
    _build.one_device("rg_lru_scan_bwd", a, h0)
    da, db = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return da, db, torch.zeros_like(h0)
    dh0 = torch.empty_like(h0)
    lib = _build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_rg_lru_scan_bwd(
            a.data_ptr(), h0.data_ptr(), h.data_ptr(), gh.data_ptr(),
            da.data_ptr(), db.data_ptr(), dh0.data_ptr(), B, T, D, stream)
    _build.check(err, "rg_lru_scan_bwd")
    _build.counted("rg_lru_scan_bwd")
    return da, db, dh0
