"""CUDA wrapper of the ordered per-target current sum
(`csrc/segment_sum.cu`).

Counterpart of the sorted `jax.ops.segment_sum` at
`repro/core/engine.py:230` (not a Pallas kernel).  One thread per target
row adds that row's contributions in canonical order from +0.0, which is
what XLA-CPU computes; `index_add_` on the card would add with atomics in
no fixed order.  Memory-bound (about 4 B/synapse).  The plain version is
`kernels.ref.segment_sum_ordered`.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import Segments


def segment_sum_ordered(contrib: torch.Tensor,
                        seg: Segments) -> torch.Tensor:
    """contrib [H, E] fp32 -> [H, N] fp32 per-target sums over the CSR
    `seg.row_ptr` [H, N + 1] int32 (per shard, valid synapses only)."""
    row_ptr = seg.row_ptr
    H, E = contrib.shape
    N = row_ptr.shape[1] - 1
    _build.require("segment_sum_ordered", torch.float32, (H, E),
                   contrib=contrib)
    _build.require("segment_sum_ordered", torch.int32, (H, N + 1),
                   row_ptr=row_ptr)
    out = torch.empty((H, N), dtype=torch.float32, device=contrib.device)
    if H * N == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(contrib.device):
        err = lib.repro_segment_sum_ordered(
            contrib.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), H, N, E,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "segment_sum_ordered")
    _build.counted("segment_sum_ordered")
    return out
