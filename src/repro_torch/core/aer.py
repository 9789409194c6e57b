"""Address Event Representation (AER) spike packing (port of
`repro.core.aer`).

Paper: "we send 'axonal spike' messages that carry the identifiers of
spiking neurons and are packed in groups that have the same spike emission
time and the same target process".  Messages are fixed-capacity int32
buffers of spiking gids, ascending, padded with INVALID, beside a spike
count.

Every function works along the last axis, so the stacked [H, N] shards
pack in one call (the JAX package `vmap`s the one-shard functions).  Where
JAX's `mode="drop"` forgets an index of `cap` or an INVALID pad, a torch
scatter would raise: the buffers here are one slot longer and the extra
slot is sliced off.  Nothing is read back to the host: counts stay
tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

INVALID = 2 ** 31 - 1


def compact_indices(mask: torch.Tensor, cap: int, fill: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-free compaction: ascending indices of the True entries of
    `mask` [..., n], padded with `fill` to length `cap`.  Rank = inclusive
    cumsum - 1, so the scatter keeps index order.  Returns (ids [..., cap]
    int32, n_dropped [...] int32)."""
    n = mask.shape[-1]
    rank = torch.cumsum(mask, -1) - 1                 # rank among selected
    idx = torch.where(mask & (rank < cap), rank, cap)  # cap: the spare slot
    ids = torch.full((*mask.shape[:-1], cap + 1), fill, dtype=torch.int32,
                     device=mask.device)
    ids.scatter_(-1, idx, torch.arange(n, dtype=torch.int32,
                                       device=mask.device).expand(mask.shape))
    dropped = torch.clamp(mask.sum(-1, dtype=torch.int32) - cap, min=0)
    return ids[..., :cap], dropped


def pack(spiked: torch.Tensor, gid: torch.Tensor, capacity: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(spiked [..., N] bool, gid [..., N]) -> (ids [..., capacity] int32
    ascending, count [...] int32).  Padding entries are INVALID (at the
    tail); -1 gids (capacity pads) never pack.  The gid tables ascend by
    local index for every placement, so the order-preserving compaction
    keeps the ascending order `match_sources` needs."""
    n = gid.shape[-1]
    sel = spiked & (gid >= 0)
    idx, dropped = compact_indices(sel, capacity, fill=n)
    safe = torch.clamp(idx, max=n - 1).to(torch.int64)
    ids = torch.where(idx < n, torch.gather(gid, -1, safe).to(torch.int32),
                      INVALID)
    count = sel.sum(-1, dtype=torch.int32) - dropped
    return ids, count


def match_sources(ids: torch.Tensor, src_gid: torch.Tensor) -> torch.Tensor:
    """Mark which local sources appear in a received AER buffer.

    ids [..., C] ascending spike gids (INVALID padded); src_gid [..., S]
    the local source table (-1 pads anywhere, masked).  Returns [..., S]
    bool."""
    src = src_gid.to(ids.dtype)           # searchsorted wants one dtype
    pos = torch.searchsorted(ids.contiguous(), src.contiguous())
    pos = torch.clamp(pos, 0, ids.shape[-1] - 1)
    hit = torch.gather(ids, -1, pos) == src
    return hit & (src_gid >= 0)
