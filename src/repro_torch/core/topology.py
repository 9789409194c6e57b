"""Column-grid topology: neighbour rings, periodic wrap, gid numbering,
shard ownership (block / scatter placements).

Global neuron id (gid) layout:  gid = column_id * neurons_per_column + n,
column_id = cy * grid_x + cx  (row-major), n in [0, neurons_per_column);
neuron n is excitatory iff n < n_exc_per_column.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .params import GridConfig


def ring_offsets(ring: int) -> List[Tuple[int, int]]:
    """(dx, dy) offsets at Chebyshev distance == ring, deterministic order."""
    if ring == 0:
        return [(0, 0)]
    out = []
    for dy in range(-ring, ring + 1):
        for dx in range(-ring, ring + 1):
            if max(abs(dx), abs(dy)) == ring:
                out.append((dx, dy))
    return out


RING_SIZES = (1, 8, 16, 24)  # Chebyshev rings 0..3


def column_coords(cfg: GridConfig, col: np.ndarray):
    cx = col % cfg.grid_x
    cy = col // cfg.grid_x
    return cx, cy


def wrap_column(cfg: GridConfig, cx: np.ndarray, cy: np.ndarray) -> np.ndarray:
    """Periodic boundary conditions (paper: used for all scaling runs)."""
    return (cy % cfg.grid_y) * cfg.grid_x + (cx % cfg.grid_x)


def profile_reach(cfg: GridConfig) -> int:
    """Halo depth of the connectivity profile `cfg` selects (the largest
    Chebyshev ring a forward synapse can target — `profiles.reach()`)."""
    from . import profiles
    return profiles.from_config(cfg).reach()


def neighbour_columns(cfg: GridConfig, col: int,
                      max_ring: Optional[int] = None) -> np.ndarray:
    """Unique columns within `max_ring` Chebyshev rings of `col` (periodic).

    `max_ring=None` derives the depth from the connectivity profile the
    config selects (`profile_reach`) — the default for every caller that
    provisions halos.  Note that on small grids periodic wrap can alias
    several offsets onto the same column (the paper's single-column case
    projects everything to itself); the returned array is deduplicated.
    """
    if max_ring is None:
        max_ring = profile_reach(cfg)
    cx, cy = column_coords(cfg, np.asarray(col))
    cols = []
    for r in range(max_ring + 1):
        for dx, dy in ring_offsets(r):
            cols.append(wrap_column(cfg, cx + dx, cy + dy))
    return np.unique(np.asarray(cols, dtype=np.int64))


def gid_column(cfg: GridConfig, gid: np.ndarray) -> np.ndarray:
    return gid // cfg.neurons_per_column


def gid_local_n(cfg: GridConfig, gid: np.ndarray) -> np.ndarray:
    return gid % cfg.neurons_per_column


def is_excitatory(cfg: GridConfig, gid: np.ndarray) -> np.ndarray:
    return gid_local_n(cfg, gid) < cfg.n_exc_per_column


# ----------------------------------------------------------------------------
# Shard ownership.  The key property (paper: "global and local identities of
# neurons can be easily computed using the local identifiers of processes and
# neurons") is that ownership is a pure function of (gid, H, placement).
# ----------------------------------------------------------------------------


def shard_bounds_block(n_neurons: int, n_shards: int) -> np.ndarray:
    """Start offsets of each block shard; fair share N/H (paper wording)."""
    base, rem = divmod(n_neurons, n_shards)
    sizes = np.full(n_shards, base, dtype=np.int64)
    sizes[:rem] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def owner_of(cfg: GridConfig, gid: np.ndarray, n_shards: int, placement: str
             ) -> np.ndarray:
    gid = np.asarray(gid, dtype=np.int64)
    if placement == "block":
        bounds = shard_bounds_block(cfg.n_neurons, n_shards)
        return np.searchsorted(bounds, gid, side="right") - 1
    elif placement == "scatter":
        return gid % n_shards
    raise ValueError(f"unknown placement {placement!r}")


def owned_gids(cfg: GridConfig, shard: int, n_shards: int, placement: str
               ) -> np.ndarray:
    """The gids owned by `shard`, in canonical (ascending gid) order."""
    if placement == "block":
        bounds = shard_bounds_block(cfg.n_neurons, n_shards)
        return np.arange(bounds[shard], bounds[shard + 1], dtype=np.int64)
    elif placement == "scatter":
        return np.arange(shard, cfg.n_neurons, n_shards, dtype=np.int64)
    raise ValueError(f"unknown placement {placement!r}")


def local_size(cfg: GridConfig, shard: int, n_shards: int, placement: str) -> int:
    return int(owned_gids(cfg, shard, n_shards, placement).shape[0])


def max_local_size(cfg: GridConfig, n_shards: int, placement: str) -> int:
    """Static per-shard capacity (same for all shards; pads the remainder)."""
    return -(-cfg.n_neurons // n_shards)


def shard_halo_columns(cfg: GridConfig, shard: int, n_shards: int,
                       placement: str,
                       max_ring: Optional[int] = None) -> np.ndarray:
    """All columns whose neurons may project onto this shard's neurons.

    == union of `reach`-ring neighbourhoods of the columns this shard owns
    neurons in, where reach comes from the connectivity profile when
    `max_ring` is None (profile-derived halo depth, DESIGN.md
    §Connectivity profiles).  Excitatory kernels are symmetric (ring r of
    c contains c' iff ring r of c' contains c), so the same union bounds
    incoming sources; inhibitory sources are intra-column, already
    included.
    """
    if max_ring is None:
        max_ring = profile_reach(cfg)
    gids = owned_gids(cfg, shard, n_shards, placement)
    my_cols = np.unique(gid_column(cfg, gids))
    halos = [neighbour_columns(cfg, int(c), max_ring) for c in my_cols]
    return np.unique(np.concatenate(halos))
