"""Distributed, reproducible connectivity generation.

The paper's requirement: "the capability to initialize in a distributed manner
an identical network ... distributed over a varying number of software
processes and hardware processors".  Each forward synapse of neuron `g` at
slot `j` is a pure function of (seed, g, j, grid shape), computed with a
counter-based hash (splitmix64).  Any shard can therefore regenerate exactly
the incoming synapses it owns with **zero communication** — this replaces the
paper's O(P^2) MPI_Alltoall synapse-counter + MPI_Alltoallv synapse-list
construction phase (see DESIGN.md §2).

Canonical synapse order: sorted by (tgt_gid, src_gid, j).  Because every
synapse lives wholly on its target's owner shard, per-target accumulation
order is identical for every shard count / placement, which is what makes the
simulated rasters bit-identical across distributions (paper Table 1 check).

This is the port's own copy of `repro.core.connectivity` (numpy only,
unchanged): the materialized builder and the streamed half
(`parse_mode` .. `streamed_shard_keys`), whose chunk tables
`core.stream_engine` regenerates in the step.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from . import profiles, topology
from .params import EngineConfig, GridConfig

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer; input/output uint64 (wrapping)."""
    with np.errstate(over="ignore"):
        x = (x + _GOLDEN).astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * _MIX1
        x = (x ^ (x >> np.uint64(27))) * _MIX2
        return x ^ (x >> np.uint64(31))


def _stream(seed: int, counter: np.ndarray, lane: int) -> np.ndarray:
    """k-th independent uint64 draw for each counter value."""
    with np.errstate(over="ignore"):
        s = splitmix64(np.uint64(seed) + _GOLDEN * np.uint64(lane + 1))
    return splitmix64(counter.astype(np.uint64) ^ s)


def _uniform01(bits: np.ndarray) -> np.ndarray:
    return (bits >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)


@dataclasses.dataclass
class ForwardSynapses:
    """Forward synapses of a set of source neurons; all arrays [G, M]."""

    src_gid: np.ndarray       # [G]
    tgt_gid: np.ndarray       # [G, M]
    delay: np.ndarray         # [G, M] int32, in steps (1..delay_max)
    weight: np.ndarray        # [G, M] float32 initial value
    plastic: np.ndarray       # [G, M] bool


def forward_synapses(cfg: GridConfig, src_gids: np.ndarray) -> ForwardSynapses:
    """Generate the M forward synapses of each source gid (vectorized).

    The lateral kernel is pluggable (`core.profiles`): the profile supplies
    the per-ring cumulative target fractions and the flattened ring-offset
    tables up to its reach; the four splitmix64 draw lanes are identical
    for every profile, and for the default `ring3` profile this whole
    function is bit-identical to the paper's hard-coded kernel.
    """
    g = np.asarray(src_gids, dtype=np.int64)
    M = cfg.synapses_per_neuron
    counter = (g[:, None] * np.int64(M) + np.arange(M, dtype=np.int64)[None, :])
    c = counter.astype(np.uint64)

    r_ring = _uniform01(_stream(cfg.seed, c, 0))
    r_member = _stream(cfg.seed, c, 1)
    r_tgt = _stream(cfg.seed, c, 2)
    r_delay = _stream(cfg.seed, c, 3)

    exc = topology.is_excitatory(cfg, g)[:, None]     # [G, 1]
    src_col = topology.gid_column(cfg, g)             # [G]
    cx, cy = topology.column_coords(cfg, src_col)

    # --- excitatory: ring via cumulative fractions, member within ring ---
    prof = profiles.from_config(cfg)
    reach = prof.reach()
    off_tab, start = profiles.offset_tables(reach)
    fr = prof.cum_fractions()
    ring = np.searchsorted(fr, r_ring, side="right").clip(0, reach)  # [G, M]
    ring_size = (start[ring + 1] - start[ring])
    member = (r_member % ring_size.astype(np.uint64)).astype(np.int64)
    off = off_tab[start[ring] + member]               # [G, M, 2]
    tcol_exc = topology.wrap_column(cfg, cx[:, None] + off[..., 0],
                                    cy[:, None] + off[..., 1])
    n_exc_tgt = (r_tgt % np.uint64(cfg.neurons_per_column)).astype(np.int64)
    tgt_exc = tcol_exc * cfg.neurons_per_column + n_exc_tgt
    delay_exc = 1 + (r_delay % np.uint64(cfg.delay_max - cfg.delay_min + 1)
                     ).astype(np.int64) + (cfg.delay_min - 1)

    # --- inhibitory: same column, excitatory targets only, min delay ---
    n_inh_tgt = (r_tgt % np.uint64(cfg.n_exc_per_column)).astype(np.int64)
    tgt_inh = src_col[:, None] * cfg.neurons_per_column + n_inh_tgt
    delay_inh = np.full_like(delay_exc, cfg.delay_min)

    excb = np.broadcast_to(exc, tgt_exc.shape)
    tgt = np.where(excb, tgt_exc, tgt_inh)
    delay = np.where(excb, delay_exc, delay_inh).astype(np.int32)
    weight = np.where(excb, cfg.w_exc_init, cfg.w_inh_init).astype(np.float32)
    plastic = excb.copy()
    return ForwardSynapses(g, tgt, delay, weight, plastic)


@dataclasses.dataclass
class ShardSynapses:
    """Incoming synapses of one shard, canonical order (tgt_gid, src_gid, j).

    Padded to static capacities; `n_valid` / `n_src` give true counts.
    """

    # source table: sorted unique source gids with >=1 incoming synapse here
    src_gid: np.ndarray        # [S_cap] int64 (pad: -1)
    n_src: int
    # synapse arrays, flat, canonical order (pad: valid=False)
    src_idx: np.ndarray        # [E_cap] int32 -> index into src_gid
    tgt_local: np.ndarray      # [E_cap] int32 -> owned-neuron local index
    j: np.ndarray              # [E_cap] int32 forward-slot index (checkpoint key)
    delay: np.ndarray          # [E_cap] int32
    weight0: np.ndarray        # [E_cap] float32
    plastic: np.ndarray        # [E_cap] bool
    valid: np.ndarray          # [E_cap] bool
    n_valid: int


def candidate_sources(cfg: GridConfig, eng: EngineConfig, shard: int
                      ) -> np.ndarray:
    """All gids that may project a synapse onto this shard's neurons."""
    halo_cols = topology.shard_halo_columns(cfg, shard, eng.n_shards,
                                            eng.placement)
    npc = cfg.neurons_per_column
    nexc = cfg.n_exc_per_column
    # excitatory neurons of all halo columns
    exc = (halo_cols[:, None] * npc + np.arange(nexc)[None, :]).ravel()
    # inhibitory neurons of columns containing local targets (they project
    # only intra-column); own columns are a subset of the halo
    gids = topology.owned_gids(cfg, shard, eng.n_shards, eng.placement)
    own_cols = np.unique(topology.gid_column(cfg, gids))
    inh = (own_cols[:, None] * npc + np.arange(nexc, npc)[None, :]).ravel()
    return np.unique(np.concatenate([exc, inh]))


def build_shard(cfg: GridConfig, eng: EngineConfig, shard: int,
                e_cap: Optional[int] = None, s_cap: Optional[int] = None
                ) -> ShardSynapses:
    """Regenerate (locally, no communication) this shard's incoming synapses."""
    gids = topology.owned_gids(cfg, shard, eng.n_shards, eng.placement)
    cand = candidate_sources(cfg, eng, shard)
    fwd = forward_synapses(cfg, cand)

    owner = topology.owner_of(cfg, fwd.tgt_gid.ravel(), eng.n_shards,
                              eng.placement)
    keep = owner == shard
    src = np.repeat(cand, cfg.synapses_per_neuron)[keep]
    j = np.tile(np.arange(cfg.synapses_per_neuron, dtype=np.int64),
                cand.shape[0])[keep]
    tgt = fwd.tgt_gid.ravel()[keep]
    delay = fwd.delay.ravel()[keep]
    weight = fwd.weight.ravel()[keep]
    plastic = fwd.plastic.ravel()[keep]

    # canonical order: (tgt_gid, src_gid, j)
    order = np.lexsort((j, src, tgt))
    src, j, tgt, delay, weight, plastic = (a[order] for a in
                                           (src, j, tgt, delay, weight, plastic))

    # local target index: position of tgt gid within owned gid list
    tgt_local = np.searchsorted(gids, tgt).astype(np.int32)
    assert np.array_equal(gids[tgt_local], tgt), "target must be owned"

    src_table = np.unique(src)
    src_idx = np.searchsorted(src_table, src).astype(np.int32)

    E, S = src.shape[0], src_table.shape[0]
    e_cap = E if e_cap is None else e_cap
    s_cap = S if s_cap is None else s_cap
    assert e_cap >= E and s_cap >= S

    def padE(a, fill=0):
        out = np.full((e_cap,), fill, dtype=a.dtype)
        out[:E] = a
        return out

    src_gid_p = np.full((s_cap,), -1, dtype=np.int64)
    src_gid_p[:S] = src_table
    return ShardSynapses(
        src_gid=src_gid_p, n_src=S,
        src_idx=padE(src_idx), tgt_local=padE(tgt_local),
        j=padE(j.astype(np.int32)),
        delay=padE(delay.astype(np.int32), 1),
        weight0=padE(weight), plastic=padE(plastic),
        valid=padE(np.ones(E, dtype=bool)), n_valid=E)


def repad_shard(t: ShardSynapses, e_cap: int, s_cap: int) -> ShardSynapses:
    """Grow a shard table to new static capacities (no recompute)."""
    assert e_cap >= t.n_valid and s_cap >= t.n_src

    def padE(a, fill=0):
        out = np.full((e_cap,), fill, dtype=a.dtype)
        out[:t.n_valid] = a[:t.n_valid]
        return out

    src_gid = np.full((s_cap,), -1, dtype=np.int64)
    src_gid[:t.n_src] = t.src_gid[:t.n_src]
    return ShardSynapses(
        src_gid=src_gid, n_src=t.n_src,
        src_idx=padE(t.src_idx), tgt_local=padE(t.tgt_local),
        j=padE(t.j), delay=padE(t.delay, 1), weight0=padE(t.weight0),
        plastic=padE(t.plastic), valid=padE(t.valid), n_valid=t.n_valid)


def build_all_shards(cfg: GridConfig, eng: EngineConfig) -> List[ShardSynapses]:
    """Build every shard with uniform (max) capacities, for stacking."""
    raw = [build_shard(cfg, eng, h) for h in range(eng.n_shards)]
    e_cap = _round_up(max(r.n_valid for r in raw), 8)
    s_cap = _round_up(max(r.n_src for r in raw), 8)
    return [repad_shard(r, e_cap, s_cap) for r in raw]


def _round_up(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


# ---------------------------------------------------------------------------
# Streamed residency (EngineConfig.connectivity = 'streamed:chunk=<K>')
#
# The same counter-based draw lanes that make materialized construction
# communication-free also make it CHUNKABLE: the canonical synapse list of a
# shard, restricted to any contiguous range of owned target neurons, is a pure
# function of (seed, grid, range) and can be regenerated at will.  The host
# builder below only ever materializes one chunk at a time; the in-step
# counterpart lives in `core.stream_engine` and must stay bit-identical to
# `_chunk_synapses` (tests/test_torch_stream.py walls this off).


def parse_mode(spec: str) -> Tuple[str, Optional[int]]:
    """Parse an EngineConfig.connectivity spec.

    Returns ('materialized', None) or ('streamed', chunk_cols).
    """
    s = str(spec).strip()
    if s == "materialized":
        return "materialized", None
    name, _, body = s.partition(":")
    if name != "streamed":
        raise ValueError(
            f"unknown connectivity mode {spec!r}: expected 'materialized' "
            f"or 'streamed:chunk=<K>'")
    chunk = 1
    for item in filter(None, (p.strip() for p in body.split(","))):
        key, eq, val = item.partition("=")
        if key != "chunk" or not eq:
            raise ValueError(
                f"bad streamed connectivity option {item!r} in {spec!r}: "
                f"the only option is 'chunk=<K>' (target columns per "
                f"regenerated chunk)")
        chunk = int(val)
    if chunk < 1:
        raise ValueError(f"streamed chunk size must be >= 1, got {chunk}")
    return "streamed", chunk


def stream_geometry(cfg: GridConfig, eng: EngineConfig, chunk_cols: int
                    ) -> Tuple[int, int, int]:
    """(n_cap, q, n_chunks): uniform across shards (n_cap is uniform).

    q = owned-neuron slots per chunk; the last chunk may cover fewer real
    neurons (non-dividing K) — its tail slots simply never match a target.
    """
    n_cap = topology.max_local_size(cfg, eng.n_shards, eng.placement)
    q = chunk_cols * cfg.neurons_per_column
    n_chunks = -(-n_cap // q)
    return n_cap, q, n_chunks


def chunk_candidates(cfg: GridConfig, eng: EngineConfig, shard: int,
                     lo: int, hi: int) -> np.ndarray:
    """Sorted unique gids that may project onto owned local indices [lo, hi).

    Subset of `candidate_sources(cfg, eng, shard)` by construction (the
    chunk's columns are a subset of the shard's, so their halo is too).
    """
    gids = topology.owned_gids(cfg, shard, eng.n_shards, eng.placement)
    sel = gids[lo:min(hi, gids.shape[0])]
    if sel.size == 0:
        return np.empty((0,), dtype=np.int64)
    cols = np.unique(topology.gid_column(cfg, sel))
    halos = np.unique(np.concatenate(
        [topology.neighbour_columns(cfg, int(c)) for c in cols]))
    npc = cfg.neurons_per_column
    nexc = cfg.n_exc_per_column
    exc = (halos[:, None] * npc + np.arange(nexc)[None, :]).ravel()
    inh = (cols[:, None] * npc + np.arange(nexc, npc)[None, :]).ravel()
    return np.unique(np.concatenate([exc, inh]))


@dataclasses.dataclass
class ChunkSynapses:
    """One chunk's incoming synapses, canonical (tgt_gid, src_gid, j) order."""

    src_gid: np.ndarray       # [e] int64
    tgt_gid: np.ndarray       # [e] int64
    tgt_local: np.ndarray     # [e] int32 (shard-local target index)
    j: np.ndarray             # [e] int32
    delay: np.ndarray         # [e] int32
    weight0: np.ndarray       # [e] float32
    plastic: np.ndarray       # [e] bool


def _chunk_synapses(cfg: GridConfig, eng: EngineConfig, shard: int,
                    cand: np.ndarray, lo: int, hi: int) -> ChunkSynapses:
    """Host reference for one chunk: the [lo, hi) target-local-index slice of
    the shard's canonical synapse list (bit-equal to `build_shard`'s slice)."""
    gids = topology.owned_gids(cfg, shard, eng.n_shards, eng.placement)
    fwd = forward_synapses(cfg, cand)
    tgt = fwd.tgt_gid.ravel()
    owner = topology.owner_of(cfg, tgt, eng.n_shards, eng.placement)
    keep = owner == shard
    src = np.repeat(cand, cfg.synapses_per_neuron)[keep]
    j = np.tile(np.arange(cfg.synapses_per_neuron, dtype=np.int64),
                cand.shape[0])[keep]
    tgt = tgt[keep]
    delay = fwd.delay.ravel()[keep]
    weight = fwd.weight.ravel()[keep]
    plastic = fwd.plastic.ravel()[keep]
    tl = np.searchsorted(gids, tgt)
    assert np.array_equal(gids[tl], tgt), "target must be owned"
    sel = (tl >= lo) & (tl < hi)
    src, j, tgt, tl, delay, weight, plastic = (
        a[sel] for a in (src, j, tgt, tl, delay, weight, plastic))
    order = np.lexsort((j, src, tgt))
    return ChunkSynapses(
        src_gid=src[order], tgt_gid=tgt[order],
        tgt_local=tl[order].astype(np.int32), j=j[order].astype(np.int32),
        delay=delay[order].astype(np.int32), weight0=weight[order],
        plastic=plastic[order])


@dataclasses.dataclass
class StreamedShard:
    """Streamed-mode shard metadata: O(chunk) synapse residency.

    Only `weight0` is O(E) (it seeds the weight STATE, which is O(E) in
    either mode); the synapse TABLES are never held whole — `cand` rows name
    which source-table entries feed each chunk and `e_start` locates each
    chunk's slice of the canonical synapse order.
    """

    src_gid: np.ndarray       # [S_cap] int64 (pad -1) — full candidate table
    n_src: int
    cand: np.ndarray          # [n_chunks, C_cap] int32 src_gid rows (pad -1)
    e_start: np.ndarray       # [n_chunks + 1] int64 canonical chunk offsets
    weight0: np.ndarray       # [n_valid] float32, canonical order (unpadded)
    n_valid: int
    chunk_cols: int
    q: int
    n_chunks: int
    row_max: int              # the longest target row of any chunk


def build_streamed_shard(cfg: GridConfig, eng: EngineConfig, shard: int,
                         chunk_cols: int) -> StreamedShard:
    """Build one shard's streamed metadata, one chunk resident at a time."""
    src_table = candidate_sources(cfg, eng, shard)
    n_cap, q, n_chunks = stream_geometry(cfg, eng, chunk_cols)
    cands: List[np.ndarray] = []
    counts: List[int] = []
    rows: List[int] = [0]
    w0: List[np.ndarray] = []
    for c in range(n_chunks):
        cand = chunk_candidates(cfg, eng, shard, c * q, (c + 1) * q)
        sidx = np.searchsorted(src_table, cand)
        assert np.array_equal(src_table[sidx], cand), \
            "chunk candidates must be a subset of the shard source table"
        syn = _chunk_synapses(cfg, eng, shard, cand, c * q, (c + 1) * q)
        cands.append(sidx.astype(np.int32))
        counts.append(int(syn.src_gid.shape[0]))
        if counts[-1]:
            rows.append(int(np.bincount(syn.tgt_local).max()))
        w0.append(syn.weight0)
    c_cap = _round_up(max((c.shape[0] for c in cands), default=1), 8)
    cand_p = np.full((n_chunks, c_cap), -1, dtype=np.int32)
    for c, sidx in enumerate(cands):
        cand_p[c, :sidx.shape[0]] = sidx
    e_start = np.concatenate(
        [[0], np.cumsum(np.asarray(counts, dtype=np.int64))])
    weight0 = (np.concatenate(w0) if w0
               else np.empty((0,), dtype=np.float32))
    S = src_table.shape[0]
    s_cap = _round_up(S, 8)
    src_gid_p = np.full((s_cap,), -1, dtype=np.int64)
    src_gid_p[:S] = src_table
    return StreamedShard(
        src_gid=src_gid_p, n_src=S, cand=cand_p,
        e_start=e_start, weight0=weight0.astype(np.float32),
        n_valid=int(e_start[-1]), chunk_cols=chunk_cols, q=q,
        n_chunks=n_chunks, row_max=max(rows))


def build_all_streamed(cfg: GridConfig, eng: EngineConfig, chunk_cols: int
                       ) -> List[StreamedShard]:
    """Build every shard with uniform (max) caps, for stacking."""
    raw = [build_streamed_shard(cfg, eng, h, chunk_cols)
           for h in range(eng.n_shards)]
    s_cap = max(r.src_gid.shape[0] for r in raw)
    c_cap = max(r.cand.shape[1] for r in raw)
    out = []
    for r in raw:
        src_gid = np.full((s_cap,), -1, dtype=np.int64)
        src_gid[:r.n_src] = r.src_gid[:r.n_src]
        cand = np.full((r.n_chunks, c_cap), -1, dtype=np.int32)
        cand[:, :r.cand.shape[1]] = r.cand
        out.append(dataclasses.replace(r, src_gid=src_gid, cand=cand))
    return out


def streamed_shard_keys(cfg: GridConfig, eng: EngineConfig, shard: int,
                        chunk_cols: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(tgt_gid, src_gid, j) int64 arrays in canonical order, chunk-wise.

    Used by checkpointing to key each weight-state position without ever
    holding more than one chunk's synapse tables live.
    """
    _, q, n_chunks = stream_geometry(cfg, eng, chunk_cols)
    tgts, srcs, js = [], [], []
    for c in range(n_chunks):
        cand = chunk_candidates(cfg, eng, shard, c * q, (c + 1) * q)
        syn = _chunk_synapses(cfg, eng, shard, cand, c * q, (c + 1) * q)
        tgts.append(syn.tgt_gid)
        srcs.append(syn.src_gid)
        js.append(syn.j.astype(np.int64))
    empty = np.empty((0,), dtype=np.int64)
    return (np.concatenate(tgts) if tgts else empty,
            np.concatenate(srcs) if srcs else empty,
            np.concatenate(js) if js else empty)
