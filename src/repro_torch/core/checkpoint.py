"""Layout-free checkpoints of the DPSNN state (the port's
`repro.core.checkpoint`, in the same file format).

Connectivity is a pure function of gids, not of the process layout, so a
checkpoint stores neuron state keyed by gid and synapse state keyed by
the canonical (tgt_gid, src_gid, j) triple.  A run saved at H shards
restores bit-identically at any H' / placement', and over a job of any
rank count R' (`StepProgram.load`, then `place`).

The format is the JAX package's own: the same npz members, of the same
dtypes member by member and mode by mode (the reference's plan keeps
`gid` and `src_gid` as int32, so `gid` and, over materialized
connectivity, `tgt`, `src` and `j` are int32; the streamed keys are
int64), the same meta keys in the same order and the same guards.  A
file written by either package loads in the other, and for the same
state both write equal members, so equal `payload_sha256`.

Writes are crash-safe: tmp file + atomic rename with a sha256 payload
digest embedded (`core.integrity`); `load` verifies the digest and raises
`CheckpointCorrupt` on a truncated or bit-flipped file.  `latest()` finds
the newest complete checkpoint and `latest_valid()` the newest that
VERIFIES (falling back past corrupted epochs).  A checkpoint may carry
the run's cumulative spike events (`raster_events=`), so that a
supervised cluster run restarted from a mid-run epoch keeps its full-run
raster signature.

Both delivery backends share the format: the event backend's per-slot
synapse-id lists map onto the dense [D, E] ring as within-slot RANKS
(k = the k-th event of its slot), so that `load` rebuilds each list in
the order the live ring held (the arrivals add in list order).  That
relies on the ring's invariant: a slot holds its events in [0, ev_count)
and -1 after them.  The file records which backend wrote it and `load`
refuses the other one (their fp32 summation orders differ).

Save and load are host work in numpy.  The synapse keys of a layout are
rebuilt from the configuration (every shard's tables, or every chunk's
under streamed connectivity), and sorted into the global canonical
order, once a process for each grid, shard count, placement and chunk
size: a worker writing periodic epochs pays for them once.
`load` returns the state in the form `init_state()` has it: on the
program's device without a mesh, the full host state over one.
"""
from __future__ import annotations

import functools
import json
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import connectivity, engine, integrity, profiles, topology
from .engine import ShardPlan, ShardState, SimSpec
from .params import EngineConfig
from .event_engine import EventState
from .integrity import CheckpointCorrupt  # noqa: F401  (public re-export)


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _Keys(NamedTuple):
    tgt: np.ndarray        # [H, E] target gid of each synapse slot
    src: np.ndarray        # [H, E] source gid
    j: np.ndarray          # [H, E] forward-slot index
    valid: np.ndarray      # [H, E] bool
    order: np.ndarray      # the valid slots' global canonical order


@functools.lru_cache(maxsize=4)
def _layout_keys(cfg, H: int, placement: str, chunk_cols: Optional[int],
                 e_pad: int) -> _Keys:
    """The synapse keys of a layout (connectivity reads only the shard
    count and placement of an EngineConfig), in the reference's dtypes
    (int32 over materialized tables, int64 streamed), and the valid
    slots' order by (tgt, src, j)."""
    eng = EngineConfig(n_shards=H, placement=placement)
    if chunk_cols is not None:
        tgt = np.zeros((H, e_pad), np.int64)
        src = np.zeros((H, e_pad), np.int64)
        j = np.zeros((H, e_pad), np.int64)
        valid = np.zeros((H, e_pad), bool)
        for h in range(H):
            t_, s_, j_ = connectivity.streamed_shard_keys(cfg, eng, h,
                                                          chunk_cols)
            n = t_.shape[0]
            tgt[h, :n], src[h, :n], j[h, :n] = t_, s_, j_
            valid[h, :n] = True
    else:
        n_cap = topology.max_local_size(cfg, H, eng.placement)
        tables = connectivity.build_all_shards(cfg, eng)
        tgt, src, j, valid = [], [], [], []
        for h, t in enumerate(tables):
            gid = np.full((n_cap,), -1, np.int32)
            owned = topology.owned_gids(cfg, h, H, eng.placement)
            gid[:owned.shape[0]] = owned
            tgt.append(gid[t.tgt_local])
            src.append(t.src_gid.astype(np.int32)[t.src_idx])
            j.append(t.j)
            valid.append(t.valid)
        tgt, src, j, valid = (np.stack(a) for a in (tgt, src, j, valid))
    m = valid.reshape(-1)
    order = np.lexsort((j.reshape(-1)[m], src.reshape(-1)[m],
                        tgt.reshape(-1)[m]))
    return _Keys(tgt, src, j, valid, order)


def _global_keys(spec: SimSpec, plan: ShardPlan) -> _Keys:
    """Canonical per-synapse key arrays (tgt_gid, src_gid, j), the valid
    mask, per shard [H, E], and the valid slots' global canonical order.

    Streamed mode carries weight state in chunk-concatenated canonical
    order, a contiguous valid prefix of each shard's [e_pad] axis, so its
    keys come from `connectivity.streamed_shard_keys` padded to the same
    layout; the on-disk format (global canonical order) is shared with
    materialized mode.  Rebuilt once a process for each grid, shard
    count, placement and chunk size (`_layout_keys`); the plan's gids are
    those of that layout."""
    stream = spec.stream
    keys = _layout_keys(spec.cfg, spec.eng.n_shards, spec.eng.placement,
                        None if stream is None else stream.chunk_cols,
                        0 if stream is None else stream.e_pad)
    if keys[0].shape[0] != plan.gid.shape[0]:
        raise ValueError(f"a plan of {plan.gid.shape[0]} shards for a "
                         f"layout of {keys[0].shape[0]}: pass the full "
                         f"(host) plan")
    return keys


def _event_ring_to_ranks(state: EventState, e_cap: int) -> np.ndarray:
    """[H, D, cap_ev] event-id lists -> [H, D, E] per-synapse slot RANKS
    (0 = not pending, k = k-th event of its slot list).

    Rides the dense ring's per-synapse layout (a synapse is pending at
    most once a slot, delays < D) but keeps the within-slot ORDER: the
    arrivals add in list order, so a restore that re-canonicalized the
    lists would fork the trajectory bitwise whenever >= 3 same-slot
    events share a target."""
    ring = _np(state.ev_ring)
    H, D, cap = ring.shape
    ranks = np.zeros((H, D, e_cap), dtype=np.int32)
    pos = np.arange(1, cap + 1, dtype=np.int32)
    for h in range(H):
        for d in range(D):
            ids = ring[h, d]
            ranks[h, d, ids[ids >= 0]] = pos[ids >= 0]
    return ranks


def _ranks_to_event_ring(ranks: np.ndarray, cap_ev: int):
    """Inverse of `_event_ring_to_ranks`: per-slot lists ordered by the
    saved ranks, -1 after them.  A same-layout restore reproduces the live
    list exactly; a resharded restore merges each new shard's pending
    events by their old ranks (stable, ascending-id ties), which is
    deterministic and keeps every same-source relative order."""
    H, D, _ = ranks.shape
    ring = np.full((H, D, cap_ev), -1, dtype=np.int32)
    count = np.zeros((H, D), dtype=np.int32)
    for h in range(H):
        for d in range(D):
            ids = np.nonzero(ranks[h, d])[0]
            if ids.shape[0] > cap_ev:
                raise ValueError(
                    f"checkpoint slot holds {ids.shape[0]} pending events "
                    f"> cap_ev {cap_ev}; restore with a larger cap_ev")
            ids = ids[np.argsort(ranks[h, d, ids], kind="stable")]
            ring[h, d, :ids.shape[0]] = ids
            count[h, d] = ids.shape[0]
    return ring, count


def save(path: str, spec: SimSpec, plan: ShardPlan, state, t: int,
         raster_events: Optional[Tuple[np.ndarray, np.ndarray]] = None
         ) -> str:
    """Write a layout-free checkpoint of a full stacked state (a ShardState
    or an EventState, on any device; over a mesh the one `gather`
    collects, with the full host plan); returns the final path.

    `raster_events=(times, gids)` persists the run's cumulative spike
    events (`load_raster_events` reads them back)."""
    delivery, sat_total = "dense", 0
    if isinstance(state, EventState):
        delivery = "event"
        sat_total = int(_np(state.sat).sum())
        arr = _event_ring_to_ranks(state, state.base.w.shape[-1])
        state = state.base
    else:
        arr = _np(state.arr_ring)                  # [H, D, E]
    tgt, src, j, valid, key_order = _global_keys(spec, plan)
    m = valid.reshape(-1)

    gid = _np(plan.gid).astype(np.int32).reshape(-1)
    nmask = gid >= 0
    order = np.argsort(gid[nmask], kind="stable")

    def neuron(a):
        return _np(a).reshape(-1)[nmask][order]

    # synapses in global canonical order (tgt, src, j)
    def syn(a):
        return _np(a).reshape(-1)[m][key_order]

    D = spec.cfg.n_delay_slots
    arr = np.moveaxis(arr, 1, 0).reshape(D, -1)    # [D, H*E]
    arr = arr[:, m][:, key_order]

    payload = dict(
        gid=gid[nmask][order],
        v=neuron(state.v), u=neuron(state.u),
        last_post=neuron(state.last_post),
        tgt=tgt.reshape(-1)[m][key_order], src=src.reshape(-1)[m][key_order],
        j=j.reshape(-1)[m][key_order],
        w=syn(state.w), last_arr=syn(state.last_arr), arr_ring=arr,
        t=np.int64(t))
    if raster_events is not None:
        ev_t, ev_g = raster_events
        payload["ev_t"] = np.asarray(ev_t, dtype=np.int64)
        payload["ev_g"] = np.asarray(ev_g, dtype=np.int64)
    prof = profiles.from_config(spec.cfg)
    meta = dict(grid_x=spec.cfg.grid_x, grid_y=spec.cfg.grid_y,
                neurons_per_column=spec.cfg.neurons_per_column,
                synapses_per_neuron=spec.cfg.synapses_per_neuron,
                seed=spec.cfg.seed, connectivity=spec.cfg.connectivity,
                ring_masses=list(prof.ring_masses()), t=int(t),
                delivery=delivery, sat=sat_total,
                connectivity_mode=("streamed" if spec.stream is not None
                                   else "materialized"),
                n_events=(0 if raster_events is None
                          else int(payload["ev_t"].shape[0])))
    payload["meta"] = np.array(json.dumps(meta))
    return integrity.write_verified(path, payload)


def load(path: str, spec: SimSpec, plan: ShardPlan,
         cap_ev: Optional[int] = None) -> Tuple[object, int]:
    """Restore into an arbitrary (possibly different) layout: (ShardState,
    t) for delivery='dense' and (EventState, t) for delivery='event'
    (`cap_ev` sizes the rebuilt ring: `StepProgram.cap_ev`).  The state
    lies on the plan's device (over a mesh: the full host plan's CPU).

    Raises `CheckpointCorrupt` when the file is truncated, undecodable, or
    fails its sha256 payload digest, and AssertionError, with the
    reference's messages, when it was written for another grid, seed,
    delivery, connectivity mode or connectivity profile."""
    z = integrity.read_verified(path)
    meta = json.loads(str(z["meta"]))
    for k, v in (("grid_x", spec.cfg.grid_x), ("grid_y", spec.cfg.grid_y),
                 ("neurons_per_column", spec.cfg.neurons_per_column),
                 ("synapses_per_neuron", spec.cfg.synapses_per_neuron),
                 ("seed", spec.cfg.seed)):
        assert meta[k] == v, f"checkpoint {k} mismatch: {meta[k]} != {v}"
    # the backends' fp32 summation orders differ, so a silent cross-mode
    # restore would fork the trajectory; files without the key are dense
    saved_mode = meta.get("delivery", "dense")
    assert saved_mode == spec.eng.delivery, \
        f"checkpoint delivery mode mismatch: saved {saved_mode!r} != " \
        f"configured {spec.eng.delivery!r}"
    # residency mode only (a streamed file restores into any shard count
    # and chunk size), never streamed <-> materialized
    saved_cm = meta.get("connectivity_mode", "materialized")
    cur_cm = "streamed" if spec.stream is not None else "materialized"
    assert saved_cm == cur_cm, \
        f"checkpoint connectivity mode mismatch: saved {saved_cm!r} != " \
        f"configured {cur_cm!r} — streamed and materialized checkpoints " \
        f"are not interchangeable; re-save under the target mode"
    # the resolved kernel (per-ring masses), not the raw spec string:
    # other masses mean other synapse keys
    if "ring_masses" in meta:
        cur = list(profiles.from_config(spec.cfg).ring_masses())
        assert meta["ring_masses"] == cur, \
            f"checkpoint connectivity profile mismatch: saved " \
            f"{meta.get('connectivity')!r} (ring masses " \
            f"{meta['ring_masses']}) != current " \
            f"{spec.cfg.connectivity!r} ({cur})"

    # neurons: direct gid lookup
    gid = _np(plan.gid)                            # [H, N]
    ok = gid >= 0
    safe = np.where(ok, gid, 0)
    state = engine.init_state(spec, plan)

    def neuron(name, init):
        a = _np(init).copy()
        a[ok] = z[name][safe[ok]]
        return a

    # synapses: locate each local key in the stored canonical order
    tgt, src, j, valid, _ = _global_keys(spec, plan)
    H, E = valid.shape
    stored = (z["tgt"].astype(np.int64), z["src"].astype(np.int64),
              z["j"].astype(np.int64))

    # rank local keys among stored keys via searchsorted on a packed key
    # (tgt, src, j are all < 2**21 in any practical run)
    def pack(t_, s_, j_):
        return (t_.astype(np.int64) << 42) | (s_.astype(np.int64) << 21) \
            | j_.astype(np.int64)
    skey = pack(*stored)                           # ascending by construction
    lkey = pack(tgt.reshape(-1), src.reshape(-1), j.reshape(-1))
    pos = np.searchsorted(skey, lkey)
    m = valid.reshape(-1)
    pos = np.where(m, np.clip(pos, 0, skey.shape[0] - 1), 0)
    assert np.array_equal(skey[pos][m], lkey[m]), "synapse key mismatch"

    def syn(name, init):
        a = _np(init).reshape(-1).copy()
        a[m] = z[name][pos[m]]
        return a.reshape(H, E)

    # per-slot ring, re-keyed like every synapse field: bool arrival flags
    # for the dense backend, int32 within-slot ranks for the event one
    D = spec.cfg.n_delay_slots
    arr = np.zeros((H * E, D), dtype=z["arr_ring"].dtype)
    arr[m] = z["arr_ring"].T[pos[m]]
    arr = np.moveaxis(arr.reshape(H, E, D), 2, 1)  # [H, D, E]

    dev = plan.gid.device
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    event = saved_mode == "event"
    base = ShardState(
        v=put(neuron("v", state.v)), u=put(neuron("u", state.u)),
        last_post=put(neuron("last_post", state.last_post)),
        w=put(syn("w", state.w)), last_arr=put(syn("last_arr",
                                                    state.last_arr)),
        arr_ring=torch.zeros_like(state.arr_ring) if event else put(arr))
    if not event:
        return base, int(z["t"])
    if cap_ev is None:
        raise ValueError("loading an event-mode checkpoint needs cap_ev= "
                         "(the ring capacity, StepProgram.cap_ev)")
    ring, count = _ranks_to_event_ring(arr, cap_ev)
    sat = np.zeros((H,), np.int32)
    sat[0] = int(meta.get("sat", 0))       # layout-free total, on shard 0
    return EventState(base=base, ev_ring=put(ring), ev_count=put(count),
                      sat=put(sat)), int(z["t"])


def load_raster_events(path: str
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Cumulative (times, gids) spike events saved with the checkpoint,
    or None when it was written without `raster_events=`.  Verified like
    `load` (raises `CheckpointCorrupt`)."""
    z = integrity.read_verified(path)
    if "ev_t" not in z:
        return None
    return z["ev_t"].astype(np.int64), z["ev_g"].astype(np.int64)


def saved_t(path: str) -> int:
    """The step a (verified) checkpoint was taken at."""
    z = integrity.read_verified(path)
    return int(json.loads(str(z["meta"]))["t"])


def latest(directory: str, prefix: str = "ckpt_") -> Optional[str]:
    """Newest complete checkpoint in `directory` (crash-safe discovery)."""
    steps = integrity.checkpoint_steps(directory, prefix)
    return steps[-1][1] if steps else None


def latest_valid(directory: str, prefix: str = "ckpt_") -> Optional[str]:
    """Newest checkpoint that passes sha256 verification, falling back
    past corrupted epochs (the supervisor's restart anchor)."""
    return integrity.latest_valid(directory, prefix)
