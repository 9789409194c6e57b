"""Streamed connectivity: regenerate each chunk's synapse tables inside the
step (PyTorch port of `repro.core.stream_engine`).

`EngineConfig.connectivity='streamed:chunk=<K>'` trades the materialized
O(E) synapse tables for in-step regeneration: each phase walks the chunks
of K target columns and rebuilds a chunk's incoming synapses from the
same counter-based splitmix64 draw lanes the host builder uses
(`core.connectivity.forward_synapses`), so only one chunk's tables are
ever live.  The synapse STATE (w, last_arr, the arrival ring) stays O(E),
in the reference's layout: canonical (tgt_gid, src_gid, j) order, chunk
after chunk, padded to e_pad = round8(max E) + k_cap, so a JAX streamed
state carries across unchanged and rasters and weights are the
materialized mode's bit for bit.

A chunk's tables (`kernels.ref.ChunkTables`) are its per-target CSR
row_ptr [H, q + 1] in absolute state positions and, per synapse, its
source row, delay and plastic flag, sized by the largest chunk's kept
count (known at plan time), not by the reference's k_cap window.  On the
card one `ops.chunk_tables` call (`csrc/stream.cu`) regenerates them;
the phases then run the chunk-window forms of the dense kernels on them:

  phase A   per chunk: chunk_tables, then `ops.stdp_phase_a_chunk`
            (`row_kernel<true>` on the chunk's rows: arrivals, the
            ordered sum, stimulus, Izhikevich, and LTP of the rows that
            spiked).  Each row's current is complete within its chunk and
            its LTP reads only its own synapses after the same step's LTD,
            so this is the reference's three passes (dynamics, neurons,
            plasticity) bit for bit in one;
  phase B   per chunk: chunk_tables, then `ops.arborize_chunk` (the
            element walk over the chunk's synapses);

so `run` regenerates every chunk twice a step.  The split halves
(`phase_a_dynamics`, `phase_a_plasticity`; the pipelined schedule) run
the row kernel without LTP, then per chunk chunk_tables and
`ops.stdp_ltp_chunk`.  Each kernel touches only the chunk's own synapses:
the reference's k_cap window, which overlaps the next chunk, is not
read.  On the CPU the same ops run their plain versions
(`kernels.ref`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import connectivity, engine, profiles, topology
from .engine import (NEG_TIME, ShardPlan, ShardState, SimSpec, StepFns,
                     StepTimings)
from .params import (DEFAULT_IZH, DEFAULT_STDP, EngineConfig, GridConfig,
                     IzhikevichParams, StdpParams)
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..kernels import stream as kstream

ChunkTables = kref.ChunkTables


class StreamSpec(NamedTuple):
    """Static streamed-mode geometry (rides on SimSpec.stream)."""

    chunk_cols: int           # K: target columns per chunk
    q: int                    # owned-neuron slots per chunk (K * npc)
    n_chunks: int
    c_cap: int                # candidate-source cap per chunk
    k_cap: int                # generation slots per chunk (c_cap * M)
    e_pad: int                # padded synapse-state length (>= E + k_cap)
    row_cap: int              # the longest target row of any chunk


class StreamedPlan(NamedTuple):
    """Per-shard streamed metadata, stacked on a leading [H] axis: O(n_chunks
    * c_cap) ints, the only synapse-table data kept across the run."""

    cand: torch.Tensor        # [H, n_chunks, c_cap] int32 src rows (-1 pad)
    e_start: torch.Tensor     # [H, n_chunks + 1] int32 chunk offsets


# ----------------------------------------------------------------------------
# chunk regeneration
# ----------------------------------------------------------------------------


def _gen_consts(cfg: GridConfig):
    """Host-side generation constants: the profile's reach, ring offsets and
    ring starts, the thresholds U and the four draw lanes' seeds.

    U[k] = ceil(fr[k] * 2^53): `fr[k] <= bits53 * 2^-53` iff `bits53 >=
    U[k]` (power-of-two scaling is exact), so the integer comparison
    reproduces np.searchsorted(fr, r, side='right') bit for bit."""
    prof = profiles.from_config(cfg)
    reach = prof.reach()
    off_tab, start = profiles.offset_tables(reach)
    U = [math.ceil(float(f) * 2.0 ** 53) for f in prof.cum_fractions()]
    with np.errstate(over="ignore"):
        lanes = [int(connectivity.splitmix64(
            np.uint64(cfg.seed) + connectivity._GOLDEN * np.uint64(k + 1)))
            for k in range(4)]
    return reach, off_tab, start, U, lanes


def chunk_source(spec: SimSpec, plan: ShardPlan,
                 splan: StreamedPlan) -> kref.ChunkSource:
    """What `ops.chunk_tables` reads, on the plan's device: the plan's
    source table, the streamed plan, the profile's tables, the kernel's
    modulus constants and the geometry."""
    ss = spec.stream
    return make_chunk_source(spec.cfg, spec.eng, ss.q, plan.src_gid,
                             splan.cand, splan.e_start, ss.row_cap,
                             shard_id=plan.shard_id)


def make_chunk_source(cfg: GridConfig, eng: EngineConfig, q: int,
                      src_gid: torch.Tensor, cand: torch.Tensor,
                      e_start: torch.Tensor, row_cap: int,
                      shard_id: torch.Tensor = None) -> kref.ChunkSource:
    """`chunk_source` from its parts (src_gid [H, S] int64, cand [H,
    n_chunks, c_cap] int32, e_start [H, n_chunks + 1] int32, one device;
    row_cap the longest target row of any chunk, the kernel's bucket
    width).  `shard_id` [H] int64 names the stacked rows' shards (default
    0 .. H - 1): a rank's block of consecutive shards
    (`dist.sharding.shard_put`) passes the plan's, and the block bounds
    are then that block's (read on the device, no sync); under scatter
    placement row h owns the gids g with g % n_shards == shard_id[h]."""
    # the modulus arithmetic of the generator needs every modulus < 2^16
    if not (cfg.neurons_per_column < (1 << 16)
            and cfg.synapses_per_neuron < (1 << 16)):
        raise ValueError("streamed generation assumes npc, M < 65536")
    _, off_tab, start, U, lanes = _gen_consts(cfg)
    dev = cand.device
    t = lambda x, dt: torch.from_numpy(np.asarray(x, dtype=dt)).to(dev)
    dspan = cfg.delay_max - cfg.delay_min + 1
    H, n_chunks, c_cap = cand.shape
    if shard_id is None:
        shard_id = torch.arange(H, dtype=torch.int64, device=dev)
    bounds = t(topology.shard_bounds_block(cfg.n_neurons, eng.n_shards),
               np.int64)
    bounds = bounds[torch.cat([shard_id, shard_id[-1:] + 1])]
    geom = kref.ChunkGeometry(
        M=cfg.synapses_per_neuron, npc=cfg.neurons_per_column,
        nexc=cfg.n_exc_per_column, gx=cfg.grid_x, gy=cfg.grid_y,
        n_neurons=cfg.n_neurons, delay_min=cfg.delay_min, dspan=dspan, q=q,
        n_chunks=n_chunks, c_cap=c_cap,
        scatter=eng.placement == "scatter", lanes=tuple(lanes),
        row_cap=int(row_cap), n_shards=eng.n_shards)
    # the order csrc/stream.cu reads them in: npc, nexc, dspan, n_shards,
    # rings
    moduli = [cfg.neurons_per_column, cfg.n_exc_per_column, dspan,
              eng.n_shards] + list(np.diff(start))
    return kref.ChunkSource(
        src_gid=src_gid, cand=cand, e_start=e_start,
        off=t(off_tab, np.int32), start=t(start, np.int32),
        thresh=t(U, np.int64), bounds=bounds.contiguous(),
        fastmod=t(kref.fastmod_table(moduli), np.int64),
        shard_id=shard_id, geom=geom)


def live_width(splan: StreamedPlan) -> int:
    """Entries a shard of the live chunk tables holds: the largest chunk's
    kept count (at least 1)."""
    e = splan.e_start.to(torch.int64)
    return max(int((e[:, 1:] - e[:, :-1]).max()), 1)


class ChunkStream:
    """The live chunk tables of a streamed program and what regenerates
    them: `regenerate(c)` (the reference's `make_chunk_tables`, for every
    shard at once) writes chunk c of every shard into the same buffers
    (one chunk live at a time) and returns them.

    `status` [1] int32 is the kernel's flag word (bit 0: a shard kept
    another count than its e_start difference; bit 1: more than the
    tables hold).  Nothing in the step reads it: `check()` does, after
    the card has finished (the plain version raises at once)."""

    def __init__(self, spec: SimSpec, plan: ShardPlan, splan: StreamedPlan):
        self.source = chunk_source(spec, plan, splan)
        dev = plan.gid.device
        H, q, k = plan.gid.shape[0], spec.stream.q, live_width(splan)
        z = lambda n, dt: torch.zeros((H, n), dtype=dt, device=dev)
        self.tables = ChunkTables(row_ptr=z(q + 1, torch.int32),
                                  src=z(k, torch.int32),
                                  delay=z(k, torch.int32),
                                  plastic=z(k, torch.bool))
        self.status = torch.zeros(1, dtype=torch.int32, device=dev)

    def regenerate(self, c: int) -> ChunkTables:
        return kops.chunk_tables(self.source, c, self.tables, self.status)

    def check(self) -> None:
        """Raise if a regeneration flagged a chunk (reads the card)."""
        flag = int(self.status[0])
        if flag:
            raise RuntimeError(f"chunk_tables flagged a chunk (status "
                               f"{flag}): a kept count differs from the "
                               f"plan's e_start, or overflows the tables")


# ----------------------------------------------------------------------------
# streamed phases: a Python loop over chunks, each on the chunk's own rows
# ----------------------------------------------------------------------------


def _phase_a(spec, plan, chunks: ChunkStream, state, t, stim, coeffs,
             with_ltp: bool, r=None):
    H, N = state.v.shape
    dev = state.v.device
    spiked = torch.empty((H, N), dtype=torch.bool, device=dev)
    counts = torch.empty((2, H), dtype=torch.int64, device=dev)
    if r is None and not isinstance(t, torch.Tensor):
        r = t % spec.cfg.n_delay_slots
    for c in range(spec.stream.n_chunks):
        kops.stdp_phase_a_chunk(
            state.arr_ring, r, chunks.regenerate(c), c * spec.stream.q,
            plan.exc_mask, plan.neuron_valid, *stim, state.v, state.u,
            state.last_post, state.w, state.last_arr, t, spiked, counts,
            accumulate=c > 0, izh=spec.izh, stdp=spec.stdp,
            neg_time=NEG_TIME, with_ltp=with_ltp, coeffs=coeffs)
    return state, spiked, StepTimings(spikes=counts[1], arrivals=counts[0])


def phase_a_dynamics(spec: SimSpec, plan: ShardPlan, chunks: ChunkStream,
                     state: ShardState, t, stim, coeffs=None
                     ) -> Tuple[ShardState, torch.Tensor, StepTimings]:
    """Streamed phase A steps 1-5 (see engine.phase_a_dynamics): in place
    on v, u, w, last_arr and arr_ring; last_post untouched."""
    return _phase_a(spec, plan, chunks, state, t, stim, coeffs, False)


def phase_a_plasticity(spec: SimSpec, plan: ShardPlan, chunks: ChunkStream,
                       state: ShardState, spiked: torch.Tensor,
                       t) -> ShardState:
    """Streamed phase A step 6 (see engine.phase_a_plasticity): LTP chunk
    by chunk, w and last_post in place."""
    stdp = spec.stdp
    for c in range(spec.stream.n_chunks):
        kops.stdp_ltp_chunk(spiked, chunks.regenerate(c), c * spec.stream.q,
                            state.last_arr, state.w, state.last_post, t,
                            a_plus=stdp.a_plus, tau_plus=stdp.tau_plus,
                            w_min=stdp.w_min, w_max=stdp.w_max,
                            neg_time=NEG_TIME)
    return state


def phase_a(spec: SimSpec, plan: ShardPlan, chunks: ChunkStream,
            state: ShardState, t, stim, coeffs=None
            ) -> Tuple[ShardState, torch.Tensor, StepTimings]:
    """Streamed phase A, LTP in the same pass as each chunk's dynamics: the
    same bits as `phase_a_dynamics` then `phase_a_plasticity`."""
    return _phase_a(spec, plan, chunks, state, t, stim, coeffs, True)


def phase_b(spec: SimSpec, plan: ShardPlan, chunks: ChunkStream,
            state: ShardState, spiked_src: torch.Tensor, t) -> ShardState:
    """Streamed deferred arborization (see engine.phase_b), chunk by chunk,
    arr_ring in place."""
    for c in range(spec.stream.n_chunks):
        kops.arborize_chunk(state.arr_ring, spiked_src, chunks.regenerate(c),
                            t)
    return state


# ----------------------------------------------------------------------------
# build, state, step functions and the run
# ----------------------------------------------------------------------------


def _candidates(cfg: GridConfig, eng: EngineConfig, chunk_cols: int):
    """(src_gid [H, s_cap] int64, cand [H, n_chunks, c_cap] int32): the
    source tables and chunk candidates of
    `connectivity.build_all_streamed`, without generating a synapse."""
    H = eng.n_shards
    _, q, n_chunks = connectivity.stream_geometry(cfg, eng, chunk_cols)
    tables, cands = [], []
    for h in range(H):
        table = connectivity.candidate_sources(cfg, eng, h)
        rows = []
        for c in range(n_chunks):
            cand = connectivity.chunk_candidates(cfg, eng, h, c * q,
                                                 (c + 1) * q)
            sidx = np.searchsorted(table, cand)
            assert np.array_equal(table[sidx], cand), \
                "chunk candidates must be a subset of the shard source table"
            rows.append(sidx)
        tables.append(table)
        cands.append(rows)
    s_cap = max(connectivity._round_up(t.shape[0], 8) for t in tables)
    c_cap = max(connectivity._round_up(max(
        (r.shape[0] for r in rows), default=1), 8) for rows in cands)
    src_gid = np.full((H, s_cap), -1, dtype=np.int64)
    cand = np.full((H, n_chunks, c_cap), -1, dtype=np.int32)
    for h in range(H):
        src_gid[h, :tables[h].shape[0]] = tables[h]
        for c, r in enumerate(cands[h]):
            cand[h, c, :r.shape[0]] = r
    return src_gid, cand


def _count_on_card(spec: SimSpec, plan: ShardPlan, cand: torch.Tensor):
    """(e_start [H, n_chunks + 1] int64 numpy, each shard's weight0 [E_h]
    fp32 on the card, the longest target row of any chunk): the chunks'
    kept counts, rows and initial weights from `ops.chunk_tables` itself,
    chunk after chunk (what the host builder finds by generating every
    chunk in numpy).  A chunk's kept count is its row_ptr's span; a chunk
    with a row longer than the buckets (2 M keys at first) runs again with
    buckets that hold it.  The initial weight of a kept synapse is
    w_exc_init where it is plastic (an excitatory source) and w_inh_init
    elsewhere, as in `connectivity.forward_synapses`."""
    ss, cfg = spec.stream, spec.cfg
    dev = cand.device
    H = cand.shape[0]
    e_start = torch.zeros((H, ss.n_chunks + 1), dtype=torch.int32,
                          device=dev)
    source = make_chunk_source(cfg, spec.eng, ss.q, plan.src_gid, cand,
                               e_start, 2 * cfg.synapses_per_neuron)
    z = lambda n, dt: torch.zeros((H, n), dtype=dt, device=dev)
    tables = ChunkTables(row_ptr=z(ss.q + 1, torch.int32),
                         src=z(ss.k_cap, torch.int32),
                         delay=z(ss.k_cap, torch.int32),
                         plastic=z(ss.k_cap, torch.bool))
    # the kernel holds each count against e_start[:, c + 1], which is
    # written here only after it: its flag is not read
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    w_exc, w_inh = (kref.f32(x, dev) for x in (cfg.w_exc_init,
                                               cfg.w_inh_init))
    weights = [[] for _ in range(H)]
    row_max = 0
    for c in range(ss.n_chunks):
        kops.chunk_tables(source, c, tables, flag)
        longest = int((tables.row_ptr[:, 1:] - tables.row_ptr[:, :-1]).max())
        if longest > source.geom.row_cap:
            source = source._replace(
                geom=source.geom._replace(row_cap=longest))
            kops.chunk_tables(source, c, tables, flag)
        row_max = max(row_max, longest)
        kept = tables.row_ptr[:, ss.q] - tables.row_ptr[:, 0]
        e_start[:, c + 1] = e_start[:, c] + kept
        for h, n in enumerate(kept.tolist()):
            weights[h].append(torch.where(tables.plastic[h, :n], w_exc,
                                          w_inh))
    return (e_start.cpu().numpy().astype(np.int64),
            [torch.cat(w) for w in weights], row_max)


def build(cfg: GridConfig, eng: EngineConfig,
          izh: IzhikevichParams = DEFAULT_IZH,
          stdp: StdpParams = DEFAULT_STDP, *, device
          ) -> Tuple[SimSpec, ShardPlan, StreamedPlan, ShardState]:
    """Build streamed plans + initial state, stacked on a leading [H] axis,
    on `device`.  The ShardPlan carries the full candidate-source table
    (the exchange reads `src_gid` and `gid`) and 1-element dummies for the
    per-synapse arrays, as the reference's does: those are regenerated per
    chunk.

    On the CPU the chunk offsets and initial weights come from the host
    builder (`connectivity.build_all_streamed`, the reference's, which
    generates every chunk in numpy); on the card from the chunk kernel
    itself (`_count_on_card`: the same arrays, the tests hold them equal),
    so the host only finds each chunk's candidates."""
    mode, chunk_cols = connectivity.parse_mode(eng.connectivity)
    if mode != "streamed":
        raise ValueError(f"stream_engine.build called with connectivity="
                         f"{eng.connectivity!r}")
    if eng.delivery != "dense":
        raise ValueError(
            "connectivity='streamed' requires delivery='dense': the event "
            "backend's fwd/in row tables are an O(E) synapse-id "
            "permutation, which contradicts O(chunk) table residency")
    H = eng.n_shards
    n_cap, q, n_chunks = connectivity.stream_geometry(cfg, eng, chunk_cols)
    if torch.device(device).type == "cuda":
        src_gid, cand = _candidates(cfg, eng, chunk_cols)
        e_start = weight0 = None
    else:
        shards = connectivity.build_all_streamed(cfg, eng, chunk_cols)
        src_gid = np.stack([s.src_gid for s in shards])
        cand = np.stack([s.cand for s in shards])
        e_start = np.stack([s.e_start for s in shards])
        weight0 = [torch.from_numpy(s.weight0) for s in shards]
        row_max = max(s.row_max for s in shards)
    c_cap = cand.shape[2]
    s_cap = src_gid.shape[1]
    k_cap = c_cap * cfg.synapses_per_neuron
    col_cap = max(
        np.unique(topology.gid_column(
            cfg, topology.owned_gids(cfg, h, H, eng.placement))).shape[0]
        for h in range(H))

    plans = []
    for h in range(H):
        gids = topology.owned_gids(cfg, h, H, eng.placement)
        n_loc = gids.shape[0]
        gid_p = np.full((n_cap,), -1, dtype=np.int32)
        gid_p[:n_loc] = gids
        exc = np.zeros((n_cap,), dtype=bool)
        exc[:n_loc] = topology.is_excitatory(cfg, gids)
        nv = np.zeros((n_cap,), dtype=bool)
        nv[:n_loc] = True
        plans.append(dict(
            src_gid=src_gid[h].astype(np.int32),
            syn_src=np.zeros((1,), np.int32),
            syn_tgt=np.zeros((1,), np.int32),
            syn_delay=np.ones((1,), np.int32),
            syn_plastic=np.zeros((1,), bool),
            syn_valid=np.zeros((1,), bool),
            exc_mask=exc, neuron_valid=nv, gid=gid_p,
            columns=engine._owned_columns_padded(cfg, eng, h, col_cap),
            shard_id=np.int32(h)))
    plan = engine.plan_from_arrays(
        {k: np.stack([p[k] for p in plans]) for k in plans[0]}, device)
    cand_t = torch.from_numpy(cand).to(device)
    spec = SimSpec(cfg=cfg, eng=eng, izh=izh, stdp=stdp, n_local=n_cap,
                   e_cap=0, s_cap=s_cap, n_total=cfg.n_neurons,
                   stream=StreamSpec(chunk_cols=chunk_cols, q=q,
                                     n_chunks=n_chunks, c_cap=c_cap,
                                     k_cap=k_cap, e_pad=0, row_cap=0))
    if e_start is None:
        e_start, weight0, row_max = _count_on_card(spec, plan, cand_t)
    e_max = int(e_start[:, -1].max())
    # the reference's layout: its last chunk's [e0, e0 + k_cap) window fits
    e_pad = connectivity._round_up(max(e_max, 1), 8) + k_cap
    spec = spec._replace(e_cap=e_pad, stream=spec.stream._replace(
        e_pad=e_pad, row_cap=max(row_max, 1)))
    splan = StreamedPlan(cand=cand_t, e_start=torch.from_numpy(
        e_start.astype(np.int32)).to(device))
    state = init_state(spec, plan)
    for h, w in enumerate(weight0):
        state.w[h, :w.shape[0]] = w.to(device)
    return spec, plan, splan, state


def init_state(spec: SimSpec, plan: ShardPlan) -> ShardState:
    """Fresh streamed state: synapse-state arrays sized [H, e_pad]."""
    ss = spec.stream
    dev = plan.exc_mask.device
    c = lambda x: kref.f32(x, dev)
    v = torch.full(plan.exc_mask.shape, np.float32(spec.izh.v_init),
                   dtype=torch.float32, device=dev)
    b = torch.where(plan.exc_mask, c(spec.izh.b_exc), c(spec.izh.b_inh))
    H = plan.exc_mask.shape[0]
    return ShardState(
        v=v, u=b * v,
        last_post=torch.full(plan.exc_mask.shape, NEG_TIME,
                             dtype=torch.float32, device=dev),
        w=torch.zeros((H, ss.e_pad), dtype=torch.float32, device=dev),
        last_arr=torch.full((H, ss.e_pad), NEG_TIME, dtype=torch.float32,
                            device=dev),
        arr_ring=torch.zeros((H, spec.cfg.n_delay_slots, ss.e_pad),
                             dtype=torch.bool, device=dev))


def make_step_fn(spec: SimSpec, plan: ShardPlan, splan: StreamedPlan,
                 t0: int, n_steps: int, chunks: ChunkStream = None
                 ) -> StepFns:
    """Step callables for steps t0 .. t0 + n_steps - 1 (`engine.StepFns`),
    sharing one set of live chunk tables (`chunks`, made here when None)."""
    dev = plan.gid.device
    chunks = chunks or ChunkStream(spec, plan, splan)
    stim = engine.StimWindow(spec, plan, t0, n_steps)
    coeffs = (None if dev.type == "cuda"
              else kref.izh_coefficients(plan.exc_mask, spec.izh))
    exchange = engine.make_exchange(spec, plan)

    def pa(state, t):
        return phase_a(spec, plan, chunks, state, t, stim.row(t), coeffs)

    def pa_dyn(state, t):
        return phase_a_dynamics(spec, plan, chunks, state, t, stim.row(t),
                                coeffs)

    def pa_plast(state, spiked, t):
        return phase_a_plasticity(spec, plan, chunks, state, spiked, t)

    def pb(state, spiked_src, t):
        return phase_b(spec, plan, chunks, state, spiked_src, t)

    def step(state, t):
        state, spiked, tm = pa(state, t)
        state = pb(state, exchange(spiked), t)
        return state, spiked, tm

    return StepFns(phase_a=pa, exchange=exchange, phase_b=pb, step=step,
                   phase_a_dynamics=pa_dyn, phase_a_plasticity=pa_plast,
                   stim=stim)


def make_runner(spec: SimSpec, plan: ShardPlan, splan: StreamedPlan,
                state: ShardState, chunks: ChunkStream = None
                ) -> engine.CapturedRun:
    """The streamed run on the card (`engine.CapturedRun`): each step is,
    per chunk, `chunk_tables` and the phase-A row kernel, the exchange,
    then per chunk `chunk_tables` and the element walk of phase B, every
    kernel reading t from the step counter.  The runner's `chunks` holds
    the live tables (its `status` is read by `chunks.check()`)."""
    chunks = chunks or ChunkStream(spec, plan, splan)
    exchange = engine.make_exchange(spec, plan)

    def step(state, ctr, stim_index, stim_amp):
        state, spiked, tm = _phase_a(spec, plan, chunks, state, ctr,
                                     (stim_index, stim_amp), None, True)
        phase_b(spec, plan, chunks, state, exchange(spiked), ctr)
        return spiked, tm

    runner = engine.CapturedRun(step, state)
    runner.chunks = chunks
    return runner


def run(spec: SimSpec, plan: ShardPlan, splan: StreamedPlan,
        state: ShardState, t0: int, n_steps: int, *, graph: bool = True,
        runner: engine.CapturedRun = None):
    """Run steps t0 .. t0 + n_steps - 1 -> (state, raster [T, H, N],
    timings), as `engine.run`: on the card through `runner` (a captured
    CUDA graph a window of steps, or `graph=False` eagerly), on the CPU as
    a Python loop.  The input state is not modified."""
    dev = plan.gid.device
    if dev.type == "cuda":
        runner = runner or make_runner(spec, plan, splan, state)
        return runner.run(state, t0, n_steps,
                          *engine.stim_rows(spec, plan, t0, n_steps),
                          graph=graph)
    with engine._numerics(dev):
        fns = make_step_fn(spec, plan, splan, t0, n_steps)
        return engine.run_loop(fns.step, state, t0, n_steps)


# ----------------------------------------------------------------------------
# table-residency accounting (the reference's formulas, and the port's own)
# ----------------------------------------------------------------------------

# bytes per synapse-table slot: src/tgt/delay int32 + plastic/valid bool.
# Matches the materialized ShardPlan per-synapse leaves (syn_src, syn_tgt,
# syn_delay, syn_plastic, syn_valid) so the two modes compare honestly.
TABLE_BYTES_PER_SLOT = 4 + 4 + 4 + 1 + 1


def chunk_table_bytes(spec: SimSpec) -> int:
    """Peak LIVE regenerated-table bytes per shard (one chunk resident)."""
    return spec.stream.k_cap * TABLE_BYTES_PER_SLOT


def metadata_bytes(spec: SimSpec) -> int:
    """Persistent streamed metadata bytes per shard (cand + e_start)."""
    ss = spec.stream
    return ss.n_chunks * ss.c_cap * 4 + (ss.n_chunks + 1) * 4


def streamed_table_bytes(spec: SimSpec) -> int:
    """Peak live synapse-table bytes per shard in streamed mode."""
    return chunk_table_bytes(spec) + metadata_bytes(spec)


def materialized_table_bytes(e_cap: int) -> int:
    """Synapse-table bytes per shard when fully materialized."""
    return e_cap * TABLE_BYTES_PER_SLOT


#: The port's live chunk-table bytes per entry (src and delay int32,
#: plastic bool).
LIVE_BYTES_PER_ENTRY = 4 + 4 + 1


def live_table_bytes(spec: SimSpec, splan: StreamedPlan) -> int:
    """The port's actual peak live synapse-table bytes per shard: one
    chunk's tables sized by the largest kept count, its row pointers, the
    regeneration scratch (per target a bucket of row_cap keys and a
    counter: `kernels.stream`) and the persistent metadata."""
    ss = spec.stream
    k = live_width(splan)
    return (k * LIVE_BYTES_PER_ENTRY + (ss.q + 1) * 4
            + ss.q * (ss.row_cap + kstream.COUNT_STRIDE) * 4
            + metadata_bytes(spec))
