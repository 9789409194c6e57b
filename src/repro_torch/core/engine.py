"""DPSNN-STDP engine in PyTorch: per-shard plan/state, the two-phase
simulation step, and the single-process driver over stacked shards.

Port of `repro.core.engine` (dense delivery, materialized synapse tables).
Step structure (paper §Methods, "dynamic phase" 2.1-2.4):

  phase A (local compute):
    1. pop this step's slot of the arrival ring        (spikes reach synapses)
    2. synaptic currents I = sum of arrived weights    (current injection)
    3. LTD for arrived synapses (nearest post spike)   (STDP, event-driven)
    4. thalamic stimulus
    5. Izhikevich neuron update -> spikes              (time-driven dynamics)
    6. LTP for incoming synapses of spiking neurons    (STDP, event-driven)
  exchange:
    7. deliver axonal spikes (AER) to target shards    (two-phase delivery)
  phase B (local compute):
    8. expand arrived axons into synapses: set arrival flags at
       slot (t + delay) mod D                          (deferred arborization)

Where the JAX engine `vmap`s one shard's arrays, every array here carries
the leading [H] shard axis written out, and each kernel runs once per step
over all shards.  `lax.scan` is a Python loop over steps.  Pads are -1 in
`gid`, `src_gid` and `columns` and padded synapse slots have
`tgt_local = 0`: JAX's `mode="drop"`/`"fill"` hides those, a torch index
would wrap, so every pad is masked explicitly.  Index tables are int64
(what torch indexing takes).

`run` leaves the state it is given untouched: it copies it once and then
updates the copy in place each step.  On the card it is the counterpart
of the JAX package's `lax.scan` over a traced t: the kernels read t from
a device step counter, and a window of steps is captured once as a CUDA
graph and replayed (`CapturedRun`).  The phase functions of
`make_step_fn` update the state they are given: phase A its `v`, `u`,
`w`, `last_arr`, `last_post` and `arr_ring` (one kernel on the card,
`kernels.ops.stdp_phase_a`, gathering by target itself), phase B its
`arr_ring` (one kernel on the card, `kernels.ops.arborize`).  No phase
reads a device value on the host, so on the card a step never waits.
"""
from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from . import connectivity, stimulus, topology
from .params import (DEFAULT_IZH, DEFAULT_STDP, EngineConfig, GridConfig,
                     IzhikevichParams, StdpParams)
from ..kernels import _build as kbuild
from ..kernels import ops as kops
from ..kernels import ref as kref

NEG_TIME = -1.0e9   # "never" sentinel for last-spike times (exact in fp32)


class ShardPlan(NamedTuple):
    """Static per-shard data (tensors).  Leading dim [H] stacks shards."""

    src_gid: torch.Tensor      # [H, S] int64 global ids of sources (-1 pad)
    syn_src: torch.Tensor      # [H, E] int64 -> index into src table
    syn_tgt: torch.Tensor      # [H, E] int64 local target neuron
    syn_delay: torch.Tensor    # [H, E] int32 steps
    syn_plastic: torch.Tensor  # [H, E] bool
    syn_valid: torch.Tensor    # [H, E] bool
    exc_mask: torch.Tensor     # [H, N] bool
    neuron_valid: torch.Tensor  # [H, N] bool (capacity padding)
    gid: torch.Tensor          # [H, N] int64 global id of each neuron (-1)
    columns: torch.Tensor      # [H, C] int64 columns owned (padded -1)
    shard_id: torch.Tensor     # [H] int64
    row_ptr: torch.Tensor      # [H, N + 1] int32 CSR of valid synapses
    # the forward CSR (by source) of the valid synapses, for phase B's walk
    fwd_ptr: torch.Tensor      # [H, S + 1] int32 row pointers into fwd_ids
    fwd_ids: torch.Tensor      # [H, E] int32 synapse ids by source (-1 pad)
    fwd_delay: torch.Tensor    # [H, E] int32 syn_delay in fwd_ids' order


class ShardState(NamedTuple):
    """Dynamic per-shard state."""

    v: torch.Tensor            # [H, N] fp32
    u: torch.Tensor            # [H, N] fp32
    last_post: torch.Tensor    # [H, N] fp32 (time of most recent spike)
    w: torch.Tensor            # [H, E] fp32 synaptic weights
    last_arr: torch.Tensor     # [H, E] fp32 (time of most recent arrival)
    arr_ring: torch.Tensor     # [H, D, E] bool arrival flags


class SimSpec(NamedTuple):
    """Static python-side description shared by all shards."""

    cfg: GridConfig
    eng: EngineConfig
    izh: IzhikevichParams
    stdp: StdpParams
    n_local: int              # N capacity per shard
    e_cap: int
    s_cap: int
    n_total: int


class StepTimings(NamedTuple):
    """Per-phase work markers (paper Table 2 instrumentation hooks)."""
    spikes: torch.Tensor      # [H] local spike count this step
    arrivals: torch.Tensor    # [H] synaptic arrival count this step


# ----------------------------------------------------------------------------
# device
# ----------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """`None` -> CUDA; a CUDA device without a card raises (never carries
    on quietly on the CPU).  The CPU runs only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def _numerics(device: torch.device):
    """The CPU path runs with fp32 denormals flushed, as XLA-CPU does (the
    CUDA kernels are built with -ftz=true)."""
    if device.type == "cpu":
        with kref.flush_denormal():
            yield
    else:
        yield


# ----------------------------------------------------------------------------
# plan construction
# ----------------------------------------------------------------------------


def _owned_columns_padded(cfg, eng, shard, c_cap):
    gids = topology.owned_gids(cfg, shard, eng.n_shards, eng.placement)
    cols = np.unique(topology.gid_column(cfg, gids))
    out = np.full((c_cap,), -1, dtype=np.int32)
    out[:cols.shape[0]] = cols
    return out


def make_row_ptr(syn_tgt: np.ndarray, syn_valid: np.ndarray,
                 n_local: int) -> np.ndarray:
    """[H, N + 1] int32 CSR row pointers of each shard's valid synapses.

    Requires the canonical layout `build` makes: valid synapses first,
    sorted by local target; pads (tgt_local 0) after them, outside every
    row."""
    H, E = syn_tgt.shape
    out = np.zeros((H, n_local + 1), dtype=np.int32)
    for h in range(H):
        n_valid = int(syn_valid[h].sum())
        tgt = syn_tgt[h, :n_valid].astype(np.int64)
        if not syn_valid[h, :n_valid].all() or np.any(np.diff(tgt) < 0):
            raise ValueError("valid synapses must come first, sorted by "
                             "target")
        out[h, 1:] = np.cumsum(np.bincount(tgt, minlength=n_local))
    return out


def _stable_argsort(keys: np.ndarray) -> np.ndarray:
    """np.argsort(keys, kind="stable") for keys in [0, 2^32): two passes
    of numpy's radix sort over 16-bit digits (a few times faster than its
    merge sort over the 12.8 M synapses of an 8x8 grid)."""
    lo = np.argsort((keys & 0xFFFF).astype(np.uint16), kind="stable")
    hi = np.argsort((keys[lo] >> 16).astype(np.uint16), kind="stable")
    return lo[hi]


def make_fwd_csr(syn_src: np.ndarray, syn_valid: np.ndarray,
                 syn_delay: np.ndarray, n_src: int):
    """(fwd_ptr [H, S + 1], fwd_ids [H, E], fwd_delay [H, E]), all int32:
    each shard's valid synapses grouped by source, ascending within a
    source, then -1 (fwd_delay 0 there); fwd_delay is syn_delay in the
    same order, so a walk of a row reads its delays beside its ids.

    Checks that every valid synapse is listed exactly once, in the row of
    its syn_src (what phase B's kernel relies on)."""
    H, E = syn_src.shape
    ptr = np.zeros((H, n_src + 1), dtype=np.int32)
    ids = np.full((H, E), -1, dtype=np.int32)
    delay = np.zeros((H, E), dtype=np.int32)
    for h in range(H):
        e = np.flatnonzero(syn_valid[h])
        src = syn_src[h, e].astype(np.int64)
        if src.size and (src.min() < 0 or src.max() >= n_src):
            raise ValueError("a valid synapse's source lies outside the "
                             "source table")
        counts = np.bincount(src, minlength=n_src)
        ptr[h, 1:] = np.cumsum(counts)
        listed = e[_stable_argsort(src)]
        ids[h, :e.size] = listed
        delay[h, :e.size] = syn_delay[h, listed]
        once = np.bincount(listed, minlength=E)
        rows = np.repeat(np.arange(n_src), counts)
        ascending = np.diff(listed)[np.diff(rows) == 0]
        if (not np.array_equal(once > 0, syn_valid[h]) or once.max(
                initial=0) > 1 or not np.array_equal(
                syn_src[h, listed], rows) or np.any(ascending <= 0)):
            raise ValueError("the forward CSR must list every valid synapse "
                             "once, ascending, in the row of its source")
    return ptr, ids, delay


def plan_from_arrays(arrays: dict, device) -> ShardPlan:
    """ShardPlan tensors on `device` from the stacked numpy arrays of the
    JAX package's ShardPlan fields (the CSRs `row_ptr` and `fwd_*` are
    derived)."""
    a = {k: np.asarray(v) for k, v in arrays.items()}
    n_local = a["exc_mask"].shape[1]
    idx = lambda k: torch.from_numpy(a[k].astype(np.int64)).to(device)
    as_t = lambda k, dt: torch.from_numpy(a[k].astype(dt)).to(device)
    fwd = make_fwd_csr(a["syn_src"], a["syn_valid"].astype(bool),
                       a["syn_delay"], a["src_gid"].shape[1])
    return ShardPlan(
        src_gid=idx("src_gid"), syn_src=idx("syn_src"),
        syn_tgt=idx("syn_tgt"), syn_delay=as_t("syn_delay", np.int32),
        syn_plastic=as_t("syn_plastic", bool),
        syn_valid=as_t("syn_valid", bool), exc_mask=as_t("exc_mask", bool),
        neuron_valid=as_t("neuron_valid", bool), gid=idx("gid"),
        columns=idx("columns"),
        shard_id=torch.from_numpy(
            np.asarray(a["shard_id"]).reshape(-1).astype(np.int64)).to(device),
        row_ptr=torch.from_numpy(make_row_ptr(
            a["syn_tgt"], a["syn_valid"], n_local)).to(device),
        **{k: torch.from_numpy(x).to(device) for k, x in zip(
            ("fwd_ptr", "fwd_ids", "fwd_delay"), fwd)})


def build(cfg: GridConfig, eng: EngineConfig,
          izh: IzhikevichParams = DEFAULT_IZH,
          stdp: StdpParams = DEFAULT_STDP, *, device,
          tables=None) -> Tuple[SimSpec, ShardPlan, ShardState]:
    """Build plans + initial state for all shards, stacked on a leading [H]
    axis, on `device`.  Construction is fully local per shard (zero
    communication) and runs on the host in numpy, as in the JAX package;
    the finished tables are uploaded once."""
    if tables is None:
        tables = connectivity.build_all_shards(cfg, eng)
    H = eng.n_shards
    n_cap = topology.max_local_size(cfg, H, eng.placement)
    e_cap = tables[0].src_idx.shape[0]
    s_cap = tables[0].src_gid.shape[0]
    c_cap = max(
        np.unique(topology.gid_column(
            cfg, topology.owned_gids(cfg, h, H, eng.placement))).shape[0]
        for h in range(H))

    plans = []
    for h, t in enumerate(tables):
        gids = topology.owned_gids(cfg, h, H, eng.placement)
        n_loc = gids.shape[0]
        gid_p = np.full((n_cap,), -1, dtype=np.int32)
        gid_p[:n_loc] = gids
        exc = np.zeros((n_cap,), dtype=bool)
        exc[:n_loc] = topology.is_excitatory(cfg, gids)
        nv = np.zeros((n_cap,), dtype=bool)
        nv[:n_loc] = True
        plans.append(dict(
            src_gid=t.src_gid.astype(np.int32),
            syn_src=t.src_idx, syn_tgt=t.tgt_local,
            syn_delay=t.delay, syn_plastic=t.plastic, syn_valid=t.valid,
            exc_mask=exc, neuron_valid=nv, gid=gid_p,
            columns=_owned_columns_padded(cfg, eng, h, c_cap),
            shard_id=np.int32(h)))

    stacked = plan_from_arrays(
        {k: np.stack([p[k] for p in plans]) for k in plans[0]}, device)
    spec = SimSpec(cfg=cfg, eng=eng, izh=izh, stdp=stdp, n_local=n_cap,
                   e_cap=e_cap, s_cap=s_cap, n_total=cfg.n_neurons)
    w0 = torch.from_numpy(np.stack([t.weight0 for t in tables])).to(device)
    state = init_state(spec, stacked)._replace(w=w0)
    return spec, stacked, state


def init_state(spec: SimSpec, plan: ShardPlan) -> ShardState:
    """Fresh dynamic state (zero weights; `build` installs w0) [H, ...]."""
    dev = plan.exc_mask.device
    c = lambda x: kref.f32(x, dev)
    v = torch.full(plan.exc_mask.shape, np.float32(spec.izh.v_init),
                   dtype=torch.float32, device=dev)
    b = torch.where(plan.exc_mask, c(spec.izh.b_exc), c(spec.izh.b_inh))
    H, E = plan.syn_valid.shape
    return ShardState(
        v=v, u=b * v,
        last_post=torch.full(plan.exc_mask.shape, NEG_TIME,
                             dtype=torch.float32, device=dev),
        w=torch.zeros((H, E), dtype=torch.float32, device=dev),
        last_arr=torch.full((H, E), NEG_TIME, dtype=torch.float32,
                            device=dev),
        arr_ring=torch.zeros((H, spec.cfg.n_delay_slots, E), dtype=torch.bool,
                             device=dev))


def map_state(fn: Callable, state):
    """The state (a NamedTuple of tensors, possibly nested) with fn applied
    to each tensor."""
    return type(state)(*(map_state(fn, x) if isinstance(x, tuple) else fn(x)
                         for x in state))


def state_tensors(state) -> list:
    """The state's tensors, depth first in field order."""
    out = []
    for x in state:
        out.extend(state_tensors(x) if isinstance(x, tuple) else [x])
    return out


def clone_state(state):
    """A copy of a state (a ShardState, or any NamedTuple of them and of
    tensors, such as the event backend's EventState)."""
    return map_state(torch.clone, state)


# ----------------------------------------------------------------------------
# ownership maps (gid -> local index), placement-specific
# ----------------------------------------------------------------------------


def make_gid_to_local(spec: SimSpec, shard_id: torch.Tensor) -> Callable:
    """Returns gid_to_local(gids) -> (local_idx, owned_mask) for the
    stacked shards: gids [..., H, K], shard_id [H]."""
    eng, cfg = spec.eng, spec.cfg
    sid = shard_id.reshape(-1, 1)
    if eng.placement == "block":
        bounds = torch.from_numpy(
            topology.shard_bounds_block(cfg.n_neurons, eng.n_shards)
        ).to(shard_id.device)
        starts, ends = bounds[:-1][sid], bounds[1:][sid]    # [H, 1]

        def f(gids):
            owned = (gids >= starts) & (gids < ends)
            return gids - starts, owned
        return f
    elif eng.placement == "scatter":
        H = eng.n_shards

        def f(gids):
            owned = (torch.remainder(gids, H) == sid)
            owned &= (gids >= 0) & (gids < cfg.n_neurons)
            return torch.div(gids, H, rounding_mode="floor"), owned
        return f
    raise ValueError(eng.placement)


# ----------------------------------------------------------------------------
# the step, phase A / phase B
# ----------------------------------------------------------------------------


def _phase_a(spec: SimSpec, plan: ShardPlan, state: ShardState, t: int,
             stim, seg: kref.Segments, coeffs, with_ltp: bool
             ) -> Tuple[ShardState, torch.Tensor, StepTimings]:
    """Phase A steps 1-5, and 6 `with_ltp`, as one op (one launch on the
    card): pop slot t mod D (the arrived pre-LTD weights of each target
    summed in canonical (tgt, src, j) order => reproducible current), LTD
    against the nearest post spike, last-arrival refresh, stimulus,
    Izhikevich update, and LTP of the targets that spiked."""
    spiked, n_arrived, n_spikes = kops.stdp_phase_a(
        state.arr_ring, t % spec.cfg.n_delay_slots, seg, plan.syn_valid,
        plan.syn_tgt, plan.syn_plastic, plan.exc_mask, plan.neuron_valid,
        *stim, state.v, state.u, state.last_post, state.w, state.last_arr, t,
        izh=spec.izh, stdp=spec.stdp, neg_time=NEG_TIME, with_ltp=with_ltp,
        coeffs=coeffs)
    return state, spiked, StepTimings(spikes=n_spikes, arrivals=n_arrived)


def phase_a_dynamics(spec: SimSpec, plan: ShardPlan, state: ShardState,
                     t: int, stim, seg: kref.Segments, coeffs=None
                     ) -> Tuple[ShardState, torch.Tensor, StepTimings]:
    """Phase A steps 1-5: arrivals -> currents -> LTD -> stimulus -> neuron.

    `stim` is this step's (index, amp) row of `stimulus.stim_inputs`, `seg`
    the plan's `kref.make_segments(plan.row_ptr, E)`, `coeffs` the plain
    version's a, b, c, d (`kref.izh_coefficients`, built once by the
    caller; None builds them here on the CPU, and the card never needs
    them).  Returns (state, spiked [H, N], timings).  Updates `state.v`,
    `state.u`, `state.w`, `state.last_arr` and `state.arr_ring` (slot t
    mod D cleared) in place; `last_post` is untouched (plasticity owns
    it)."""
    return _phase_a(spec, plan, state, t, stim, seg, coeffs, with_ltp=False)


def neuron_update(spec: SimSpec, plan: ShardPlan, state: ShardState,
                  i_syn: torch.Tensor, stim
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase A steps 4-5 alone, as separate ops: thalamic stimulus +
    Izhikevich update on a summed current i_syn (for a step that sums
    the current in pieces, as streamed connectivity does).  Returns (v, u, spiked); the state is not
    modified."""
    izh = spec.izh
    i_tot = i_syn + kref.stim_current(*stim, spec.n_local)
    a, b, c, d = kref.izh_coefficients(plan.exc_mask, izh)
    v, u, spiked = kops.izhikevich_update(
        state.v, state.u, i_tot, a, b, c, d, v_peak=izh.v_peak, dt=izh.dt,
        substeps=izh.v_substeps)
    return v, u, spiked & plan.neuron_valid


def phase_a_plasticity(spec: SimSpec, plan: ShardPlan, state: ShardState,
                       spiked: torch.Tensor, t: int) -> ShardState:
    """Phase A step 6: LTP for incoming synapses of spiking neurons.

    dW = +a_plus * exp((last_arrival - t) / tau_plus), dt >= 0.  Updates
    `state.w` and `state.last_post` (t where spiked) in place and returns
    `state`."""
    stdp = spec.stdp
    kops.stdp_ltp(spiked, plan.row_ptr, plan.syn_plastic, state.last_arr,
                  state.w, state.last_post, t, a_plus=stdp.a_plus,
                  tau_plus=stdp.tau_plus, w_min=stdp.w_min, w_max=stdp.w_max,
                  neg_time=NEG_TIME)
    return state


def phase_a(spec: SimSpec, plan: ShardPlan, state: ShardState, t: int,
            stim, seg: kref.Segments, coeffs=None
            ) -> Tuple[ShardState, torch.Tensor, StepTimings]:
    """Local dynamics: arrivals -> currents -> LTD -> neuron -> LTP, the
    same bits as `phase_a_dynamics` then `phase_a_plasticity` in one op.
    Arguments as `phase_a_dynamics`'.  Returns (state, spiked [H, N] bool,
    timings).  Updates the state's v, u, w, last_arr, last_post and
    arr_ring in place."""
    return _phase_a(spec, plan, state, t, stim, seg, coeffs, with_ltp=True)


def phase_b(spec: SimSpec, plan: ShardPlan, state: ShardState,
            spiked_src: torch.Tensor, t: int) -> ShardState:
    """Deferred axonal arborization: set arrival flags at slot
    (t + delay) mod D, in place, for the valid synapses whose source
    spiked (`kernels.ops.arborize`: one launch on the card, which walks
    the plan's forward CSR rows of the sources that spiked and reads
    nothing back).  An all-False `spiked_src` sets nothing."""
    kops.arborize(state.arr_ring, spiked_src, *arborize_tables(plan), t)
    return state


def arborize_tables(plan: ShardPlan) -> tuple:
    """Phase B's tables, as `kernels.ops.arborize` takes them: the plain
    version's (syn_src, syn_delay, syn_valid) and the kernel's forward
    CSR (fwd_ptr, fwd_ids, fwd_delay)."""
    return (plan.syn_src, plan.syn_delay, plan.syn_valid, plan.fwd_ptr,
            plan.fwd_ids, plan.fwd_delay)


# ----------------------------------------------------------------------------
# single-process driver: stacked shards, exchange via global mask
# ----------------------------------------------------------------------------


def _global_spike_mask(spiked: torch.Tensor, gid_pos: torch.Tensor
                       ) -> torch.Tensor:
    """[N_total] bool from stacked per-shard spike masks.  gid_pos[g] is the
    flat [H * N] position of the neuron with gid g (every gid is owned by
    exactly one shard, so this gather is the reference's scatter-max)."""
    return spiked.reshape(-1)[gid_pos]


class StimWindow:
    """The stimulus (index, amp) rows of a window of steps [t0, t0 + n),
    drawn on the host and uploaded in one copy.  `row(t)` of a step
    outside the window draws the window of n steps that t falls in (the
    windows tile time from the first t0), so a caller that steps through
    time pays one upload per window; `draw(t0, n)` sets the window
    explicitly (a timed loop draws its whole range before it starts)."""

    def __init__(self, spec: SimSpec, plan: ShardPlan, t0: int, n: int):
        self.spec, self.plan = spec, plan
        self.columns = plan.columns.cpu().numpy()
        self.g2l = make_gid_to_local(spec, plan.shard_id)
        self.origin = t0
        self.draw(t0, n)

    def draw(self, t0: int, n: int) -> None:
        gids = torch.from_numpy(stimulus.stim_table(
            self.spec.cfg, self.columns, t0, n)).to(self.plan.gid.device)
        self.index, self.amp = stimulus.stim_inputs(
            self.spec.cfg, self.plan.columns, self.g2l,
            gids.to(torch.int64), self.spec.n_local)
        self.t0, self.n = t0, n

    def row(self, t: int):
        if not self.t0 <= t < self.t0 + self.n:
            self.draw(self.origin + (t - self.origin) // self.n * self.n,
                      self.n)
        i = t - self.t0
        return self.index[i], self.amp[i]


class StepFns(NamedTuple):
    """The phases of one run window [t0, t0 + n_steps), as callables:
    phase_a(state, t) -> (state, spiked, tm), exchange(spiked) ->
    spiked_src, phase_b(state, spiked_src, t) -> state, step(state, t),
    and phase A's halves phase_a_dynamics(state, t) -> (state, spiked,
    tm) and phase_a_plasticity(state, spiked, t) -> state.  `stim` holds
    the window's stimulus; a phase A outside it draws the window its t
    falls in."""
    phase_a: Callable
    exchange: Callable
    phase_b: Callable
    step: Callable
    phase_a_dynamics: Callable
    phase_a_plasticity: Callable
    stim: StimWindow


def make_exchange(spec: SimSpec, plan: ShardPlan) -> Callable:
    """The run's exchange, spiked [H, N] -> spiked_src [H, S]: the global
    spike mask gathered by each shard's source table (its tables derived
    from the plan once; three device operations a call)."""
    dev = plan.gid.device
    flat_gid = plan.gid.reshape(-1)
    owned = torch.nonzero(flat_gid >= 0).reshape(-1)
    gid_pos = torch.zeros(spec.n_total, dtype=torch.int64, device=dev)
    gid_pos[flat_gid[owned]] = owned
    src_ok = plan.src_gid >= 0
    src_safe = torch.where(src_ok, plan.src_gid, 0)

    def exchange(spiked):
        glob = _global_spike_mask(spiked, gid_pos)
        return glob[src_safe] & src_ok
    return exchange


def make_step_fn(spec: SimSpec, plan: ShardPlan, t0: int,
                 n_steps: int) -> StepFns:
    """Step callables for steps t0 .. t0 + n_steps - 1.

    The stimulus of the whole window is drawn on the host and uploaded in
    one copy; the exchange tables, and on the CPU the neurons' a, b, c
    and d, are derived from the plan once."""
    dev = plan.gid.device
    stim = StimWindow(spec, plan, t0, n_steps)
    seg = kref.make_segments(plan.row_ptr, plan.syn_valid.shape[1],
                             with_index=dev.type != "cuda")
    # the plain version's per-neuron constants, once per window (the
    # kernel takes them as launch arguments)
    coeffs = (None if dev.type == "cuda"
              else kref.izh_coefficients(plan.exc_mask, spec.izh))
    exchange = make_exchange(spec, plan)

    def pa(state, t):
        return phase_a(spec, plan, state, t, stim.row(t), seg, coeffs)

    def pa_dyn(state, t):
        return phase_a_dynamics(spec, plan, state, t, stim.row(t), seg,
                                coeffs)

    def pa_plast(state, spiked, t):
        return phase_a_plasticity(spec, plan, state, spiked, t)

    def pb(state, spiked_src, t):
        return phase_b(spec, plan, state, spiked_src, t)

    def step(state, t):
        state, spiked, tm = pa(state, t)
        state = pb(state, exchange(spiked), t)
        return state, spiked, tm

    return StepFns(phase_a=pa, exchange=exchange, phase_b=pb, step=step,
                   phase_a_dynamics=pa_dyn, phase_a_plasticity=pa_plast,
                   stim=stim)


def run_loop(step: Callable, state, t0: int, n_steps: int):
    """The CPU's run: step(state, t) -> (state, spiked, tm) for t = t0 ..
    t0 + n_steps - 1 with Python ints, on a copy of `state` -> (state,
    raster [T, H, N], timings [T, H])."""
    state = clone_state(state)
    v = state_tensors(state)[0]                  # [H, N]
    raster = torch.empty((n_steps,) + v.shape, dtype=torch.bool,
                         device=v.device)
    spikes = torch.empty((n_steps, v.shape[0]), dtype=torch.int64,
                         device=v.device)
    arrivals = torch.empty_like(spikes)
    for i in range(n_steps):
        state, spiked, tm = step(state, t0 + i)
        raster[i] = spiked
        spikes[i] = tm.spikes
        arrivals[i] = tm.arrivals
    return state, raster, StepTimings(spikes=spikes, arrivals=arrivals)


#: Steps of one captured CUDA graph (`CapturedRun`).
RUN_WINDOW = 50


class CapturedRun:
    """`run` on the card: the counterpart of the JAX package's `lax.scan`
    over a traced t.

    The run's state lives in static buffers, copied in before and out
    after.  The step t, and the row of the stimulus window, come from a
    device step counter `ctr` (int64 [2]) that each step advances; the
    kernels read it (`kernels._build.step_counter`), and the step's
    stimulus, spikes and counters are read and written at its row of
    static window buffers, so a step has no launch argument that changes
    with t.  Everything runs on the runner's own stream, and every kernel's
    integer scratch is the runner's own (`kernels._build.Scratch`), kept
    as long as its graph.  The first full window of RUN_WINDOW steps runs
    eagerly (the scratch and every buffer the steps use are made there),
    and then the same steps are captured as one CUDA graph; every later
    full window replays it, and a remainder shorter than a window runs the
    same steps eagerly.  `graph=False` runs every step eagerly, through
    the same operations.  A failed capture raises: nothing falls back.
    The kernels' launch counts (`kernels.ops.launch_counts`) hold the
    eager steps' launches only: the capture launches nothing, and a
    replay passes through no wrapper; `replayed_launches` says what the
    last run's replays launched, from what the capture recorded.

    `step(state, ctr, stim_index, stim_amp) -> (spiked [H, N], timings)`
    updates the static state in place; stim_index / stim_amp are the
    window buffers [RUN_WINDOW, H, K], made by the first run."""

    def __init__(self, step: Callable, state):
        self.step = step
        v = state_tensors(state)[0]                  # [H, N]
        H = v.shape[0]
        self.device = v.device
        self.stream = torch.cuda.Stream(self.device)
        self.state = map_state(torch.empty_like, state)
        self.ctr = torch.zeros(2, dtype=torch.int64, device=self.device)
        self.stim_index = self.stim_amp = None
        self.raster = torch.zeros((RUN_WINDOW,) + v.shape, dtype=torch.bool,
                                  device=self.device)
        self.spikes = torch.zeros((RUN_WINDOW, H), dtype=torch.int64,
                                  device=self.device)
        self.arrivals = torch.zeros_like(self.spikes)
        self.scratch = kbuild.Scratch(self.device)
        self.graph = None
        self.recorded = {}      # kernel -> launches a window's graph holds
        self.replays = 0        # of the last run

    def _one_step(self) -> None:
        spiked, tm = self.step(self.state, self.ctr, self.stim_index,
                               self.stim_amp)
        row = self.ctr[1:]
        self.raster.index_copy_(0, row, spiked[None])
        self.spikes.index_copy_(0, row, tm.spikes[None])
        self.arrivals.index_copy_(0, row, tm.arrivals[None])
        self.ctr.add_(1)

    def _set_window(self, stim_index, stim_amp, t: int, m: int) -> None:
        self.stim_index[:m].copy_(stim_index)
        self.stim_amp[:m].copy_(stim_amp)
        self.ctr[0].fill_(t)
        self.ctr[1].fill_(0)

    def _capture(self) -> None:
        before = dict(kbuild.recorded)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self.stream):
            for _ in range(RUN_WINDOW):
                self._one_step()
        self.recorded = {k: n - before.get(k, 0)
                         for k, n in kbuild.recorded.items()
                         if n != before.get(k, 0)}
        self.graph = graph

    def replayed_launches(self) -> dict:
        """Launches of each kernel by the last run's replays: the replays
        times what the capture recorded."""
        return {k: self.replays * n for k, n in self.recorded.items()}

    def run(self, state, t0: int, n_steps: int, stim_index, stim_amp, *,
            graph: bool = True):
        """Steps t0 .. t0 + n_steps - 1 from `state` (not modified), with
        the run's stimulus rows stim_index / stim_amp [n_steps, H, K] on
        the card -> (state, raster [T, H, N], timings [T, H]).  Nothing is
        read back; only the capture waits for the card."""
        W = RUN_WINDOW
        H, N = self.raster.shape[1:]
        if self.stim_index is None:
            self.stim_index = stim_index.new_zeros((W,) + stim_index.shape[1:])
            self.stim_amp = stim_amp.new_zeros((W,) + stim_amp.shape[1:])
        cur = torch.cuda.current_stream(self.device)
        raster = torch.empty((n_steps, H, N), dtype=torch.bool,
                             device=self.device)
        spikes = torch.empty((n_steps, H), dtype=torch.int64,
                             device=self.device)
        arrivals = torch.empty_like(spikes)
        static = state_tensors(self.state)
        self.replays = 0
        self.stream.wait_stream(cur)
        with (torch.cuda.stream(self.stream),
              kbuild.own_scratch(self.scratch)):
            for dst, src in zip(static, state_tensors(state)):
                dst.copy_(src)
            for w0 in range(0, n_steps, W):
                m = min(W, n_steps - w0)
                self._set_window(stim_index[w0:w0 + m],
                                 stim_amp[w0:w0 + m], t0 + w0, m)
                if graph and m == W and self.graph is not None:
                    self.graph.replay()
                    self.replays += 1
                else:
                    for _ in range(m):
                        self._one_step()
                    if graph and m == W:
                        self._capture()     # the stream is warm now
                raster[w0:w0 + m].copy_(self.raster[:m])
                spikes[w0:w0 + m].copy_(self.spikes[:m])
                arrivals[w0:w0 + m].copy_(self.arrivals[:m])
        cur.wait_stream(self.stream)
        out = clone_state(self.state)
        return out, raster, StepTimings(spikes=spikes, arrivals=arrivals)


def stim_rows(spec: SimSpec, plan: ShardPlan, t0: int, n_steps: int):
    """The stimulus (index, amp) rows [n_steps, H, C*K] of steps t0 ..
    t0 + n_steps - 1 on the plan's device."""
    w = StimWindow(spec, plan, t0, n_steps)
    return w.index, w.amp


def make_runner(spec: SimSpec, plan: ShardPlan,
                state: ShardState) -> CapturedRun:
    """The dense run on the card (`CapturedRun`): each step is the phase-A
    kernel and phase B's, both reading the step counter, with the run's
    exchange between them."""
    seg = kref.make_segments(plan.row_ptr, plan.syn_valid.shape[1],
                             with_index=False)
    exchange = make_exchange(spec, plan)

    def step(state, ctr, stim_index, stim_amp):
        spiked, n_arrived, n_spikes = kops.stdp_phase_a(
            state.arr_ring, None, seg, plan.syn_valid, plan.syn_tgt,
            plan.syn_plastic, plan.exc_mask, plan.neuron_valid, stim_index,
            stim_amp, state.v, state.u, state.last_post, state.w,
            state.last_arr, ctr, izh=spec.izh, stdp=spec.stdp,
            neg_time=NEG_TIME, with_ltp=True)
        kops.arborize(state.arr_ring, exchange(spiked),
                      *arborize_tables(plan), ctr)
        return spiked, StepTimings(spikes=n_spikes, arrivals=n_arrived)

    return CapturedRun(step, state)


def run(spec: SimSpec, plan: ShardPlan, state: ShardState, t0: int,
        n_steps: int, *, graph: bool = True, runner: CapturedRun = None):
    """Run steps t0 .. t0 + n_steps - 1; returns (state, raster [T, H, N]
    bool, timings with [T, H] counters), all on the plan's device.  The
    input state is not modified.

    On the card the steps run through `runner` (made here when None): one
    captured CUDA graph a window of steps, or with `graph=False` the same
    steps eagerly.  The CPU runs the steps as a Python loop."""
    dev = plan.gid.device
    if dev.type == "cuda":
        runner = runner or make_runner(spec, plan, state)
        return runner.run(state, t0, n_steps,
                          *stim_rows(spec, plan, t0, n_steps), graph=graph)
    with _numerics(dev):
        fns = make_step_fn(spec, plan, t0, n_steps)
        return run_loop(fns.step, state, t0, n_steps)
