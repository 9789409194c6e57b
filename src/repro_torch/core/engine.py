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
updates the copy in place each step.  The phase functions of
`make_step_fn` update the state they are given: phase A its `w`,
`last_arr`, `last_post` and `arr_ring` (the STDP kernels write them in
place, gathering by target themselves), phase B its `arr_ring`.
"""
from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from . import connectivity, stimulus, topology
from .params import (DEFAULT_IZH, DEFAULT_STDP, EngineConfig, GridConfig,
                     IzhikevichParams, StdpParams)
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


def plan_from_arrays(arrays: dict, device) -> ShardPlan:
    """ShardPlan tensors on `device` from the stacked numpy arrays of the
    JAX package's ShardPlan fields (the CSR `row_ptr` is derived)."""
    a = {k: np.asarray(v) for k, v in arrays.items()}
    n_local = a["exc_mask"].shape[1]
    idx = lambda k: torch.from_numpy(a[k].astype(np.int64)).to(device)
    as_t = lambda k, dt: torch.from_numpy(a[k].astype(dt)).to(device)
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
            a["syn_tgt"], a["syn_valid"], n_local)).to(device))


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


def clone_state(state: ShardState) -> ShardState:
    return ShardState(*(x.clone() for x in state))


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


def phase_a_dynamics(spec: SimSpec, plan: ShardPlan, state: ShardState,
                     t: int, stim, seg: kref.Segments
                     ) -> Tuple[ShardState, torch.Tensor, StepTimings]:
    """Phase A steps 1-5: arrivals -> currents -> LTD -> stimulus -> neuron.

    `stim` is this step's (index, amp) row of `stimulus.stim_inputs`, `seg`
    the plan's `kref.make_segments(plan.row_ptr, E)`.
    Returns (state', spiked [H, N], timings).  Updates `state.w`,
    `state.last_arr` and `state.arr_ring` (slot t mod D cleared) in place,
    so state' shares them; `last_post` is untouched (plasticity owns it)."""
    cfg, stdp = spec.cfg, spec.stdp
    r = t % cfg.n_delay_slots

    # 1-3. fused arrival pass: pop slot r, the current of each target (its
    # arrived pre-LTD weights summed in canonical (tgt, src, j) order =>
    # reproducible sum), LTD against the nearest post spike, last_arrival
    # refresh.
    i_syn, n_arrived = kops.stdp_arrival_current(
        state.arr_ring, r, seg, plan.syn_valid, plan.syn_tgt,
        plan.syn_plastic, state.last_post, state.w, state.last_arr, t,
        a_minus=stdp.a_minus, tau_minus=stdp.tau_minus, w_min=stdp.w_min,
        w_max=stdp.w_max, neg_time=NEG_TIME)

    # 4+5. stimulus + Izhikevich
    v, u, spiked = neuron_update(spec, plan, state, i_syn, stim)

    tm = StepTimings(spikes=spiked.sum(1), arrivals=n_arrived)
    return state._replace(v=v, u=u), spiked, tm


def neuron_update(spec: SimSpec, plan: ShardPlan, state: ShardState,
                  i_syn: torch.Tensor, stim
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase A steps 4-5: thalamic stimulus + Izhikevich update.
    Returns (v, u, spiked)."""
    izh = spec.izh
    dev = i_syn.device
    c = lambda x: kref.f32(x, dev)
    i_ext = stimulus.stim_current(*stim, spec.n_local)
    i_tot = i_syn + i_ext
    ex = plan.exc_mask
    a = torch.where(ex, c(izh.a_exc), c(izh.a_inh))
    b = torch.where(ex, c(izh.b_exc), c(izh.b_inh))
    cc = torch.where(ex, c(izh.c_exc), c(izh.c_inh))
    d = torch.where(ex, c(izh.d_exc), c(izh.d_inh))
    v, u, spiked = kops.izhikevich_update(
        state.v, state.u, i_tot, a, b, cc, d, v_peak=izh.v_peak, dt=izh.dt,
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
            stim, seg: kref.Segments
            ) -> Tuple[ShardState, torch.Tensor, StepTimings]:
    """Local dynamics: arrivals -> currents -> LTD -> neuron -> LTP.
    Returns (state', spiked [H, N] bool, timings).  Updates the state's
    w, last_arr, last_post and arr_ring in place (v and u are new)."""
    state, spiked, tm = phase_a_dynamics(spec, plan, state, t, stim, seg)
    state = phase_a_plasticity(spec, plan, state, spiked, t)
    return state, spiked, tm


def phase_b(spec: SimSpec, plan: ShardPlan, state: ShardState,
            spiked_src: torch.Tensor, t: int) -> ShardState:
    """Deferred axonal arborization: set arrival flags at slot
    (t + delay) mod D, in place, for the synapses whose source spiked.
    Each such synapse sets one flag of its own, so no two writes meet."""
    D = spec.cfg.n_delay_slots
    active = torch.gather(spiked_src, 1, plan.syn_src) & plan.syn_valid
    h, e = torch.nonzero(active, as_tuple=True)
    slot = torch.remainder(plan.syn_delay[h, e] + t, D).to(torch.int64)
    state.arr_ring[h, slot, e] = True
    return state


# ----------------------------------------------------------------------------
# single-process driver: stacked shards, exchange via global mask
# ----------------------------------------------------------------------------


def _global_spike_mask(spiked: torch.Tensor, gid_pos: torch.Tensor
                       ) -> torch.Tensor:
    """[N_total] bool from stacked per-shard spike masks.  gid_pos[g] is the
    flat [H * N] position of the neuron with gid g (every gid is owned by
    exactly one shard, so this gather is the reference's scatter-max)."""
    return spiked.reshape(-1)[gid_pos]


class StepFns(NamedTuple):
    """The phases of one run window [t0, t0 + n_steps), as callables:
    phase_a(state, t) -> (state, spiked, tm), exchange(spiked) ->
    spiked_src, phase_b(state, spiked_src, t) -> state, step(state, t)."""
    phase_a: Callable
    exchange: Callable
    phase_b: Callable
    step: Callable


def make_step_fn(spec: SimSpec, plan: ShardPlan, t0: int,
                 n_steps: int) -> StepFns:
    """Step callables for steps t0 .. t0 + n_steps - 1.

    The stimulus of the whole window is drawn on the host and uploaded in
    one copy; the exchange tables are derived from the plan once."""
    dev = plan.gid.device
    gids = torch.from_numpy(stimulus.stim_table(
        spec.cfg, plan.columns.cpu().numpy(), t0, n_steps)).to(dev)
    g2l = make_gid_to_local(spec, plan.shard_id)
    stim_idx, stim_amp = stimulus.stim_inputs(spec.cfg, plan.columns, g2l,
                                              gids.to(torch.int64),
                                              spec.n_local)
    seg = kref.make_segments(plan.row_ptr, plan.syn_valid.shape[1],
                             with_index=dev.type != "cuda")

    flat_gid = plan.gid.reshape(-1)
    owned = torch.nonzero(flat_gid >= 0).reshape(-1)
    gid_pos = torch.zeros(spec.n_total, dtype=torch.int64, device=dev)
    gid_pos[flat_gid[owned]] = owned
    src_ok = plan.src_gid >= 0
    src_safe = torch.where(src_ok, plan.src_gid, 0)

    def pa(state, t):
        i = t - t0
        return phase_a(spec, plan, state, t, (stim_idx[i], stim_amp[i]),
                       seg)

    def exchange(spiked):
        glob = _global_spike_mask(spiked, gid_pos)
        return glob[src_safe] & src_ok

    def pb(state, spiked_src, t):
        return phase_b(spec, plan, state, spiked_src, t)

    def step(state, t):
        state, spiked, tm = pa(state, t)
        state = pb(state, exchange(spiked), t)
        return state, spiked, tm

    return StepFns(phase_a=pa, exchange=exchange, phase_b=pb, step=step)


def run(spec: SimSpec, plan: ShardPlan, state: ShardState, t0: int,
        n_steps: int):
    """Run steps t0 .. t0 + n_steps - 1; returns (state, raster [T, H, N]
    bool, timings with [T, H] counters), all on the plan's device.  The
    input state is not modified."""
    dev = plan.gid.device
    H, N = plan.gid.shape
    with _numerics(dev):
        fns = make_step_fn(spec, plan, t0, n_steps)
        state = clone_state(state)
        raster = torch.empty((n_steps, H, N), dtype=torch.bool, device=dev)
        spikes = torch.empty((n_steps, H), dtype=torch.int64, device=dev)
        arrivals = torch.empty((n_steps, H), dtype=torch.int64, device=dev)
        for i in range(n_steps):
            state, spiked, tm = fns.step(state, t0 + i)
            raster[i] = spiked
            spikes[i] = tm.spikes
            arrivals[i] = tm.arrivals
    return state, raster, StepTimings(spikes=spikes, arrivals=arrivals)
