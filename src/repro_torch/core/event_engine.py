"""Event-driven delivery backend (EngineConfig.delivery='event'), port of
`repro.core.event_engine`.

The paper's computational model is event-driven for synaptic dynamics:
per-step work scales with (spikes x fan-out), not with the synapse count
E.  The dense backend (`core.engine`) flags every synapse in an [H, D, E]
arrival ring; this backend keeps EVENT LISTS instead:

  - ev_ring [H, D, cap_ev] int32 synapse ids (-1 pad), ev_count [H, D]:
    slot d holds its events in [0, ev_count[:, d]) and -1 after them;
  - emission (phase B) appends the spiking sources' forward rows (the
    EventPlan's `fwd_rows`) to slot (t + delay) mod D, in (source rank,
    row position) order;
  - arrivals (phase A) touch only this step's list: each target's current
    is the sum of its events' pre-LTD weights in list order, LTD and the
    last-arrival refresh on the listed synapses;
  - LTP walks the incoming rows of the spiking neurons (`in_rows`, which
    are the plan's CSR rows, `row_ptr`).

Capacities are static (the AER trade): cap_ev bounds a slot's events,
c_post and c_src the compacted spike lists; overflow counts in `sat`
instead of corrupting.  Compaction is sort-free (`aer.compact_indices`:
a cumsum ranks the selected entries; on the card the neuron pass ranks
the spiking neurons by a scan), and so is every op of the step.

On the card a step is four ops of hand-written kernels
(`kernels.ops.event_arrival`; `event_neurons`: the stimulus, the neurons,
the spikes listed by a scan and their bookkeeping; `event_ltp`;
`event_emit`), the split schedule's plasticity half listing the spikes
apart (`event_compact`); on the CPU the plain versions give the JAX
package's bits (its event backend, jitted under
`XLA_FLAGS=--xla_cpu_max_isa=AVX`).  Against the dense backend the
rasters are equal and the weights agree to ~1e-5: the sum orders differ
(list order here, canonical synapse order there).

The [H] shard axis is written out, as in `core.engine`; `run` on the card
is one captured CUDA graph a window of steps (`engine.CapturedRun`).  The
phase functions update the state they are given in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import aer, connectivity, engine
from .engine import (NEG_TIME, ShardPlan, ShardState, SimSpec, StepFns,
                     StepTimings)
from .params import DEFAULT_IZH, DEFAULT_STDP
from ..kernels import ops as kops
from ..kernels import ref as kref


class EventPlan(NamedTuple):
    fwd_rows: torch.Tensor     # [H, S, Kf] int32 flat synapse ids (-1 pad)
    in_rows: torch.Tensor      # [H, N, Ki] int32 flat synapse ids (-1 pad)


class EventState(NamedTuple):
    base: ShardState           # v, u, last_post, w, last_arr (arr_ring unused)
    ev_ring: torch.Tensor      # [H, D, cap_ev] int32 (-1 pad)
    ev_count: torch.Tensor     # [H, D] int32
    sat: torch.Tensor          # [H] int32 dropped events (overflow counter)


def default_caps(spec: SimSpec) -> Tuple[int, int]:
    """(c_post, c_src) spike-compaction capacities.

    Paper rates keep spikes/step far below N (<= ~6% at 60 Hz); N/2 and
    S/8 are comfortable headroom, the floors keep tiny test grids from
    degenerating.  Overflow is counted in `sat`, never corrupting."""
    n, s = spec.n_local, spec.s_cap
    return min(n, max(64, n // 2)), min(s, max(128, s // 8))


def no_drop_caps(spec: SimSpec) -> dict:
    """Compaction capacities that hold every spike (c_post = the shard's
    neurons, c_src = its sources), for a grid whose bursts overflow
    `default_caps` (a 4x4 grid at full width spikes up to ~6,900 of its
    16,000 neurons in a step).  With a ring of cap_ev = spec.e_cap (each
    synapse is in a slot at most once; `init_event_state`) such a run
    drops nothing."""
    return dict(c_post=spec.n_local, c_src=spec.s_cap)


def _rows(keys: np.ndarray, n_rows: int, pad_to: int) -> np.ndarray:
    """[n_rows, pad_to] int32: row k lists, ascending, the positions e
    with keys[e] == k, then -1 (a stable argsort groups them)."""
    out = np.full((n_rows, pad_to), -1, dtype=np.int32)
    order = np.argsort(keys, kind="stable")
    counts = np.bincount(keys, minlength=n_rows)
    starts = np.cumsum(counts) - counts
    k = keys[order]
    out[k, np.arange(order.shape[0]) - starts[k]] = order
    return out


def build_event_plan(spec: SimSpec, cap_ev_factor: float = 0.25,
                     tables=None, device=None) -> Tuple[EventPlan, int]:
    """Padded forward (by source) and incoming (by target) rows of every
    shard's valid synapses, stacked [H, ...], on `device` (the card by
    default), and cap_ev, the events a delay slot holds: factor * E
    rounded up to 128, at least 256.  Built on the host with numpy;
    `tables` reuses connectivity tables already built for this (cfg,
    eng)."""
    if tables is None:
        tables = connectivity.build_all_shards(spec.cfg, spec.eng)
    dev = engine.resolve_device(device)
    S = tables[0].src_gid.shape[0]
    N = spec.n_local
    src = [np.asarray(t.src_idx[:int(t.n_valid)]).astype(np.int64)
           for t in tables]
    tgt = [np.asarray(t.tgt_local[:int(t.n_valid)]).astype(np.int64)
           for t in tables]
    width = lambda keys, n: max([1] + [int(np.bincount(k, minlength=n).max())
                                       for k in keys if k.size])
    kf, ki = width(src, S), width(tgt, N)
    plan = EventPlan(
        fwd_rows=torch.from_numpy(np.stack([_rows(k, S, kf) for k in src])
                                  ).to(dev),
        in_rows=torch.from_numpy(np.stack([_rows(k, N, ki) for k in tgt])
                                 ).to(dev))
    cap_ev = int(spec.e_cap * cap_ev_factor)
    cap_ev = max(256, -(-cap_ev // 128) * 128)
    return plan, cap_ev


def init_event_state(spec: SimSpec, base: ShardState, cap_ev: int
                     ) -> EventState:
    H = base.v.shape[0]
    D = spec.cfg.n_delay_slots
    dev = base.v.device
    return EventState(
        base=base,
        ev_ring=torch.full((H, D, cap_ev), -1, dtype=torch.int32,
                           device=dev),
        ev_count=torch.zeros((H, D), dtype=torch.int32, device=dev),
        sat=torch.zeros((H,), dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# per-step phases (same A / exchange / B split as the dense engine)
# ---------------------------------------------------------------------------


def _arrivals(spec: SimSpec, plan: ShardPlan, st: EventState, t,
              t_base=None):
    """This step's event list -> (i_syn, n_arrived): currents, LTD and the
    last-arrival refresh, the slot's list and count cleared (in place).
    `t_base` (int64 [H]) gives each shard its own step t + t_base[h], as in
    every phase below."""
    stdp = spec.stdp
    b = st.base
    return kops.event_arrival(
        st.ev_ring, st.ev_count, plan.syn_tgt, plan.row_ptr,
        plan.syn_plastic, b.last_post, b.w, b.last_arr, t,
        a_minus=stdp.a_minus, tau_minus=stdp.tau_minus, w_min=stdp.w_min,
        w_max=stdp.w_max, neg_time=NEG_TIME, t_base=t_base)


def _neurons(spec: SimSpec, plan: ShardPlan, st: EventState, i_syn, t, stim,
             coeffs, c_post: Optional[int], t_base=None):
    """Stimulus -> neuron update -> spikes, and with c_post the list of the
    first c_post spiking neurons, last_post and sat (in place)."""
    b = st.base
    return kops.event_neurons(
        i_syn, *stim, plan.exc_mask, plan.neuron_valid, b.v, b.u,
        b.last_post, st.sat, t, izh=spec.izh, c_post=c_post, coeffs=coeffs,
        t_base=t_base)


def _ltp(spec: SimSpec, plan: ShardPlan, st: EventState, ids, count,
         t, t_base=None) -> None:
    """LTP on the incoming rows of the listed neurons (w in place)."""
    stdp = spec.stdp
    kops.event_ltp(ids, count, plan.row_ptr, plan.syn_plastic,
                   st.base.last_arr, st.base.w, t, a_plus=stdp.a_plus,
                   tau_plus=stdp.tau_plus, w_min=stdp.w_min,
                   w_max=stdp.w_max, neg_time=NEG_TIME, t_base=t_base)


def phase_a_dynamics(spec: SimSpec, plan: ShardPlan, eplan: EventPlan,
                     st: EventState, t, stim, coeffs
                     ) -> Tuple[EventState, torch.Tensor, StepTimings]:
    """Event phase A minus LTP: this step's event list -> currents, LTD and
    last-arrival refresh -> stimulus -> neuron update.

    `t` is the step (an int; on the card also the device step counter),
    `stim` the step's (index, amp) rows [H, C*K] (with the counter, the
    window [W, H, C*K]), `coeffs` the neurons' (a, b, c, d)
    (`kernels.ref.izh_coefficients`, built once by the caller).  Updates
    v, u, w, last_arr and the slot's list and count in place; returns
    (state, spiked [H, N], timings)."""
    i_syn, n_arrived = _arrivals(spec, plan, st, t)
    spiked, count, _ = _neurons(spec, plan, st, i_syn, t, stim, coeffs,
                                None)
    return st, spiked, StepTimings(spikes=count, arrivals=n_arrived)


def phase_a_plasticity(spec: SimSpec, plan: ShardPlan, eplan: EventPlan,
                       st: EventState, spiked: torch.Tensor, t,
                       c_post: Optional[int] = None) -> EventState:
    """Event phase A's LTP: the incoming rows of the first c_post spiking
    neurons (compacted), last_post = t of every spiking neuron, and the
    compaction's overflow into `sat`.  Touches only {w, last_post, sat},
    disjoint from phase B's {ev_ring, ev_count}: what makes overlapping
    the exchange with it legal.  In place; returns `st`."""
    if c_post is None:
        c_post = default_caps(spec)[0]
    count, ids = kops.event_compact(spiked, st.base.last_post, st.sat, t,
                                    c_post=c_post)
    _ltp(spec, plan, st, ids, count, t)
    return st


def phase_a(spec: SimSpec, plan: ShardPlan, eplan: EventPlan,
            st: EventState, t, stim, coeffs, c_post: Optional[int] = None,
            t_base=None) -> Tuple[EventState, torch.Tensor, StepTimings]:
    """`phase_a_dynamics` then `phase_a_plasticity`, in three ops: the
    arrivals, the neurons with the spike list and its bookkeeping
    (`kernels.ops.event_neurons`), LTP.  (state, spiked, tm), the contract
    of `engine.phase_a`; `t_base` as `_arrivals`'."""
    if c_post is None:
        c_post = default_caps(spec)[0]
    i_syn, n_arrived = _arrivals(spec, plan, st, t, t_base)
    spiked, count, ids = _neurons(spec, plan, st, i_syn, t, stim, coeffs,
                                  c_post, t_base)
    _ltp(spec, plan, st, ids, count, t, t_base)
    return st, spiked, StepTimings(spikes=count, arrivals=n_arrived)


def phase_b(spec: SimSpec, plan: ShardPlan, eplan: EventPlan,
            st: EventState, spiked_src: torch.Tensor, t,
            c_src: Optional[int] = None, t_base=None) -> EventState:
    """Emission: the first c_src spiking sources (compacted) append their
    forward rows to slot (t + delay) mod D (floor mod; the pipelined
    prologue's t = -1 included); the compaction's overflow and the events
    past cap_ev count in `sat`.  In place; returns `st`.  `t_base` as
    `_arrivals`'."""
    S = spiked_src.shape[1]
    if c_src is None:
        c_src = default_caps(spec)[1]
    ids, dropped = aer.compact_indices(spiked_src, c_src, fill=S)
    kops.event_emit(ids.contiguous(), dropped, eplan.fwd_rows, plan.syn_delay,
                    st.ev_ring, st.ev_count, st.sat, t, t_base=t_base)
    return st


# ---------------------------------------------------------------------------
# single-process driver (mirrors engine.make_step_fn / run)
# ---------------------------------------------------------------------------


def build(cfg, eng, izh=None, stdp=None, *, device
          ) -> Tuple[SimSpec, ShardPlan, EventPlan, EventState]:
    """(spec, plan, eplan, state) for the event backend, on `device`.  The
    connectivity tables are built once and shared by the dense plan and
    the event rows."""
    if str(eng.connectivity).strip() != "materialized":
        raise ValueError(
            "delivery='event' requires connectivity='materialized': the "
            "event backend's per-source row tables are an O(E) permutation "
            "of synapse ids, which contradicts O(chunk) streamed residency")
    tables = connectivity.build_all_shards(cfg, eng)
    spec, plan, base = engine.build(cfg, eng, izh or DEFAULT_IZH,
                                    stdp or DEFAULT_STDP, device=device,
                                    tables=tables)
    eplan, cap_ev = build_event_plan(spec, tables=tables,
                                     device=plan.gid.device)
    return spec, plan, eplan, init_event_state(spec, base, cap_ev)


def make_step_fn(spec: SimSpec, plan: ShardPlan, eplan: EventPlan, t0: int,
                 n_steps: int, c_post: Optional[int] = None,
                 c_src: Optional[int] = None) -> StepFns:
    """Step callables for steps t0 .. t0 + n_steps - 1, as
    `engine.make_step_fn`'s (the same exchange); the stimulus of the window
    is drawn at once, the neurons' a, b, c, d built once."""
    stim = engine.StimWindow(spec, plan, t0, n_steps)
    coeffs = kref.izh_coefficients(plan.exc_mask, spec.izh)
    exchange = engine.make_exchange(spec, plan)

    def pa(state, t):
        return phase_a(spec, plan, eplan, state, t, stim.row(t), coeffs,
                       c_post=c_post)

    def pa_dyn(state, t):
        return phase_a_dynamics(spec, plan, eplan, state, t, stim.row(t),
                                coeffs)

    def pa_plast(state, spiked, t):
        return phase_a_plasticity(spec, plan, eplan, state, spiked, t,
                                  c_post=c_post)

    def pb(state, spiked_src, t):
        return phase_b(spec, plan, eplan, state, spiked_src, t, c_src=c_src)

    def step(state, t):
        state, spiked, tm = pa(state, t)
        state = pb(state, exchange(spiked), t)
        return state, spiked, tm

    return StepFns(phase_a=pa, exchange=exchange, phase_b=pb, step=step,
                   phase_a_dynamics=pa_dyn, phase_a_plasticity=pa_plast,
                   stim=stim)


def make_step(spec: SimSpec, plan: ShardPlan, eplan: EventPlan,
              exchange, c_post: Optional[int] = None,
              c_src: Optional[int] = None, *, t_base=None):
    """The event step `step(state, t, stim_index, stim_amp) -> (spiked,
    timings)`, `engine.make_step`'s contract: phase A, the exchange, phase
    B, in place, each shard at t + t_base[h] where `t_base` is given."""
    coeffs = (kref.izh_coefficients(plan.exc_mask, spec.izh)
              if plan.gid.device.type != "cuda" else None)

    def step(state, t, stim_index, stim_amp):
        state, spiked, tm = phase_a(spec, plan, eplan, state, t,
                                    (stim_index, stim_amp), coeffs,
                                    c_post=c_post, t_base=t_base)
        phase_b(spec, plan, eplan, state, exchange(spiked), t, c_src=c_src,
                t_base=t_base)
        return spiked, tm

    return step


def make_runner(spec: SimSpec, plan: ShardPlan, eplan: EventPlan,
                state: EventState, c_post: Optional[int] = None,
                c_src: Optional[int] = None, *, t_base=None, exchange=None,
                window: int = engine.RUN_WINDOW) -> engine.CapturedRun:
    """The event run on the card (`engine.CapturedRun` of `window` steps):
    every kernel reads t from the step counter (plus each shard's offset
    in `t_base` where given), and the neuron pass its stimulus row from
    the window at the counter's row; the exchange is `exchange` (by
    default `engine.make_exchange`'s)."""
    exchange = exchange or engine.make_exchange(spec, plan)
    return engine.CapturedRun(
        make_step(spec, plan, eplan, exchange, c_post, c_src, t_base=t_base),
        state, window=window, t_base=t_base)


def run(spec: SimSpec, plan: ShardPlan, eplan: EventPlan, state: EventState,
        t0: int, n_steps: int, c_post: Optional[int] = None,
        c_src: Optional[int] = None, *, graph: bool = True,
        runner: Optional[engine.CapturedRun] = None):
    """Steps t0 .. t0 + n_steps - 1 -> (state, raster [T, H, N],
    timings), the contract of `engine.run`; the input state is not
    modified.  On the card through `runner` (made here when None): a
    captured CUDA graph a window, or with `graph=False` the same steps
    eagerly; on the CPU a Python loop."""
    dev = plan.gid.device
    if dev.type == "cuda":
        runner = runner or make_runner(spec, plan, eplan, state, c_post,
                                       c_src)
        return runner.run(state, t0, n_steps,
                          *engine.stim_rows(spec, plan, t0, n_steps),
                          graph=graph)
    with engine._numerics(dev):
        fns = make_step_fn(spec, plan, eplan, t0, n_steps, c_post, c_src)
        return engine.run_loop(fns.step, state, t0, n_steps)
