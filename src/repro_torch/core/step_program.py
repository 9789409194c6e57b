"""`StepProgram`: the one constructor for the DPSNN step (PyTorch port).

    sp = StepProgram(cfg, eng)                    # on the card
    sp = StepProgram(cfg, eng, device="cpu")      # plain PyTorch on the CPU
    state, raster, tm = sp.run(sp.init_state(), 0, 500)
    pa, ex, pb = sp.phase_fns()[:3]               # Table 2 phase split
    state, times, rasters, counts = sp.time_phases(state, 0, 100)

This is the single-process subset of `repro.core.step_program.StepProgram`
(`mesh=None`; dense or event delivery over materialized connectivity, or
dense delivery over streamed connectivity, `connectivity='streamed:chunk=
K'`, `core.stream_engine`), with the shards stacked on a leading [H] axis
of one device.  `run` is the
reference driver that defines the physics (global-mask exchange); on the
card it replays one captured CUDA graph a window of steps, kept per
StepProgram (`engine.CapturedRun`).  The phase
handles emulate each exchange wire over the stacked shards ('allgather':
the global mask; 'halo': `aer.pack` per shard and `torch.roll` over the
shard axis by each halo offset; 'hier': one AER buffer per group of
shards, rolled at whole-group stride), so per-phase profiles keep each
wire's work.  `StepProgram.fused` (an HLO analysis handle) has no
counterpart here (ROADMAP queue 1, item 13.6); the rest of the JAX facade
raises `NotImplementedError` naming the ROADMAP item that ports it.

The phase handles update the state they are given in place; `run` and
`time_phases` copy their input first and leave it untouched.  On the card
no phase reads a device value on the host.
"""
from __future__ import annotations

import hashlib
import time
from typing import Optional

import numpy as np
import torch

from . import aer, connectivity, distributed, engine, event_engine
from . import stream_engine
from .engine import ShardPlan, SimSpec
from .params import (DEFAULT_IZH, DEFAULT_STDP, EngineConfig, GridConfig,
                     IzhikevichParams, StdpParams)

# steps of stimulus a phase handle draws at once when its caller has not
# drawn a window (`time_phases` draws its whole range)
PHASE_WINDOW = 100


def check_supported(eng: EngineConfig, mesh=None) -> None:
    """Raise NotImplementedError for what this port does not run yet, and
    ValueError for a delivery or connectivity mode that does not exist or
    a pair of them that the reference refuses (streamed with event
    delivery)."""
    if eng.delivery not in ("dense", "event"):
        raise ValueError(f"unknown delivery {eng.delivery!r}: expected "
                         f"'dense' or 'event'")
    mode, _ = connectivity.parse_mode(eng.connectivity)
    if mode == "streamed" and eng.delivery != "dense":
        raise ValueError(
            "connectivity='streamed' requires delivery='dense': the event "
            "backend's fwd/in row tables are an O(E) synapse-id "
            "permutation, which contradicts O(chunk) table residency")
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh is not ported yet; shards run stacked on one "
            "device (ROADMAP queue 1, item 8)")


def _match(ids: torch.Tensor, n_total: int, src_safe, src_ok):
    """[H, S] spiked_src from received AER ids [H, K]: scatter the ids into
    a per-shard [N_total] mask (INVALID pads into a spare last slot), then
    one gather by the source table."""
    idx = torch.where(ids < n_total, ids, n_total).to(torch.int64)
    mask = torch.zeros((ids.shape[0], n_total + 1), dtype=torch.bool,
                       device=ids.device)
    mask.scatter_(1, idx, True)
    return torch.gather(mask, 1, src_safe) & src_ok


class StepProgram:
    """Run, phase and timing handles for one (GridConfig, EngineConfig) on
    one device.

    `device=None` means the card; without one it raises.  Pass
    `device="cpu"` for the plain PyTorch path (what the tests do).
    `hier_groups` (a group count, or a list of equal-sized contiguous
    blocks of shards) sets the shard groups of `exchange='hier'`.  With
    `delivery='event'` the state is an `event_engine.EventState` and
    `caps` may set the spike compactions' c_post / c_src.  Streamed
    connectivity keeps its chunk metadata in `splan`
    (`stream_engine.StreamedPlan`)."""

    def __init__(self, cfg: GridConfig, eng: EngineConfig, *,
                 device=None, mesh=None,
                 izh: Optional[IzhikevichParams] = None,
                 stdp: Optional[StdpParams] = None,
                 caps: Optional[dict] = None, hier_groups=None):
        check_supported(eng, mesh)
        dev = engine.resolve_device(device)
        izh, stdp = izh or DEFAULT_IZH, stdp or DEFAULT_STDP
        eplan = splan = None
        if connectivity.parse_mode(eng.connectivity)[0] == "streamed":
            spec, plan, splan, state = stream_engine.build(
                cfg, eng, izh, stdp, device=dev)
        elif eng.delivery == "event":
            spec, plan, eplan, state = event_engine.build(
                cfg, eng, izh, stdp, device=dev)
        else:
            spec, plan, state = engine.build(cfg, eng, izh, stdp,
                                             device=dev)
        self._init(spec, plan, state, eplan, caps, hier_groups, splan)

    @classmethod
    def from_parts(cls, spec: SimSpec, plan: ShardPlan, state0=None, *,
                   eplan: Optional[event_engine.EventPlan] = None,
                   splan: Optional[stream_engine.StreamedPlan] = None,
                   caps: Optional[dict] = None,
                   hier_groups=None) -> "StepProgram":
        """Wrap an already-built (spec, plan[, state][, eplan][, splan])
        without re-running connectivity construction (e.g. a plan from
        `convert.from_jax`); delivery='event' needs the EventPlan, streamed
        connectivity the StreamedPlan."""
        check_supported(spec.eng)
        sp = cls.__new__(cls)
        sp._init(spec, plan, state0, eplan, caps, hier_groups, splan)
        return sp

    def _init(self, spec, plan, state0, eplan, caps, hier_groups, splan):
        if spec.eng.delivery == "event" and eplan is None:
            raise ValueError("delivery='event' needs an EventPlan")
        if spec.stream is not None and splan is None:
            raise ValueError("streamed connectivity needs a StreamedPlan")
        self.spec: SimSpec = spec
        self.plan: ShardPlan = plan
        self.eplan = eplan
        self.splan = splan
        self.caps = caps or {}
        self.device = plan.gid.device
        self.hier_groups = hier_groups
        self._state0 = state0
        self._fns = None
        self._phases = None
        # the card's run loop (`engine.CapturedRun`), made by the first run
        self.runner = None

    @property
    def cap_ev(self) -> Optional[int]:
        """Events a delay slot of the event ring holds; None for the dense
        backend (or without an initial state)."""
        if self._state0 is not None and self.eplan is not None:
            return int(self._state0.ev_ring.shape[-1])
        return None

    def init_state(self):
        """The freshly-built initial state."""
        if self._state0 is None:
            raise ValueError("no initial state: this StepProgram wraps "
                             "prebuilt parts without state0")
        return self._state0

    def run(self, state, t0: int, n_steps: int, *, graph: bool = True):
        """(state, raster [T, H, N] bool, timings) on this device; the
        input state is not modified.  On the card the steps replay this
        program's CUDA graph of `engine.RUN_WINDOW` steps (its first full
        window runs eagerly and is then captured; `self.runner`);
        `graph=False` runs the same steps eagerly."""
        spec, plan = self.spec, self.plan
        if self.device.type == "cuda" and self.runner is None:
            if self.splan is not None:
                self.runner = stream_engine.make_runner(spec, plan,
                                                        self.splan, state)
            elif self.eplan is not None:
                self.runner = event_engine.make_runner(
                    spec, plan, self.eplan, state, self.caps.get("c_post"),
                    self.caps.get("c_src"))
            else:
                self.runner = engine.make_runner(spec, plan, state)
        if self.splan is not None:
            return stream_engine.run(spec, plan, self.splan, state, t0,
                                     n_steps, graph=graph,
                                     runner=self.runner)
        if self.eplan is not None:
            return event_engine.run(spec, plan, self.eplan, state, t0,
                                    n_steps, self.caps.get("c_post"),
                                    self.caps.get("c_src"), graph=graph,
                                    runner=self.runner)
        return engine.run(spec, plan, state, t0, n_steps, graph=graph,
                          runner=self.runner)

    def weight_signature(self, state) -> bytes:
        """sha256 over the valid synapse weights in canonical per-shard
        order (the plastic-state counterpart of the raster signature),
        byte-compatible with the JAX package's (of either delivery and
        either connectivity mode: streamed state holds shard h's valid
        weights at [0, e_start[h, -1]))."""
        if isinstance(state, event_engine.EventState):
            state = state.base
        w = state.w.detach().cpu().numpy()
        h = hashlib.sha256()
        if self.splan is not None:
            ends = self.splan.e_start[:, -1].cpu().numpy()
            for hh in range(w.shape[0]):
                h.update(np.ascontiguousarray(w[hh, :int(ends[hh])])
                         .tobytes())
            return h.digest()
        valid = self.plan.syn_valid.cpu().numpy()
        for hh in range(w.shape[0]):
            h.update(np.ascontiguousarray(w[hh][valid[hh]]).tobytes())
        return h.digest()

    # -- phase handles (paper Table 2 split) -----------------------------

    def phase_fns(self) -> distributed.PhasePrograms:
        """Phase handles with the JAX package's signatures:

            phase_a(state, t) -> (state, spiked, tm)
            exchange(spiked) -> spiked_src
            phase_b(state, spiked_src, t) -> state
            phase_a_dynamics(state, t) / phase_a_plasticity(state, spiked, t)

        They update the state they are given in place.  A phase A draws
        the stimulus window its t falls in when t leaves the current one
        (`engine.StimWindow`)."""
        if self._phases is None:
            fns = distributed.delivery_step_fns(
                self.spec, self.plan, 0, PHASE_WINDOW, self.eplan, self.caps,
                splan=self.splan)
            num = self._with_numerics
            self._fns = fns
            self._phases = distributed.PhasePrograms(
                phase_a=num(fns.phase_a), exchange=self._exchange(fns),
                phase_b=num(fns.phase_b),
                phase_a_dynamics=num(fns.phase_a_dynamics),
                phase_a_plasticity=num(fns.phase_a_plasticity))
        return self._phases

    def _with_numerics(self, fn):
        """fn under the device's numerics (fp32 denormals flushed on the
        CPU, as the reference's XLA-CPU does)."""
        if self.device.type != "cpu":
            return fn

        def wrapped(*args):
            with engine._numerics(self.device):
                return fn(*args)
        return wrapped

    def _exchange(self, fns: engine.StepFns):
        """The exchange wire over the stacked [H, N] spike masks, each mode
        keeping its own work: the global mask ('allgather', the run's own
        `fns.exchange`), AER buffers rolled over the shard axis ('halo'),
        or over groups of shards ('hier'); all give the same [H, S]
        spiked_src."""
        spec, plan = self.spec, self.plan
        if spec.eng.exchange == "allgather":
            return fns.exchange
        src_ok = plan.src_gid >= 0
        src_safe = torch.where(src_ok, plan.src_gid, 0)
        n_total = spec.n_total
        if spec.eng.exchange == "halo":
            offsets = distributed.halo_offsets(spec, plan)
            gid = plan.gid

            def ex_halo(spiked):
                ids, _ = aer.pack(spiked, gid, gid.shape[1])
                # receiver h hears sender (h - d) mod H
                received = [torch.roll(ids, d, 0) for d in offsets]
                return _match(torch.cat(received, 1), n_total, src_safe,
                              src_ok)
            return ex_halo

        if spec.eng.exchange == "hier":
            groups = distributed._resolve_groups(spec, None,
                                                 self.hier_groups)
            G, L = len(groups), len(groups[0])
            g_offsets = distributed.hier_offsets(spec, plan, L)
            H, N = plan.gid.shape
            gid_g = plan.gid.reshape(G, L * N)

            def ex_hier(spiked):
                # level 1: the group's gather is a reshape on one device;
                # level 2: one buffer a group, rolled at group stride
                ids, _ = aer.pack(spiked.reshape(G, L * N), gid_g, L * N)
                received = torch.cat([torch.roll(ids, d, 0)
                                      for d in g_offsets], 1)
                per_shard = received[:, None].expand(G, L, -1).reshape(H, -1)
                return _match(per_shard, n_total, src_safe, src_ok)
            return ex_hier

        raise ValueError(f"unknown exchange {spec.eng.exchange!r}")

    # -- timing handle (per-phase wall-clock attribution) ----------------

    def time_phases(self, state, t0: int, n_steps: int,
                    collect_rasters: bool = False):
        """Per-step wall-clock attribution: the paper's Table 2 split.

        Returns (final_state, times, rasters, counts): `times` accumulates
        phase_a_s / exchange_s / phase_b_s over `n_steps`, each phase
        fenced by `torch.cuda.synchronize` on the card; `rasters` is a
        list of per-step [H, N] numpy spike masks when `collect_rasters`
        else None; `counts` totals the spike and arrival counters.  The
        input state is not modified (the warm-up and the timed run each
        work on a copy), and the stimulus of the whole range is drawn
        before the timed loop.

        Under 'sync' the exchange is fenced between A and B, so
        exchange_s is its full exposed latency.  Under 'pipelined' the
        exchange of step t is issued between phase A's halves and only
        waited for right before the phase B that consumes it, one step
        later, so exchange_s records the issue and the residual wait; an
        all-False buffer makes the first phase B (at t0 - 1) a no-op, and
        an epilogue delivers the last step's spikes.  Keys are the same
        under both schedules."""
        self.phase_fns()
        self._fns.stim.draw(t0, n_steps)
        if self.spec.eng.exchange_schedule == "pipelined":
            run = self._time_phases_pipelined
        else:
            run = self._time_phases_sync
        return run(state, t0, n_steps, collect_rasters)

    def _fence(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _time_phases_sync(self, state, t0, n_steps, collect_rasters):
        pp, fence = self.phase_fns(), self._fence
        warm = engine.clone_state(state)
        s_w, spk_w, _ = pp.phase_a(warm, t0)
        pp.phase_b(s_w, pp.exchange(spk_w), t0)
        fence()
        del warm, s_w

        times = dict(phase_a_s=0.0, exchange_s=0.0, phase_b_s=0.0)
        tally = ([], [], [])
        s = engine.clone_state(state)
        fence()
        for t in range(t0, t0 + n_steps):
            c0 = time.perf_counter()
            s, spiked, tm = pp.phase_a(s, t)
            fence()
            times["phase_a_s"] += time.perf_counter() - c0
            c0 = time.perf_counter()
            spiked_src = pp.exchange(spiked)
            fence()
            times["exchange_s"] += time.perf_counter() - c0
            c0 = time.perf_counter()
            s = pp.phase_b(s, spiked_src, t)
            fence()
            times["phase_b_s"] += time.perf_counter() - c0
            self._tally(tally, spiked, tm, collect_rasters)
        return (s, times) + self._totals(tally, collect_rasters)

    def _time_phases_pipelined(self, state, t0, n_steps, collect_rasters):
        pp, fence = self.phase_fns(), self._fence
        warm = engine.clone_state(state)
        s_w, spk_w, _ = pp.phase_a_dynamics(warm, t0)
        src_w = pp.exchange(spk_w)
        s_w = pp.phase_a_plasticity(s_w, spk_w, t0)
        pp.phase_b(s_w, src_w, t0)
        fence()
        del warm, s_w

        times = dict(phase_a_s=0.0, exchange_s=0.0, phase_b_s=0.0)
        tally = ([], [], [])
        s = engine.clone_state(state)
        # all-False prologue buffer (phase B of it sets nothing)
        ss_buf = torch.zeros(self.plan.src_gid.shape, dtype=torch.bool,
                             device=self.device)
        fence()
        for t in range(t0, t0 + n_steps):
            # the residual exchange wait surfaces only here, right before
            # the consuming phase B: everything since its issue was hidden
            c0 = time.perf_counter()
            fence()
            times["exchange_s"] += time.perf_counter() - c0
            c0 = time.perf_counter()
            s = pp.phase_b(s, ss_buf, t - 1)
            fence()
            times["phase_b_s"] += time.perf_counter() - c0
            c0 = time.perf_counter()
            s, spiked, tm = pp.phase_a_dynamics(s, t)
            fence()
            times["phase_a_s"] += time.perf_counter() - c0
            c0 = time.perf_counter()
            ss_buf = pp.exchange(spiked)       # issue, do not wait
            times["exchange_s"] += time.perf_counter() - c0
            c0 = time.perf_counter()
            s = pp.phase_a_plasticity(s, spiked, t)
            fence()
            times["phase_a_s"] += time.perf_counter() - c0
            self._tally(tally, spiked, tm, collect_rasters)
        # epilogue flush: deliver the last step's spikes
        c0 = time.perf_counter()
        fence()
        times["exchange_s"] += time.perf_counter() - c0
        c0 = time.perf_counter()
        s = pp.phase_b(s, ss_buf, t0 + n_steps - 1)
        fence()
        times["phase_b_s"] += time.perf_counter() - c0
        return (s, times) + self._totals(tally, collect_rasters)

    @staticmethod
    def _tally(tally, spiked, tm, collect_rasters):
        """Keep the step's outputs (no device work, no host read); the
        spike mask only when the rasters are asked for."""
        if collect_rasters:
            tally[0].append(spiked)
        tally[1].append(tm.spikes)
        tally[2].append(tm.arrivals)

    @staticmethod
    def _totals(tally, collect_rasters):
        """(rasters or None, counts) read back once, after the loop."""
        rasters, spikes, arrivals = tally
        counts = dict(spikes=int(torch.stack(spikes).sum()) if spikes else 0,
                      arrivals=int(torch.stack(arrivals).sum())
                      if arrivals else 0)
        if not collect_rasters:
            return None, counts
        if not rasters:
            return [], counts
        return list(torch.stack(rasters).cpu().numpy()), counts
