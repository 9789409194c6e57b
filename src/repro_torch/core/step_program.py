"""`StepProgram`: the one constructor for the DPSNN step (PyTorch port).

    sp = StepProgram(cfg, eng)                    # on the card
    sp = StepProgram(cfg, eng, device="cpu")      # plain PyTorch on the CPU
    state, raster, tm = sp.run(sp.init_state(), 0, 500)
    checkpoint.save(path, sp.spec, sp.plan, state, 500)
    state, t = sp.load(path)                      # any layout, either package
    pa, ex, pb = sp.phase_fns()[:3]               # Table 2 phase split
    state, times, rasters, counts = sp.time_phases(state, 0, 100)

    # a rank of a torch.distributed job (cluster.runtime): its block of
    # H / R shards on its device, real collectives between the ranks
    sp = StepProgram(cfg, eng, mesh=make_snn_mesh(H))
    state, raster, tm = sp.run(sp.place(sp.init_state()), 0, 500)
    raster = sp.gather_raster(raster)             # [T, H, N] on the primary

This is `repro.core.step_program.StepProgram` for dense or event
delivery over materialized connectivity, or dense delivery over streamed
connectivity (`connectivity='streamed:chunk=K'`, `core.stream_engine`).
Without a mesh the shards are stacked on a leading [H] axis of one
device.  With one (`dist.mesh.SnnMesh`) every rank builds the full host
plan and uploads only its block of L = H / R shards; `run`, the phase
handles and `time_phases` step that block and exchange spikes with the
other ranks over the wire (`core.distributed.MeshProgram`), eagerly;
`gather` and `gather_raster` collect a state or raster on the primary.
Without a mesh, `run` is the
reference driver that defines the physics (global-mask exchange); on the
card it replays one captured CUDA graph a window of steps, kept per
StepProgram (`engine.CapturedRun`).  The phase
handles run each exchange wire over the stacked shards ('allgather':
the global mask; 'halo' and 'hier': the mesh path's AER wires over a
one-process mesh, a buffer a shard or a group of shards, each receiver
gathering its senders' buffers on the device), so per-phase profiles keep
each wire's work.  `StepProgram.fused` (an HLO analysis handle) has no
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

from . import connectivity, distributed, engine, event_engine
from . import stream_engine
from .distributed import PHASE_WINDOW
from .engine import ShardPlan, SimSpec
from .params import (DEFAULT_IZH, DEFAULT_STDP, EngineConfig, GridConfig,
                     IzhikevichParams, StdpParams)
from ..cluster import runtime
from ..dist.mesh import Ready


def check_supported(eng: EngineConfig, mesh=None) -> None:
    """Raise NotImplementedError for what this port does not run yet, and
    ValueError for a delivery or connectivity mode that does not exist, a
    pair of them that the reference refuses (streamed with event
    delivery), or a mesh of another shard count."""
    if eng.delivery not in ("dense", "event"):
        raise ValueError(f"unknown delivery {eng.delivery!r}: expected "
                         f"'dense' or 'event'")
    mode, _ = connectivity.parse_mode(eng.connectivity)
    if mode == "streamed" and eng.delivery != "dense":
        raise ValueError(
            "connectivity='streamed' requires delivery='dense': the event "
            "backend's fwd/in row tables are an O(E) synapse-id "
            "permutation, which contradicts O(chunk) table residency")
    if mesh is None:
        return
    if mesh.n_shards != eng.n_shards:
        raise ValueError(f"the mesh has {mesh.n_shards} shards, the engine "
                         f"{eng.n_shards}")
    if mode == "streamed" and eng.placement == "scatter" and mesh.world > 1:
        raise NotImplementedError(
            "streamed connectivity with scatter placement over more than "
            "one rank: the chunk kernel (csrc/stream.cu) takes a block "
            "row's index as its shard id, which a rank's block of scatter "
            "shards is not (ROADMAP queue 1, item 8's remainder)")


class StepProgram:
    """Run, phase and timing handles for one (GridConfig, EngineConfig) on
    one device, or on one rank of a mesh.

    `device=None` means the card; without one it raises.  Pass
    `device="cpu"` for the plain PyTorch path (what the tests do).  With
    `mesh=` (`dist.mesh.SnnMesh`) the device is the rank's.
    `hier_groups` (a group count, or a list of equal-sized contiguous
    blocks of shards) sets the shard groups of `exchange='hier'` without a
    mesh; over a mesh they are the ranks' blocks.  With
    `delivery='event'` the state is an `event_engine.EventState` and
    `caps` may set the spike compactions' c_post / c_src.  Streamed
    connectivity keeps its chunk metadata in `splan`
    (`stream_engine.StreamedPlan`).

    Over a mesh `plan`, `eplan`, `splan` and `init_state()` are the full
    host trees (every rank builds them); `run`, the phase handles and
    `time_phases` take and give the rank's block ([L, ...], `place`)."""

    def __init__(self, cfg: GridConfig, eng: EngineConfig, *,
                 device=None, mesh=None,
                 izh: Optional[IzhikevichParams] = None,
                 stdp: Optional[StdpParams] = None,
                 caps: Optional[dict] = None, hier_groups=None):
        check_supported(eng, mesh)
        streamed = connectivity.parse_mode(eng.connectivity)[0] == "streamed"
        if mesh is None:
            dev = engine.resolve_device(device)
        else:
            if device is not None and \
                    torch.device(device).type != mesh.device.type:
                raise ValueError(f"device={device!r}, the mesh's rank runs "
                                 f"on {mesh.device}")
            # the host plan is built on the CPU, except that on the card the
            # streamed build counts the chunks with the chunk kernel
            dev = (mesh.device if streamed and mesh.device.type == "cuda"
                   else torch.device("cpu"))
        izh, stdp = izh or DEFAULT_IZH, stdp or DEFAULT_STDP
        eplan = splan = None
        if streamed:
            spec, plan, splan, state = stream_engine.build(
                cfg, eng, izh, stdp, device=dev)
        elif eng.delivery == "event":
            spec, plan, eplan, state = event_engine.build(
                cfg, eng, izh, stdp, device=dev)
        else:
            spec, plan, state = engine.build(cfg, eng, izh, stdp,
                                             device=dev)
        if mesh is not None and dev.type != "cpu":
            plan, splan, state = (engine.map_state(torch.Tensor.cpu, t)
                                  for t in (plan, splan, state))
        self._init(spec, plan, state, eplan, caps, hier_groups, splan, mesh)

    @classmethod
    def from_parts(cls, spec: SimSpec, plan: ShardPlan, state0=None, *,
                   eplan: Optional[event_engine.EventPlan] = None,
                   splan: Optional[stream_engine.StreamedPlan] = None,
                   caps: Optional[dict] = None,
                   hier_groups=None, mesh=None) -> "StepProgram":
        """Wrap an already-built (spec, plan[, state][, eplan][, splan])
        without re-running connectivity construction (e.g. a plan from
        `convert.from_jax`); delivery='event' needs the EventPlan, streamed
        connectivity the StreamedPlan.  Over a `mesh` the parts are the
        full stacked trees, on any device."""
        check_supported(spec.eng, mesh)
        sp = cls.__new__(cls)
        sp._init(spec, plan, state0, eplan, caps, hier_groups, splan, mesh)
        return sp

    def _init(self, spec, plan, state0, eplan, caps, hier_groups, splan,
              mesh=None):
        if spec.eng.delivery == "event" and eplan is None:
            raise ValueError("delivery='event' needs an EventPlan")
        if spec.stream is not None and splan is None:
            raise ValueError("streamed connectivity needs a StreamedPlan")
        self.spec: SimSpec = spec
        self.plan: ShardPlan = plan
        self.eplan = eplan
        self.splan = splan
        self.caps = caps or {}
        self.mesh = mesh
        self.device = plan.gid.device if mesh is None else mesh.device
        self.hier_groups = hier_groups
        self._state0 = state0
        self._fns = None
        self._phases = None
        self._issue = None
        # the rank's part over a mesh (`distributed.MeshProgram`), made on
        # first use
        self._mp = None
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
        """The freshly-built initial state (over a mesh: the full host
        state; `place` takes the rank's block of it)."""
        if self._state0 is None:
            raise ValueError("no initial state: this StepProgram wraps "
                             "prebuilt parts without state0")
        return self._state0

    def load(self, path: str):
        """Restore (state, t) from a checkpoint (`core.checkpoint`, written
        by either package at any layout) into this program's layout: the
        state as `init_state()` has it, on this device without a mesh and
        the full host state over one (`place` takes the rank's block).
        `run` from it at t resumes this program's captured graph at any
        t."""
        from . import checkpoint
        return checkpoint.load(path, self.spec, self.plan,
                               cap_ev=self.cap_ev)

    # -- the mesh: placement and gathers ---------------------------------

    def _mesh_program(self) -> distributed.MeshProgram:
        if self._mp is None:
            self._mp = distributed.MeshProgram(
                self.spec, self.plan, self.mesh, eplan=self.eplan,
                caps=self.caps, hier_groups=self.hier_groups,
                splan=self.splan)
        return self._mp

    def place(self, state):
        """The rank's block of a full stacked state, on its device (the
        block of a job of two or more ranks is returned as it is); the
        state itself without a mesh."""
        if self.mesh is None:
            return state
        v = engine.state_tensors(state)[0]
        if (self.mesh.world > 1 and v.shape[0] == self.mesh.per_rank
                and v.device == self.mesh.device):
            return state
        return self._mesh_program().place(state)

    def gather(self, state):
        """The ranks' blocks of a state assembled into the full [H, ...]
        state on the primary's CPU (None on the other ranks; a collective).
        Without a mesh, the state on the CPU."""
        if self.mesh is None:
            return engine.map_state(torch.Tensor.cpu, state)
        return runtime.gather(state)

    def gather_raster(self, raster: torch.Tensor):
        """The ranks' rasters [T, L, N] as [T, H, N] on the primary's CPU
        (None on the other ranks; a collective)."""
        if self.mesh is None:
            return raster.cpu()
        full = runtime.gather(raster.transpose(0, 1))
        return None if full is None else full.transpose(0, 1).contiguous()

    def run(self, state, t0: int, n_steps: int, *, graph: bool = True):
        """(state, raster [T, H, N] bool, timings) on this device; the
        input state is not modified.  On the card the steps replay this
        program's CUDA graph of `engine.RUN_WINDOW` steps (its first full
        window runs eagerly and is then captured; `self.runner`);
        `graph=False` runs the same steps eagerly.  Over a mesh: the
        rank's block (state [L, ...], raster [T, L, N], timings [T, L]),
        stepped eagerly under the engine's schedule, the wire between
        phase A and phase B; a full state is placed first."""
        spec, plan = self.spec, self.plan
        if self.mesh is not None:
            return self._mesh_program().run(self.place(state), t0, n_steps)
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
        weights at [0, e_start[h, -1])).  Over a mesh, of a gathered
        (full) state."""
        if isinstance(state, event_engine.EventState):
            state = state.base
        if state.w.shape[0] != self.spec.eng.n_shards:
            raise ValueError(f"weight_signature of {state.w.shape[0]} "
                             f"shards: gather the ranks' blocks first "
                             f"(StepProgram.gather)")
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
        (`engine.StimWindow`).  Over a mesh they step the rank's block and
        `exchange` sends and receives over the wire and waits for it."""
        if self._phases is None:
            if self.mesh is not None:
                mp = self._mesh_program()
                fns, exchange, issue = (mp.step_fns(0, PHASE_WINDOW),
                                        mp.exchange, mp.issue)
            else:
                fns = distributed.delivery_step_fns(
                    self.spec, self.plan, 0, PHASE_WINDOW, self.eplan,
                    self.caps, splan=self.splan)
                exchange = distributed.stacked_exchange(
                    self.spec, self.plan, fns, self.hier_groups)
                issue = lambda spiked: Ready(exchange(spiked))
            self._fns, self._issue = fns, issue
            self._phases = distributed.phase_programs(
                fns, exchange, self._with_numerics)
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
        under both schedules.

        Over a mesh the state is the rank's block (a full one is placed),
        the times are this rank's, the exchange's fence includes the wire
        (its wait for the other ranks), `counts` are the job's totals and
        `rasters` are gathered on the primary (None on the other ranks)."""
        self.phase_fns()
        state = self.place(state)
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

    def _no_spikes(self) -> torch.Tensor:
        """The all-False spiked_src of the stepped shards."""
        if self.mesh is not None:
            return self._mesh_program().no_spikes()
        return torch.zeros(self.plan.src_gid.shape, dtype=torch.bool,
                           device=self.device)

    def _time_phases_pipelined(self, state, t0, n_steps, collect_rasters):
        pp, fence, issue = self.phase_fns(), self._fence, self._issue
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
        pending = Ready(self._no_spikes())
        fence()
        for t in range(t0, t0 + n_steps):
            # the residual exchange wait surfaces only here, right before
            # the consuming phase B: everything since its issue was hidden
            c0 = time.perf_counter()
            ss_buf = pending.wait()
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
            pending = issue(spiked)            # issue, do not wait
            times["exchange_s"] += time.perf_counter() - c0
            c0 = time.perf_counter()
            s = pp.phase_a_plasticity(s, spiked, t)
            fence()
            times["phase_a_s"] += time.perf_counter() - c0
            self._tally(tally, spiked, tm, collect_rasters)
        # epilogue flush: deliver the last step's spikes
        c0 = time.perf_counter()
        ss_buf = pending.wait()
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

    def _totals(self, tally, collect_rasters):
        """(rasters or None, counts) read back once, after the loop; over a
        mesh the counts summed over the ranks and the rasters gathered on
        the primary."""
        rasters, spikes, arrivals = tally
        sums = torch.stack([
            torch.stack(x).sum().to(torch.int64) if x else torch.zeros(
                (), dtype=torch.int64, device=self.device)
            for x in (spikes, arrivals)])
        if self.mesh is not None:
            sums = self.mesh.wire.all_reduce_sum(sums)
        counts = dict(spikes=int(sums[0]), arrivals=int(sums[1]))
        if not collect_rasters:
            return None, counts
        if not rasters:
            return [], counts
        stack = torch.stack(rasters)
        if self.mesh is not None:
            stack = self.gather_raster(stack)
            if stack is None:
                return None, counts
        return list(stack.cpu().numpy()), counts
