"""Shape-keyed program cache and the multi-tenant round (port of
`repro.simserve.batcher`).

The service rests on one observation about the engine: a tenant's seed
enters the computation only through values, its connectivity tables and
initial weights (host-built into the plan and state) and its stimulus
stream.  So every config that differs only by seed runs the same steps on
tables of the same shapes, and a whole fleet of such tenants can share ONE
round program with the per-tenant data side by side.

Where the JAX package stacks the tenants on a leading batch axis and
`vmap`s one tenant's step over it, the port folds them onto the shard
axis: a group of B slots of an H-shard layout is one simulation of B*H
shards.  Every plan and state tensor is [B*H, ...] (slot b's shards are
rows [b*H, (b+1)*H)); each kernel of the dense and event steps launches
once a step for the whole group, and treats each shard (`blockIdx.y`)
independently, so no per-shard reduction order changes; the exchange is
the global spike mask over B * n_total gids, slot b's gids offset by
b * n_total (`engine.FoldedExchange`), so no slot sees another's spikes.
Each slot runs at its own step: a refilled slot starts at t = 0 while its
companions are further on, so the kernels read each shard's step as the
device counter plus its own offset, t_base [B*H] (int64; slot b's rows
hold its tenant's t).  The stimulus rows of each slot are drawn from its
own tenant's `GridConfig`, never from the group's spec, whose seed is 0.

On the card a shape key's round is ONE captured CUDA graph of
`round_steps` steps (`engine.CapturedRun`) over static buffers: a slot
install copies the tenant's plan, its exchange rows and its state into
them in place, and a round writes t_base and the stimulus window and
replays.  On the CPU the same folded steps run as a Python loop through
the plain versions (`kernels.ref.shardwise_step` steps each slot's rows at
its own t), which give the JAX package's bits.

`shape_key` captures what the program depends on: the full GridConfig
with the seed zeroed, the EngineConfig (delivery, shards, placement,
exchange, schedule), and the event-capacity overrides.  The realized
capacities (source-table width `s_cap`, valid-synapse capacity `e_cap`,
event forward-row padding Kf and incoming-row padding Ki) depend on the
drawn connectivity, i.e. on the seed, so each group negotiates
`GroupCaps` (its first tenant's realized capacities plus headroom) and
every admitted tenant's tables are re-padded to them
(`connectivity.repad_shard`; pad entries carry `valid=False` / -1 and are
masked out of every reduction, so padding changes no bit).  A tenant that
overflows the group's capacities forces a regroup (rare by construction
of the headroom, counted in metrics, and exact through the checkpoint
round trip).  Each tenant's raster equals the same config run solo through
`StepProgram`: the service's correctness contract.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import connectivity, engine, event_engine, observables
from ..core.engine import NEG_TIME, map_state, state_tensors
from ..core.event_engine import EventPlan, EventState
from ..core.params import EngineConfig, GridConfig

ShapeKey = Tuple[GridConfig, EngineConfig,
                 Optional[Tuple[int, int]], Optional[int]]


def shape_key(cfg: GridConfig, eng: EngineConfig,
              caps: Optional[Tuple[int, int]] = None,
              cap_ev: Optional[int] = None) -> ShapeKey:
    """Program identity: everything that shapes the round's computation.

    The seed is zeroed out: it reaches the program only through values
    (plan tables, initial weights, the stimulus rows).  Both configs are
    frozen dataclasses, so the tuple is hashable."""
    return (dataclasses.replace(cfg, seed=0), eng, caps, cap_ev)


# ---------------------------------------------------------------------------
# capacity canonicalization
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GroupCaps:
    """Canonical static capacities every member of a batch group is
    padded to.  `cap_ev` is the event-ring capacity implied by the padded
    e_cap (or the tenant override, which is part of the shape key)."""
    e_cap: int
    s_cap: int
    kf: int              # event forward-row padding (0 for dense)
    ki: int              # event incoming-row padding (0 for dense)
    cap_ev: int          # event ring capacity (0 for dense)

    def fits(self, other: "GroupCaps") -> bool:
        return (self.e_cap >= other.e_cap and self.s_cap >= other.s_cap
                and self.kf >= other.kf and self.ki >= other.ki)


def _round_up(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


def measure_caps(spec, planT, state) -> GroupCaps:
    """Realized capacities of one tenant's build."""
    if isinstance(state, EventState):
        _, eplan = planT
        return GroupCaps(e_cap=spec.e_cap, s_cap=spec.s_cap,
                         kf=int(eplan.fwd_rows.shape[-1]),
                         ki=int(eplan.in_rows.shape[-1]),
                         cap_ev=int(state.ev_ring.shape[-1]))
    return GroupCaps(e_cap=spec.e_cap, s_cap=spec.s_cap, kf=0, ki=0,
                     cap_ev=0)


def negotiate(realized: GroupCaps, cap_ev: Optional[int] = None,
              prior: Optional[GroupCaps] = None) -> GroupCaps:
    """Realized capacities -> group capacities with headroom, so sibling
    tenants (different seeds, slightly different realized paddings) fit
    without a regroup.  Deterministic; monotone over `prior` on regroup.
    e_cap is a multiple of 16, so the phase-A kernel's 8-flag ring reads
    stay aligned."""
    e = _round_up(realized.e_cap + realized.e_cap // 8, 16)
    s = _round_up(realized.s_cap + realized.s_cap // 8, 16)
    kf = _round_up(realized.kf + max(2, realized.kf // 4), 4) \
        if realized.kf else 0
    ki = _round_up(realized.ki + max(2, realized.ki // 4), 4) \
        if realized.ki else 0
    if prior is not None:
        e, s = max(e, prior.e_cap), max(s, prior.s_cap)
        kf, ki = max(kf, prior.kf), max(ki, prior.ki)
    if cap_ev is not None:
        cev = cap_ev
    elif realized.cap_ev:
        # the rule event_engine.build_event_plan applies, over padded E
        cev = max(256, _round_up(e // 4, 128))
    else:
        cev = 0
    return GroupCaps(e_cap=e, s_cap=s, kf=kf, ki=ki, cap_ev=cev)


def _pad_rows_to(rows: torch.Tensor, n_rows: int, k: int) -> torch.Tensor:
    """Pad [H, R, K] event rows to [H, n_rows, k] with -1."""
    H, R, K = rows.shape
    out = torch.full((H, n_rows, k), -1, dtype=torch.int32,
                     device=rows.device)
    out[:, :R, :K] = rows
    return out


def build_parts(cfg: GridConfig, eng: EngineConfig,
                caps: Optional[Tuple[int, int]] = None,
                cap_ev: Optional[int] = None,
                pad: Optional[GroupCaps] = None, tables=None, *, device):
    """(spec, planT, state0) for one tenant, on `device`.

    planT is the delivery-dependent plan tree (dense: ShardPlan; event:
    (ShardPlan, EventPlan)).  With `pad`, the connectivity tables are
    re-padded to the group's capacities before the plan and state derive
    from them, so all members of a batch group fold exactly.  `caps` is
    accepted for the JAX package's signature: the compaction capacities
    shape the round, not the parts."""
    if connectivity.parse_mode(eng.connectivity)[0] != "materialized":
        raise ValueError("simserve runs materialized connectivity: a "
                         "streamed tenant's tables are regenerated on the "
                         "card each step, not held in a slot")
    if tables is None:
        tables = connectivity.build_all_shards(cfg, eng)
    if pad is not None:
        tables = [connectivity.repad_shard(t, pad.e_cap, pad.s_cap)
                  for t in tables]
    spec, plan, state = engine.build(cfg, eng, tables=tables, device=device)
    if eng.delivery != "event":
        return spec, plan, state
    eplan, cap_default = event_engine.build_event_plan(
        spec, tables=tables, device=plan.gid.device)
    if pad is not None:
        eplan = EventPlan(
            fwd_rows=_pad_rows_to(eplan.fwd_rows, spec.s_cap, pad.kf),
            in_rows=_pad_rows_to(eplan.in_rows, spec.n_local, pad.ki))
    resolved = cap_ev if cap_ev is not None else (
        pad.cap_ev if pad is not None else cap_default)
    estate = event_engine.init_event_state(spec, state, resolved)
    return spec, (plan, eplan), estate


def base_plan(planT) -> engine.ShardPlan:
    """The ShardPlan of a plan tree (dense: itself; event: its first)."""
    return planT if isinstance(planT, engine.ShardPlan) else planT[0]


def unpad_state(state, e_real: int):
    """Slice a group-padded state back to its realized synapse capacity
    (padding is a suffix the engine never writes), so the layout-free
    checkpoint writer sees the shapes its connectivity rebuild produces."""
    if isinstance(state, EventState):
        return state._replace(base=unpad_state(state.base, e_real))
    return state._replace(w=state.w[..., :e_real],
                          last_arr=state.last_arr[..., :e_real],
                          arr_ring=state.arr_ring[..., :e_real])


def pad_state(state, e_pad: int):
    """Inverse of `unpad_state` for checkpoint-loaded states: grow the
    synapse axis to the group capacity with the engine's init fill values
    (w = 0, last_arr = never, no pending arrivals)."""
    if isinstance(state, EventState):
        return state._replace(base=pad_state(state.base, e_pad))
    d = e_pad - state.w.shape[-1]
    if d == 0:
        return state

    def padf(a, v):
        return torch.cat([a, torch.full(a.shape[:-1] + (d,), v,
                                        dtype=a.dtype, device=a.device)], -1)
    return state._replace(w=padf(state.w, 0.0),
                          last_arr=padf(state.last_arr, NEG_TIME),
                          arr_ring=padf(state.arr_ring, False))


def caps_dict(caps: Optional[Tuple[int, int]]) -> Optional[dict]:
    """(c_post, c_src) tuple -> the dict `StepProgram` takes."""
    if caps is None:
        return None
    return {"c_post": caps[0], "c_src": caps[1]}


def solo_signature(cfg: GridConfig, eng: EngineConfig, n_steps: int,
                   caps: Optional[Tuple[int, int]] = None,
                   cap_ev: Optional[int] = None, *, device=None) -> bytes:
    """Reference signature: the same tenant run alone through
    `StepProgram` (no batching, no padding, no service), on `device` (the
    card by default).  The right-hand side of the service's correctness
    contract."""
    return solo_run(cfg, eng, n_steps, caps, cap_ev, device=device)[0]


def solo_run(cfg: GridConfig, eng: EngineConfig, n_steps: int,
             caps: Optional[Tuple[int, int]] = None,
             cap_ev: Optional[int] = None, *, device=None):
    """(signature, sat_total) of the tenant's solo `StepProgram.run`."""
    from ..core.step_program import StepProgram
    dev = engine.resolve_device(device)
    spec, planT, state = build_parts(cfg, eng, caps, cap_ev, device=dev)
    plan = base_plan(planT)
    eplan = planT[1] if eng.delivery == "event" else None
    prog = StepProgram.from_parts(spec, plan, state0=state, eplan=eplan,
                                  caps=caps_dict(caps))
    st, raster, _ = prog.run(state, 0, n_steps)
    sig = observables.raster_signature(raster.cpu().numpy(),
                                       plan.gid.cpu().numpy())
    sat = int(st.sat.sum()) if isinstance(st, EventState) else 0
    return sig, sat


# ---------------------------------------------------------------------------
# the round program + program cache
# ---------------------------------------------------------------------------


def _fold(x: torch.Tensor, slots: int, device) -> torch.Tensor:
    """[H, ...] -> [slots * H, ...] on `device`: x repeated for each slot."""
    return x.to(device).repeat((slots,) + (1,) * (x.dim() - 1)).contiguous()


def _copy_rows(dst_tree, src_tree, rows: slice) -> None:
    """Every tensor of src_tree into rows `rows` of dst_tree's, in place."""
    for dst, src in zip(state_tensors(dst_tree), state_tensors(src_tree)):
        dst[rows].copy_(src)


class CompiledRound:
    """The round program of one shape key: `slots` tenant slots of an
    H-shard layout folded onto a [slots * H] shard axis, advanced
    `round_steps` steps a call.

    It owns the folded static buffers the steps read: the plan (and event
    rows), the exchange's tables (`engine.FoldedExchange`) and the
    per-shard step offsets `t_base` [slots * H]; `install` copies a slot's
    plan into them in place.  On the card the steps are one CUDA graph,
    captured by the first call and replayed by every later one
    (`engine.CapturedRun` of `round_steps` steps, its runner made at the
    first call); `traces` counts the captures, the counterpart of the JAX
    package's traces, and stays 1 however many tenants, rounds and refills
    ride the program.  On the CPU the same folded steps run as a Python
    loop, the step functions made once at the first call (`traces` = 1
    from then on), their plain versions' segment index and coefficients
    rebuilt after an install."""

    def __init__(self, spec, caps: Optional[Tuple[int, int]],
                 round_steps: int, slots: int, planT, device,
                 gcaps: Optional[GroupCaps] = None):
        # the group's spec carries no seed: nothing of the program may
        # depend on which tenant built it first (the stimulus rows come
        # from each slot's own config)
        self.spec = spec._replace(
            cfg=dataclasses.replace(spec.cfg, seed=0))
        self.caps = caps
        self.gcaps = gcaps      # the group capacities its buffers are sized by
        self.round_steps = int(round_steps)
        self.slots = int(slots)
        self.device = torch.device(device)
        self.H = spec.eng.n_shards
        self.traces = 0
        self.event = spec.eng.delivery == "event"
        plan = base_plan(planT)
        fold = lambda x: _fold(x, self.slots, self.device)
        self.plan = map_state(fold, plan)
        self.eplan = map_state(fold, planT[1]) if self.event else None
        self.exchange = engine.FoldedExchange(
            self.spec, plan.gid.to(self.device), self.slots, spec.s_cap)
        for b in range(self.slots):
            self.exchange.install(b, plan.src_gid.to(self.device))
        self.t_base = torch.zeros(self.slots * self.H, dtype=torch.int64,
                                  device=self.device)
        self.runner = None      # the card's CapturedRun, made by the first call
        self._step = None       # the CPU's folded step
        self._stale = True      # an install since the CPU step was made

    def install(self, b: int, planT) -> None:
        """Slot b's plan tree (padded to the group's capacities) into the
        folded plan and exchange tables, in place."""
        rows = slice(b * self.H, (b + 1) * self.H)
        plan = base_plan(planT)
        _copy_rows(self.plan, plan, rows)
        if self.event:
            _copy_rows(self.eplan, planT[1], rows)
        self.exchange.install(b, plan.src_gid.to(self.device))
        self._stale = True

    def _caps(self) -> tuple:
        cd = caps_dict(self.caps) or {}
        return cd.get("c_post"), cd.get("c_src")

    def _make_runner(self, states) -> engine.CapturedRun:
        """The card's run of `round_steps` steps over the folded buffers,
        each shard at the counter's t plus its t_base."""
        kw = dict(t_base=self.t_base, exchange=self.exchange,
                  window=self.round_steps)
        if self.event:
            return event_engine.make_runner(self.spec, self.plan, self.eplan,
                                            states, *self._caps(), **kw)
        return engine.make_runner(self.spec, self.plan, states, **kw)

    def _make_step(self):
        """The CPU's folded step, the plain versions' constants derived
        from the buffers as they stand."""
        if self.event:
            return event_engine.make_step(
                self.spec, self.plan, self.eplan, self.exchange,
                *self._caps(), t_base=self.t_base)
        return engine.make_step(self.spec, self.plan, self.exchange,
                                t_base=self.t_base)

    def __call__(self, states, t0s, stim_index, stim_amp):
        """Advance the folded `states` (not modified) `round_steps` steps,
        slot b from step t0s[b], with the stimulus rows stim_index /
        stim_amp [round_steps, slots * H, K] -> (states, raster [R,
        slots * H, N]) on this program's device."""
        R = self.round_steps
        t_base = torch.as_tensor(np.repeat(np.asarray(t0s, dtype=np.int64),
                                           self.H))
        if self.device.type == "cuda":
            if self.runner is None:
                self.runner = self._make_runner(states)
            before = self.runner.captures
            out, raster, _ = self.runner.run(
                states, 0, R, stim_index, stim_amp,
                t_base=t_base.to(self.device))
            self.traces += self.runner.captures - before
            return out, raster
        self.t_base.copy_(t_base)
        if self._step is None or self._stale:
            # the plain versions' per-plan constants follow the installs
            self._step = self._make_step()
            self._stale = False
            self.traces = 1
        with engine._numerics(self.device):
            st = engine.clone_state(states)
            raster = []
            for i in range(R):
                spiked, _ = self._step(st, i, stim_index[i], stim_amp[i])
                raster.append(spiked)
        return st, torch.stack(raster)


class ProgramCache:
    """Shape key -> CompiledRound.  One capture per key and capacities,
    ever: a regroup with grown capacities is a miss and a new program (as
    a JAX retrace is)."""

    def __init__(self, round_steps: int, device=None):
        self.round_steps = int(round_steps)
        self.device = device
        self._programs: Dict[ShapeKey, CompiledRound] = {}
        self.hits = 0
        self.misses = 0

    def get(self, key: ShapeKey, spec, planT, slots: int,
            gcaps: GroupCaps) -> CompiledRound:
        prog = self._programs.get(key)
        # the folded buffers are sized by every group capacity (the event
        # rows by kf and ki, the ring by cap_ev): a regroup that grows any
        # of them needs a fresh program
        if prog is not None and prog.gcaps == gcaps:
            self.hits += 1
            return prog
        self.misses += 1
        prog = CompiledRound(spec, caps=key[2],
                             round_steps=self.round_steps, slots=slots,
                             planT=planT, device=self.device, gcaps=gcaps)
        self._programs[key] = prog
        return prog

    @property
    def builds(self) -> int:
        return len(self._programs)

    def trace_counts(self) -> Dict[str, int]:
        return {f"{k[1].delivery}/H{k[1].n_shards}"
                f"/{k[0].grid_x}x{k[0].grid_y}x{k[0].neurons_per_column}":
                p.traces for k, p in self._programs.items()}


# ---------------------------------------------------------------------------
# the live batch group
# ---------------------------------------------------------------------------


class BatchGroup:
    """Live batch of same-shape tenants: the folded state [slots * H, ...]
    and the slots.

    The plan lives in the program's static buffers (`CompiledRound`), the
    state here: a round commits its state only when the program returns.
    Free slots keep whatever payload last occupied them (a valid plan and
    state of the same shape, at t = 0 with no stimulus; their output is
    ignored), so the batch width never changes and the program is never
    recaptured.  `prog` is the seam a round goes through (tests replace
    it to inject failures); installs write the buffers of the program the
    group was made with."""

    def __init__(self, key: ShapeKey, prog: CompiledRound, slots: int,
                 caps: GroupCaps, planT, state):
        self.key = key
        self.prog = prog
        self._buffers = prog
        self.slots = int(slots)
        self.caps = caps
        self.H = key[1].n_shards
        self.device = prog.device
        self.sessions = [None] * self.slots
        self.admit_round = [0] * self.slots     # scheduler round of admission
        self.states = map_state(
            lambda x: _fold(x, self.slots, self.device), state)
        # the stimulus rows' width (columns a shard x events a column)
        self._stim_width = None

    def free_slot(self) -> Optional[int]:
        for b, s in enumerate(self.sessions):
            if s is None:
                return b
        return None

    def live(self):
        return [(b, s) for b, s in enumerate(self.sessions)
                if s is not None]

    def install(self, b: int, sess, planT, state, round_no: int) -> None:
        self._buffers.install(b, planT)
        _copy_rows(self.states, state, slice(b * self.H, (b + 1) * self.H))
        self.sessions[b] = sess
        self.admit_round[b] = round_no

    def release(self, b: int) -> None:
        self.sessions[b] = None

    def slot_state(self, b: int):
        rows = slice(b * self.H, (b + 1) * self.H)
        return map_state(lambda x: x[rows], self.states)

    def _stimulus(self, R: int):
        """Each slot's stimulus rows of its next R steps, drawn from its own
        tenant's config and realized plan -> (index, amp) [R, slots * H,
        K] on the group's device; a free slot's rows are empty (amp 0)."""
        spec = self._buffers.spec
        idx, amp = [], []
        for b, sess in enumerate(self.sessions):
            if sess is None:
                idx.append(None)
                amp.append(None)
                continue
            i, a = engine.stim_rows(spec, base_plan(sess.planT), sess.t, R,
                                    cfg=sess.request.cfg)
            idx.append(i.to(self.device))
            amp.append(a.to(self.device))
            self._stim_width = i.shape[-1]
        K = self._stim_width
        for b in range(self.slots):
            if idx[b] is None:
                idx[b] = torch.zeros((R, self.H, K), dtype=torch.int64,
                                     device=self.device)
                amp[b] = torch.zeros((R, self.H, K), dtype=torch.float32,
                                     device=self.device)
        return torch.cat(idx, 1).contiguous(), torch.cat(amp, 1).contiguous()

    def round(self) -> np.ndarray:
        """Advance every slot `round_steps` steps; returns the stacked
        raster [slots, R, H, N] (host numpy)."""
        R = self._buffers.round_steps
        t0s = [s.t if s is not None else 0 for s in self.sessions]
        stim_index, stim_amp = self._stimulus(R)
        states, raster = self.prog(self.states, t0s, stim_index, stim_amp)
        self.states = states
        N = raster.shape[-1]
        return raster.view(R, self.slots, self.H, N).permute(
            1, 0, 2, 3).cpu().numpy()


__all__ = ["BatchGroup", "CompiledRound", "GroupCaps", "ProgramCache",
           "ShapeKey", "base_plan", "build_parts", "caps_dict",
           "measure_caps", "negotiate", "pad_state", "shape_key",
           "solo_run", "solo_signature", "unpad_state"]
