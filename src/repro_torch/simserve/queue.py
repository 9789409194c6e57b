"""Admission queue and lockstep-round scheduler for `repro_torch.simserve`
(port of `repro.simserve.queue`).

Continuous batching with static shapes: tenants are admitted into
fixed-width batch groups (one per shape key), all live groups advance in
lockstep rounds of `round_steps` simulation steps, and slots refill from
the FIFO queue between rounds, so every eviction and checkpoint happens
at an exact round boundary and the checkpoints' bit-identity carries over
unchanged.

Scheduling policy:
  - FIFO admission per shape key; a group is created on first demand.
  - Saturation preemption (optional): when a queued tenant's group is
    full, the occupant with the most completed steps that has been
    resident >= `min_resident_rounds` is evicted to a checkpoint and
    re-queued: round-robin time-sharing that keeps every tenant making
    progress under overload.
  - Explicit `evict(name)` parks a tenant on disk (status EVICTED) until
    `resume(name, eng=...)` re-queues it, possibly into another shard
    layout: the checkpoint is layout-free (`core.checkpoint`), so a resume
    reshards.
  - A tenant whose realized capacities overflow its group's negotiated
    padding triggers a regroup: the occupants are checkpointed and
    re-queued, and the group re-forms with grown capacities (a new
    program; rare, as `negotiate`'s headroom absorbs seed-to-seed
    variation; counted in metrics).
  - Graceful degradation: a group whose round raises loses the group, not
    the service: its occupants are evicted to their last round-boundary
    state and re-queued (`_fail_group`); a tenant failing past
    `max_tenant_failures` retires FAILED.  Other groups and queued tenants
    are untouched, and the survivors' outputs keep every bit.

Every tenant's streamed raster signature equals the same config run solo
through `StepProgram`, whatever its batch companions, refill order or
evict / resume (and reshard) cycles: the paper's Table 1 invariant
applied to many tenants.

Each admission builds the tenant's connectivity tables on the host, as
the JAX service does (`metrics.build_s` totals that time); the realized
plan stays on the host (its gid table, its columns for the stimulus, the
checkpoint's layout), and only the group's folded buffers live on the
service's device.
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, List, Optional

import torch

from ..core import checkpoint, connectivity, engine
from ..core.params import EngineConfig
from . import batcher
from .metrics import ServiceMetrics
from .session import (DONE, EVICTED, FAILED, QUEUED, RUNNING,
                      TenantRequest, TenantSession)

_HOST = torch.device("cpu")


class SimService:
    """Multi-tenant simulation service over shape-keyed batch groups, on
    `device` (the card by default; it raises without one: pass
    `device="cpu"` for the plain PyTorch path)."""

    def __init__(self, slots: int = 4, round_steps: int = 20,
                 ckpt_dir: Optional[str] = None,
                 stream_dir: Optional[str] = None,
                 preempt: bool = True, min_resident_rounds: int = 2,
                 max_tenant_failures: int = 2, *, device=None):
        self.device = engine.resolve_device(device)
        self.slots = int(slots)
        self.round_steps = int(round_steps)
        self.preempt = preempt
        self.min_resident_rounds = int(min_resident_rounds)
        self.max_tenant_failures = int(max_tenant_failures)
        self.cache = batcher.ProgramCache(round_steps, device=self.device)
        self.groups: Dict[batcher.ShapeKey, batcher.BatchGroup] = {}
        self.queue: List[TenantSession] = []
        self.sessions: Dict[str, TenantSession] = {}
        self.metrics = ServiceMetrics()
        self.round_no = 0
        self.regroups = 0
        # without a ckpt_dir the service owns a temporary directory, removed
        # with the service, and keeps only each tenant's latest checkpoint
        self._own_ckpt = (None if ckpt_dir else
                          tempfile.TemporaryDirectory(prefix="simserve_"))
        self._ckpt_dir = ckpt_dir or self._own_ckpt.name
        self._stream_dir = stream_dir

    # -- client surface --------------------------------------------------

    def submit(self, request: TenantRequest) -> TenantSession:
        if request.name in self.sessions:
            raise ValueError(f"tenant {request.name!r} already exists")
        csv = (os.path.join(self._stream_dir, f"{request.name}.csv")
               if self._stream_dir else None)
        sess = TenantSession(request, submitted_round=self.round_no,
                             csv_path=csv)
        self.sessions[request.name] = sess
        self.queue.append(sess)
        self.metrics.submitted += 1
        return sess

    def evict(self, name: str) -> str:
        """Park a tenant on disk (between rounds); returns the checkpoint
        path.  The tenant stays EVICTED until `resume`."""
        sess = self.sessions[name]
        if sess.status != RUNNING:
            raise ValueError(f"tenant {name!r} is {sess.status}, not "
                             f"running")
        group, b = self._locate(sess)
        self._evict_slot(group, b, requeue=False)
        return sess.ckpt_path

    def resume(self, name: str,
               eng: Optional[EngineConfig] = None) -> TenantSession:
        """Re-queue an evicted tenant, optionally into another engine
        layout (a reshard: the checkpoint is layout-free)."""
        sess = self.sessions[name]
        if sess.status != EVICTED:
            raise ValueError(f"tenant {name!r} is {sess.status}, not "
                             f"evicted")
        if eng is not None:
            if eng.delivery != sess.eng.delivery:
                raise ValueError("cannot change delivery on resume: the "
                                 "backends' fp32 summation orders differ")
            sess.eng = eng
        sess.status = QUEUED
        sess.resumes += 1
        self.metrics.resumes += 1
        self.queue.append(sess)
        return sess

    def run(self, max_rounds: int = 100_000) -> dict:
        """Drive rounds until every submitted tenant is DONE (or parked
        EVICTED with nothing left to schedule).  Returns the metrics
        snapshot."""
        t0 = time.perf_counter()
        for _ in range(max_rounds):
            if not self.step_round():
                break
        self.metrics.wall_s += time.perf_counter() - t0
        return self.metrics.snapshot(self.cache)

    # -- the lockstep round ----------------------------------------------

    def step_round(self) -> bool:
        """One scheduler round: refill slots from the queue, advance every
        live group `round_steps` steps, stream chunks, retire completed
        tenants.  Returns False when nothing is runnable."""
        self._refill()
        live_groups = [g for g in self.groups.values() if g.live()]
        if not live_groups and not self.queue:
            return False
        self.round_no += 1
        self.metrics.rounds += 1
        for group in live_groups:
            try:
                rasters = group.round()      # [slots, R, H, N]
            except Exception as err:         # noqa: BLE001: degrade, don't die
                self._fail_group(group, err)
                continue
            self.metrics.group_rounds += 1
            for b, sess in group.live():
                take = min(self.round_steps,
                           sess.request.n_steps - sess.t)
                chunk = rasters[b, :take]
                gid = batcher.base_plan(sess.planT).gid.numpy()
                sess.stream.push(chunk, gid, t0=sess.t)
                sess.spike_total += int(chunk.sum())
                sess.t += self.round_steps
                sess.rounds += 1
                self.metrics.tenant_rounds += 1
                self.metrics.tenant_steps += take
                if sess.t >= sess.request.n_steps:
                    self._complete(group, b, sess)
        for sess in self.queue:
            sess.queue_wait_rounds += 1
            self.metrics.queue_wait_rounds += 1
        return True

    # -- internals -------------------------------------------------------

    def _locate(self, sess: TenantSession):
        for group in self.groups.values():
            for b, s in group.live():
                if s is sess:
                    return group, b
        raise KeyError(sess.name)

    def _session_key(self, sess: TenantSession) -> batcher.ShapeKey:
        req = sess.request
        return batcher.shape_key(req.cfg, sess.eng, req.caps, req.cap_ev)

    def _refill(self) -> None:
        pending, self.queue = self.queue, []
        deferred: List[TenantSession] = []
        while pending:
            sess = pending.pop(0)
            if not self._try_admit(sess):
                deferred.append(sess)
        # re-queued preemption victims land behind deferred waiters
        self.queue = deferred + self.queue

    def _try_admit(self, sess: TenantSession) -> bool:
        key = self._session_key(sess)
        group = self.groups.get(key)
        b = group.free_slot() if group is not None else None
        if group is not None and b is None:
            if not self.preempt:
                return False
            b = self._preempt_slot(group, sess)
            if b is None:
                return False

        req = sess.request
        c0 = time.perf_counter()
        tables = connectivity.build_all_shards(req.cfg, sess.eng)
        spec_r, planT_r, state_r = batcher.build_parts(
            req.cfg, sess.eng, req.caps, req.cap_ev, tables=tables,
            device=_HOST)
        caps_r = batcher.measure_caps(spec_r, planT_r, state_r)

        if group is not None and not group.caps.fits(caps_r):
            # regroup: grow the negotiated capacities, park the current
            # occupants (exact through the checkpoint), re-form the group
            self.regroups += 1
            grown = batcher.negotiate(caps_r, cap_ev=req.cap_ev,
                                      prior=group.caps)
            for ob, _ in group.live():
                self._evict_slot(group, ob, requeue=True)
            del self.groups[key]
            group, b = None, None
            gcaps = grown
        elif group is None:
            gcaps = batcher.negotiate(caps_r, cap_ev=req.cap_ev)
        else:
            gcaps = group.caps

        spec_p, planT_p, state_p = batcher.build_parts(
            req.cfg, sess.eng, req.caps, req.cap_ev, pad=gcaps,
            tables=tables, device=_HOST)
        self.metrics.build_s += time.perf_counter() - c0
        if sess.ckpt_path is not None:
            state_p = self._load_state(sess, spec_r, planT_r, gcaps)

        if group is None:
            prog = self.cache.get(key, spec_p, planT_p, self.slots, gcaps)
            group = batcher.BatchGroup(key, prog, self.slots, gcaps,
                                       planT_p, state_p)
            self.groups[key] = group
            b = 0
        elif b is None:                      # group was just re-formed
            b = group.free_slot()

        sess.spec, sess.planT = spec_r, planT_r
        group.install(b, sess, planT_p, state_p, self.round_no)
        sess.status = RUNNING
        sess.admitted_round = self.round_no
        if sess.first_admit_round is None:
            sess.first_admit_round = self.round_no
        self.metrics.admissions += 1
        return True

    def _load_state(self, sess: TenantSession, spec_r, planT_r,
                    gcaps: batcher.GroupCaps):
        """Checkpoint -> realized-layout state -> group-padded state."""
        plan_r = batcher.base_plan(planT_r)
        cap_ev = gcaps.cap_ev if sess.eng.delivery == "event" else None
        state, t = checkpoint.load(sess.ckpt_path, spec_r, plan_r,
                                   cap_ev=cap_ev)
        assert t == sess.t, (t, sess.t)
        return batcher.pad_state(state, gcaps.e_cap)

    def _preempt_slot(self, group: batcher.BatchGroup,
                      waiter: TenantSession) -> Optional[int]:
        cands = [(b, s) for b, s in group.live()
                 if self.round_no - group.admit_round[b]
                 >= self.min_resident_rounds
                 and s.t > waiter.t]
        if not cands:
            return None
        b, _ = max(cands, key=lambda bs: (bs[1].t, -bs[0]))
        self._evict_slot(group, b, requeue=True)
        self.metrics.preemptions += 1
        return b

    def _evict_slot(self, group: batcher.BatchGroup, b: int,
                    requeue: bool) -> None:
        sess = group.sessions[b]
        state = batcher.unpad_state(group.slot_state(b),
                                    sess.spec.e_cap)
        path = os.path.join(self._ckpt_dir,
                            f"{sess.name}_t{sess.t}.npz")
        plan_r = batcher.base_plan(sess.planT)
        checkpoint.save(path, sess.spec, plan_r, state, sess.t)
        self._drop_ckpt(sess, keep=path)
        sess.ckpt_path = path
        group.release(b)
        sess.evictions += 1
        self.metrics.evictions += 1
        if requeue:
            sess.status = QUEUED
            self.queue.append(sess)
        else:
            sess.status = EVICTED

    def _fail_group(self, group: batcher.BatchGroup, err: Exception) -> None:
        """Graceful degradation: a group whose round raised loses the
        group, not the service.  `BatchGroup.round` commits its state only
        when the round program returns, so every slot still holds the
        tenant's last round-boundary state, which is what the eviction
        path checkpoints.  Occupants are evicted and re-queued (they
        re-admit into a fresh group, replaying nothing and changing no
        output bit); a tenant that keeps failing past
        `max_tenant_failures` retires FAILED instead of retrying forever.
        The dead group is dropped (a fresh one forms on re-admission); the
        round program stays cached: it is shape-keyed, not group-owned."""
        self.metrics.group_failures += 1
        print(f"[simserve] group {group.key} round failed: {err!r}; "
              f"evicting {len(group.live())} tenant(s)", flush=True)
        for b, sess in group.live():
            sess.failures += 1
            if sess.failures > self.max_tenant_failures:
                group.release(b)
                sess.status = FAILED
                self.metrics.failed += 1
                print(f"[simserve] tenant {sess.name!r} FAILED after "
                      f"{sess.failures} group failures", flush=True)
                continue
            self._evict_slot(group, b, requeue=True)
            self.metrics.failure_evictions += 1
        self.groups.pop(group.key, None)

    def _complete(self, group: batcher.BatchGroup, b: int,
                  sess: TenantSession) -> None:
        state = group.slot_state(b)
        if hasattr(state, "sat"):
            sess.sat_total = int(state.sat.sum())
        group.release(b)
        sess.status = DONE
        self._drop_ckpt(sess)
        self.metrics.completed += 1

    def _drop_ckpt(self, sess: TenantSession, keep: Optional[str] = None):
        """Remove the tenant's superseded checkpoint from the service's own
        directory (a ckpt_dir the caller gave keeps every file)."""
        old = sess.ckpt_path
        if self._own_ckpt is not None and old is not None and old != keep:
            os.remove(old)
            sess.ckpt_path = None


__all__ = ["SimService", "TenantRequest", "DONE", "EVICTED", "FAILED",
           "QUEUED", "RUNNING"]
