"""Tenant lifecycle for `repro_torch.simserve` (port of
`repro.simserve.session`).

A tenant is one independent user simulation: its own `GridConfig` (seed
included), engine layout, requested step count and optional event-backend
capacity overrides.  The session tracks the tenant through

    QUEUED -> RUNNING -> (EVICTED -> QUEUED -> RUNNING)* -> DONE

(or FAILED past the service's failure cap), where every RUNNING stretch
lives in one slot of a shape-key batch group (`batcher.BatchGroup`) and
every EVICTED stretch is a layout-free checkpoint on disk
(`core.checkpoint`).  A resume may change the engine layout
(`TenantSession.eng` vs the original `request.eng`): the checkpoint
machinery reshards, and the correctness contract
(`RasterStream.signature()` == the solo `StepProgram` run of the original
config) is layout-independent by the paper's Table 1 invariant.

Raster output is streamed: each scheduler round pushes one `[take, H, N]`
chunk; `RasterStream` accumulates the extracted (t, gid) events (and
optionally appends them to a CSV via `observables.dump_events_csv`)
without ever holding the full raster.  `raster_events` sorts each chunk by
(t, g) and chunk time ranges never overlap, so the concatenation of chunk
events is the canonical order and `observables.events_signature` over it
equals the full run's `raster_signature`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..core import observables
from ..core.params import EngineConfig, GridConfig

QUEUED = "queued"
RUNNING = "running"
EVICTED = "evicted"
DONE = "done"
FAILED = "failed"   # terminal: exceeded the service's per-tenant failure cap


@dataclasses.dataclass(frozen=True)
class TenantRequest:
    """One user simulation: config + how long to run it.

    `caps` / `cap_ev` override the event backend's compaction and ring
    capacities (they change the program's shapes, so they are part of the
    shape key: tenants with custom capacities batch only with like
    tenants)."""
    name: str
    cfg: GridConfig
    eng: EngineConfig
    n_steps: int
    caps: Optional[Tuple[int, int]] = None   # (c_post, c_src)
    cap_ev: Optional[int] = None             # event ring capacity


class RasterStream:
    """Incremental spike-event accumulation with a streaming signature."""

    def __init__(self, csv_path: Optional[str] = None):
        self._ts: List[np.ndarray] = []
        self._gs: List[np.ndarray] = []
        self.csv_path = csv_path
        self.n_events = 0
        self.chunks = 0

    def push(self, raster: np.ndarray, gid: np.ndarray, t0: int) -> None:
        """Append one raster chunk [T, H, N] starting at absolute step
        `t0`."""
        t, g = observables.raster_events(raster, gid, t0=t0)
        self._ts.append(t)
        self._gs.append(g)
        self.n_events += int(t.shape[0])
        self.chunks += 1
        if self.csv_path:
            observables.dump_events_csv(self.csv_path, raster, gid,
                                        append=True, t0=t0)

    def events(self) -> Tuple[np.ndarray, np.ndarray]:
        if not self._ts:
            z = np.zeros((0,), np.int64)
            return z, z
        return np.concatenate(self._ts), np.concatenate(self._gs)

    def signature(self) -> bytes:
        return observables.events_signature(*self.events())


class TenantSession:
    """Scheduler-side view of one tenant."""

    def __init__(self, request: TenantRequest, submitted_round: int,
                 csv_path: Optional[str] = None):
        self.request = request
        self.status = QUEUED
        self.t = 0                    # steps completed (round-granular)
        self.stream = RasterStream(csv_path)
        self.eng = request.eng        # CURRENT layout (resume may change it)
        self.spec = None              # set on admission (current layout)
        self.planT = None             # the realized plan tree, on the host
        self.ckpt_path: Optional[str] = None
        self.sat_total = 0            # event-backend drop counter at DONE
        self.spike_total = 0
        # metrics
        self.submitted_round = submitted_round
        self.first_admit_round: Optional[int] = None
        self.admitted_round: Optional[int] = None
        self.queue_wait_rounds = 0
        self.rounds = 0
        self.evictions = 0
        self.resumes = 0
        self.failures = 0   # group-execution failures survived (evicted +
        #                     requeued from the last round boundary)

    @property
    def name(self) -> str:
        return self.request.name

    @property
    def done(self) -> bool:
        return self.status == DONE

    def metrics(self) -> dict:
        return dict(name=self.name, status=self.status, t=self.t,
                    n_steps=self.request.n_steps, rounds=self.rounds,
                    evictions=self.evictions, resumes=self.resumes,
                    failures=self.failures,
                    queue_wait_rounds=self.queue_wait_rounds,
                    n_events=self.stream.n_events,
                    spike_total=self.spike_total,
                    sat_total=self.sat_total,
                    shards=self.eng.n_shards,
                    delivery=self.eng.delivery)
