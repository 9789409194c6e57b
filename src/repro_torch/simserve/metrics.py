"""Per-tenant and service-level counters for `repro_torch.simserve` (port
of `repro.simserve.metrics`).

Everything the scheduler knows is counted here: admissions, queue wait
(in rounds, the service's unit of time), evictions / resumes /
preemptions, tenant-steps advanced, and the program cache's hit / miss /
capture counts that back the zero-recapture criterion.  A capture is the
port's counterpart of a JAX trace: the snapshot keeps the key `traces`
for it, so the two packages' snapshots compare key for key.  The host
time the admissions spend building tenants' tables is `build_s`.
`snapshot()` renders one JSON-able dict; the CLI prints it and the bench
suite lifts aggregate rates (steps/s, rounds/s) from it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ServiceMetrics:
    submitted: int = 0
    admissions: int = 0
    completed: int = 0
    evictions: int = 0
    resumes: int = 0
    preemptions: int = 0
    group_failures: int = 0      # group round executions that raised
    failure_evictions: int = 0   # tenants evicted+requeued by a failure
    failed: int = 0              # tenants retired FAILED (cap exceeded)
    rounds: int = 0              # scheduler rounds executed
    group_rounds: int = 0        # round-program launches (one per live group)
    tenant_rounds: int = 0       # tenant-slot rounds advanced
    tenant_steps: int = 0        # tenant simulation steps advanced (truncated)
    queue_wait_rounds: int = 0   # summed over tenants, one per waiting round
    wall_s: float = 0.0
    build_s: float = 0.0         # host time of admissions' table builds

    def snapshot(self, cache: Optional[object] = None) -> dict:
        d = dataclasses.asdict(self)
        wall = max(self.wall_s, 1e-9)
        d["rounds_per_s"] = self.rounds / wall
        d["tenant_steps_per_s"] = self.tenant_steps / wall
        if cache is not None:
            d["program_cache"] = dict(
                hits=cache.hits, misses=cache.misses,
                builds=cache.builds, traces=cache.trace_counts())
        return d
