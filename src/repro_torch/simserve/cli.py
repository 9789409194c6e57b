"""Command-line entry for `repro_torch.simserve` (port of
`repro.simserve.cli`).

    python -m repro_torch.simserve demo                 # on the card
    python -m repro_torch.simserve soak --reshard       # overload + evict
    python -m repro_torch.simserve demo --device cpu    # plain PyTorch

Both modes submit a fleet of tenants (alternating dense / event delivery:
two shape keys at least), drive the service to completion, check EVERY
tenant's streamed raster signature against the same config run solo
through `StepProgram` on the same device, and print per-tenant metrics
and the service snapshot.  The exit status is non-zero on any signature
mismatch, so a smoke job can gate on it.

`soak` also overloads the slots (queueing and preemption), force-evicts
one running tenant and resumes it a round later, with `--reshard` into a
doubled shard count: the checkpointed reshard under load.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List

from ..core.params import EngineConfig, GridConfig
from . import batcher
from .queue import SimService
from .session import DONE, RUNNING, TenantRequest


def _fleet(args) -> List[TenantRequest]:
    cfg0 = GridConfig(grid_x=args.grid_x, grid_y=args.grid_y,
                      neurons_per_column=args.npc,
                      synapses_per_neuron=args.spn)
    reqs = []
    for i in range(args.tenants):
        cfg = dataclasses.replace(cfg0, seed=args.seed0 + 7919 * i)
        eng = EngineConfig(n_shards=args.shards,
                           delivery="event" if i % 2 else "dense")
        reqs.append(TenantRequest(f"t{i:02d}", cfg, eng, args.steps))
    return reqs


def _verify(svc: SimService, reqs: List[TenantRequest]) -> int:
    failures = 0
    for req in reqs:
        sess = svc.sessions[req.name]
        if sess.status != DONE:
            print(f"  FAIL {req.name}: status={sess.status}")
            failures += 1
            continue
        want = batcher.solo_signature(req.cfg, req.eng, req.n_steps,
                                      req.caps, req.cap_ev,
                                      device=svc.device)
        ok = sess.stream.signature() == want
        failures += 0 if ok else 1
        m = sess.metrics()
        print(f"  {'ok  ' if ok else 'FAIL'} {req.name} "
              f"delivery={m['delivery']} shards={m['shards']} "
              f"events={m['n_events']} chunks={sess.stream.chunks} "
              f"evictions={m['evictions']} resumes={m['resumes']} "
              f"wait={m['queue_wait_rounds']}")
    return failures


def _finish(svc: SimService, reqs: List[TenantRequest],
            snap: dict) -> int:
    print(f"service: rounds={snap['rounds']} "
          f"admissions={snap['admissions']} evictions={snap['evictions']} "
          f"resumes={snap['resumes']} preemptions={snap['preemptions']} "
          f"tenant_steps/s={snap['tenant_steps_per_s']:.0f} "
          f"build_s={snap['build_s']:.2f} ({svc.device.type})")
    print(f"programs: {json.dumps(snap['program_cache'])}")
    print("verifying against solo StepProgram runs...")
    failures = _verify(svc, reqs)
    if failures:
        print(f"{failures} signature mismatch(es)")
        return 1
    print("all tenant signatures bit-identical to solo runs")
    return 0


def _service(args) -> SimService:
    return SimService(slots=args.slots, round_steps=args.round_steps,
                      stream_dir=args.stream_dir, device=args.device)


def cmd_demo(args) -> int:
    reqs = _fleet(args)
    svc = _service(args)
    for r in reqs:
        svc.submit(r)
    snap = svc.run()
    return _finish(svc, reqs, snap)


def cmd_soak(args) -> int:
    reqs = _fleet(args)
    svc = _service(args)
    for r in reqs:
        svc.submit(r)
    # warm-up rounds, then force-evict one running tenant...
    for _ in range(args.evict_round):
        svc.step_round()
    victim = next(s for s in svc.sessions.values()
                  if s.status == RUNNING)
    print(f"soak: evicting {victim.name} at t={victim.t}")
    svc.evict(victim.name)
    svc.step_round()
    # ...and resume it, optionally into a doubled shard count
    eng = None
    if args.reshard:
        eng = dataclasses.replace(victim.eng,
                                  n_shards=victim.eng.n_shards * 2)
        print(f"soak: resuming {victim.name} resharded "
              f"H{victim.eng.n_shards}->H{eng.n_shards}")
    svc.resume(victim.name, eng=eng)
    snap = svc.run()
    return _finish(svc, reqs, snap)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.simserve",
        description="multi-tenant SNN simulation service (PyTorch port)")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in (("demo", cmd_demo), ("soak", cmd_soak)):
        sp = sub.add_parser(name)
        sp.set_defaults(fn=fn)
        sp.add_argument("--tenants", type=int,
                        default=4 if name == "demo" else 6)
        sp.add_argument("--steps", type=int, default=60)
        sp.add_argument("--slots", type=int,
                        default=4 if name == "demo" else 2)
        sp.add_argument("--round-steps", type=int, default=15)
        sp.add_argument("--grid-x", type=int, default=2)
        sp.add_argument("--grid-y", type=int, default=2)
        sp.add_argument("--npc", type=int, default=20)
        sp.add_argument("--spn", type=int, default=10)
        sp.add_argument("--shards", type=int, default=2)
        sp.add_argument("--seed0", type=int, default=2013)
        sp.add_argument("--stream-dir", default=None,
                        help="also append per-tenant event CSVs here")
        sp.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
        if name == "soak":
            sp.add_argument("--evict-round", type=int, default=2)
            sp.add_argument("--reshard", action="store_true",
                            help="resume the evicted tenant at 2x shards")
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
