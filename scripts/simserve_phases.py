"""Run chip_smoke.py's simulation-service phases alone on one card.

    python3 scripts/simserve_phases.py [--kernels] [--host-profile]
                                       [--no-service]

The card's name and power limit (`phase_card`), the kernels
(`phase_build`), then `simserve_check` (the service at 4x4 full width
against each tenant's solo run and `jax_reference.json`) and
`simserve_timed` (`simserve_throughput` at 1, 4 and 8 tenants beside the
same tenants run alone), each printing chip_smoke's JSON line and its
seconds.  With `--kernels`, first the `[t_base]` rows of chip_smoke's
`kernels` phase: the six ops' per-shard step forms at the 8-tenant fold
of the 4x4 plan, against their plain versions and each shard's solo
launch.  With `--host-profile`, last, `simserve_timed`'s 8-tenant cell
(4x4 full width, H = 1) again, one round after its capture under
cProfile: the host functions a round spends its wall in.  `--no-service`
leaves out `simserve_check` and `simserve_timed`.  Exits 1 if a phase
failed.  About four minutes on an H100 (one more with `--kernels` or
`--host-profile`).
"""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    cs.import_port()
    torch = cs.torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = cs.phase_card()
    lookup = cs.phase_build()
    rc = 0
    if "--kernels" in argv:
        t0 = time.perf_counter()
        sp4e = cs._program(cs.GridConfig(grid_x=4, grid_y=4),
                           cs.EngineConfig(delivery="event"))
        rows, failed = cs._t_base_rows(sp4e, lookup)
        print(json.dumps({"phase": "kernels_t_base",
                          "seconds": time.perf_counter() - t0,
                          "rows": rows, "failed": failed}), flush=True)
        rc |= bool(failed)
        del sp4e
        torch.cuda.empty_cache()
    service = () if "--no-service" in argv else (
        ("simserve_check", lambda: cs.phase_simserve_check(card)),
        ("simserve_timed", lambda: cs.phase_simserve_timed(card)))
    for name, run in service:
        t0 = time.perf_counter()
        try:
            run()
        except cs.PhaseFailed as e:
            print(f"{name} FAILED: {e}", file=sys.stderr, flush=True)
            rc = 1
        print(json.dumps({"phase": f"{name}_seconds",
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    if "--host-profile" in argv:
        _host_profile(cs)
    return rc


def _host_profile(cs) -> None:
    """One round of 8 tenants (4x4 full width, H = 1, rounds of 50 steps)
    after the round that captured its graph, under cProfile: the wall and
    the 25 functions with the most cumulative time."""
    import cProfile
    import pstats
    torch, simserve = cs.torch, cs.simserve
    eng = cs.EngineConfig(n_shards=1)
    svc = simserve.SimService(slots=8, round_steps=50, device="cuda")
    for i, cfg in enumerate(cs.simserve_throughput._tenants(
            cs.GridConfig(grid_x=4, grid_y=4), 8)):
        svc.submit(simserve.TenantRequest(f"t{i}", cfg, eng, 300))
    svc.step_round()              # the admissions, the capture
    svc.step_round()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    svc.step_round()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof)
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][3])[:25]
    print(json.dumps({"phase": "host_profile", "tenants": 8,
                      "round_wall_s": wall, "top": [
                          dict(fn=f"{os.path.basename(f)}:{line}:{name}",
                               calls=nc, tottime_s=tt, cumtime_s=ct)
                          for (f, line, name), (_, nc, tt, ct, _) in rows]}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
