"""`python -m repro_torch.bench` — run benchmarks on the card (or the
CPU), write BENCH_<name>.json, gate against baselines.

  python -m repro_torch.bench list
  python -m repro_torch.bench run [names...] [--quick] [--out DIR]
                                  [--device cuda|cpu]
  python -m repro_torch.bench compare [names...] --baseline DIR
                                      [--current DIR] [--wall-tol F]

`run` with no names executes every registered suite; `compare` exits
nonzero on any deterministic drift (see repro_torch.bench.report for the
policy); the port has no committed baselines yet, so `--baseline` is
required (the JAX package's `benchmarks/baselines` record jax, not
torch, and do not validate here). The JAX package's `plan` commands are
not ported (ROADMAP queue 1, item 12).
"""
from __future__ import annotations

import argparse
import sys
import traceback

from . import _summary, registry, report

DEFAULT_OUT = "results/bench_torch"


def _cmd_list(args) -> int:
    for name in sorted(registry.BENCHES):
        print(f"{name:16s} {registry.BENCHES[name].doc}")
    for name, item in sorted(registry.NOT_PORTED.items()):
        print(f"{name:16s} not ported yet (ROADMAP queue 1, {item})")
    return 0


def _cmd_run(args) -> int:
    names = args.names or registry.default_names()
    failures = []
    for name in names:
        print(f"\n===== {name} =====", flush=True)
        try:
            rep = registry.get(name).fn(args.quick, args.device)
            path = report.save(rep, args.out)
            print(f"[bench] wrote {path} "
                  f"({len(rep['deterministic'])} deterministic, "
                  f"{len(rep['wall'])} wall metrics)", flush=True)
        except Exception as e:
            failures.append(name)
            print(f"[bench] {name} FAILED: {e}", flush=True)
            traceback.print_exc()
    if failures:
        print(f"\nFAILURES: {failures}")
        return 1
    print(f"\nall {len(names)} benchmark suite(s) completed")
    return 0


def _cmd_compare(args) -> int:
    res = report.compare_dirs(args.current, args.baseline,
                              names=args.names or None,
                              wall_tol=args.wall_tol)
    rendered = res.render()
    print(rendered)
    _summary.append(_summary.code_block(
        rendered, title=f"bench compare ({args.current} vs "
                        f"{args.baseline})"))
    return 0 if res.ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list registered benchmark suites")

    rp = sub.add_parser("run", help="run suites, write BENCH_*.json")
    rp.add_argument("names", nargs="*",
                    help="suite names (default: all registered)")
    rp.add_argument("--quick", action="store_true",
                    help="CI-sized grids/steps")
    rp.add_argument("--out", default=DEFAULT_OUT,
                    help=f"output directory (default {DEFAULT_OUT})")
    rp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the suites run (default: the card)")

    cp = sub.add_parser("compare",
                        help="gate current reports against baselines")
    cp.add_argument("names", nargs="*",
                    help="suite names (default: every baseline present)")
    cp.add_argument("--current", default=DEFAULT_OUT,
                    help=f"directory with fresh reports "
                         f"(default {DEFAULT_OUT})")
    cp.add_argument("--baseline", required=True,
                    help="directory with the baseline reports")
    cp.add_argument("--wall-tol", type=float, default=0.5,
                    help="relative wall-clock warn threshold "
                         "(default 0.5 = ±50%%)")

    args = ap.parse_args(argv)
    return {"list": _cmd_list, "run": _cmd_run,
            "compare": _cmd_compare}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
