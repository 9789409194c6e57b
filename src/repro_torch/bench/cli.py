"""`python -m repro_torch.bench` — run benchmarks on the card (or the
CPU), write BENCH_<name>.json, gate against baselines.

  python -m repro_torch.bench list
  python -m repro_torch.bench run [names...] [--quick] [--out DIR]
                                  [--device cuda|cpu]
  python -m repro_torch.bench compare [names...] --baseline DIR
                                      [--current DIR] [--wall-tol F]
  python -m repro_torch.bench plan run|resume PLANFILE [--out DIR]
                                      [--device cuda|cpu] [--assert-complete]
  python -m repro_torch.bench plan report PLANFILE [--out DIR]
                                      [--device cuda|cpu] [--partial]
                                      [--plan-history DIR]
  python -m repro_torch.bench plan expand PLANFILE [--device cuda|cpu]

`run` with no names executes every registered suite; `compare` exits
nonzero on any deterministic drift (see repro_torch.bench.report for the
policy); the port has no committed baselines yet, so `--baseline` is
required (the JAX package's `benchmarks/baselines` record jax, not
torch, and do not validate here).  `plan` commands drive experiment
plans (repro_torch.bench.plans): `run` executes every incomplete cell of
the plan on the device (so it doubles as resume; `resume` insists prior
results exist), `report` merges the cells into BENCH_plan_<name>.json
plus a static HTML dashboard and exits nonzero when a physics group's
rasters differ, and `expand` prints the cell list without running
anything.  A cell's hash names torch's version and the device, so
`--device` must be the one the cells ran on.  The dashboard charts no
earlier plan reports unless `--plan-history` names a directory (the
committed baselines record jax, not torch).
"""
from __future__ import annotations

import argparse
import sys
import traceback

from . import _summary, registry, report

DEFAULT_OUT = "results/bench_torch"
DEFAULT_PLAN_OUT = "results/plans_torch"


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


def _cmd_plan(args) -> int:
    from . import plans
    from .plans.expand import runtime_env

    try:
        plan = plans.load(args.plan)
    except plans.PlanError as e:
        print(e)
        return 2
    env = runtime_env(args.device)

    if args.plan_cmd == "expand":
        cells, excluded = plans.expand(plan, env=env)
        for c in cells:
            print(f"{c['key']}  hash={c['hash']}  "
                  f"group={c['physics_group']}")
        for ex in excluded:
            print(f"EXCLUDED  {plans.cell_key(ex['cell'])}: "
                  f"{ex['reason']}")
        print(f"{len(cells)} cell(s), {len(excluded)} excluded")
        return 0

    store = plans.ResultStore(args.out, plan.name)
    if args.plan_cmd in ("run", "resume"):
        if args.plan_cmd == "resume" and not store.exists():
            print(f"[plan {plan.name}] nothing to resume under "
                  f"{store.root} — use `plan run`")
            return 2
        summary = plans.run_plan(plan, args.out, device=args.device,
                                 assert_complete=args.assert_complete,
                                 env=env)
        return 0 if summary["ok"] else 1

    # report: merged BENCH json + dashboard
    try:
        path, rep = plans.write_report(plan, args.out,
                                       allow_partial=args.partial, env=env)
    except plans.PlanError as e:
        print(e)
        return 1
    print(f"[plan {plan.name}] wrote {path} "
          f"({len(rep['deterministic'])} deterministic, "
          f"{len(rep['wall'])} wall metrics)")

    from .plans import dashboard as dash
    records = rep["extra"]["cells"]
    prior = plans.load_plan_history(args.plan_history, plan.name)
    html_path = dash.write(
        f"{store.root}/dashboard.html", plan.to_config(), records,
        summary=store.load_summary(), prior_reports=prior)
    print(f"[plan {plan.name}] wrote {html_path} "
          f"({len(records)} cells, {len(prior)} prior plan runs)")

    bad = [g for g, d in rep["extra"]["groups"].items()
           if not d["identical"]]
    if bad:
        print(f"[plan {plan.name}] Table 1 invariant VIOLATED in "
              f"group(s): {bad}")
        return 1
    return 0


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

    pp = sub.add_parser("plan",
                        help="experiment plans (run/resume/report/expand)")
    psub = pp.add_subparsers(dest="plan_cmd", required=True)

    def plan_args(q, out=True):
        q.add_argument("plan", help="plan file (.json, or .yaml with "
                                    "PyYAML)")
        if out:
            q.add_argument("--out", default=DEFAULT_PLAN_OUT,
                           help=f"result store root "
                                f"(default {DEFAULT_PLAN_OUT})")
        q.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="where the cells run (default: the card); "
                            "part of every cell's hash")

    for pcmd, phelp in (("run", "execute every incomplete cell"),
                        ("resume", "like run, but requires prior "
                                   "results to exist")):
        q = psub.add_parser(pcmd, help=phelp)
        plan_args(q)
        q.add_argument("--assert-complete", action="store_true",
                       help="exit nonzero if ANY cell had to execute (the "
                            "resume proof: a second run must skip "
                            "everything)")
    q = psub.add_parser("report",
                        help="merge cells -> BENCH_plan_<name>.json + "
                             "dashboard.html")
    plan_args(q)
    q.add_argument("--plan-history", default="",
                   help="directory of prior BENCH_plan_<name>.json runs "
                        "for the plan-over-plan wall chart (default: none)")
    q.add_argument("--partial", action="store_true",
                   help="report over an incomplete store (missing cells "
                        "are simply absent)")
    q = psub.add_parser("expand", help="print the expanded cell list")
    plan_args(q, out=False)

    args = ap.parse_args(argv)
    return {"list": _cmd_list, "run": _cmd_run, "compare": _cmd_compare,
            "plan": _cmd_plan}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
