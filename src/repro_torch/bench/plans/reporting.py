"""Merge completed plan cells into a gateable `BENCH_plan_<name>.json`
(port of `repro.bench.plans.reporting`).

The merged report rides the port's `repro_torch.bench.report` schema
(version 1), so its comparator gates plan results exactly like any other
suite:

  deterministic   per-cell spike totals and raster signatures, plus one
                  `identical_<physics group>` flag per group of cells
                  that share physics but differ in execution layout
                  (shards, processes, exchange, schedule, placement,
                  delivery) — the paper's Table 1 invariant as data;
  wall            per-cell wall (the fastest rep) + per-phase
                  A/exchange/B splits (tolerance-compared, never a hard
                  failure; each rep's wall stays in the cell record);
  config          the plan document itself (env-independent, so two
                  machines running the same plan compare);
  extra           full cell records + the runner summary, for dashboards
                  and humans.

A report over an incomplete store is refused unless `allow_partial`
(a partial report would gate as "metric missing" failures downstream and
mask the real problem: unfinished cells).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .. import report as bench_report
from .expand import expand, runtime_env
from .schema import Plan, PlanError
from .store import ResultStore

PHASE_KEYS = ("phase_a_s", "exchange_s", "phase_b_s")


def collect(plan: Plan, store: ResultStore,
            env: Optional[dict] = None) -> Tuple[List[dict], List[str]]:
    """(completed records in plan order, missing cell keys)."""
    cells, _ = expand(plan, env=env)
    records, missing = [], []
    for cell in cells:
        rec = store.load_cell(cell["key"])
        if rec is None or rec.get("hash") != cell["hash"]:
            missing.append(cell["key"])
        else:
            records.append(rec)
    return records, missing


def identity_groups(records: List[dict]) -> Dict[str, dict]:
    """physics_group -> {cells, sigs, identical}: the Table 1 invariant
    across every execution-layout variant the plan swept."""
    groups: Dict[str, dict] = {}
    for rec in records:
        g = rec["cell"].get("physics_group", "ungrouped")
        d = groups.setdefault(g, dict(cells=[], sigs=set()))
        d["cells"].append(rec["key"])
        sig = rec["result"].get("raster_sig")
        if sig:
            d["sigs"].add(sig)
    for d in groups.values():
        d["identical"] = len(d["sigs"]) <= 1
        d["sigs"] = sorted(d["sigs"])
    return groups


def merged_report(plan: Plan, records: List[dict],
                  summary: Optional[dict] = None, device=None) -> dict:
    """Cell records -> BENCH-schema report named `plan_<plan name>`, its
    env that of `device` (default: the card where there is one)."""
    deterministic, wall = {}, {}
    for rec in records:
        key, res = rec["key"], rec["result"]
        if "spikes" in res:
            deterministic[f"{key}_spikes"] = int(res["spikes"])
        if "raster_sig" in res:
            deterministic[f"{key}_sig"] = str(res["raster_sig"])
        if "saturated" in res:
            deterministic[f"{key}_saturated"] = int(res["saturated"])
        if "wall_s" in res:
            wall[f"{key}_wall_s"] = res["wall_s"]
        for pk in PHASE_KEYS:
            if pk in res:
                wall[f"{key}_{pk}"] = res[pk]

    groups = identity_groups(records)
    for g, d in sorted(groups.items()):
        if len(d["cells"]) > 1:
            deterministic[f"identical_{g}"] = bool(d["identical"])

    extra = dict(cells=[dict(key=r["key"], hash=r["hash"], cell=r["cell"],
                             result=r["result"],
                             elapsed_s=r.get("elapsed_s"))
                        for r in records],
                 groups={g: dict(cells=d["cells"], sigs=d["sigs"],
                                 identical=d["identical"])
                         for g, d in groups.items()})
    if summary is not None:
        extra["summary"] = summary
    return bench_report.make_report(f"plan_{plan.name}", plan.to_config(),
                                    deterministic, wall, extra=extra,
                                    device=device)


def load_plan_history(d: str, plan_name: str) -> List[Tuple[str, dict]]:
    """Prior merged reports of THIS plan, in filename order: every
    `BENCH_*.json` under `d` whose report name is `plan_<plan_name>`
    (baselines and archived runs alike).  Feeds the dashboard's
    plan-over-plan section — one (label, report) per prior run."""
    import os

    out: List[Tuple[str, dict]] = []
    if not d or not os.path.isdir(d):
        return out
    for fn in sorted(os.listdir(d)):
        if not (fn.startswith("BENCH_") and fn.endswith(".json")):
            continue
        rep = bench_report.load(os.path.join(d, fn))
        if rep.get("name") == f"plan_{plan_name}":
            out.append((fn[len("BENCH_"):-len(".json")], rep))
    return out


def write_report(plan: Plan, out_root: str, *,
                 allow_partial: bool = False,
                 env: Optional[dict] = None) -> Tuple[str, dict]:
    """Merge the store into BENCH_plan_<name>.json inside the store dir;
    returns (path, report).  Raises PlanError when cells are missing and
    `allow_partial` is not set.  `env` is the hash environment
    (`expand.runtime_env`, default the card's); a "cpu" one makes the
    report's env the CPU's, any other the card's where there is one."""
    env = env if env is not None else runtime_env()
    store = ResultStore(out_root, plan.name)
    records, missing = collect(plan, store, env=env)
    if missing and not allow_partial:
        raise PlanError(
            [f"{len(missing)} of {len(missing) + len(records)} cells "
             f"have no (current) result — run `plan run`/`plan resume` "
             f"first, or pass --partial for a provisional report"]
            + [f"missing: {k}" for k in missing[:10]])
    rep = merged_report(plan, records, summary=store.load_summary(),
                        device="cpu" if env.get("device") == "cpu"
                        else None)
    path = bench_report.save(rep, store.root)
    return path, rep
