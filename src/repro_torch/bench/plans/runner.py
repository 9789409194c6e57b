"""Plan runner: execute expanded cells resumably, one result file each
(port of `repro.bench.plans.runner`).

Single-process cells (`nprocs == 1`) run each in a fresh interpreter
(`bench.subproc.run_subprocess`): the cell builds a `StepProgram` with its
H shards stacked on one device (the card unless the runner's device is
"cpu"), runs it once (on the card that run captures the graph), then
`reps` timed runs from the same state, each between two device
synchronisations, and reports the fastest as `wall_s` and every rep's
wall as `wall_reps_s` (their spread), spike totals, the raster signature
and — when the plan budgets phase steps — the per-phase A/exchange/B
split from `StepProgram.time_phases`.  Multi-process cells go through
`repro_torch.cluster` (`cluster.cli.run_plan_cell`, the launcher and
worker the cluster_scaling suite uses) on the runner's device.

Every completed cell is persisted through `ResultStore` keyed by its
content hash; a second `run` (or `resume`) skips completed cells and the
exit summary counts executed/skipped/failed — `assert_complete` turns
"anything executed" into a failure, the proof that resume covers the
plan.  Failed cells are reported, leave no result file, and make the
runner exit nonzero; everything else still runs, so one flaky point
never costs the whole sweep.
"""
from __future__ import annotations

import json
import time
from typing import Callable, List, Optional

from .. import _summary
from .expand import expand, runtime_env
from .schema import Plan
from .store import ResultStore

# executed in a fresh interpreter; the cell dict and the device are
# substituted as JSON (no .format: the source has braces)
_CELL_SRC = """
import json, time
import torch
from repro_torch.core import EngineConfig, GridConfig, StepProgram, observables

cell = json.loads(__CELL_JSON__)
device = __DEVICE__
gx, gy = (int(v) for v in cell["grid"].split("x"))
cfg = GridConfig(grid_x=gx, grid_y=gy,
                 neurons_per_column=cell["neurons_per_column"],
                 synapses_per_neuron=cell["synapses_per_neuron"],
                 seed=cell["seed"], connectivity=cell["profile"],
                 stim_events_per_ms_per_column=cell["stim_events"],
                 stim_amplitude=cell["stim_amplitude"])
eng = EngineConfig(n_shards=cell["shards"], exchange=cell["exchange"],
                   exchange_schedule=cell["exchange_schedule"],
                   placement=cell["placement"], delivery=cell["delivery"],
                   connectivity=cell["connectivity"])
sp = StepProgram(cfg, eng, device=device)
state = sp.init_state()


def sync():
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


sp.run(state, 0, cell["steps"])          # on the card: captures the graph
sync()
walls = []
for _ in range(cell["reps"]):
    sync()
    t0 = time.perf_counter()
    state_f, raster, _ = sp.run(state, 0, cell["steps"])
    sync()
    walls.append(time.perf_counter() - t0)
raster = raster.cpu().numpy()
res = dict(wall_s=min(walls), wall_reps_s=walls, spikes=int(raster.sum()),
           rate_hz=round(observables.mean_rate_hz(raster,
                                                  cfg.n_neurons), 3),
           raster_sig=observables.raster_signature(
               raster, sp.plan.gid.cpu().numpy()).hex())
if cell["delivery"] == "event":
    res["saturated"] = int(state_f.sat.sum())
if cell["phase_steps"]:
    _, times, _, counts = sp.time_phases(state, 0, cell["phase_steps"])
    res.update(times)
    res["phase_steps"] = cell["phase_steps"]
    res["arrivals"] = int(counts["arrivals"])
print("PLAN_CELL " + json.dumps(res))
"""

RESULT_PREFIX = "PLAN_CELL "


class CellError(RuntimeError):
    pass


def _finalize(cell: dict, res: dict) -> dict:
    """Uniform derived metrics: the paper's normalized elapsed time per
    synaptic event (each spike fans out to synapses_per_neuron targets),
    computable identically for local and cluster cells."""
    events = res.get("spikes", 0) * cell["synapses_per_neuron"]
    if res.get("wall_s") and events:
        res["time_per_syn_event_s"] = float(
            f"{res['wall_s'] / events:.3e}")
    return res


def run_local_cell(cell: dict, timeout: Optional[float] = None,
                   device: str = "cuda") -> dict:
    """One fresh-interpreter cell, its shards stacked on `device`."""
    from ..subproc import run_subprocess
    code = (_CELL_SRC
            .replace("__CELL_JSON__", repr(json.dumps(cell, sort_keys=True)))
            .replace("__DEVICE__", repr(str(device))))
    out = run_subprocess(code, timeout=timeout)
    for line in out.splitlines():
        if line.startswith(RESULT_PREFIX):
            return _finalize(cell, json.loads(line[len(RESULT_PREFIX):]))
    raise CellError(f"no {RESULT_PREFIX!r} line in cell output:\n"
                    f"{out[-2000:]}")


def run_cluster_cell(cell: dict, timeout: Optional[float] = None,
                     device: str = "cuda") -> dict:
    """One real multi-process cell via the repro_torch.cluster launcher."""
    from ...cluster import cli as cluster_cli
    row = cluster_cli.run_plan_cell(cell, timeout=timeout, device=device)
    keep = ("wall_s", "spikes", "rate_hz", "raster_sig", "saturated",
            "phase_a_s", "exchange_s", "phase_b_s", "per_proc")
    res = {k: row[k] for k in keep if k in row}
    if cell["phase_steps"]:
        res["phase_steps"] = cell["phase_steps"]
    return _finalize(cell, res)


def execute_cell(cell: dict, timeout: Optional[float] = None,
                 device: str = "cuda") -> dict:
    if cell["nprocs"] > 1:
        return run_cluster_cell(cell, timeout=timeout, device=device)
    return run_local_cell(cell, timeout=timeout, device=device)


def run_plan(plan: Plan, out_root: str, *, device: str = "cuda",
             assert_complete: bool = False,
             executor: Optional[Callable[[dict], dict]] = None,
             env: Optional[dict] = None,
             log: Callable[[str], None] = print) -> dict:
    """Execute every incomplete cell of `plan`; returns the exit summary

      {plan, total, executed, skipped, failed, excluded, ok,
       executed_keys, skipped_keys, failed_keys}

    `ok` is False when any cell failed, or when `assert_complete` was set
    and anything had to execute (the resume proof).  The cells run on
    `device` ("cuda" or "cpu"), which the hash environment names.
    `executor` overrides cell execution (tests inject fakes); `env`
    overrides the hash environment the same way.
    """
    env = env if env is not None else runtime_env(device)
    executor = executor or (
        lambda c: execute_cell(c, timeout=plan.budgets["timeout_s"],
                               device=device))
    cells, excluded = expand(plan, env=env)
    store = ResultStore(out_root, plan.name)

    executed, skipped, failed = [], [], []
    t_start = time.time()
    for i, cell in enumerate(cells):
        tag = f"[plan {plan.name}] cell {i + 1}/{len(cells)} {cell['key']}"
        if store.completed(cell["key"], cell["hash"]):
            skipped.append(cell["key"])
            log(f"{tag}: complete, skipping (hash {cell['hash']})")
            continue
        t0 = time.time()
        try:
            result = executor(cell)
        except Exception as e:
            failed.append(cell["key"])
            log(f"{tag}: FAILED after {time.time() - t0:.1f}s: "
                f"{str(e)[:500]}")
            continue
        record = dict(key=cell["key"], hash=cell["hash"], cell=cell,
                      env=env, result=result,
                      elapsed_s=round(time.time() - t0, 3))
        store.save_cell(record)
        executed.append(cell["key"])
        log(f"{tag}: done in {record['elapsed_s']}s "
            f"(wall {result.get('wall_s')}s, "
            f"sig {str(result.get('raster_sig'))[:16]})")

    summary = dict(plan=plan.name, total=len(cells),
                   executed=len(executed), skipped=len(skipped),
                   failed=len(failed), excluded=len(excluded),
                   executed_keys=executed, skipped_keys=skipped,
                   failed_keys=failed,
                   wall_s=round(time.time() - t_start, 3),
                   ok=not failed and not (assert_complete and executed))
    store.save_summary(summary)
    log(f"[plan {plan.name}] PLAN_SUMMARY " + json.dumps(
        {k: summary[k] for k in ("plan", "total", "executed", "skipped",
                                 "failed", "excluded", "ok")}))
    if assert_complete and executed:
        log(f"[plan {plan.name}] --assert-complete: {len(executed)} "
            f"cell(s) had to execute — resume did NOT cover the plan")
    _summary.append(_summary_markdown(plan, summary, excluded))
    return summary


def _summary_markdown(plan: Plan, summary: dict,
                      excluded: List[dict]) -> str:
    """Runner summary for a CI job's page ($GITHUB_STEP_SUMMARY)."""
    lines = [f"### experiment plan `{plan.name}`",
             "",
             f"| total | executed | skipped | failed | excluded |",
             f"|---|---|---|---|---|",
             f"| {summary['total']} | {summary['executed']} | "
             f"{summary['skipped']} | {summary['failed']} | "
             f"{summary['excluded']} |",
             ""]
    if summary["failed_keys"]:
        lines.append("failed cells: " + ", ".join(
            f"`{k}`" for k in summary["failed_keys"]))
    status = "resumed clean" if summary["executed"] == 0 else (
        f"{summary['executed']} executed")
    lines.append(f"outcome: **{'OK' if summary['ok'] else 'FAIL'}** "
                 f"({status}, {summary['wall_s']}s)")
    return "\n".join(lines)
