"""Aggregate per-process worker results into scaling rows and a
BENCH-schema report (the port's `repro.cluster.report`).

Workers emit one `CLUSTER_RESULT {json}` line each
(`repro_torch.cluster.worker`); `summarize_point` folds the P lines of
one launch into a single row, cross-checking that every process reports
the same raster and weight signatures, and `scaling_report` turns a
sweep's rows into the `BENCH_cluster_scaling.json` document in the
schema of the port's `bench.report` (`make_report`, `validate`): raster
signatures in `deterministic` (the paper's Table 1 invariant over the
process axis), per-process phase A / exchange / phase B walls in `wall`
(paper Figs. 5-8), and the environment of the device the workers ran on.
"""
from __future__ import annotations

import json
from typing import Dict, List, Sequence

from ..bench import report as bench_report
from .worker import RESULT_PREFIX

PHASE_KEYS = ("phase_a_s", "exchange_s", "phase_b_s")


def parse_worker_outputs(outputs: Sequence[str]) -> List[dict]:
    """One result dict per worker stdout, ordered by process id."""
    results = []
    for i, out in enumerate(outputs):
        lines = [ln for ln in out.splitlines()
                 if ln.startswith(RESULT_PREFIX)]
        if len(lines) != 1:
            raise ValueError(f"worker {i}: expected exactly one "
                             f"{RESULT_PREFIX!r} line, got {len(lines)}:\n"
                             f"{out[-2000:]}")
        results.append(json.loads(lines[0][len(RESULT_PREFIX):]))
    return sorted(results, key=lambda r: r["proc"])


def summarize_point(results: List[dict],
                    attempts: List[dict] = None) -> dict:
    """Fold one launch's per-process results into a scaling row.

    Wall time is the max over processes (the job is done when the slowest
    process is); per-phase walls keep both the max and the per-process
    breakdown.  Raster AND weight signatures must agree across processes
    — each gathered the same global raster and plastic state.

    `attempts` (from `local.supervised_launch`) attaches the recovery
    history: the row records how many restarts the point needed, why each
    attempt died, and what the surviving attempt salvaged from periodic
    epochs."""
    if not results:
        raise ValueError("no worker results")
    sigs = {r["raster_sig"] for r in results}
    if len(sigs) != 1:
        raise ValueError(f"raster signatures diverge across processes: "
                         f"{[r['raster_sig'] for r in results]}")
    wsigs = {r["weights_sig"] for r in results if "weights_sig" in r}
    if len(wsigs) > 1:
        raise ValueError(f"weight signatures diverge across processes: "
                         f"{sorted(wsigs)}")
    nprocs = results[0]["nprocs"]
    if len(results) != nprocs or [r["proc"] for r in results] != list(
            range(nprocs)):
        raise ValueError(f"expected results from procs 0..{nprocs - 1}, "
                         f"got {[r['proc'] for r in results]}")
    row = dict(nprocs=nprocs, shards=results[0]["shards"],
               steps=results[0]["steps"], t0=results[0]["t0"],
               exchange=results[0]["exchange"],
               placement=results[0]["placement"],
               delivery=results[0].get("delivery", "dense"),
               profile=results[0].get("profile", "ring3"),
               connectivity_mode=results[0].get("connectivity_mode",
                                                "materialized"),
               exchange_schedule=results[0].get("exchange_schedule",
                                                "sync"),
               tuned_env=results[0].get("tuned_env", False),
               device=results[0].get("device", "cpu"),
               wire=results[0].get("wire"),
               wall_s=max(r["wall_s"] for r in results),
               spikes=results[0]["spikes"],
               rate_hz=results[0]["rate_hz"],
               raster_sig=results[0]["raster_sig"],
               per_proc=[{k: r[k] for k in
                          ("proc", "wall_s", *PHASE_KEYS) if k in r}
                         for r in results])
    if wsigs:
        row["weights_sig"] = next(iter(wsigs))
    if "ckpt_every" in results[0]:
        row["ckpt_every"] = results[0]["ckpt_every"]
        row["n_ckpts"] = max(r.get("n_ckpts", 0) for r in results)
        row["ckpt_wall_s"] = round(
            max(r.get("ckpt_wall_s", 0.0) for r in results), 4)
    # recovery bookkeeping: what the surviving attempt restored, plus the
    # supervisor's restart history when the launch was supervised
    restored = [r for r in results if r.get("restored_from")]
    row["recovery"] = dict(
        attempt=max((r.get("attempt", 0) for r in results), default=0),
        restarts=len(attempts or []),
        restored=bool(restored),
        restored_t=(restored[0].get("restored_t") if restored else None),
        recovered_steps=max(
            (r.get("recovered_steps", 0) for r in results), default=0),
        attempts=[dict(index=a["index"], reason=a["reason"],
                       backoff_s=a["backoff_s"])
                  for a in (attempts or [])])
    if "saturated" in results[0]:
        row["saturated"] = max(r.get("saturated", 0) for r in results)
    for k in PHASE_KEYS:
        if all(k in r for r in results):
            row[k] = round(max(r[k] for r in results), 4)
    return row


def scaling_report(rows: List[dict], config: Dict, name: str =
                   "cluster_scaling") -> dict:
    """Sweep rows (one per process count, same workload) -> BENCH report.

    Deterministic section: the shared raster signature, total spikes, and
    the across-P identity flag.  Wall section: per-P end-to-end wall and
    the per-phase maxima."""
    if not rows:
        raise ValueError("no scaling rows")
    sigs = [r["raster_sig"] for r in rows]
    deterministic = dict(
        raster_sig=sigs[0],
        spikes=rows[0]["spikes"],
        identical_across_procs=(len(set(sigs)) == 1))
    wsigs = [r["weights_sig"] for r in rows if "weights_sig" in r]
    if wsigs:
        deterministic["weights_sig"] = wsigs[0]
        deterministic["identical_weights_across_procs"] = (
            len(set(wsigs)) == 1)
    wall = {}
    for r in rows:
        p = r["nprocs"]
        wall[f"p{p}_wall_s"] = r["wall_s"]
        if r.get("ckpt_wall_s") is not None:
            wall[f"p{p}_ckpt_wall_s"] = r["ckpt_wall_s"]
        for k in PHASE_KEYS:
            if k in r:
                wall[f"p{p}_{k}"] = r[k]
    return bench_report.make_report(name, config, deterministic, wall,
                                    extra=dict(points=rows),
                                    device=rows[0].get("device", "cpu"))
