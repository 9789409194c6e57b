"""Paper Table 1: problem sizes, firing rates, and the normalised
time-per-synapse metric (port of `repro.bench.suites.table1`).

The paper sweeps 200 K .. 1.6 G synapses; each row here runs a grid of
the paper's column (1,000 neurons, 200 synapses each) for real through
`engine.run` on one device, and records (a) the firing rate beside the
paper's 20-48 Hz initial-activity band, (b) the detailed firing (spike
count + raster signature, gated against a baseline), (c) the normalised
execution time (s per synapse per simulated second per Hz, the paper's
metric) and synaptic events per second.  Each row also records its host
build seconds and, on the card, its peak device memory.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ...core import EngineConfig, GridConfig, build, observables, run
from ...core.engine import resolve_device
from .. import report as R
from .. import timing

# (grid_x, grid_y) -> paper row; synapses = cols * 1000 * 200
ROWS = [
    (1, 1),      # 200 K synapses   (paper: 20 Hz)
    (4, 4),      # 3.2 M            (paper: 26 Hz)
    (8, 4),      # 6.4 M            (paper: 29 Hz)
    (8, 8),      # 12.8 M           (paper: 31 Hz)
]
PAPER_RATES = {1: 20, 16: 26, 32: 29, 64: 31, 128: 33, 256: 33}


def bench(steps: int = 300, rows=None, quick: bool = False, device=None):
    """One dict per row (`rows` of (grid_x, grid_y); quick: 1x1 and 4x4
    at 150 steps), on `device` (the card by default)."""
    dev = resolve_device(device)
    rows = rows if rows is not None else (ROWS[:2] if quick else ROWS)
    steps = 150 if quick else steps
    out = []
    for gx, gy in rows:
        cfg = GridConfig(grid_x=gx, grid_y=gy)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        with timing.Timer() as tb:
            spec, plan, state = build(cfg, EngineConfig(n_shards=1),
                                      device=dev)

        def run_fn(s):
            return run(spec, plan, s, 0, steps)
        _, raster, tm = timing.synchronize(run_fn(state))  # warm run
        t = timing.time_fn(run_fn, state, reps=1 if quick else 2, warmup=0)

        raster = raster.cpu().numpy()
        rate = observables.mean_rate_hz(raster, cfg.n_neurons)
        sig = observables.raster_signature(raster, plan.gid.cpu().numpy())
        norm = timing.norm_seconds(t.median_s, cfg.n_synapses, steps, rate)
        row = dict(grid=f"{gx}x{gy}", columns=cfg.n_columns,
                   neurons=cfg.n_neurons, synapses=cfg.n_synapses,
                   steps=steps, rate_hz=round(float(rate), 1),
                   paper_rate_hz=PAPER_RATES.get(cfg.n_columns),
                   wall_s=t.median_s, spread=t.spread,
                   ms_per_step=t.median_s / steps * 1e3, build_s=tb.s,
                   spikes=int(raster.sum()), raster_sig=sig.hex(),
                   arrivals=int(tm.arrivals.sum()),
                   norm_s_per_syn_per_s_per_hz=norm,
                   syn_events_per_s=cfg.n_synapses * rate * steps
                   / 1000.0 / t.median_s,
                   max_memory_allocated_bytes=(
                       torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None),
                   device=dev.type)
        out.append(row)
        print("[table1]", json.dumps(row), flush=True)
        del spec, plan, state, raster, tm
    return out


def run_suite(quick: bool = False, device=None, rows=None) -> dict:
    """The suite's report; `rows` of (grid_x, grid_y) replaces the default
    grids (e.g. to add the paper's 16x16 row)."""
    rows = bench(rows=rows, quick=quick, device=device)
    deterministic, wall = {}, {}
    for r in rows:
        g = r["grid"]
        deterministic[f"spikes_{g}"] = r["spikes"]
        deterministic[f"sig_{g}"] = r["raster_sig"]
        wall[f"wall_{g}"] = r["wall_s"]
        wall[f"norm_{g}"] = r["norm_s_per_syn_per_s_per_hz"]
    config = dict(quick=quick, grids=[r["grid"] for r in rows],
                  steps=rows[0]["steps"])
    return R.make_report("table1", config, deterministic, wall,
                         extra=dict(rows=rows), device=resolve_device(device))
