"""Dense O(E) delivery against event-driven O(spikes x fan-out) delivery,
port of `repro.bench.suites.event_vs_dense` (its single-device rows).

The paper's model is event-driven; the dense formulation is the
accelerator-idiomatic one.  `bench` runs both backends end to end
(`StepProgram.run`: on the card one captured CUDA graph a window of steps)
at two thalamic drives (stim 1 and 0 events/ms/column: lower drive ->
sparser activity -> the event backend's advantage grows) and gates their
rasters equal.  The distributed cells (H x exchange x delivery over a
device mesh) need real collectives: `bench_distributed` raises, naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

import json

import numpy as np

from ...core import observables
from ...core.engine import resolve_device
from ...core.params import EngineConfig, GridConfig
from ...core.step_program import StepProgram
from .. import report as R
from .. import timing


def _timed_run(sp: StepProgram, steps: int):
    """The run's outputs (its first call, which on the card captures the
    graph) and the wall of one more run."""
    state0 = sp.init_state()
    out = sp.run(state0, 0, steps)
    timing.synchronize(out)
    t = timing.time_fn(lambda s: sp.run(s, 0, steps), state0, reps=1,
                       warmup=0)
    return out, t


def bench(quick: bool = False, device=None):
    """Single-device fused rows (stim 1 vs 0)."""
    npc = 250 if quick else 500
    steps = 100 if quick else 200
    rows = []
    for stim in (1, 0):          # events/ms/column: normal vs silent-ish
        cfg = GridConfig(grid_x=2, grid_y=2, neurons_per_column=npc,
                         synapses_per_neuron=50, seed=5,
                         stim_events_per_ms_per_column=stim)
        sp_d = StepProgram(cfg, EngineConfig(n_shards=1), device=device)
        (_, raster_d, _), td = _timed_run(sp_d, steps)
        sp_e = StepProgram(cfg, EngineConfig(n_shards=1, delivery="event"),
                           device=device)
        (st_e, raster_e, _), te = _timed_run(sp_e, steps)

        raster_d = raster_d.cpu().numpy()
        sig_d = observables.raster_signature(raster_d,
                                             sp_d.plan.gid.cpu().numpy())
        sig_e = observables.raster_signature(raster_e.cpu().numpy(),
                                             sp_e.plan.gid.cpu().numpy())
        rate = observables.mean_rate_hz(raster_d, cfg.n_neurons)
        row = dict(stim_per_ms=stim, rate_hz=round(rate, 1),
                   dense_s=round(td.median_s, 3),
                   event_s=round(te.median_s, 3),
                   speedup=round(td.median_s / max(te.median_s, 1e-9), 2),
                   identical_rasters=bool(sig_d == sig_e),
                   raster_sig=sig_d.hex(),
                   saturated=int(np.asarray(st_e.sat.cpu()).sum()))
        rows.append(row)
        print("[event_vs_dense]", json.dumps(row), flush=True)
    return rows


def bench_distributed(quick: bool = False, device=None):
    """The H x exchange x delivery cells over a device mesh."""
    raise NotImplementedError(
        "event_vs_dense's distributed cells run over a device mesh with real "
        "collectives, which are not ported yet (ROADMAP queue 1, item 8)")


def run_suite(quick: bool = False, device=None) -> dict:
    rows = bench(quick=quick, device=device)
    deterministic, wall = {}, {}
    for r in rows:
        s = r["stim_per_ms"]
        deterministic[f"identical_rasters_stim{s}"] = r["identical_rasters"]
        deterministic[f"sig_stim{s}"] = r["raster_sig"]
        deterministic[f"sat_stim{s}"] = r["saturated"]
        wall[f"dense_s_stim{s}"] = r["dense_s"]
        wall[f"event_s_stim{s}"] = r["event_s"]
    if not all(r["identical_rasters"] for r in rows):
        raise RuntimeError(f"event and dense rasters differ: {rows}")
    return R.make_report("event_vs_dense", dict(quick=quick), deterministic,
                         wall, extra=dict(rows=rows),
                         device=resolve_device(device))
