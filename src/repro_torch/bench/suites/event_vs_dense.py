"""Dense O(E) delivery against event-driven O(spikes x fan-out) delivery,
port of `repro.bench.suites.event_vs_dense` (its single-device rows).

The paper's model is event-driven; the dense formulation is the
accelerator-idiomatic one.  `bench` runs both backends end to end
(`StepProgram.run`: on the card one captured CUDA graph a window of steps)
at two thalamic drives (stim 1 and 0 events/ms/column: lower drive ->
sparser activity -> the event backend's advantage grows) and gates their
rasters equal.

`bench_distributed` runs the distributed cells (H x exchange x delivery)
over H `torch.distributed` ranks, one shard a rank (`core.distributed`),
per-phase walls from `StepProgram.time_phases` (the paper's Table 2
split; the primary rank's), with one sparse-stimulus pair and, at stim 0,
rate-calibrated event cells (floor-sized capacities: the AER trade of
sizing the static buffers from the expected rate, overflow counted in
`sat`).  Every cell of a stimulus level must give the same raster (the
Table 1 invariance and the backends' equivalence, gated).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from ...core import observables
from ...core.engine import resolve_device
from ...core.params import EngineConfig, GridConfig
from ...core.step_program import StepProgram
from .. import report as R
from .. import timing
from ..subproc import call_ranks, emit

H_LIST = (1, 2, 4)
EXCHANGES = ("halo", "allgather")
DELIVERIES = ("dense", "event")


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


def _phase_cell(sp, steps: int) -> dict:
    """Per-phase walls of one distributed cell on this rank
    (`time_phases`); the raster signature, spikes and `sat` are the
    job's, on the primary."""
    from ...cluster import runtime
    s, times, rasters, counts = sp.time_phases(sp.init_state(), 0, steps,
                                               collect_rasters=True)
    sat = None
    if sp.eplan is not None:
        sat = int(sp.mesh.wire.all_reduce_sum(s.sat.sum()))
    if not runtime.is_primary():
        return {}
    raster = np.stack(rasters)                         # [T, H, N]
    out = dict(**times, raster_sig=observables.raster_signature(
        raster, sp.plan.gid.numpy()).hex(), spikes=counts["spikes"])
    if sat is not None:
        out["saturated"] = sat
    return out


def rank_cells(args: dict) -> None:
    """Inside each rank of an H-rank job: the cells of H (one connectivity
    build, shared by both deliveries and both stimulus levels); the
    primary emits one result line a cell."""
    from ...cluster import runtime
    from ...core import event_engine as EV
    from ...dist.mesh import make_snn_mesh
    H, steps = runtime.process_count(), args["steps"]
    cfg1 = GridConfig(grid_x=2, grid_y=2, neurons_per_column=args["npc"],
                      synapses_per_neuron=50, seed=5)
    mesh = make_snn_mesh(H)
    sp_e = StepProgram(cfg1, EngineConfig(n_shards=H, delivery="event"),
                       mesh=mesh)
    espec, plan, eplan, estate = (sp_e.spec, sp_e.plan, sp_e.eplan,
                                  sp_e.init_state())

    def cell(key, spec, state, **kw):
        sp = StepProgram.from_parts(spec, plan, state, mesh=mesh, **kw)
        c = _phase_cell(sp, steps)
        if runtime.is_primary():
            emit(dict(key=key, h=H, exchange=spec.eng.exchange,
                      delivery=spec.eng.delivery,
                      stim_per_ms=spec.cfg.stim_events_per_ms_per_column,
                      steps=steps, wire=mesh.backend, **c))

    for suffix, stim in (("", 1), ("_stim0", 0)):
        if stim == 0 and H != 2:
            continue
        spec_s = espec._replace(cfg=dataclasses.replace(
            cfg1, stim_events_per_ms_per_column=stim))
        for ex in EXCHANGES:
            for delivery in DELIVERIES:
                spec = spec_s._replace(eng=EngineConfig(
                    n_shards=H, exchange=ex, delivery=delivery))
                if delivery == "event":
                    cell(f"h{H}_{ex}_event{suffix}", spec, estate,
                         eplan=eplan)
                else:
                    cell(f"h{H}_{ex}_dense{suffix}", spec, estate.base)
            if stim != 0:
                continue
            # rate-calibrated event cell: floor-sized capacities (cap_ev
            # 256, c_post = c_src = 16), overflow counted in sat
            spec = spec_s._replace(eng=EngineConfig(
                n_shards=H, exchange=ex, delivery="event"))
            cell(f"h{H}_{ex}_event{suffix}_rated", spec,
                 EV.init_event_state(spec, estate.base, cap_ev=256),
                 eplan=eplan, caps=dict(c_post=16, c_src=16))


def bench_distributed(quick: bool = False, device=None, *, npc=None,
                      steps=None, timeout=None):
    """H x exchange x delivery per-phase cells over H ranks (and one
    sparse-stimulus pair); returns (H list, cells)."""
    dev = resolve_device(device)
    args = dict(npc=npc or (100 if quick else 250),
                steps=steps or (40 if quick else 100))
    cells = {}
    for H in H_LIST:
        for c in call_ranks("repro_torch.bench.suites.event_vs_dense:"
                            "rank_cells", args, H, device=dev.type,
                            timeout=timeout):
            cells[c.pop("key")] = c
            print("[event_vs_dense]", json.dumps(c), flush=True)
    return list(H_LIST), cells


def run_suite(quick: bool = False, device=None, *,
              distributed: bool = True) -> dict:
    """The single-device rows and, with `distributed`, the distributed
    cells, gated: each stimulus level gives one raster across every
    layout and backend."""
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
    config, extra = dict(quick=quick), dict(rows=rows)
    if distributed:
        h_list, cells = bench_distributed(quick=quick, device=device)
        sigs = {}
        for c in cells.values():
            sigs.setdefault(c["stim_per_ms"], set()).add(c["raster_sig"])
        for stim, ss in sorted(sigs.items()):
            if len(ss) != 1:
                got = [(k, c["raster_sig"][:12]) for k, c in cells.items()
                       if c["stim_per_ms"] == stim]
                raise RuntimeError(
                    f"distributed rasters diverge across layouts/backends "
                    f"at stim={stim}: {got}")
            deterministic[f"dist_sig_stim{stim}"] = next(iter(ss))
        for key, c in cells.items():
            deterministic[f"sat_{key}"] = c.get("saturated", 0)
            for m in ("phase_a_s", "exchange_s", "phase_b_s"):
                wall[f"{key}_{m}"] = c[m]
        # the crossover: does event beat dense on phase A per cell? (>1 =
        # event faster; rated cells against the same layout's dense cell)
        wins = {}
        for k, c in cells.items():
            dense_key = k.replace("_event", "_dense").replace("_rated", "")
            if c["delivery"] == "event" and dense_key in cells:
                wins[k] = (cells[dense_key]["phase_a_s"]
                           / max(c["phase_a_s"], 1e-9))
        config.update(h_list=h_list,
                      wire={f"h{c['h']}": c["wire"] for c in cells.values()})
        extra.update(dist_cells=[dict(cell=k, **c)
                                 for k, c in sorted(cells.items())],
                     phase_a_event_speedup=wins)
    return R.make_report("event_vs_dense", config, deterministic, wall,
                         extra=extra, device=resolve_device(device))
