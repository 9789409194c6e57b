"""Per-phase profiling of the DPSNN step (paper Table 2 instrumentation),
port of `repro.bench.profile`.

The paper splits wall-clock into computational and communication parts and
concludes communication stays <= ~10% of the total.  The step is cut at
the same joints, each phase timed with a device synchronise after it:

  phase_a     — local dynamics: arrivals -> currents -> LTD -> Izhikevich
                update -> LTP (the paper's "dynamic phase" compute),
  exchange    — spike delivery between shards: 'allgather' reads the
                global spike mask, 'halo' packs fixed-capacity AER buffers
                and routes them along the static halo offsets (the paper's
                two-phase sparse delivery),
  phase_b     — deferred axonal arborization (arrival-ring updates).

Shards are stacked on one device, so the halo route is emulated with
`torch.roll` over the shard axis, which keeps the exchange's work (AER
pack, scatter-match).  Both the phase handles and the timing loop come
from `core.StepProgram`.  Each cell records the deterministic counters
(total spikes and arrivals, raster signature) beside the walls.  The JAX
package also records the HLO flops and bytes of the fused step; those
need XLA and have no counterpart here (the report's `extra` says so).
"""
from __future__ import annotations

import time

import numpy as np

from ..core import StepProgram, engine, observables
from ..core.params import EngineConfig, GridConfig
from . import timing

EXCHANGES = ("allgather", "halo")
PLACEMENTS = ("block", "scatter")
NO_HLO = ("hlo_flops / hlo_bytes of the fused step are not recorded: they "
          "come from XLA's compiled HLO, which the port has no "
          "counterpart of (ROADMAP queue 1, item 13.6)")


def profile_cell(cfg: GridConfig, eng: EngineConfig, steps: int,
                 device=None, built=None) -> dict:
    """Profile one (exchange, placement[, schedule]) cell; flat metrics.
    `device` defaults to the card.

    `built` optionally passes a prebuilt (spec, plan, state) from
    `engine.build` for the same (cfg, shards, placement) on that device:
    the plan is exchange-independent, so callers sweeping exchange modes
    (the connectivity_sweep suite) skip rebuilding the synapse tables —
    `spec.eng` is re-pointed at `eng` here, and the state is not
    changed."""
    if built is None:
        spec, plan, state = engine.build(
            cfg, eng, device=engine.resolve_device(device))
    else:
        spec, plan, state = built
        if (spec.eng.n_shards, spec.eng.placement) != (eng.n_shards,
                                                       eng.placement):
            raise ValueError("prebuilt plan layout mismatch")
        spec = spec._replace(eng=eng)
    sp = StepProgram.from_parts(spec, plan, state)
    pp = sp.phase_fns()

    # warm-up on a copy (the phases update their state in place): builds
    # the kernels and fills the caches outside the wall-clock window;
    # time_phases warms up again on its own copy
    warm = engine.clone_state(state)
    warm, spiked_w, _ = pp.phase_a(warm, 0)
    pp.phase_b(warm, pp.exchange(spiked_w), 0)
    if spec.eng.exchange_schedule == "pipelined":
        warm, spiked_w, _ = pp.phase_a_dynamics(warm, 1)
        pp.phase_a_plasticity(warm, spiked_w, 1)
    timing.synchronize(warm)
    del warm

    wall0 = time.perf_counter()
    _, times, rasters, counts = sp.time_phases(state, 0, steps,
                                               collect_rasters=True)
    wall_s = time.perf_counter() - wall0

    raster = np.stack(rasters)                       # [T, H, N]
    sig = observables.raster_signature(raster, plan.gid.cpu().numpy())
    rate = observables.mean_rate_hz(raster, cfg.n_neurons)

    phases_sum = sum(times.values())
    return dict(
        exchange=eng.exchange, placement=eng.placement, steps=steps,
        exchange_schedule=eng.exchange_schedule,
        **times, phases_sum_s=phases_sum, wall_s=wall_s,
        steps_per_s=steps / wall_s if wall_s else 0.0,
        comm_fraction=times["exchange_s"] / phases_sum if phases_sum
        else 0.0,
        spikes=counts["spikes"], arrivals=counts["arrivals"],
        raster_sig=sig.hex(), rate_hz=round(rate, 2))


def run_profile(quick: bool = False, device=None) -> dict:
    """Full exchange x placement profiling matrix -> one bench report.

    Enforces the paper's Table 1 invariant in-process: every cell must
    produce the identical raster signature and spike/arrival totals — the
    distribution layout may change the timings, never the physics.
    """
    from . import report as R

    dev = engine.resolve_device(device)
    gx = gy = 2
    npc = 200 if quick else 1000
    H = 2 if quick else 4
    steps = 60 if quick else 150
    cfg = GridConfig(grid_x=gx, grid_y=gy, neurons_per_column=npc)

    cells = {}
    for ex in EXCHANGES:
        for pl in PLACEMENTS:
            eng = EngineConfig(n_shards=H, exchange=ex, placement=pl)
            cells[f"{ex}_{pl}"] = profile_cell(cfg, eng, steps, device=dev)

    sigs = {k: c["raster_sig"] for k, c in cells.items()}
    if len(set(sigs.values())) != 1:
        raise RuntimeError(f"paper Table 1 invariant violated: raster "
                           f"signatures differ across layouts: {sigs}")
    counts = {k: (c["spikes"], c["arrivals"]) for k, c in cells.items()}
    if len(set(counts.values())) != 1:
        raise RuntimeError(f"spike/arrival totals differ across layouts: "
                           f"{counts}")

    ref = next(iter(cells.values()))
    deterministic = dict(spikes=ref["spikes"], arrivals=ref["arrivals"],
                         raster_sig=ref["raster_sig"])
    wall = {}
    for key, c in cells.items():
        for m in ("phase_a_s", "exchange_s", "phase_b_s", "wall_s",
                  "steps_per_s"):
            wall[f"{key}_{m}"] = c[m]
    config = dict(grid=f"{gx}x{gy}", neurons_per_column=npc, shards=H,
                  steps=steps, quick=quick)
    extra = dict(rate_hz=ref["rate_hz"], not_recorded=NO_HLO,
                 cells=[dict(cell=k, **c) for k, c in cells.items()])
    return R.make_report("profile", config, deterministic, wall, extra,
                         device=dev)
