"""Exchange-vs-reach: per-phase profile of the DPSNN step across
lateral-connectivity profiles (port of
`repro.bench.suites.connectivity_sweep`; arXiv:1803.08833's experiment,
one command: `python -m repro_torch.bench run connectivity_sweep
--quick`).

The paper's benchmark fixes projection to the 3rd Chebyshev ring; the
follow-up study on the same simulator shows Gaussian/exponential decay
kernels shift the compute/communication balance with connectivity reach.
This suite measures exactly that: for each profile it times phase A /
spike exchange / phase B (the `bench.profile` harness, the shards
stacked on one device) under BOTH exchange modes, and records the
reach-derived distribution quantities — halo columns per shard, static
halo-offset schedule size, per-shard synapse capacity — that the
profile's `reach()` controls.

Within one profile the two exchange modes must produce bit-identical
rasters (paper Table 1 invariant at every reach — asserted here);
ACROSS profiles the rasters differ by construction (different physics),
so each profile records its own spike count / raster signature.
"""
from __future__ import annotations

from typing import Optional

from .. import report as R
from ..profile import profile_cell
from ...core import profiles, topology
from ...core import distributed as dcore
from ...core import engine as engine_mod
from ...core.params import EngineConfig, GridConfig

#: Profile specs swept, in report order.  ring3 is the paper kernel
#: (reach 3), ring1 a narrow variant (reach 1), gaussian/exponential the
#: arXiv:1803.08833 decay kernels (reach 5 at these parameters).
PROFILE_SPECS = ("ring3", "ring1", "gaussian:sigma=1.5",
                 "exponential:lambda=1.0")

EXCHANGES = ("halo", "allgather")


def _key(spec: str) -> str:
    """Metric-key-safe profile tag: 'gaussian:sigma=1.5' -> 'gaussian'."""
    return spec.partition(":")[0]


def _reach_stats(cfg: GridConfig, eng: EngineConfig, built) -> dict:
    """Distribution-side quantities the profile's reach determines (read
    off the prebuilt (spec, plan, state) — no extra engine build)."""
    prof = profiles.from_config(cfg)
    halo_cols = [topology.shard_halo_columns(cfg, h, eng.n_shards,
                                             eng.placement).shape[0]
                 for h in range(eng.n_shards)]
    spec, plan, _ = built
    offsets = dcore.halo_offsets(spec, plan)
    return dict(reach=prof.reach(),
                ring_masses=[round(m, 4) for m in prof.ring_masses()],
                halo_cols_max=int(max(halo_cols)),
                halo_offsets=len(offsets),
                e_cap=spec.e_cap, s_cap=spec.s_cap)


def run_suite(quick: bool = False, device=None, *,
              grid: Optional[int] = None,
              steps: Optional[int] = None) -> dict:
    """Profile x exchange matrix -> one BENCH report, on `device` (the
    card by default).

    The grid must out-span the widest kernel (2*reach + 1 columns per
    axis) or periodic wrap aliases every halo to the full grid and the
    reach effect disappears; 12x12 covers reach 5, the 6x6 quick grid
    deliberately half-wraps (recorded in config).  `grid` (a side) and
    `steps` cut the sizes further (the CPU tests).
    """
    dev = engine_mod.resolve_device(device)
    gx = gy = grid if grid is not None else (6 if quick else 12)
    npc = 40 if quick else 100
    M = 30 if quick else 60
    H = 4 if quick else 8
    steps = steps if steps is not None else (40 if quick else 100)

    rows, deterministic, wall = [], {}, {}
    for pspec in PROFILE_SPECS:
        cfg = GridConfig(grid_x=gx, grid_y=gy, neurons_per_column=npc,
                         synapses_per_neuron=M, seed=2013,
                         connectivity=pspec)
        # one engine build per profile: the synapse tables are
        # exchange-independent, so both cells (and the reach stats) share
        # it via profile_cell's `built` hook
        eng0 = EngineConfig(n_shards=H, exchange=EXCHANGES[0],
                            placement="block")
        built = engine_mod.build(cfg, eng0, device=dev)
        stats = _reach_stats(cfg, eng0, built)
        cells = {}
        for ex in EXCHANGES:
            eng = EngineConfig(n_shards=H, exchange=ex, placement="block")
            cells[ex] = profile_cell(cfg, eng, steps, device=dev,
                                     built=built)

        sigs = {c["raster_sig"] for c in cells.values()}
        if len(sigs) != 1:
            raise RuntimeError(
                f"Table 1 invariant violated at profile {pspec!r}: "
                f"halo vs allgather rasters differ: "
                f"{ {k: c['raster_sig'] for k, c in cells.items()} }")

        key = _key(pspec)
        ref = cells["halo"]
        deterministic[f"{key}_spikes"] = ref["spikes"]
        deterministic[f"{key}_raster_sig"] = ref["raster_sig"]
        deterministic[f"{key}_reach"] = stats["reach"]
        deterministic[f"{key}_halo_offsets"] = stats["halo_offsets"]
        deterministic[f"{key}_halo_cols_max"] = stats["halo_cols_max"]
        deterministic[f"{key}_e_cap"] = stats["e_cap"]
        for ex, c in cells.items():
            for m in ("phase_a_s", "exchange_s", "phase_b_s", "wall_s"):
                wall[f"{key}_{ex}_{m}"] = c[m]
            wall[f"{key}_{ex}_comm_fraction"] = c["comm_fraction"]

        row = dict(profile=pspec, **stats,
                   rate_hz=ref["rate_hz"], spikes=ref["spikes"],
                   cells={ex: {m: c[m] for m in
                               ("phase_a_s", "exchange_s", "phase_b_s",
                                "wall_s", "comm_fraction")}
                          for ex, c in cells.items()})
        rows.append(row)
        exch_ratio = (ref["exchange_s"] / ref["phase_a_s"]
                      if ref["phase_a_s"] else float("nan"))
        print(f"[connectivity_sweep] {pspec}: reach {stats['reach']}, "
              f"{stats['halo_offsets']} halo offsets, halo exchange/phaseA "
              f"= {exch_ratio:.3f}, rate {ref['rate_hz']} Hz", flush=True)

    config = dict(grid=f"{gx}x{gy}", neurons_per_column=npc,
                  synapses_per_neuron=M, shards=H, steps=steps,
                  profiles=list(PROFILE_SPECS), exchanges=list(EXCHANGES),
                  quick=quick)
    extra = dict(rows=rows)
    return R.make_report("connectivity_sweep", config, deterministic, wall,
                         extra, device=dev)
