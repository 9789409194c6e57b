"""Weak scaling toward the paper's 20G-synapse regime with streamed
connectivity (port of `repro.bench.suites.weak_scaling`;
`python -m repro_torch.bench run weak_scaling --quick`).

The DPSNN follow-up study (arXiv:1511.09325) frames cluster capacity as
time per synaptic event at constant synapses per process while the grid
grows.  The materialized engine cannot follow that curve far: per-shard
synapse tables are O(total synapses / H) live bytes.
`connectivity='streamed'` regenerates each chunk's tables inside the step
from the counter-based splitmix64 draw lanes (`core.stream_engine`), so
live table bytes stay O(chunk), with rasters AND weights bit-identical to
materialized mode.

Two measurements per run:

  1. RESIDENCY RATIO: one grid sized so the materialized synapse tables
     exceed streamed mode's per-chunk table bytes by >= 8x (the
     reference's accounting, `stream_engine.streamed_table_bytes`; the
     port's own live bytes are reported beside it).  The same cell proves
     bit-identity: streamed and materialized runs must agree on the raster
     signature and the weight signature, or the suite raises.
  2. WEAK-SCALING LADDER: constant synapses per shard, growing grid, in
     streamed mode: wall and time per synaptic event per rung.

Every rung stacks its shards on one device, as the reference's suite
does (its logical shards), so the numbers compare across machines.
"""
from __future__ import annotations

import time

from ...core import observables, stream_engine
from ...core.engine import resolve_device
from ...core.params import EngineConfig, GridConfig
from ...core.step_program import StepProgram
from .. import report as R
from .. import timing

#: Minimum materialized / streamed table-bytes ratio of the residency cell.
RATIO_FLOOR = 8.0

#: ladder rungs: (grid_x, grid_y, shards), columns per shard constant
LADDER = ((4, 4, 1), (4, 8, 2), (8, 8, 4))


def _run_cell(cfg: GridConfig, eng: EngineConfig, steps: int,
              device) -> dict:
    """Warmed run -> wall, spikes, raster and weight signatures."""
    sp = StepProgram(cfg, eng, device=device)
    state0 = sp.init_state()
    timing.synchronize(sp.run(state0, 0, steps))       # warm (and capture)
    t0 = time.perf_counter()
    state_f, raster, _ = timing.synchronize(sp.run(state0, 0, steps))
    wall = time.perf_counter() - t0
    if sp.splan is not None and sp.runner is not None:
        sp.runner.chunks.check()
    raster = raster.cpu().numpy()
    return dict(
        sp=sp, wall_s=wall, spikes=int(raster.sum()),
        rate_hz=observables.mean_rate_hz(raster, cfg.n_neurons),
        raster_sig=observables.raster_signature(
            raster, sp.plan.gid.cpu().numpy()).hex(),
        weight_sig=sp.weight_signature(state_f).hex())


def _residency_cell(quick: bool, device, steps=None) -> dict:
    """The >= 8x residency grid and the bit-identity wall."""
    gx = gy = 10 if quick else 14
    npc, M, full = (30, 100, 20) if quick else (40, 120, 40)
    steps = steps or full
    cfg = GridConfig(grid_x=gx, grid_y=gy, neurons_per_column=npc,
                     synapses_per_neuron=M, seed=2013,
                     connectivity="ring:max_ring=1")
    cs = _run_cell(cfg, EngineConfig(n_shards=1,
                                     connectivity="streamed:chunk=1"),
                   steps, device)
    cm = _run_cell(cfg, EngineConfig(n_shards=1), steps, device)
    spec_s, spec_m = cs["sp"].spec, cm["sp"].spec
    streamed_b = stream_engine.streamed_table_bytes(spec_s)
    live_b = stream_engine.live_table_bytes(spec_s, cs["sp"].splan)
    mat_b = stream_engine.materialized_table_bytes(spec_m.e_cap)
    ratio = mat_b / streamed_b
    if ratio < RATIO_FLOOR:
        raise RuntimeError(
            f"residency grid too small: materialized {mat_b} B / streamed "
            f"{streamed_b} B = {ratio:.1f}x < required {RATIO_FLOOR}x")
    if cs["raster_sig"] != cm["raster_sig"]:
        raise RuntimeError(
            f"streamed raster forked from materialized: "
            f"{cs['raster_sig'][:16]} != {cm['raster_sig'][:16]}")
    if cs["weight_sig"] != cm["weight_sig"]:
        raise RuntimeError(
            f"streamed final weights forked from materialized: "
            f"{cs['weight_sig'][:16]} != {cm['weight_sig'][:16]}")
    ss = spec_s.stream
    print(f"[weak_scaling] residency {gx}x{gy} npc={npc} M={M}: "
          f"materialized {mat_b} B vs streamed {streamed_b} B "
          f"({ratio:.1f}x, floor {RATIO_FLOOR}x; the port's live tables "
          f"{live_b} B); raster+weights bit-identical "
          f"({cs['raster_sig'][:16]})", flush=True)
    return dict(
        grid=f"{gx}x{gy}", npc=npc, M=M, steps=steps,
        streamed_table_bytes=int(streamed_b),
        live_table_bytes=int(live_b),
        materialized_table_bytes=int(mat_b),
        ratio_x10=int(ratio * 10), live_ratio_x10=int(mat_b / live_b * 10),
        k_cap=int(ss.k_cap), e_cap_materialized=int(spec_m.e_cap),
        n_chunks=int(ss.n_chunks), spikes=cs["spikes"],
        raster_sig=cs["raster_sig"], weight_sig=cs["weight_sig"],
        identical=(cs["raster_sig"] == cm["raster_sig"]
                   and cs["weight_sig"] == cm["weight_sig"]),
        wall_streamed_s=cs["wall_s"], wall_materialized_s=cm["wall_s"],
        rate_hz=round(cs["rate_hz"], 3))


def _ladder(quick: bool, device, steps=None) -> list:
    npc, M, full = (30, 60, 20) if quick else (50, 80, 60)
    steps = steps or full
    rows = []
    for gx, gy, H in LADDER:
        cfg = GridConfig(grid_x=gx, grid_y=gy, neurons_per_column=npc,
                         synapses_per_neuron=M, seed=2013,
                         connectivity="ring:max_ring=1")
        eng = EngineConfig(n_shards=H, connectivity="streamed:chunk=2")
        c = _run_cell(cfg, eng, steps, device)
        events = c["spikes"] * M
        tpse = c["wall_s"] / events if events else float("nan")
        ss = c["sp"].spec.stream
        rows.append(dict(
            grid=f"{gx}x{gy}", shards=H, npc=npc, M=M, steps=steps,
            syn_per_shard=gx * gy * npc * M // H,
            k_cap=int(ss.k_cap), wall_s=round(c["wall_s"], 4),
            spikes=c["spikes"], rate_hz=round(c["rate_hz"], 3),
            raster_sig=c["raster_sig"],
            time_per_syn_event_s=float(f"{tpse:.3e}")))
        print(f"[weak_scaling] ladder {gx}x{gy} H={H}: "
              f"{rows[-1]['syn_per_shard']} syn/shard, wall "
              f"{rows[-1]['wall_s']}s, {tpse:.3e} s/syn-event", flush=True)
    return rows


def run_suite(quick: bool = False, device=None, steps=None) -> dict:
    """The report; `steps` cuts every cell's run (the CPU tests' depth)."""
    dev = resolve_device(device)
    res = _residency_cell(quick, dev, steps)
    rows = _ladder(quick, dev, steps)

    deterministic = dict(
        residency_ratio_x10=res["ratio_x10"],
        residency_streamed_table_bytes=res["streamed_table_bytes"],
        residency_materialized_table_bytes=res["materialized_table_bytes"],
        residency_k_cap=res["k_cap"],
        residency_spikes=res["spikes"],
        residency_raster_sig=res["raster_sig"],
        residency_weight_sig=res["weight_sig"],
        residency_identical=res["identical"])
    wall = dict(residency_streamed_s=round(res["wall_streamed_s"], 4),
                residency_materialized_s=round(res["wall_materialized_s"],
                                               4))
    for r in rows:
        tag = f"ladder_{r['grid']}_h{r['shards']}"
        deterministic[f"{tag}_spikes"] = r["spikes"]
        deterministic[f"{tag}_raster_sig"] = r["raster_sig"]
        deterministic[f"{tag}_syn_per_shard"] = r["syn_per_shard"]
        wall[f"{tag}_wall_s"] = r["wall_s"]
        wall[f"{tag}_time_per_syn_event_s"] = r["time_per_syn_event_s"]

    config = dict(quick=quick, ratio_floor=int(RATIO_FLOOR),
                  residency=dict(grid=res["grid"], npc=res["npc"],
                                 M=res["M"], steps=res["steps"],
                                 chunk=1),
                  ladder=[dict(grid=r["grid"], shards=r["shards"],
                               npc=r["npc"], M=r["M"], steps=r["steps"],
                               chunk=2) for r in rows])
    extra = dict(residency=res, ladder=rows)
    return R.make_report("weak_scaling", config, deterministic, wall,
                         extra, device=dev)

