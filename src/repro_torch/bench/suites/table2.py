"""Paper Table 2: per-phase time decomposition at H=1 (single process),
port of `repro.bench.suites.table2`.

The paper instruments barrier wait, spike-counter exchange, payload
transmission and total, and concludes communication is <= ~10% of the
total.  This suite is a projection of the per-phase profiler
(`repro_torch.bench.profile`): one shard, 'halo' exchange (the AER pack
and match, the closest analogue of the paper's two-phase delivery),
reported in the paper's compute/communication split.  The full exchange x
placement matrix lives in the 'profile' suite.
"""
from __future__ import annotations

import json

from ...core.engine import resolve_device
from ...core.params import EngineConfig, GridConfig
from .. import profile as P
from .. import report as R


def bench(gx=2, gy=2, npc=1000, steps=200, quick=False, device=None):
    if quick:
        gx = gy = 2
        npc = 250
        steps = 100
    cfg = GridConfig(grid_x=gx, grid_y=gy, neurons_per_column=npc)
    eng = EngineConfig(n_shards=1, exchange="halo")
    cell = P.profile_cell(cfg, eng, steps, device=device)
    row = dict(grid=f"{gx}x{gy}", steps=steps, spikes=cell["spikes"],
               arrivals=cell["arrivals"],
               compute_s=cell["phase_a_s"],
               exchange_s=cell["exchange_s"],
               arborize_s=cell["phase_b_s"],
               total_s=cell["phases_sum_s"],
               comm_fraction=cell["comm_fraction"],
               raster_sig=cell["raster_sig"], rate_hz=cell["rate_hz"],
               paper_claim="comm <= ~10% of total")
    print("[table2]", json.dumps(row), flush=True)
    return row


def run_suite(quick: bool = False, device=None) -> dict:
    row = bench(quick=quick, device=device)
    deterministic = dict(spikes=row["spikes"], raster_sig=row["raster_sig"])
    wall = dict(compute_s=row["compute_s"], exchange_s=row["exchange_s"],
                arborize_s=row["arborize_s"], total_s=row["total_s"])
    config = dict(quick=quick, grid=row["grid"], steps=row["steps"])
    return R.make_report("table2", config, deterministic, wall,
                         extra=dict(row=row), device=resolve_device(device))
