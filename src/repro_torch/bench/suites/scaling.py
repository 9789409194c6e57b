"""Paper Figures 3-1 / 3-2: strong and weak scaling of the DPSNN engine,
port of `repro.bench.suites.scaling` over `torch.distributed` ranks.

Each scaling point starts H fresh ranks (`bench.subproc.call_ranks`),
one shard a rank, real collectives (`core.distributed`), and times
`StepProgram.run` of the whole job (from a barrier to the last rank's
end) after a warm-up run.  NOTE on honesty: on one card (the ranks
sharing its SMs, the wire gloo through host memory) or one CPU, wall
time cannot fall with H the way the paper's 128-core cluster shows it;
what these curves measure there is (a) that the engine runs at every H
with identical spiking, and (b) the distribution overhead (the wire and
the imbalance) against H, the quantity the paper's Discussion analyses.
On a machine with a card a rank the same harness gives the paper's
curves.
"""
from __future__ import annotations

import json
import time

from .. import report as R
from ..subproc import call_ranks, emit


def rank_point(args: dict) -> None:
    """Inside each rank of an H-rank job: the run's wall (the slowest
    rank's), rate and raster signature, emitted by the primary."""
    import torch
    from ...cluster import runtime
    from ...core import (EngineConfig, GridConfig, StepProgram,
                         observables)
    from ...dist.mesh import make_snn_mesh
    H = runtime.process_count()
    cfg = GridConfig(grid_x=args["gx"], grid_y=args["gy"],
                     neurons_per_column=args["npc"])
    eng = EngineConfig(n_shards=H, exchange=args["exchange"])
    mesh = make_snn_mesh(H)
    sp = StepProgram(cfg, eng, mesh=mesh)
    state = sp.place(sp.init_state())

    def barrier():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        mesh.wire.all_reduce_sum(torch.zeros(1, device=mesh.device))

    sp.run(state, 0, args["steps"])                     # warm-up
    barrier()
    t0 = time.perf_counter()
    _, raster, _ = sp.run(state, 0, args["steps"])
    barrier()
    wall = time.perf_counter() - t0
    raster = sp.gather_raster(raster)
    if runtime.is_primary():
        raster = raster.numpy()
        emit(dict(wall_s=wall,
                  rate_hz=observables.mean_rate_hz(raster, cfg.n_neurons),
                  raster_sig=observables.raster_signature(
                      raster, sp.plan.gid.numpy()).hex(),
                  wire=mesh.backend))


def _run_point(H, gx, gy, npc, steps, device, exchange="allgather",
               timeout=None) -> dict:
    return call_ranks("repro_torch.bench.suites.scaling:rank_point",
                      dict(gx=gx, gy=gy, npc=npc, steps=steps,
                           exchange=exchange), H, device=device,
                      timeout=timeout)[0]


def strong_scaling(quick: bool = False, device: str = "cuda", *, npc=None,
                   steps=None, timeout=None):
    """A fixed problem (a 4x4 grid; 2x2 quick), growing H."""
    gx = gy = 2 if quick else 4
    npc = npc or (500 if quick else 1000)
    steps = steps or (100 if quick else 200)
    hs = [1, 2, 4] if quick else [1, 2, 4, 8]
    rows, sig0 = [], None
    for h in hs:
        p = _run_point(h, gx, gy, npc, steps, device, timeout=timeout)
        sig0 = sig0 or p["raster_sig"]
        n_syn = gx * gy * npc * 200
        norm = p["wall_s"] / (n_syn * steps / 1000.0
                              * max(p["rate_hz"], 1e-9))
        row = dict(mode="strong", shards=h, synapses=n_syn,
                   wall_s=p["wall_s"], rate_hz=p["rate_hz"],
                   raster_sig=p["raster_sig"], norm_s=norm, wire=p["wire"],
                   identical_spikes=p["raster_sig"] == sig0)
        rows.append(row)
        print("[scaling]", json.dumps(row), flush=True)
    if not all(r["identical_spikes"] for r in rows):
        raise RuntimeError("spiking must be identical across "
                           "distributions (paper Table 1)")
    return rows


def weak_scaling(quick: bool = False, device: str = "cuda", *, npc=None,
                 steps=None, timeout=None):
    """Fixed synapses per shard (one column a shard), growing H."""
    npc = npc or (500 if quick else 1000)
    steps = steps or (100 if quick else 200)
    grids = [(1, 1), (2, 1), (2, 2)] if quick else [(1, 1), (2, 1), (2, 2),
                                                    (4, 2)]
    rows = []
    for gx, gy in grids:
        h = gx * gy
        p = _run_point(h, gx, gy, npc, steps, device, timeout=timeout)
        syn_per_shard = npc * 200
        norm = p["wall_s"] / (syn_per_shard * steps / 1000.0
                              * max(p["rate_hz"], 1e-9))
        row = dict(mode="weak", shards=h, syn_per_shard=syn_per_shard,
                   wall_s=p["wall_s"], rate_hz=p["rate_hz"],
                   raster_sig=p["raster_sig"], norm_s=norm, wire=p["wire"])
        rows.append(row)
        print("[scaling]", json.dumps(row), flush=True)
    return rows


def run_suite(quick: bool = False, device=None, *, npc=None, steps=None,
              timeout=None) -> dict:
    from ...core.engine import resolve_device
    dev = resolve_device(device)
    npc = npc or (500 if quick else 1000)
    steps = steps or (100 if quick else 200)
    kw = dict(npc=npc, steps=steps, timeout=timeout)
    strong = strong_scaling(quick=quick, device=dev.type, **kw)
    weak = weak_scaling(quick=quick, device=dev.type, **kw)
    deterministic = dict(
        strong_raster_sig=strong[0]["raster_sig"],
        strong_identical_across_h=all(r["identical_spikes"]
                                      for r in strong))
    wall = {}
    for r in strong:
        wall[f"strong_h{r['shards']}_wall_s"] = r["wall_s"]
    for r in weak:
        wall[f"weak_h{r['shards']}_wall_s"] = r["wall_s"]
    config = dict(quick=quick, wire=strong[-1]["wire"],
                  strong_shards=[r["shards"] for r in strong],
                  weak_shards=[r["shards"] for r in weak],
                  neurons_per_column=npc, steps=steps)
    return R.make_report("scaling", config, deterministic, wall,
                         extra=dict(strong=strong, weak=weak), device=dev)
