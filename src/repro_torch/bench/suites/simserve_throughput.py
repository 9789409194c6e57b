"""Multi-tenant service throughput: `repro_torch.simserve` at 1 / 4 / 8
tenants on one shape key (port of `repro.bench.suites.
simserve_throughput`).

Same-shape tenants share one round program with the tenants folded onto
the shard axis (on the card one captured CUDA graph of `round_steps`
steps), so aggregate steps/s should grow with the tenant count for as
long as one step of the folded group costs less than one step of each
tenant apart.  Each cell submits N same-shape tenants (seeds differ, which
the shape key ignores), drives the service to completion and reports

  wall           aggregate tenant-steps/s, the service's wall and the
                 paper's time per synaptic event (service wall / (total
                 spikes x synapses per neuron)) per tenant count;
  deterministic  one combined signature per tenant count (sha256 over the
                 tenants' streamed raster signatures, each equal to its
                 solo run) and the program cache's builds and captures
                 (`traces`: 1 build, 1 capture whatever N).

The default grid is the JAX suite's (2x2, 20 neurons a column, 10
synapses, H = 2), so that the CPU signatures compare with it;
`size="full"` runs the paper's column (1,000 neurons, 200 synapses each)
on a 4x4 grid, 3.2 M synapses a tenant, and also reports the same
tenants run one after another through solo `StepProgram.run` and, on the
card, the device's idle share over one profiled round (each cell's last,
after the capture).  Every cell reports the host time the admissions
spend building tables (`build_s`) and the rounds' time without it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
import torch

from ...core import EngineConfig, GridConfig, observables
from ...core.engine import resolve_device
from ...core.step_program import StepProgram
from ...simserve import SimService, TenantRequest
from .. import report as R

TENANT_COUNTS = (1, 4, 8)
SIZES = {"jax": dict(grid_x=2, grid_y=2, neurons_per_column=20,
                     synapses_per_neuron=10),
         "full": dict(grid_x=4, grid_y=4)}


def _tenants(cfg0: GridConfig, n: int):
    return [dataclasses.replace(cfg0, seed=2013 + 7919 * i)
            for i in range(n)]


def _profile_round(svc: SimService) -> dict:
    """One scheduler round under torch.profiler: its wall, the device time
    of its kernels and copies, and the device's idle share (1 - busy /
    wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.step_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return dict(round_wall_s=wall, round_device_busy_s=busy_us * 1e-6,
                device_idle_share=(1.0 - busy_us * 1e-6 / wall)
                if busy_us else None)


def _run_cell(n_tenants: int, steps: int, round_steps: int,
              cfg0: GridConfig, eng: EngineConfig, device,
              profile_last: bool = False) -> dict:
    svc = SimService(slots=n_tenants, round_steps=round_steps,
                     device=device)
    reqs = [TenantRequest(f"t{i}", cfg, eng, steps)
            for i, cfg in enumerate(_tenants(cfg0, n_tenants))]
    for r in reqs:
        svc.submit(r)
    prof = None
    spikes_of = lambda: sum(svc.sessions[r.name].spike_total for r in reqs)
    if profile_last:
        # every round but the last timed as the service runs them (the
        # wall and rates are theirs), the last (its graph captured long
        # before) under the profiler
        rounds = -(-steps // round_steps)
        snap = svc.run(max_rounds=rounds - 1)
        timed_spikes = spikes_of()
        prof = _profile_round(svc)
        svc.run()
    else:
        snap = svc.run()
        timed_spikes = spikes_of()
    sigs = [svc.sessions[r.name].stream.signature() for r in reqs]
    combined = hashlib.sha256(b"".join(sigs)).hexdigest()[:16]
    spikes = spikes_of()
    syn_events = timed_spikes * cfg0.synapses_per_neuron
    wall = snap["wall_s"]
    row = dict(
        tenants=n_tenants, steps=steps, round_steps=round_steps,
        spikes=spikes, wall_s=round(wall, 4),
        steps_per_s=int(snap["tenant_steps_per_s"]),
        time_per_syn_event_s=wall / max(syn_events, 1),
        sig=combined,
        cache_builds=snap["program_cache"]["builds"],
        traces=sum(snap["program_cache"]["traces"].values()),
        build_s=snap["build_s"], run_s=wall - snap["build_s"],
        tenant_steps=snap["tenant_steps"],
        sat=sum(svc.sessions[r.name].sat_total for r in reqs),
        device=svc.device.type, tenant_sigs=[s.hex() for s in sigs])
    if prof is not None:
        row.update(prof, timed_rounds=snap["rounds"])
    return row


def solo_sequence(n_tenants: int, steps: int, cfg0: GridConfig,
                  eng: EngineConfig, device) -> list:
    """The suite's tenants run one after another, each alone through
    `StepProgram.run` (its first window eager, then its captured graph):
    per tenant its host build seconds, its run's seconds (synchronised)
    and its raster signature."""
    dev = resolve_device(device)
    out = []
    for cfg in _tenants(cfg0, n_tenants):
        t0 = time.perf_counter()
        sp = StepProgram(cfg, eng, device=dev)
        build = time.perf_counter() - t0
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, raster, _ = sp.run(sp.init_state(), 0, steps)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        run = time.perf_counter() - t0
        sig = observables.raster_signature(raster.cpu().numpy(),
                                           sp.plan.gid.cpu().numpy())
        out.append(dict(build_s=build, run_s=run, sig=sig.hex(),
                        spikes=int(raster.sum())))
        del sp, raster
    return out


def run_suite(quick: bool = False, device=None, size: str = "jax") -> dict:
    """The suite's report on `device` (the card by default).  `size`
    "jax" is the JAX suite's grid at H = 2 (`quick`: 40 steps in rounds of
    10, else 100 in rounds of 20); "full" the paper's column on a 4x4 grid
    at H = 1, 300 steps in rounds of 50, beside the same tenants run one
    after another alone (`solo_sequence`), with the device's idle share
    over each cell's last round on the card."""
    dev = resolve_device(device)
    cfg0 = GridConfig(**SIZES[size])
    full = size == "full"
    eng = EngineConfig(n_shards=1 if full else 2, delivery="dense")
    steps, round_steps = (300, 50) if full else (40, 10) if quick \
        else (100, 20)
    solos = solo_sequence(max(TENANT_COUNTS), steps, cfg0, eng, dev) \
        if full else None
    deterministic, wall, rows = {}, {}, []
    for n in TENANT_COUNTS:
        row = _run_cell(n, steps, round_steps, cfg0, eng, dev,
                        profile_last=full and dev.type == "cuda")
        if solos is not None:
            seq = solos[:n]
            run_s = sum(s["run_s"] for s in seq)
            row.update(
                solo_run_s=run_s,
                solo_build_s=sum(s["build_s"] for s in seq),
                solo_steps_per_s=n * steps / run_s,
                solo_equal=[s["sig"] for s in seq] == row["tenant_sigs"])
        rows.append(row)
        print("[simserve]", json.dumps(row), flush=True)
        deterministic[f"t{n}_sig"] = row["sig"]
        deterministic[f"t{n}_cache_builds"] = row["cache_builds"]
        deterministic[f"t{n}_traces"] = row["traces"]
        wall[f"t{n}_wall_s"] = row["wall_s"]
        wall[f"t{n}_steps_per_s"] = row["steps_per_s"]
        wall[f"t{n}_time_per_syn_event_s"] = row["time_per_syn_event_s"]
    config = dict(quick=quick, steps=steps, round_steps=round_steps,
                  tenants=list(TENANT_COUNTS), size=size,
                  grid=dataclasses.asdict(cfg0), shards=eng.n_shards)
    return R.make_report("simserve_throughput", config, deterministic,
                         wall, extra=dict(rows=rows, solo=solos),
                         device=dev)
