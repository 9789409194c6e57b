"""Comm/compute overlap: hidden against exposed spike-exchange time, port
of `repro.bench.suites.comm_overlap` over `torch.distributed` ranks.

The paper keeps communication under ~10% of the wall clock by overlapping
the AER spike exchange with computation where the delay structure allows.
Every cell runs the same physics under both exchange schedules:

  sync       the exchange fenced between phase A and phase B; exchange_s
             is the wire's full exposed time,
  pipelined  the exchange issued between phase A's two halves and waited
             for only right before the phase B that consumes it, one step
             later; exchange_s records the issue and the residual wait,
             what stays exposed after hiding behind the LTP half,

across lateral-connectivity profiles (the reach sets how much wire there
is to hide) and shard counts H, each over H ranks (one shard a rank, real
collectives, `core.distributed`), timed by `StepProgram.time_phases`.
Each H starts its ranks once (`bench.subproc.call_ranks`); the times are
the primary rank's, each the minimum over `reps` passes.

Gates: (a) both schedules give the same raster in every cell (a schedule
is an execution layout, never physics), always; (b) on profiles of reach
>= 3 the pipelined exposed exchange is below the sync one, only where the
ranks own separate devices (one GPU a rank: `config.hidden_gate`).  Where
ranks share a card (the one-card machine: gloo staged through host
memory, the ranks sharing its SMs) or run on the CPU, (b) is recorded and
not enforced: that pipelining hides nothing there is a finding, not a
failure.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from .. import report as R
from ..subproc import call_ranks, emit

# (key, profile spec): keys are report-safe names, specs feed GridConfig
PROFILES = (("ring1", "ring1"),
            ("ring3", "ring3"),
            ("gauss5", "gaussian:sigma=1.5"))
SCHEDULES = ("sync", "pipelined")
H_LIST = (2, 4)


def _cell(sp, steps: int, reps: int) -> dict:
    """One (profile, H, schedule) cell on this rank: per-phase walls are
    the per-key minimum over `reps` passes of `time_phases`; the raster
    signature is the primary's (None elsewhere)."""
    from ...cluster import runtime
    from ...core import observables
    times = rasters = counts = None
    for _ in range(reps):
        _, t1, rasters, counts = sp.time_phases(sp.init_state(), 0, steps,
                                                collect_rasters=True)
        times = t1 if times is None else \
            {k: min(v, t1[k]) for k, v in times.items()}
    if not runtime.is_primary():
        return {}
    sig = observables.raster_signature(np.stack(rasters),
                                       sp.plan.gid.numpy())
    phases_sum = sum(times.values())
    return dict(**times, phases_sum_s=phases_sum,
                exposed_fraction=times["exchange_s"] / phases_sum
                if phases_sum else 0.0,
                spikes=counts["spikes"], raster_sig=sig.hex())


def rank_cells(args: dict) -> None:
    """Inside each rank of an H-rank job: every (profile, schedule) cell at
    H shards; the primary emits one result line a cell."""
    from ...cluster import runtime
    from ...core import EngineConfig, GridConfig, StepProgram, profiles
    from ...dist.mesh import make_snn_mesh
    H = runtime.process_count()
    for pkey, pspec in PROFILES:
        cfg = GridConfig(grid_x=4, grid_y=2,
                         neurons_per_column=args["npc"],
                         synapses_per_neuron=50, seed=5, connectivity=pspec)
        eng0 = EngineConfig(n_shards=H, exchange="halo")
        mesh = make_snn_mesh(H)
        # one build per (profile, H): the plan is schedule-independent
        sp0 = StepProgram(cfg, eng0, mesh=mesh)
        for sched in SCHEDULES:
            eng = dataclasses.replace(eng0, exchange_schedule=sched)
            sp = StepProgram.from_parts(sp0.spec._replace(eng=eng), sp0.plan,
                                        sp0.init_state(), mesh=mesh)
            cell = _cell(sp, args["steps"], args["reps"])
            if runtime.is_primary():
                emit(dict(key=f"{pkey}_h{H}_{sched}", profile=pspec,
                          reach=profiles.parse(pspec).reach(), h=H,
                          schedule=sched, steps=args["steps"],
                          wire=mesh.backend, **cell))


def separate_devices(device: str, n_ranks: int) -> bool:
    """Whether `n_ranks` ranks on `device` each own a device of their own
    (one GPU a rank): where the hidden < exposed gate holds."""
    import torch
    return device == "cuda" and n_ranks <= torch.cuda.device_count()


def run_suite(quick: bool = False, device=None, *, npc=None, steps=None,
              timeout=None) -> dict:
    from ...core.engine import resolve_device
    dev = resolve_device(device)
    npc = npc or (80 if quick else 200)
    steps = steps or (40 if quick else 100)
    reps = 3
    cells, pairs, gated = {}, {}, {}
    for H in H_LIST:
        gated[H] = separate_devices(dev.type, H)
        for c in call_ranks("repro_torch.bench.suites.comm_overlap:"
                            "rank_cells", dict(npc=npc, steps=steps,
                                               reps=reps), H,
                            device=dev.type, timeout=timeout):
            cells[c.pop("key")] = c
            print("[comm_overlap]", json.dumps(c), flush=True)
        for pkey, pspec in PROFILES:
            sy = cells[f"{pkey}_h{H}_sync"]
            pi = cells[f"{pkey}_h{H}_pipelined"]
            if sy["raster_sig"] != pi["raster_sig"]:
                raise RuntimeError(
                    f"schedule changed the physics at {pkey} H={H}: sync "
                    f"{sy['raster_sig'][:16]} != pipelined "
                    f"{pi['raster_sig'][:16]}")
            hidden = pi["exchange_s"] < sy["exchange_s"]
            if gated[H] and sy["reach"] >= 3 and not hidden:
                raise RuntimeError(
                    f"pipelined exchange not hidden at {pkey} (reach "
                    f"{sy['reach']}) H={H} on ranks with a GPU each: "
                    f"exposed {pi['exchange_s']}s >= sync "
                    f"{sy['exchange_s']}s")
            pairs[f"{pkey}_h{H}"] = dict(
                profile=pspec, reach=sy["reach"], h=H,
                sync_exchange_s=sy["exchange_s"],
                pipelined_exchange_s=pi["exchange_s"],
                hidden_s=sy["exchange_s"] - pi["exchange_s"],
                hidden_fraction=1.0 - pi["exchange_s"] / sy["exchange_s"]
                if sy["exchange_s"] else 0.0, hidden=hidden)

    deterministic, wall = {}, {}
    for pair_key in pairs:
        deterministic[f"sig_{pair_key}"] = \
            cells[f"{pair_key}_sync"]["raster_sig"]
        deterministic[f"spikes_{pair_key}"] = \
            cells[f"{pair_key}_sync"]["spikes"]
        wall[f"{pair_key}_hidden_fraction"] = pairs[pair_key][
            "hidden_fraction"]
    for key, c in cells.items():
        for m in ("phase_a_s", "exchange_s", "phase_b_s",
                  "exposed_fraction"):
            wall[f"{key}_{m}"] = c[m]
    config = dict(
        quick=quick, h_list=list(H_LIST), grid="4x2",
        neurons_per_column=npc, steps=steps, exchange="halo",
        profiles=[p for _, p in PROFILES],
        wire={f"h{H}": cells[f"ring1_h{H}_sync"]["wire"] for H in H_LIST},
        hidden_gate={f"h{H}": ("enforced: a GPU a rank" if g else
                               "recorded only: the ranks share a device")
                     for H, g in gated.items()})
    return R.make_report(
        "comm_overlap", config, deterministic, wall,
        extra=dict(cells=[dict(cell=k, **c) for k, c in sorted(
            cells.items())],
            overlap=[dict(pair=k, **p) for k, p in sorted(pairs.items())]),
        device=dev)
