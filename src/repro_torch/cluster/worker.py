"""Per-process cluster worker: join the job, run shards, report (the
port's `repro.cluster.worker`).

  python -m repro_torch.cluster.worker --grid 2x2 --shards 4 --steps 100 ...

Every rank joins the job (`runtime.ensure_initialized`, from the
REPRO_CLUSTER_* variables the launcher sets) before it touches a device,
builds the full host plan (construction is a pure function of the
config), uploads its block of H / R shards
(`StepProgram(cfg, eng, mesh=make_snn_mesh(H))`, on the job's device: the
card unless REPRO_CLUSTER_DEVICE=cpu) and runs:

  1. `StepProgram.run` over the mesh, timed end to end in
     checkpoint-period chunks; each chunk's raster is gathered on the
     primary for the global signature;
  2. optionally `StepProgram.time_phases`, attributing wall-clock to
     phase A / exchange / phase B on each rank (the paper's Table 2
     split across processes, schedule-aware under `--exchange-schedule
     pipelined`).

Fault tolerance (`cluster.faults`): with `--ckpt-dir`/`--ckpt-every K`
the primary writes a sha256-verified, layout-free epoch every K steps
(`core.checkpoint`, atomic tmp + rename) carrying the run's cumulative
spike events, and at startup every rank SELF-RESUMES from the newest
VALID epoch in the directory, so the supervisor
(`local.supervised_launch`) relaunches a failed gang with an unchanged
command line and recovery replays at most one period.  Chunk boundaries
are aligned to `base_t + k*K` whatever the resume point, and chunked
execution is bit-identical to unchunked, so the recovered run's final
raster AND weight signatures equal the fault-free run's.  Progress
beacons (`REPRO_BEACON_DIR`) and the deterministic fault hooks
(`REPRO_FAULT`) ride the same chunk boundaries.

The result is one `CLUSTER_RESULT {json}` line on stdout per rank, with
the reference's keys; `repro_torch.cluster.report` aggregates them.  The
gathered raster and state exist on the primary only, so the primary
computes the signatures, the spike count and `saturated` and shares
them over the wire: every rank reports the job's values.
`local_devices` is the rank's shard count (H / R).  A combination that
`core.step_program.check_supported` refuses exits non-zero with its
message.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import faults

RESULT_PREFIX = "CLUSTER_RESULT "


def add_workload_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--grid", default="2x2")
    ap.add_argument("--neurons-per-column", type=int, default=100)
    ap.add_argument("--synapses", type=int, default=40)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--shards", type=int, default=2,
                    help="total shards H across ALL processes")
    ap.add_argument("--exchange", default="allgather",
                    choices=["allgather", "halo", "hier"])
    ap.add_argument("--exchange-schedule", default="sync",
                    choices=["sync", "pipelined"],
                    help="'pipelined' overlaps the spike exchange with "
                         "phase A's LTP half (bit-identical outputs)")
    ap.add_argument("--placement", default="block",
                    choices=["block", "scatter"])
    ap.add_argument("--delivery", default="dense",
                    choices=["dense", "event"],
                    help="synaptic delivery backend: dense O(E) masked or "
                         "event-driven O(spikes x fan)")
    ap.add_argument("--profile", default="ring3",
                    help="lateral-connectivity profile spec "
                         "(repro_torch.core.profiles)")
    ap.add_argument("--connectivity-mode", default="materialized",
                    help="synapse-table residency: 'materialized' or "
                         "'streamed:chunk=K' (per-chunk regeneration "
                         "inside the step; requires --delivery dense)")
    ap.add_argument("--stim-events", type=int, default=1,
                    help="thalamic events per ms per column "
                         "(GridConfig.stim_events_per_ms_per_column)")
    ap.add_argument("--stim-amplitude", type=float, default=20.0,
                    help="thalamic event amplitude in mV")
    ap.add_argument("--phase-steps", type=int, default=0,
                    help="extra phase-split steps for per-phase timings "
                         "(0 = skip)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint to restore before running (its saved "
                         "t becomes t0)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="directory for periodic epochs; at startup the "
                         "worker self-resumes from the newest sha256-VALID "
                         "epoch found here (corrupt epochs skipped)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="periodic checkpoint period K in steps "
                         "(0 = off; needs --ckpt-dir)")


def workload_argv(args) -> list:
    """args -> worker argv tail (parent-side helper, kept next to the
    parser so the two cannot drift)."""
    argv = ["--grid", args.grid,
            "--neurons-per-column", str(args.neurons_per_column),
            "--synapses", str(args.synapses),
            "--seed", str(args.seed),
            "--steps", str(args.steps),
            "--shards", str(args.shards),
            "--exchange", args.exchange,
            "--exchange-schedule", getattr(args, "exchange_schedule",
                                           "sync"),
            "--placement", args.placement,
            "--delivery", getattr(args, "delivery", "dense"),
            "--profile", args.profile,
            "--connectivity-mode", getattr(args, "connectivity_mode",
                                           "materialized"),
            "--stim-events", str(getattr(args, "stim_events", 1)),
            "--stim-amplitude", str(getattr(args, "stim_amplitude",
                                            20.0)),
            "--phase-steps", str(args.phase_steps)]
    if getattr(args, "ckpt", None):
        argv += ["--ckpt", args.ckpt]
    if getattr(args, "ckpt_dir", None):
        argv += ["--ckpt-dir", args.ckpt_dir]
    if getattr(args, "ckpt_every", 0):
        argv += ["--ckpt-every", str(args.ckpt_every)]
    return argv


def _chunk_spans(t_from: int, t_end: int, k: int, align: int) -> list:
    """[(a, b)] chunk boundaries for [t_from, t_end), cut at every
    `align + i*k` (k=0: one chunk).  Alignment to the run BASE rather
    than the resume point is what makes a resumed run re-enter the exact
    chunk sequence of the fault-free run."""
    bs = [t_from]
    if k > 0:
        b = align + ((t_from - align) // k + 1) * k
        while b < t_end:
            bs.append(b)
            b += k
    if bs[-1] != t_end:
        bs.append(t_end)
    return [(bs[i], bs[i + 1]) for i in range(len(bs) - 1)
            if bs[i + 1] > bs[i]]


def _share(mesh, values):
    """The primary's list of non-negative ints on every rank (a sum over
    the wire, the other ranks adding zeros); `values` is the length-n
    list on the primary and [0] * n elsewhere."""
    import torch
    x = torch.tensor(values, dtype=torch.int64, device=mesh.device)
    return [int(v) for v in mesh.wire.all_reduce_sum(x).cpu()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.cluster.worker")
    add_workload_args(ap)
    args = ap.parse_args(argv)
    if args.ckpt_every > 0 and not args.ckpt_dir:
        raise SystemExit("worker: --ckpt-every needs --ckpt-dir")

    # the rank from the launcher's environment: faults and beacons key off
    # it before the job is joined
    from .._flags import ENV_PROC_ID
    rank = int(os.environ.get(ENV_PROC_ID, "0") or 0)
    attempt = int(os.environ.get(faults.ENV_ATTEMPT, "0") or 0)
    inj = faults.FaultInjector.from_env(rank)
    beacon = faults.BeaconWriter.from_env(rank)
    beacon.write(0, "boot", attempt=attempt)

    # join the job BEFORE anything touches a device
    from . import runtime
    runtime.ensure_initialized()

    import numpy as np
    import torch

    from .._flags import ENV_TUNED
    from ..core import (EngineConfig, GridConfig, StepProgram, checkpoint,
                        observables)
    from ..core.step_program import check_supported
    from ..dist.mesh import make_snn_mesh

    H = args.shards
    gx, gy = (int(v) for v in args.grid.split("x"))
    cfg = GridConfig(grid_x=gx, grid_y=gy,
                     neurons_per_column=args.neurons_per_column,
                     synapses_per_neuron=args.synapses, seed=args.seed,
                     connectivity=args.profile,
                     stim_events_per_ms_per_column=args.stim_events,
                     stim_amplitude=args.stim_amplitude)
    eng = EngineConfig(n_shards=H, exchange=args.exchange,
                       exchange_schedule=args.exchange_schedule,
                       placement=args.placement, delivery=args.delivery,
                       connectivity=args.connectivity_mode)
    try:
        mesh = make_snn_mesh(H)
        check_supported(eng, mesh)
    except (NotImplementedError, ValueError, RuntimeError) as e:
        raise SystemExit(f"worker: {e}")
    event = args.delivery == "event"
    primary = runtime.is_primary()
    sp = StepProgram(cfg, eng, mesh=mesh)
    state, base_t = sp.init_state(), 0
    if args.ckpt:
        state, base_t = sp.load(args.ckpt)

    # self-resume: the newest VALID periodic epoch wins over the cold start
    # or the explicit --ckpt base.  Cumulative events ride the epoch, so
    # the FULL-run signature survives the restart.
    t0, restored_from = base_t, None
    ev_t = np.zeros((0,), np.int64)
    ev_g = np.zeros((0,), np.int64)
    if args.ckpt_dir:
        newest = checkpoint.latest_valid(args.ckpt_dir)
        if newest is not None and checkpoint.saved_t(newest) > base_t:
            state, t0 = sp.load(newest)
            ev = checkpoint.load_raster_events(newest)
            if ev is not None:
                ev_t, ev_g = ev
            restored_from = newest
            print(f"[worker {rank}] resumed from {newest} (t={t0}, "
                  f"{ev_t.shape[0]} events restored)", flush=True)
    t_end = base_t + args.steps
    beacon.write(t0, "built")

    def fence():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    state_d = sp.place(state)
    spans = _chunk_spans(t0, t_end, args.ckpt_every, base_t)
    # warm-up: one step loads the kernels and sizes the wire's buffers, so
    # that the timed chunks measure steady state (run copies its input)
    if spans:
        sp.run(state_d, t0, 1)
        fence()
    beacon.write(t0, "warmup")

    gid_np = sp.plan.gid.cpu().numpy()
    cur = state_d
    wall_s = ckpt_wall_s = 0.0
    n_ckpts = 0
    for a, b in spans:
        beacon.write(a, "chunk")
        inj.on_chunk(a, b)
        w0 = time.perf_counter()
        cur, raster, _ = sp.run(cur, a, b - a)
        fence()
        wall_s += time.perf_counter() - w0
        # event times RELATIVE to the run base (t - base_t): a run
        # restored from --ckpt signs its continuation window like a
        # single-process run over the same window
        raster = sp.gather_raster(raster)
        if primary:
            ct, cg = observables.raster_events(raster.numpy(), gid_np,
                                               t0=a - base_t)
            ev_t = np.concatenate([ev_t, ct])
            ev_g = np.concatenate([ev_g, cg])
        if args.ckpt_every > 0:
            c0 = time.perf_counter()
            host = sp.gather(cur)          # a collective; the write is not
            path = os.path.join(args.ckpt_dir, f"ckpt_{b}.npz")
            if primary:
                checkpoint.save(path, sp.spec, sp.plan, host, b,
                                raster_events=(ev_t, ev_g))
                inj.on_checkpoint_written(path, b)
            # no rank starts the next chunk (where a fault may fire) before
            # the epoch is on disk
            _share(mesh, [0])
            ckpt_wall_s += time.perf_counter() - c0
            n_ckpts += 1

    beacon.write(t_end, "report")
    host = sp.gather(cur)
    shared = [0] * 66
    if primary:
        shared = ([int(ev_t.shape[0]),
                   int(host.sat.sum()) if event else 0]
                  + list(observables.events_signature(ev_t, ev_g))
                  + list(sp.weight_signature(host)))
    shared = _share(mesh, shared)
    spikes, saturated = shared[:2]
    T = t_end - base_t
    result = dict(
        proc=runtime.process_index(), nprocs=runtime.process_count(),
        shards=H, t0=base_t, steps=args.steps,
        exchange=args.exchange, placement=args.placement,
        exchange_schedule=args.exchange_schedule,
        delivery=args.delivery, profile=args.profile,
        connectivity_mode=args.connectivity_mode,
        stim_events=args.stim_events,
        tuned_env=os.environ.get(ENV_TUNED, "") == "1",
        device=mesh.device.type, wire=mesh.backend,
        local_devices=mesh.per_rank,
        wall_s=round(wall_s, 4),
        spikes=spikes,
        rate_hz=round(spikes / (cfg.n_neurons * T / 1000.0), 3)
        if T else 0.0,
        # signature over the FULL run window [base_t, t_end): per-chunk
        # events concatenate in canonical order, so this equals the
        # one-shot raster_signature bit for bit
        raster_sig=bytes(shared[2:34]).hex(),
        weights_sig=bytes(shared[34:66]).hex(),
        # recovery bookkeeping (surfaced by cluster.report)
        attempt=attempt,
        ckpt_every=args.ckpt_every, n_ckpts=n_ckpts,
        ckpt_wall_s=round(ckpt_wall_s, 4),
        restored_from=restored_from,
        restored_t=(t0 if restored_from else None),
        # steps salvaged from periodic epochs instead of recomputed: the
        # restart replays only [restored_t, failure point)
        recovered_steps=(t0 - base_t) if restored_from else 0)
    if event:
        result["saturated"] = saturated

    if args.phase_steps > 0:
        # run never changes its input state, so state_d seeds the split
        # loop; its warm-up and fences are time_phases' own
        _, times, _, _ = sp.time_phases(state_d, t0, args.phase_steps)
        result["phase_steps"] = args.phase_steps
        result.update({k: round(v, 4) for k, v in times.items()})

    if inj.emit_result():
        print(RESULT_PREFIX + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
