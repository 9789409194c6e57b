"""`python -m repro_torch.cluster` — run the engine across real processes
(the port's `repro.cluster.cli`).

  python -m repro_torch.cluster run --nprocs 2 [--shards H] [--grid 2x2]
      [--device cuda|cpu] [--supervise --ckpt-every K [--fault SPEC]] ...
      one job of `nprocs` ranks on localhost (`cluster.local`); verifies
      that the gathered raster and final weights are bit-identical to the
      port's single-process run of the same config.

  python -m repro_torch.cluster sweep [--nprocs-list 1,2] [--quick]
      [--out DIR] [--device cuda|cpu]
      strong scaling over process counts at fixed total shards H: every
      point must produce the identical raster (paper Table 1 across the
      process axis) and reports per-process phase A / exchange / phase B
      walls (paper Figs. 5-8), written as BENCH_cluster_scaling.json.

The ranks run on the card (`--device cuda`, the default; ranks sharing
one GPU exchange over gloo staged through pinned host memory) or, when
asked, on the CPU.  The reference's `run_plan_cell` (an experiment-plan
cell as a launch) needs `bench/plans`, which is not ported (ROADMAP
queue 1, item 12).
"""
from __future__ import annotations

import argparse
import sys

from . import local
from . import report as crep
from . import worker as cworker

WORKER = ["-m", "repro_torch.cluster.worker"]


def workload_namespace(**kw):
    """Workload namespace with worker defaults, overridden by `kw`."""
    ap = argparse.ArgumentParser()
    cworker.add_workload_args(ap)
    args = ap.parse_args([])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def run_point(args, nprocs: int, timeout: float = 900.0) -> dict:
    """Launch one `nprocs`-process run of the workload in `args` on
    `args.device` (default "cuda"); returns the aggregated scaling row.
    `args.tuned_env` starts the workers under `_flags.tuned_host_env`
    (recorded in their results).

    `args.supervise` routes through `local.supervised_launch`: beacon
    stall detection, fault arming (`args.fault` or the ambient
    REPRO_FAULT, first attempt only), and gang relaunch under
    `args.max_restarts`; the restart history lands in the row's
    `recovery` dict."""
    H = args.shards
    if H % nprocs != 0:
        raise ValueError(f"shards {H} not divisible by nprocs {nprocs}")
    cmd = [*WORKER, *cworker.workload_argv(args)]
    device = getattr(args, "device", "cuda")
    tuned = getattr(args, "tuned_env", False)
    attempts = []
    if getattr(args, "supervise", False):
        outputs, attempts = local.supervised_launch(
            cmd, nprocs, timeout=timeout, device=device,
            stall_timeout=getattr(args, "stall_timeout", 120.0),
            max_restarts=getattr(args, "max_restarts", 2),
            fault=getattr(args, "fault", None), tuned_env=tuned)
    else:
        outputs = local.launch(cmd, nprocs, timeout=timeout, device=device,
                               tuned_env=tuned)
    return crep.summarize_point(crep.parse_worker_outputs(outputs),
                                attempts=attempts)


def reference_signatures(args) -> tuple:
    """(raster_sig, weights_sig) of the port's single-process run of the
    same workload (the shards stacked on `args.device`): the ground truth
    `run --verify` compares with.  A supervised run that crashed and
    recovered must match BOTH, the Table 1 invariant extended along the
    failure axis."""
    from ..core import EngineConfig, GridConfig, StepProgram, observables

    gx, gy = (int(v) for v in args.grid.split("x"))
    cfg = GridConfig(grid_x=gx, grid_y=gy,
                     neurons_per_column=args.neurons_per_column,
                     synapses_per_neuron=args.synapses, seed=args.seed,
                     connectivity=getattr(args, "profile", "ring3"),
                     stim_events_per_ms_per_column=getattr(
                         args, "stim_events", 1),
                     stim_amplitude=getattr(args, "stim_amplitude",
                                            20.0))
    eng = EngineConfig(n_shards=args.shards, exchange=args.exchange,
                       placement=args.placement,
                       delivery=getattr(args, "delivery", "dense"),
                       connectivity=getattr(args, "connectivity_mode",
                                            "materialized"))
    sp = StepProgram(cfg, eng, device=getattr(args, "device", "cuda"))
    state, t0 = sp.init_state(), 0
    if getattr(args, "ckpt", None):
        state, t0 = sp.load(args.ckpt)
    state_f, raster, _ = sp.run(state, t0, args.steps)
    return (observables.raster_signature(raster.cpu().numpy(),
                                         sp.plan.gid.cpu().numpy()).hex(),
            sp.weight_signature(state_f).hex())


def cmd_run(args) -> int:
    """`run`: one localhost job; prints the per-process phase walls and
    (unless --no-verify) checks that the gathered raster AND final weights
    bit-match the single-process run.  Exit 1 on a mismatch.  With
    --supervise, injected or real failures are recovered by gang relaunch
    from the newest valid epoch (see --ckpt-every) and the restart
    history is printed."""
    if args.shards is None:
        args.shards = args.nprocs
    if (getattr(args, "supervise", False) and args.ckpt_every > 0
            and not args.ckpt_dir):
        # recovery needs a place for epochs; default to a fresh temp dir
        import tempfile
        args.ckpt_dir = tempfile.mkdtemp(prefix="repro_ckpt_")
    row = run_point(args, args.nprocs, timeout=args.timeout)
    print(f"[cluster] {args.nprocs} procs x "
          f"{args.shards // args.nprocs} shards on {row['device']} "
          f"({row['wire']}): wall {row['wall_s']}s, "
          f"rate {row['rate_hz']} Hz, raster {row['raster_sig'][:16]}..., "
          f"weights {row.get('weights_sig', '?')[:16]}...")
    for pp in row["per_proc"]:
        print(f"[cluster]   proc {pp['proc']}: " + ", ".join(
            f"{k}={pp[k]}" for k in pp if k != "proc"))
    rec = row.get("recovery", {})
    if rec.get("restarts"):
        print(f"[cluster] recovered after {rec['restarts']} restart(s); "
              f"resumed at t={rec.get('restored_t')} "
              f"({rec.get('recovered_steps', 0)} steps salvaged)")
        for a in rec.get("attempts", []):
            print(f"[cluster]   attempt {a['index']}: {a['reason']} "
                  f"(backoff {a['backoff_s']}s)")
    if args.verify:
        ref_r, ref_w = reference_signatures(args)
        fail = []
        if ref_r != row["raster_sig"]:
            fail.append(f"raster {row['raster_sig'][:16]} != {ref_r[:16]}")
        if row.get("weights_sig") and ref_w != row["weights_sig"]:
            fail.append(
                f"weights {row['weights_sig'][:16]} != {ref_w[:16]}")
        if fail:
            print(f"[cluster] FAIL: differs from the single-process run "
                  f"({'; '.join(fail)})")
            return 1
        print("[cluster] verify OK: raster and weights bit-identical to "
              "the single-process run")
    return 0


def sweep_report(quick: bool = False, nprocs_list=None, out: str = None,
                 timeout: float = 900.0, profile: str = "ring3",
                 delivery: str = "dense", exchange_schedule: str = "sync",
                 tuned_env: bool = False, ckpt_every: int = 0,
                 device: str = "cuda") -> dict:
    """Run the strong-scaling sweep; returns (and optionally writes) the
    BENCH report.  Total shards H = max process count, so the 1-process
    point runs H shards on its rank and the P-process point H/P each.
    `profile` selects the lateral-connectivity kernel and `delivery` the
    synaptic backend; the invariant must hold at every reach and for both
    backends.  `ckpt_every` > 0 adds periodic checkpointing (a fresh
    epoch directory per point), so the rows carry `ckpt_wall_s`."""
    import tempfile

    from ..bench import report as bench_report

    nprocs_list = sorted(nprocs_list or [1, 2])
    args = workload_namespace(
        grid="2x2",
        neurons_per_column=60 if quick else 150,
        synapses=25 if quick else 60,
        steps=60 if quick else 150,
        phase_steps=15 if quick else 40,
        shards=max(nprocs_list),
        profile=profile,
        delivery=delivery,
        exchange_schedule=exchange_schedule,
        tuned_env=tuned_env,
        ckpt_every=ckpt_every,
        device=device)
    rows = []
    for p in nprocs_list:
        if ckpt_every > 0:
            # fresh per point: a stale epoch would otherwise short-circuit
            # the run through the worker's self-resume
            args.ckpt_dir = tempfile.mkdtemp(prefix=f"repro_sweep_p{p}_")
        row = run_point(args, p, timeout=timeout)
        print(f"[cluster] point nprocs={p}: wall {row['wall_s']}s "
              f"sig {row['raster_sig'][:16]}", flush=True)
        rows.append(row)
    for key in ("raster_sig", "weights_sig"):
        sigs = {r[key] for r in rows if key in r}
        if len(sigs) > 1:
            raise RuntimeError(
                f"paper Table 1 invariant violated across the process "
                f"axis ({key}): "
                f"{[(r['nprocs'], r[key][:16]) for r in rows]}")
    config = dict(quick=quick, nprocs=nprocs_list, shards=args.shards,
                  grid=args.grid, neurons_per_column=args.neurons_per_column,
                  synapses=args.synapses, steps=args.steps,
                  phase_steps=args.phase_steps, exchange=args.exchange,
                  placement=args.placement, profile=args.profile,
                  delivery=args.delivery,
                  exchange_schedule=args.exchange_schedule,
                  tuned_env=tuned_env, device=device)
    if ckpt_every > 0:
        config["ckpt_every"] = ckpt_every
    rep = crep.scaling_report(rows, config)
    if out:
        path = bench_report.save(rep, out)
        print(f"[cluster] wrote {path}")
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.cluster",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("run", help="one multi-process run on localhost")
    rp.add_argument("--nprocs", type=int, default=2)
    cworker.add_workload_args(rp)
    rp.set_defaults(shards=None)
    rp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the ranks (and the verifying run) run")
    rp.add_argument("--timeout", type=float, default=900.0)
    rp.add_argument("--no-verify", dest="verify", action="store_false",
                    help="skip the single-process bit-identity check")
    rp.add_argument("--tuned-env", action="store_true",
                    help="launch workers under the tcmalloc host preset "
                         "(_flags.tuned_host_env); recorded in the result "
                         "JSON for A/B comparison")
    rp.add_argument("--supervise", action="store_true",
                    help="beacon stall detection + gang relaunch from the "
                         "newest valid epoch on any failure (see "
                         "--ckpt-every / --max-restarts)")
    rp.add_argument("--fault", default=None,
                    help="deterministic fault to inject on the FIRST "
                         "attempt (repro_torch.cluster.faults grammar, e.g. "
                         "crash@step=30:rank=1); default: the ambient "
                         "REPRO_FAULT variable")
    rp.add_argument("--max-restarts", type=int, default=2,
                    help="supervised restart budget (relaunches, not "
                         "counting the first attempt)")
    rp.add_argument("--stall-timeout", type=float, default=120.0,
                    help="supervised: declare the gang hung when no "
                         "worker beacon changes for this many seconds")

    sp = sub.add_parser("sweep", help="strong scaling over process counts")
    sp.add_argument("--nprocs-list", default="1,2",
                    help="comma-separated process counts (default 1,2)")
    sp.add_argument("--quick", action="store_true",
                    help="CI-sized workload")
    sp.add_argument("--out", default="results/cluster",
                    help="directory for BENCH_cluster_scaling.json")
    sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    sp.add_argument("--timeout", type=float, default=900.0,
                    help="per-point launch timeout (seconds)")
    sp.add_argument("--profile", default="ring3",
                    help="lateral-connectivity profile spec "
                         "(repro_torch.core.profiles)")
    sp.add_argument("--delivery", default="dense",
                    choices=["dense", "event"],
                    help="synaptic delivery backend for every sweep point")
    sp.add_argument("--exchange-schedule", default="sync",
                    choices=["sync", "pipelined"],
                    help="exchange issue order for every sweep point")
    sp.add_argument("--tuned-env", action="store_true",
                    help="launch workers under the tcmalloc host preset")
    sp.add_argument("--ckpt-every", type=int, default=0,
                    help="periodic checkpoint period K for every point "
                         "(0 = off); rows then carry ckpt_wall_s")

    args = ap.parse_args(argv)
    if args.cmd == "run":
        return cmd_run(args)
    nprocs_list = [int(v) for v in args.nprocs_list.split(",") if v]
    sweep_report(quick=args.quick, nprocs_list=nprocs_list, out=args.out,
                 timeout=args.timeout, profile=args.profile,
                 delivery=args.delivery,
                 exchange_schedule=args.exchange_schedule,
                 tuned_env=args.tuned_env, ckpt_every=args.ckpt_every,
                 device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
