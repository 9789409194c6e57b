"""repro_torch.cluster — the DPSNN engine across real processes (the
port's `repro.cluster`).

The paper runs DPSNN-STDP as N communicating MPI processes on a commodity
cluster.  Here the processes are the ranks of one `torch.distributed`
job on localhost, each holding its block of H / R shards on the card
(ranks sharing one GPU exchange over gloo staged through pinned host
memory) or, when asked, on the CPU (gloo):

  runtime — joining the job from the REPRO_CLUSTER_* variables (or
      torchrun's) and the host-side gathers.
  local — the launcher: starts the workers as the ranks of a job
      (`bench.subproc.Ranks`, a `file://` store an attempt), collects
      their output, reaps the survivors when any worker fails; under
      supervision, beacon stall detection and gang relaunch from the
      newest valid epoch.  The supervising parent touches no device.
  worker — the per-process entry point: joins the job, builds its
      shards, runs `StepProgram` over the mesh in checkpoint-period
      chunks, self-resumes from the newest sha256-valid epoch, reports
      per-phase timings and the gathered raster and weight signatures.
  faults — deterministic fault injection (`REPRO_FAULT`) and progress
      beacons, stdlib only.
  report — worker results into scaling rows and a BENCH-schema report.
  cli — `python -m repro_torch.cluster run|sweep`.

The headline invariant is the paper's Table 1 check extended across the
process axis, and along the failure axis: rasters and weights are
bit-identical for 1 process x H shards vs P processes x H/P shards, and
for a supervised run that crashed, hung, straggled, lost a report or
found its newest epoch corrupt and recovered.

    python -m repro_torch.cluster run --nprocs 2 --shards 4 --steps 150 \\
        --ckpt-every 50 --supervise --fault crash@step=50:rank=1
    python -m repro_torch.cluster run ... --device cpu     # gloo on the CPU
    python -m repro_torch.cluster sweep --quick --out DIR

The reference's `cli.run_plan_cell` needs `bench/plans` (ROADMAP queue 1,
item 12).
"""
from . import faults, local, report, runtime

__all__ = ["faults", "local", "report", "runtime"]
