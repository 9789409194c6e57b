"""Stdlib-only names of a cluster job's environment (the cluster part of
`repro._flags`), importable before torch.

A worker joins a job from three variables, set by its launcher
(`bench.subproc.run_ranks`, or by hand) through `cluster_env`:

  REPRO_CLUSTER_COORD    "host:port" of rank 0's store (or a "file://"
                         path, which needs no port)
  REPRO_CLUSTER_NPROCS   the number of ranks
  REPRO_CLUSTER_PROC_ID  this worker's rank

and, optionally, REPRO_CLUSTER_DEVICE ("cuda" or "cpu"; "cuda" when unset),
where its tensors live.  The names are the repo's own, so an ambient MPI
or SLURM environment can never half-configure a worker.

`tuned_host_env` is the cluster launcher's opt-in host preset
(`--tuned-env`).  The JAX package's `force_host_device_count` and
`subprocess_env` force XLA host devices and have no counterpart: a rank
holds its H / R shards through `dist.mesh.SnnMesh`.
"""
from __future__ import annotations

import os
from typing import Optional

ENV_COORD = "REPRO_CLUSTER_COORD"        # "host:port" of rank 0
ENV_NUM_PROCS = "REPRO_CLUSTER_NPROCS"   # total process count
ENV_PROC_ID = "REPRO_CLUSTER_PROC_ID"    # this worker's rank
ENV_DEVICE = "REPRO_CLUSTER_DEVICE"      # "cuda" (default) or "cpu"


def cluster_env(src_path: str, *, coordinator: str, num_processes: int,
                process_id: int, device: Optional[str] = None,
                tuned: bool = False) -> dict:
    """The environment of a fresh interpreter that joins a
    `torch.distributed` job as rank `process_id` of `num_processes`, with
    `src_path` first on PYTHONPATH (so that `repro_torch` imports
    uninstalled).  `tuned=True` overlays `tuned_host_env`."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src_path, env.get("PYTHONPATH")) if p)
    env[ENV_COORD] = coordinator
    env[ENV_NUM_PROCS] = str(num_processes)
    env[ENV_PROC_ID] = str(process_id)
    if device is not None:
        env[ENV_DEVICE] = device
    if tuned:
        env.update(tuned_host_env())
    return env


# Install locations of gperftools' tcmalloc on the distributions the
# benchmark targets: host-side plan construction and checkpoint writes
# allocate heavily, and tcmalloc's thread caches serve them faster than
# glibc's arenas.
TCMALLOC_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib64/libtcmalloc.so.4",
    "/usr/lib64/libtcmalloc_minimal.so.4",
)

ENV_TUNED = "REPRO_TUNED_ENV"            # "1" when the preset is active


def find_tcmalloc() -> Optional[str]:
    """The first installed tcmalloc shared object, or None."""
    for p in TCMALLOC_CANDIDATES:
        if os.path.exists(p):
            return p
    return None


def tuned_host_env() -> dict:
    """Opt-in host-runtime preset of a cluster launch (`--tuned-env`).

    LD_PRELOADs tcmalloc where it is installed (and leaves it out
    otherwise: the preset never breaks a launch) and silences tcmalloc's
    large-allocation reports.  It sets nothing that could change the
    numerics (no torch, CUDA or compiler setting), so the Table 1
    invariant holds byte for byte under it.  REPRO_TUNED_ENV=1 marks the
    worker, so that its result records which arm of an A/B it ran in."""
    env = {"TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000",
           ENV_TUNED: "1"}
    tc = find_tcmalloc()
    if tc:
        prev = os.environ.get("LD_PRELOAD", "")
        env["LD_PRELOAD"] = f"{tc}:{prev}" if prev else tc
    return env
