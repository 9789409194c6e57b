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
"""
from __future__ import annotations

import os
from typing import Optional

ENV_COORD = "REPRO_CLUSTER_COORD"        # "host:port" of rank 0
ENV_NUM_PROCS = "REPRO_CLUSTER_NPROCS"   # total process count
ENV_PROC_ID = "REPRO_CLUSTER_PROC_ID"    # this worker's rank
ENV_DEVICE = "REPRO_CLUSTER_DEVICE"      # "cuda" (default) or "cpu"


def cluster_env(src_path: str, *, coordinator: str, num_processes: int,
                process_id: int, device: Optional[str] = None) -> dict:
    """The environment of a fresh interpreter that joins a
    `torch.distributed` job as rank `process_id` of `num_processes`, with
    `src_path` first on PYTHONPATH (so that `repro_torch` imports
    uninstalled)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src_path, env.get("PYTHONPATH")) if p)
    env[ENV_COORD] = coordinator
    env[ENV_NUM_PROCS] = str(num_processes)
    env[ENV_PROC_ID] = str(process_id)
    if device is not None:
        env[ENV_DEVICE] = device
    return env
