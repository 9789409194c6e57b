"""`torch.distributed` bootstrap and the host-side gathers of a job (the
part of `repro.cluster.runtime` the mesh needs).

A worker joins the job from the REPRO_CLUSTER_* variables
(`repro_torch._flags`), from torchrun's (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT), or from an explicit `ClusterConfig`:

    runtime.ensure_initialized()          # before anything touches a device
    mesh = dist.make_snn_mesh(H)          # the job's ranks, H / R shards each

`ensure_initialized()` is a no-op without those variables, idempotent,
and joins `torch.distributed.init_process_group` with
`init_method="tcp://{coord}"` (or the given "file://" / "env://" method);
`shutdown()`, run at exit, leaves the job.
Each rank's device is `cuda:{rank % device_count}`, or the CPU when the
job asks for it.

The wire.  On the CPU the backend is gloo.  On the card it is NCCL when
every rank has a GPU of its own; when ranks share a GPU (more ranks than
cards) NCCL cannot run (it refuses two ranks of one communicator on one
device), so the backend is gloo and every message is staged through
pinned host memory (`dist.mesh.Wire`).  An explicit `backend="nccl"` that
cannot be met raises and says why; nothing falls back.  `job().wire`
names the wire chosen.
"""
from __future__ import annotations

import atexit
import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from .._flags import ENV_COORD, ENV_DEVICE, ENV_NUM_PROCS, ENV_PROC_ID

#: torchrun's variables, read when the REPRO_CLUSTER_* ones are absent
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    coordinator: str          # "host:port", or a "file://" / "env://" method
    num_processes: int
    process_id: int
    device: str = "cuda"      # where the rank's tensors live: "cuda" or "cpu"

    @property
    def init_method(self) -> str:
        return (self.coordinator if "://" in self.coordinator
                else f"tcp://{self.coordinator}")


def from_env() -> Optional[ClusterConfig]:
    """ClusterConfig from the REPRO_CLUSTER_* variables, else from
    torchrun's; None when this process is not a rank of a job.  Half-set
    REPRO_CLUSTER_* variables are an error, not a quiet single process: a
    worker that ran alone would leave its peers waiting."""
    present = [v for v in (ENV_COORD, ENV_NUM_PROCS, ENV_PROC_ID)
               if os.environ.get(v)]
    device = os.environ.get(ENV_DEVICE) or "cuda"
    if present:
        if len(present) != 3:
            raise RuntimeError(
                f"partial cluster environment: have {present}, need all of "
                f"{[ENV_COORD, ENV_NUM_PROCS, ENV_PROC_ID]}")
        return ClusterConfig(coordinator=os.environ[ENV_COORD],
                             num_processes=int(os.environ[ENV_NUM_PROCS]),
                             process_id=int(os.environ[ENV_PROC_ID]),
                             device=device)
    if all(os.environ.get(v) for v in TORCHRUN_ENV):
        return ClusterConfig(coordinator="env://",
                             num_processes=int(os.environ["WORLD_SIZE"]),
                             process_id=int(os.environ["RANK"]),
                             device=device)
    return None


@dataclasses.dataclass(frozen=True)
class Job:
    """The joined job as this rank sees it."""
    world: int
    rank: int
    device: torch.device
    backend: str              # "gloo" or "nccl"
    staged: bool              # CUDA tensors staged through pinned host memory

    @property
    def wire(self) -> str:
        if self.backend == "nccl":
            return "nccl"
        return "gloo, host-staged" if self.staged else "gloo"


def choose_backend(device: torch.device, world: int, device_count: int,
                   backend: Optional[str] = None):
    """(backend, staged) for `world` ranks on `device`'s type: gloo on the
    CPU; on the card NCCL when every rank has a card of its own, else gloo
    staged through pinned host memory.  Raises where the backend asked for
    cannot run."""
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}: expected 'gloo' or "
                         f"'nccl'")
    if device.type == "cpu":
        if backend == "nccl":
            raise ValueError("backend='nccl' needs CUDA tensors: the ranks "
                             "run on the CPU, where the backend is gloo")
        return "gloo", False
    shared = world > device_count
    if backend == "nccl" and shared:
        raise ValueError(
            f"backend='nccl' with {world} ranks on {device_count} GPU(s): "
            f"ranks would share a GPU, and NCCL refuses two ranks of one "
            f"communicator on one device; use gloo (host-staged) or one "
            f"rank a GPU")
    if backend == "gloo" or (backend is None and shared):
        return "gloo", True
    return "nccl", False


_job: Optional[Job] = None


def ensure_initialized(cfg: Optional[ClusterConfig] = None, *,
                       backend: Optional[str] = None,
                       device: Optional[str] = None) -> bool:
    """Join the job described by `cfg` (default: `from_env()`).  Returns
    True when this process is a rank of a job, False for a plain single
    process.  `device` ("cuda" or "cpu") overrides the config's; `backend`
    asks for "gloo" or "nccl" (default: `choose_backend`'s)."""
    global _job
    if _job is not None:
        return True
    cfg = cfg or from_env()
    if cfg is None:
        return False
    kind = device or cfg.device
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the job's ranks run on the card, and no CUDA "
                               "device is available; ask for device='cpu'")
        n_dev = torch.cuda.device_count()
        dev = torch.device("cuda", cfg.process_id % n_dev)
        torch.cuda.set_device(dev)
    elif kind == "cpu":
        n_dev, dev = 0, torch.device("cpu")
    else:
        raise ValueError(f"unsupported device {kind!r}")
    name, staged = choose_backend(dev, cfg.num_processes, n_dev, backend)
    dist.init_process_group(name, init_method=cfg.init_method,
                            world_size=cfg.num_processes,
                            rank=cfg.process_id)
    # a process group left to the interpreter's exit aborts the rank now
    # and then ("terminate called without an active exception": its
    # threads outlive it), which fails the job after its work is done
    atexit.register(shutdown)
    _job = Job(world=cfg.num_processes, rank=cfg.process_id, device=dev,
               backend=name, staged=staged)
    return True


def shutdown() -> None:
    """Leave the job: destroy the process group (registered at exit by
    `ensure_initialized`; a no-op when there is none)."""
    global _job
    if dist.is_initialized():
        dist.destroy_process_group()
    _job = None


def job() -> Optional[Job]:
    """The joined job, or None."""
    return _job


def process_index() -> int:
    return _job.rank if _job is not None else 0


def process_count() -> int:
    return _job.world if _job is not None else 1


def is_primary() -> bool:
    """True on the rank that owns side effects (reports, printed results);
    True in a single process."""
    return process_index() == 0


def is_distributed() -> bool:
    return process_count() > 1


def gather(tree):
    """The ranks' blocks of a tree of tensors (a tensor, or NamedTuples of
    them, each with the rank's block on its leading axis), concatenated in
    rank order on the primary's CPU; None on the other ranks.  A
    collective: every rank calls it with the same structure and shapes.
    In a single process, the tree on the CPU."""
    from ..dist import mesh as dist_mesh
    from ..dist.sharding import tree_leaves, tree_map
    if _job is None:
        return tree_map(lambda x: x.cpu(), tree)
    wire = dist_mesh.Wire.of(_job)
    parts = iter([wire.gather(x) for x in tree_leaves(tree)])
    return tree_map(lambda _: next(parts), tree) if is_primary() else None
