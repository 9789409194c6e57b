"""The meshes over a `torch.distributed` job (port of `repro.dist.mesh`):
the SNN's flat mesh (`make_snn_mesh`, `spans_processes`), the LM's named
mesh (`LmMesh`: `make_lm_mesh`, `make_production_mesh`), and the wire
their collectives use.

The JAX package's mesh is one flat `cells` axis of devices, one shard a
device.  Here the mesh is the job's R ranks, each on one device (see
`cluster.runtime`): the H shards are cut into R equal contiguous blocks of
L = H / R, and rank r holds shards [r*L, (r+1)*L) stacked on its device,
as the single-device engine stacks all H (the reference's "a process owns
a contiguous block of devices", `repro.core.distributed.mesh_shard_groups`).
With R = H it is one shard a rank.

`Wire` is the job's collectives on one rank's tensors: the backend's own
on its device (NCCL, or gloo on the CPU), or, where ranks share a GPU
under gloo, every message staged through pinned host memory (device ->
pinned host, the copy's stream synchronised before the collective; host
-> device after it).  That staging is the wire, and the phase timers count
it as exchange time.  It counts the point-to-point messages each rank
sends, by destination.  Each collective takes a process group (None: the
whole job); an `LmMesh` holds one for each axis set its step needs.

The LM mesh names its axes as the JAX package's does ('data', 'model', and
'pod' in front on the multi-pod mesh): rank r sits at the row-major
coordinates of r in the mesh's shape, as `jax.make_mesh` lays devices out.
`make_production_mesh` builds the 16x16 (or 2x16x16) mesh without a job,
for its axis sizes (the sharding rules need nothing else); `make_lm_mesh`
binds a mesh to the joined job, and raises where the job's size is not the
mesh's: nothing runs on fewer ranks in its place.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Pending:
    """A message exchange in flight: `wait()` waits for it and returns its
    result on the rank's device (once)."""

    def __init__(self, works: Sequence, finish: Callable, keep=()):
        self._works = list(works)
        self._finish = finish
        self._keep = keep           # send buffers live until the wait

    def wait(self):
        for w in self._works:
            w.wait()
        out, self._finish, self._keep = self._finish(), None, ()
        return out

    def then(self, fn: Callable) -> "Pending":
        """The exchange whose result is fn(this one's result)."""
        return Pending((), lambda: fn(self.wait()))


class Ready(Pending):
    """A result that is there already (the stacked exchange's)."""

    def __init__(self, value):
        super().__init__((), lambda: value)


class Wire:
    """The job's collectives on one rank's tensors (see the module
    docstring).  `sent[q]` counts the point-to-point messages this rank
    sent to rank q."""

    def __init__(self, world: int, rank: int, device: torch.device,
                 staged: bool):
        self.world, self.rank = world, rank
        self.device, self.staged = device, staged
        self.sent = collections.Counter()

    @classmethod
    def of(cls, job) -> "Wire":
        """The wire of a joined job (`cluster.runtime.Job`)."""
        return cls(job.world, job.rank, job.device, job.staged)

    # -- staging -----------------------------------------------------------

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        """What the backend sends: the tensor itself, or its copy in pinned
        host memory, complete before this returns."""
        if not self.staged:
            return x.to(self.device).contiguous()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)               # synchronises the copy's stream
        return host

    def _buf(self, shape, dtype) -> torch.Tensor:
        """A receive buffer, where the backend writes."""
        if self.staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _back(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device, non_blocking=True) if self.staged else x

    # -- collectives -------------------------------------------------------

    def _size(self, group) -> int:
        return self.world if group is None else dist.get_world_size(group)

    def all_gather(self, x: torch.Tensor, group=None) -> Pending:
        """Every rank's x [L, ...] -> [R * L, ...] in rank order, issued
        now (R the ranks of `group`, None: the job)."""
        src = self._out(_bytes(x))
        out = self._buf((self._size(group) * src.shape[0],)
                        + tuple(src.shape[1:]), src.dtype)
        work = dist.all_gather_into_tensor(out, src, group=group,
                                           async_op=True)
        return Pending([work], lambda: _unbytes(self._back(out), x.dtype),
                       keep=(src,))

    def exchange(self, sends: Dict[int, torch.Tensor],
                 recvs: Dict[int, Tuple[tuple, torch.dtype]]) -> Pending:
        """Point to point, issued now: sends[q] to rank q, and from each
        rank p of `recvs` a message of (shape, dtype).  `wait()` gives
        {p: received tensor}.  Every send has its receive on the other
        side, so no rank waits on a message nobody sent."""
        outs = {q: self._out(x) for q, x in sends.items()}
        ins = {p: self._buf(shape, dt) for p, (shape, dt) in recvs.items()}
        ops = [dist.P2POp(dist.isend, b, q)
               for q, b in sorted(outs.items())]
        ops += [dist.P2POp(dist.irecv, b, p)
                for p, b in sorted(ins.items())]
        works = dist.batch_isend_irecv(ops) if ops else []
        for q in outs:
            self.sent[q] += 1
        return Pending(works, lambda: {p: self._back(b)
                                       for p, b in ins.items()},
                       keep=tuple(outs.values()))

    def gather(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """Every rank's x [L, ...] concatenated in rank order on rank 0's
        CPU; None on the other ranks."""
        src = self._out(_bytes(x))
        parts = ([self._buf(tuple(src.shape), src.dtype)
                  for _ in range(self.world)] if self.rank == 0 else None)
        dist.gather(src, parts, dst=0)
        if parts is None:
            return None
        return _unbytes(torch.cat([p.cpu() for p in parts]), x.dtype)

    def all_to_all(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """x [R, ...]: x[q] to the q-th rank of `group` (None: the job);
        returns [R, ...], whose p-th row came from its p-th rank."""
        src = self._out(x)
        out = self._buf(tuple(src.shape), src.dtype)
        dist.all_to_all_single(out, src, group=group)
        return self._back(out)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the ranks, on the rank's device."""
        buf = self._out(x) if self.staged else x.to(self.device, copy=True)
        dist.all_reduce(buf)
        return self._back(buf)


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """bool travels as uint8 (what every backend takes)."""
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def _unbytes(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.view(torch.bool) if dtype == torch.bool else x


@dataclasses.dataclass(frozen=True)
class SnnMesh:
    """The SNN engine's mesh: `n_shards` shards over the job's `world`
    ranks, this `rank` holding `block` on `device`."""
    n_shards: int
    world: int
    rank: int
    device: torch.device
    wire: Wire
    backend: str              # the wire's name (`cluster.runtime.Job.wire`)

    @property
    def per_rank(self) -> int:
        return self.n_shards // self.world

    @property
    def block(self) -> range:
        """The shards this rank holds."""
        return self.block_of(self.rank)

    def block_of(self, rank: int) -> range:
        L = self.per_rank
        return range(rank * L, (rank + 1) * L)

    def owner(self, shard: int) -> int:
        """The rank holding `shard`."""
        return shard // self.per_rank


def make_snn_mesh(n_shards: int) -> SnnMesh:
    """The mesh of `n_shards` shards over the joined job's ranks
    (`cluster.runtime.ensure_initialized` first).  Raises where the ranks
    do not divide the shards."""
    from ..cluster import runtime
    job = runtime.job()
    if job is None:
        raise RuntimeError(
            "make_snn_mesh: no torch.distributed job; start the ranks "
            "(`repro_torch.bench.subproc.run_ranks`, or torchrun) and call "
            "`repro_torch.cluster.runtime.ensure_initialized()` first")
    if n_shards < job.world or n_shards % job.world:
        raise ValueError(f"make_snn_mesh: {n_shards} shards do not divide "
                         f"into {job.world} ranks' equal blocks")
    wire = Wire.of(job)
    # the communicator's first collective, so that every later
    # point-to-point batch finds it set up
    wire.all_reduce_sum(torch.zeros(1, device=job.device))
    return SnnMesh(n_shards=n_shards, world=job.world, rank=job.rank,
                   device=job.device, wire=wire, backend=job.wire)


def stacked_mesh(n_shards: int, device) -> SnnMesh:
    """All `n_shards` shards on this process's `device` and no other rank:
    the mesh the stacked phase handles route their AER wires over, with
    nothing to send (`core.distributed.make_mesh_exchange`)."""
    device = torch.device(device)
    return SnnMesh(n_shards=n_shards, world=1, rank=0, device=device,
                   wire=Wire(1, 0, device, staged=False), backend="stacked")


def spans_processes(mesh: Optional[SnnMesh]) -> bool:
    """True when the mesh has ranks other than this process."""
    return mesh is not None and mesh.world > 1


# ---------------------------------------------------------------------------
# the LM's mesh
# ---------------------------------------------------------------------------

#: the axis sets an LM step communicates over: the FSDP ('batch') axes,
#: 'model', and the whole job
LM_GROUPS = ("batch", "model", "world")


@dataclasses.dataclass(frozen=True)
class Group:
    """The ranks of one axis set that hold this rank, in rank order, and
    their process group (None for the whole job, or a group of one)."""
    ranks: Tuple[int, ...]
    pg: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclasses.dataclass(frozen=True)
class LmMesh:
    """Named mesh axes and their sizes; bound to a job (`make_lm_mesh`),
    also this rank, its device, its wire and its groups."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    rank: Optional[int] = None
    device: Optional[torch.device] = None
    wire: Optional[Wire] = None
    groups: Tuple[Tuple[str, Group], ...] = ()
    backend: str = ""

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The row-major coordinates of `rank`, axis -> index."""
        out = {}
        for a, n in zip(reversed(self.axis_names),
                        reversed(self.axis_sizes)):
            out[a] = rank % n
            rank //= n
        return {a: out[a] for a in self.axis_names}

    @property
    def coords(self) -> Dict[str, int]:
        return self.coords_of(self.rank)

    def group_axes(self, name: str) -> Tuple[str, ...]:
        """The mesh axes of an axis set: 'batch' the FSDP axes the mesh
        has, 'model', or 'world' (all)."""
        if name == "world":
            return self.axis_names
        want = ("pod", "data") if name == "batch" else (name,)
        return tuple(a for a in self.axis_names if a in want)

    def group(self, name: str) -> Group:
        return dict(self.groups)[name]

    def members(self, name: str, rank: Optional[int] = None
                ) -> Tuple[int, ...]:
        """The ranks that differ from `rank` (default: this one) only in
        the axes of `name`, in rank order."""
        axes = self.group_axes(name)
        c = self.coords_of(self.rank if rank is None else rank)
        out = [r for r in range(self.size)
               if all(v == c[a] for a, v in self.coords_of(r).items()
                      if a not in axes)]
        return tuple(out)


def make_production_mesh(*, multi_pod: bool = False) -> LmMesh:
    """16x16 = 256 ranks a pod ('data', 'model'); 2 pods = 512 ranks
    ('pod', 'data', 'model').  Built without a job: `bind` it to a job of
    that many ranks."""
    if multi_pod:
        return LmMesh(("pod", "data", "model"), (2, 16, 16))
    return LmMesh(("data", "model"), (16, 16))


def bind(mesh: LmMesh) -> LmMesh:
    """`mesh` bound to the joined job (`make_lm_mesh`)."""
    return make_lm_mesh(mesh.axis_sizes, mesh.axis_names)


def make_lm_mesh(shape: Sequence[int], axes: Sequence[str]) -> LmMesh:
    """The LM mesh of `shape` over `axes`, bound to the joined job
    (`cluster.runtime.ensure_initialized` first): this rank's coordinates,
    device and wire, and one process group for each of `LM_GROUPS`.  Every
    rank of the job calls it, with the same arguments.  Raises where there
    is no job or the job's size is not the mesh's."""
    from ..cluster import runtime
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"make_lm_mesh: shape {shape} and axes {axes}")
    job = runtime.job()
    n = math.prod(shape)
    if job is None:
        raise RuntimeError(
            f"make_lm_mesh: the mesh {shape} over {axes} needs a "
            f"torch.distributed job of {n} ranks, and this process joined "
            f"none (`repro_torch.cluster.runtime.ensure_initialized()`)")
    if job.world != n:
        raise ValueError(
            f"make_lm_mesh: the mesh {shape} over {axes} needs a job of "
            f"{n} ranks; this job has world size {job.world}")
    mesh = LmMesh(axes, shape, rank=job.rank, device=job.device)
    groups = []
    for name in LM_GROUPS:
        mine = mesh.members(name)
        if name == "world" or len(mine) == 1:
            groups.append((name, Group(mine)))
            continue
        # every rank creates every group of the partition, in one order
        seen, pg = set(), None
        for r in range(n):
            part = mesh.members(name, r)
            if part in seen:
                continue
            seen.add(part)
            made = dist.new_group(list(part))
            if part == mine:
                pg = made
        groups.append((name, Group(mine, pg)))
    wire = Wire.of(job)
    wire.all_reduce_sum(torch.zeros(1, device=job.device))
    return dataclasses.replace(mesh, wire=wire, groups=tuple(groups),
                               backend=job.wire)
