"""`repro.core.distributed` in PyTorch: the static halo and group offsets
the exchange routes along, the shard groups of the 'hier' exchange, the
phase handles, and the mesh path: the step over a `torch.distributed`
job's ranks (`dist.mesh.SnnMesh`), with real collectives.

Spike exchange modes (EngineConfig.exchange):

  'allgather' — every shard reads the global spike mask (over a mesh: an
      all-gather of the ranks' [L, N] spike blocks);
  'halo' — each shard packs a fixed-capacity AER buffer (`core.aer`) and
      sends it along the static set of shard offsets the connectivity
      uses (`halo_offsets`, the paper's construction-time discovery of the
      processes to listen to); received ids are matched against the local
      source table.  Over a mesh the buffers go point to point, one
      message a destination rank, and only to the ranks those offsets
      reach: the paper's subset-of-processes delivery;
  'hier' — one AER buffer per group of shards (the shards one process
      owns), sent at whole-group stride along `hier_offsets`.  Over a mesh
      the groups are the ranks' blocks: level 1 is a reshape on the rank's
      device, level 2 one buffer a rank, point to point.

Schedules (EngineConfig.exchange_schedule): 'sync' runs A -> X -> B;
'pipelined' runs B(t-1) -> A_dyn(t) -> issue X(t) -> A_plast(t) and waits
for X(t) right before the B that consumes it (an all-False buffer before
the first step, one B after the last).  Both give the same bits.

Over a mesh each rank holds its block of L = H / R shards stacked on its
device and runs the single-device phases (`delivery_step_fns`: the
hand-written kernels on the card) on it; the exchange between them is the
only traffic (`MeshProgram`).  Without a mesh the phase handles run the
same wires over the shards stacked on one device, a one-process mesh
with nothing to send (`stacked_exchange`).
The offsets and groups are host-side numpy functions of the full plan's
tables, which every rank builds (construction is local and deterministic).
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from . import aer, engine, event_engine, stream_engine, topology
from .engine import ShardPlan, SimSpec
from ..dist import mesh as dist_mesh
from ..dist import sharding as dist_sharding
from ..dist.mesh import Ready, SnnMesh

# steps of stimulus a phase handle draws at once when its caller has not
# drawn a window (`StepProgram.time_phases` draws its whole range)
PHASE_WINDOW = 100


def _owners(spec: SimSpec, plan: ShardPlan):
    """Per shard h, the distinct shards owning its sources."""
    H = spec.eng.n_shards
    src_gid = plan.src_gid.cpu().numpy()          # [H, S]
    for h in range(H):
        s = src_gid[h]
        s = s[s >= 0]
        yield h, np.unique(topology.owner_of(spec.cfg, s, H,
                                             spec.eng.placement)).tolist()


def halo_offsets(spec: SimSpec, plan: ShardPlan) -> List[int]:
    """Static shard-to-shard offsets used by the connectivity: sender o
    reaches receiver h at offset (h - o) mod H.  Derived from the source
    tables, which follow the connectivity profile's reach."""
    H = spec.eng.n_shards
    return sorted({(h - o) % H for h, owners in _owners(spec, plan)
                   for o in owners})


def hier_offsets(spec: SimSpec, plan: ShardPlan, group_size: int
                 ) -> List[int]:
    """`halo_offsets` at group granularity: the static set of group
    strides the connectivity reaches."""
    G = spec.eng.n_shards // group_size
    return sorted({(h // group_size - o // group_size) % G
                   for h, owners in _owners(spec, plan) for o in owners})


def make_mesh(n_shards: int) -> SnnMesh:
    """The SNN mesh of `n_shards` shards over the joined job's ranks."""
    return dist_mesh.make_snn_mesh(n_shards)


def mesh_shard_groups(mesh: SnnMesh, n_shards: int) -> List[List[int]]:
    """The ranks' shard blocks, in rank order: contiguous and of equal size
    by construction (`SnnMesh`)."""
    if n_shards != mesh.n_shards:
        raise ValueError(f"{n_shards} shards, the mesh has {mesh.n_shards}")
    return [list(mesh.block_of(q)) for q in range(mesh.world)]


def _explicit_groups(H: int, hier_groups) -> List[List[int]]:
    """An explicit group count or group list as equal-sized contiguous
    blocks `range(g*L, (g+1)*L)` in order (what the exchange can route)."""
    if isinstance(hier_groups, int):
        G = hier_groups
        if G <= 0 or H % G:
            raise ValueError(f"hier_groups={G} must divide n_shards={H}")
        L = H // G
        return [list(range(g * L, (g + 1) * L)) for g in range(G)]
    groups = [list(g) for g in hier_groups]
    L = len(groups[0]) if groups else 0
    if L == 0 or H % L or groups != [list(range(g * L, (g + 1) * L))
                                    for g in range(H // L)]:
        raise ValueError(f"hier_groups={groups} must be equal-sized "
                         f"contiguous blocks of the {H} shards in order, "
                         f"e.g. [[0, 1], [2, 3]]")
    return groups


def _resolve_groups(spec: SimSpec, mesh: Optional[SnnMesh],
                    hier_groups) -> List[List[int]]:
    """Shard groups of the 'hier' exchange: over a mesh the ranks' blocks
    (an explicit `hier_groups` must name the same); without one an
    explicit group count or list of equal-sized contiguous blocks."""
    H = spec.eng.n_shards
    if mesh is not None:
        groups = mesh_shard_groups(mesh, H)
        if hier_groups is not None and \
                _explicit_groups(H, hier_groups) != groups:
            raise ValueError(f"over a mesh the hier groups are the ranks' "
                             f"blocks {groups}; got hier_groups="
                             f"{hier_groups}")
        return groups
    if hier_groups is None:
        raise ValueError("exchange='hier' needs a mesh (its ranks' blocks) "
                         "or hier_groups= (a group count or a list of "
                         "groups)")
    return _explicit_groups(H, hier_groups)


def _match(ids: torch.Tensor, n_total: int, src_safe, src_ok):
    """[H, S] spiked_src from received AER ids [H, K]: scatter the ids into
    a per-shard [N_total] mask (INVALID pads into a spare last slot), then
    one gather by the source table."""
    idx = torch.where(ids < n_total, ids, n_total).to(torch.int64)
    mask = torch.zeros((ids.shape[0], n_total + 1), dtype=torch.bool,
                       device=ids.device)
    mask.scatter_(1, idx, True)
    return torch.gather(mask, 1, src_safe) & src_ok


def _source_tables(plan: ShardPlan):
    src_ok = plan.src_gid >= 0
    return torch.where(src_ok, plan.src_gid, 0), src_ok


class PhasePrograms(NamedTuple):
    """Phase handles over the stacked shards (of one device, or of the
    rank's block over a mesh): `phase_a(state, t)` /
    `exchange(spiked)` / `phase_b(state, ss, t)` is the paper's Table 2
    split; `phase_a_dynamics(state, t)` and `phase_a_plasticity(state,
    spiked, t)` are phase A's halves, timed separately under the
    pipelined schedule (the exchange is issued between them)."""
    phase_a: Callable
    exchange: Callable
    phase_b: Callable
    phase_a_dynamics: Callable
    phase_a_plasticity: Callable


def delivery_step_fns(spec: SimSpec, plan: ShardPlan, t0: int, n_steps: int,
                      eplan=None, caps: Optional[dict] = None, *,
                      splan=None) -> engine.StepFns:
    """The phase callables of a window of steps for the plan's delivery
    and connectivity mode: `stream_engine.make_step_fn` (streamed, with
    the StreamedPlan), `engine.make_step_fn` (dense) or
    `event_engine.make_step_fn` (event, with the EventPlan and the
    optional `caps` c_post / c_src).  All share the exchange and the
    signatures of `engine.StepFns`."""
    if spec.stream is not None:
        if splan is None:
            raise ValueError("streamed connectivity needs the StreamedPlan")
        return stream_engine.make_step_fn(spec, plan, splan, t0, n_steps)
    if spec.eng.delivery == "event":
        if eplan is None:
            raise ValueError("delivery='event' needs the EventPlan")
        caps = caps or {}
        return event_engine.make_step_fn(spec, plan, eplan, t0, n_steps,
                                         c_post=caps.get("c_post"),
                                         c_src=caps.get("c_src"))
    return engine.make_step_fn(spec, plan, t0, n_steps)


# ---------------------------------------------------------------------------
# the mesh path: one rank's block of shards, real collectives
# ---------------------------------------------------------------------------


def _mesh_allgather(spec: SimSpec, plan: ShardPlan, mesh: SnnMesh,
                    block: ShardPlan) -> Callable:
    """issue(spiked [L, N]) -> Pending of [L, S]: the ranks' spike blocks
    all-gathered into the [H, N] stack, the global mask read from it by
    each gid's flat position, then gathered by the block's source tables
    (`engine.make_exchange` over the gathered stack)."""
    flat_gid = plan.gid.reshape(-1).cpu()
    owned = torch.nonzero(flat_gid >= 0).reshape(-1)
    gid_pos = torch.zeros(spec.n_total, dtype=torch.int64)
    gid_pos[flat_gid[owned]] = owned
    gid_pos = gid_pos.to(mesh.device)
    src_safe, src_ok = _source_tables(block)

    def issue(spiked):
        return mesh.wire.all_gather(spiked).then(
            lambda stack: stack.reshape(-1)[gid_pos][src_safe] & src_ok)
    return issue


def aer_routes(mesh: SnnMesh, unit: int, offsets) -> dict:
    """The static routing of an AER wire for this rank, over units of
    `unit` consecutive shards (a shard for halo, a group for hier; a unit
    never straddles ranks); unit u hears unit (u - d) mod U for each d of
    `offsets`.  `send` {rank q: the local units (unit - first local unit)
    whose buffers q's units hear}, `recv` {rank p: the units of p this
    rank's units hear, ascending}, and `rows` [local units][offsets], for
    each local unit the row, in the table [local buffers; received buffers
    in rank order], of each unit it hears.  Sent units and received units
    are listed in the same order on both sides."""
    U, me = mesh.n_shards // unit, mesh.rank
    local = range(mesh.block.start // unit, mesh.block.stop // unit)

    def owner(u):
        return mesh.owner(u * unit)
    send, recv = {}, {}
    for u in local:
        for d in offsets:
            q = owner((u + d) % U)
            if q != me:
                send.setdefault(q, set()).add(u - local.start)
    hears = {u: [(u - d) % U for d in offsets] for u in local}
    for senders in hears.values():
        for v in senders:
            p = owner(v)
            if p != me:
                recv.setdefault(p, set()).add(v)
    send = {q: sorted(v) for q, v in send.items()}
    recv = {p: sorted(v) for p, v in recv.items()}
    order = list(local) + [v for p in sorted(recv) for v in recv[p]]
    where = {v: i for i, v in enumerate(order)}
    rows = [[where[v] for v in hears[u]] for u in local]
    return dict(send=send, recv=recv, rows=rows)


def _aer_wire(spec: SimSpec, mesh: SnnMesh, block: ShardPlan, unit: int,
              offsets) -> Callable:
    """issue(spiked [L, N]) -> Pending of [L, S]: each local unit of `unit`
    shards packs one AER buffer (`aer.pack`, capacity unit * N) and sends
    it in one message to each rank whose units hear any of the rank's
    (`aer_routes`), none elsewhere; each local shard matches the buffers
    its unit hears.  Over one rank nothing is sent: the units hear each
    other's buffers by a row gather on the device."""
    r = aer_routes(mesh, unit, offsets)
    dev = block.gid.device
    L, N = block.gid.shape
    Lu, K = L // unit, unit * N
    send = {q: torch.tensor(v, dtype=torch.int64, device=dev)
            for q, v in r["send"].items()}
    recvs = {p: ((len(v), K), torch.int32) for p, v in r["recv"].items()}
    rows = torch.tensor(r["rows"], dtype=torch.int64, device=dev)
    src_safe, src_ok = _source_tables(block)
    gid_u = block.gid.reshape(Lu, K)

    def issue(spiked):
        ids, _ = aer.pack(spiked.reshape(Lu, K), gid_u, K)

        def match(got):
            table = (torch.cat([ids] + [got[p] for p in sorted(got)])
                     if got else ids)
            heard = table[rows]
            if unit > 1:        # a group's shards hear the same buffers
                heard = heard.reshape(Lu, 1, -1).expand(Lu, unit, -1)
            return _match(heard.reshape(L, -1), spec.n_total, src_safe,
                          src_ok)
        sends = {q: ids.index_select(0, i) for q, i in send.items()}
        return mesh.wire.exchange(sends, recvs).then(match)
    return issue


def make_mesh_exchange(spec: SimSpec, plan: ShardPlan, mesh: SnnMesh,
                       block: ShardPlan, group_size: Optional[int] = None
                       ) -> Callable:
    """The exchange wire of spec.eng.exchange over `mesh`: issue(spiked
    [L, N] bool on the rank's device) -> `dist.mesh.Pending` whose wait()
    gives the rank's [L, S] spiked_src.  `plan` is the full host plan
    (the static routes come from its tables), `block` the rank's placed
    block.  'halo' sends a buffer a shard along `halo_offsets`; 'hier'
    one a group of `group_size` shards (the rank's block by default:
    level 1 is then a reshape on its device, level 2 one buffer a rank)
    along `hier_offsets`."""
    ex = spec.eng.exchange
    if ex == "allgather":
        return _mesh_allgather(spec, plan, mesh, block)
    if ex == "halo":
        return _aer_wire(spec, mesh, block, 1, halo_offsets(spec, plan))
    if ex == "hier":
        g = group_size or mesh.per_rank
        return _aer_wire(spec, mesh, block, g, hier_offsets(spec, plan, g))
    raise ValueError(f"unknown exchange {ex!r}")


def stacked_exchange(spec: SimSpec, plan: ShardPlan, fns: engine.StepFns,
                     hier_groups=None) -> Callable:
    """The exchange wire over the [H, N] spike masks of the shards stacked
    on one device, each mode keeping its own work: the global mask
    ('allgather', the run's own `fns.exchange`), or the mesh path's AER
    wires over a one-process mesh (`dist.mesh.stacked_mesh`: 'halo' a
    buffer a shard, 'hier' a buffer a group of `hier_groups`); all give
    the same [H, S] spiked_src."""
    if spec.eng.exchange == "allgather":
        return fns.exchange
    group_size = None
    if spec.eng.exchange == "hier":
        group_size = len(_resolve_groups(spec, None, hier_groups)[0])
    mesh = dist_mesh.stacked_mesh(plan.gid.shape[0], plan.gid.device)
    issue = make_mesh_exchange(spec, plan, mesh, plan, group_size)
    return lambda spiked: issue(spiked).wait()


def phase_programs(fns: engine.StepFns, exchange: Callable,
                   wrap: Callable = lambda f: f) -> PhasePrograms:
    """PhasePrograms from a window's phase callables and an exchange, each
    phase passed through `wrap` (the device's numerics)."""
    return PhasePrograms(
        phase_a=wrap(fns.phase_a), exchange=exchange,
        phase_b=wrap(fns.phase_b),
        phase_a_dynamics=wrap(fns.phase_a_dynamics),
        phase_a_plasticity=wrap(fns.phase_a_plasticity))


class MeshProgram:
    """One rank's part of a program over a mesh: its block of the plan
    (and of the EventPlan or StreamedPlan) on its device, the exchange
    wire, `run` under either schedule and the phase callables.

    `plan` (and `eplan`, `splan`) is the full stacked plan, built by every
    rank (on any device); only the rank's block is uploaded
    (`dist.sharding.shard_put`).  States given to `run` are the rank's
    block ([L, ...], `place` makes one from a full state)."""

    def __init__(self, spec: SimSpec, plan: ShardPlan, mesh: SnnMesh,
                 eplan=None, caps: Optional[dict] = None, hier_groups=None,
                 splan=None):
        if spec.eng.exchange_schedule not in ("sync", "pipelined"):
            raise ValueError(f"unknown exchange_schedule "
                             f"{spec.eng.exchange_schedule!r}")
        if spec.eng.delivery == "event" and eplan is None:
            raise ValueError("delivery='event' needs the EventPlan")
        if spec.stream is not None and splan is None:
            raise ValueError("streamed connectivity needs the StreamedPlan")
        if spec.eng.exchange == "hier":     # hier_groups must name the blocks
            _resolve_groups(spec, mesh, hier_groups)
        self.spec, self.mesh, self.caps = spec, mesh, caps or {}
        self.device = mesh.device
        self.plan = dist_sharding.shard_put(mesh, plan)
        self.eplan = (None if eplan is None
                      else dist_sharding.shard_put(mesh, eplan))
        self.splan = (None if splan is None
                      else dist_sharding.shard_put(mesh, splan))
        self.issue = make_mesh_exchange(spec, plan, mesh, self.plan)

    def place(self, state):
        return dist_sharding.shard_put(self.mesh, state)

    def exchange(self, spiked):
        """The wire, waited for: spiked [L, N] -> spiked_src [L, S]."""
        return self.issue(spiked).wait()

    def step_fns(self, t0: int, n_steps: int) -> engine.StepFns:
        """The block's phase callables of a window of steps."""
        return delivery_step_fns(self.spec, self.plan, t0, n_steps,
                                 self.eplan, self.caps, splan=self.splan)

    def no_spikes(self) -> torch.Tensor:
        """The all-False [L, S] spiked_src (the pipelined prologue)."""
        return torch.zeros(self.plan.src_gid.shape, dtype=torch.bool,
                           device=self.device)

    def run(self, state, t0: int, n_steps: int):
        """Steps t0 .. t0 + n_steps - 1 of the rank's block -> (state [L,
        ...], raster [T, L, N], timings [T, L]); the input state is not
        modified.  The steps run eagerly (no CUDA graph: a captured graph
        cannot hold the wire's host round trip)."""
        with engine._numerics(self.device):
            fns = self.step_fns(t0, n_steps)
            if self.spec.eng.exchange_schedule == "sync":
                def step(s, t):
                    s, spiked, tm = fns.phase_a(s, t)
                    return fns.phase_b(s, self.exchange(spiked), t), \
                        spiked, tm
                return engine.run_loop(step, state, t0, n_steps)

            pending = Ready(self.no_spikes())

            def step(s, t):
                nonlocal pending
                s = fns.phase_b(s, pending.wait(), t - 1)
                s, spiked, tm = fns.phase_a_dynamics(s, t)
                pending = self.issue(spiked)          # in flight during LTP
                s = fns.phase_a_plasticity(s, spiked, t)
                return s, spiked, tm
            state, raster, tm = engine.run_loop(step, state, t0, n_steps)
            state = fns.phase_b(state, pending.wait(), t0 + n_steps - 1)
            return state, raster, tm


def make_run_program(spec: SimSpec, plan: ShardPlan, mesh: SnnMesh,
                     eplan=None, caps: Optional[dict] = None,
                     hier_groups=None, splan=None) -> Callable:
    """run(state, t0, n_steps) -> (state, raster, timings) of the rank's
    block over `mesh`, under spec.eng.exchange_schedule (`MeshProgram`;
    constructed via `core.StepProgram`)."""
    return MeshProgram(spec, plan, mesh, eplan=eplan, caps=caps,
                       hier_groups=hier_groups, splan=splan).run


def make_phase_programs(spec: SimSpec, plan: ShardPlan, mesh: SnnMesh,
                        eplan=None, caps: Optional[dict] = None,
                        hier_groups=None, splan=None) -> PhasePrograms:
    """The phase handles of the rank's block over `mesh` (`exchange` waits
    for the wire), drawing the stimulus window their t falls in."""
    mp = MeshProgram(spec, plan, mesh, eplan=eplan, caps=caps,
                     hier_groups=hier_groups, splan=splan)
    dev = mp.device

    def wrap(fn):
        def wrapped(*args):
            with engine._numerics(dev):
                return fn(*args)
        return wrapped
    return phase_programs(mp.step_fns(0, PHASE_WINDOW), mp.exchange, wrap)
