"""The single-device part of `repro.core.distributed`: the static halo and
group offsets the exchange routes along, the shard groups of the 'hier'
exchange, and the `PhasePrograms` handle type.

Spike exchange modes (EngineConfig.exchange), all emulated here over the
shards stacked on one device (`StepProgram.phase_fns`):

  'allgather' — every shard reads the global spike mask;
  'halo' — each shard packs a fixed-capacity AER buffer (`core.aer`) and
      sends it along the static set of shard offsets the connectivity
      uses (`halo_offsets`, the paper's construction-time discovery of the
      processes to listen to); received ids are matched against the local
      source table;
  'hier' — one AER buffer per group of shards (the shards one process
      owns), sent at whole-group stride along `hier_offsets`.

A mesh of devices (one shard per device, real collectives) is ROADMAP
queue 1 item 8.  The offsets and groups are host-side numpy functions of
the plan's tables; `delivery_step_fns` dispatches the phase callables on
EngineConfig.delivery and on streamed connectivity, as the JAX package's
`_delivery_phases` does, so every phase handle runs every backend.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np

from . import engine, event_engine, stream_engine, topology
from .engine import ShardPlan, SimSpec


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


def _resolve_groups(spec: SimSpec, mesh, hier_groups) -> List[List[int]]:
    """Shard groups of the 'hier' exchange: an explicit group count or an
    explicit group list.  The stacked exchange moves whole blocks of
    consecutive shards, so a list must be equal-sized contiguous blocks
    `range(g*L, (g+1)*L)` in order.  Groups from a mesh's per-process
    device blocks are ROADMAP queue 1 item 8."""
    H = spec.eng.n_shards
    if mesh is not None:
        raise NotImplementedError(
            "hier groups from a device mesh are not ported yet (ROADMAP "
            "queue 1, item 8); pass hier_groups=")
    if hier_groups is None:
        raise ValueError("exchange='hier' needs hier_groups= (a group "
                         "count or a list of groups)")
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


class PhasePrograms(NamedTuple):
    """Phase handles over the stacked shards: `phase_a(state, t)` /
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
