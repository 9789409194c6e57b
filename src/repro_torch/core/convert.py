"""Carry a JAX run's plan and state across into the port.

`from_jax(plan, state, device)` takes the JAX package's `ShardPlan` and
`ShardState` (NamedTuples whose leaves are numpy arrays, or anything
`np.asarray` takes) and returns the port's tensors on `device`, so a run
started in JAX continues here bit for bit; `event_from_jax(plan, eplan,
state, device)` does the same for the event backend's `EventPlan` and
`EventState`, and `streamed_from_jax(plan, splan, state, device)` for
streamed connectivity's `StreamedPlan` (its state is a ShardState sized
[H, e_pad]).  This module does not import JAX: it reads the fields by
name.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .engine import ShardPlan, ShardState, plan_from_arrays, resolve_device
from .event_engine import EventPlan, EventState
from .stream_engine import StreamedPlan

_PLAN_FIELDS = ("src_gid", "syn_src", "syn_tgt", "syn_delay", "syn_plastic",
                "syn_valid", "exc_mask", "neuron_valid", "gid", "columns",
                "shard_id")


def from_jax(plan, state, device=None) -> Tuple[ShardPlan, ShardState]:
    """(port ShardPlan, port ShardState) from the JAX package's stacked
    dense-delivery ShardPlan / ShardState."""
    dev = resolve_device(device)
    p = plan_from_arrays({k: getattr(plan, k) for k in _PLAN_FIELDS}, dev)
    s = ShardState(**{
        k: torch.from_numpy(np.array(getattr(state, k))).to(dev)
        for k in ShardState._fields})
    return p, s


def _tensor(x, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(x).astype(dtype)).to(dev)


def event_from_jax(plan, eplan, state, device=None
                   ) -> Tuple[ShardPlan, EventPlan, EventState]:
    """(port ShardPlan, EventPlan, EventState) from the JAX package's
    stacked event-delivery ShardPlan, EventPlan and EventState (its `base`
    a ShardState)."""
    dev = resolve_device(device)
    p, base = from_jax(plan, state.base, dev)
    ep = EventPlan(**{k: _tensor(getattr(eplan, k), np.int32, dev)
                      for k in EventPlan._fields})
    st = EventState(base=base,
                    ev_ring=_tensor(state.ev_ring, np.int32, dev),
                    ev_count=_tensor(state.ev_count, np.int32, dev),
                    sat=_tensor(state.sat, np.int32, dev))
    return p, ep, st


def streamed_from_jax(plan, splan, state, device=None
                      ) -> Tuple[ShardPlan, StreamedPlan, ShardState]:
    """(port ShardPlan, StreamedPlan, ShardState) from the JAX package's
    stacked streamed-connectivity ShardPlan (1-element synapse dummies),
    StreamedPlan and ShardState (synapse state [H, e_pad])."""
    dev = resolve_device(device)
    p, s = from_jax(plan, state, dev)
    sp = StreamedPlan(**{k: _tensor(getattr(splan, k), np.int32, dev)
                         for k in StreamedPlan._fields})
    return p, sp, s
