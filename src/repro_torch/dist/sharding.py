"""Sharding: the SNN's stacked trees on its mesh, and the LM's rules (port
of `repro.dist.sharding`).

**SNN.**  A tree is a tensor or a NamedTuple (nested) of tensors whose
leading axis stacks the H shards, as `core.engine.build` returns them: a
ShardPlan, an EventPlan, a StreamedPlan, a ShardState or an EventState
(`shard_put`, `replicated_put`).

**LM.**  The JAX package's rule tables, computed on a mesh's axis sizes
alone (anything with a `.shape` mapping axis name -> size, in the mesh's
order: a `dist.mesh.LmMesh`, bound to a job or not).  A spec is a tuple
with an entry a dimension: None, an axis name, or a tuple of axis names
(the JAX `PartitionSpec`'s entries).  `infer_param_spec`,
`infer_cache_spec` and `infer_batch_spec` try candidate rules in order
and keep the first whose every mesh-present axis divides its dimension
(`_fit`); axes the mesh lacks are dropped.  They place every leaf by the
same path + shape rules as the JAX package: FSDP over ('pod', 'data'), TP
over 'model'.  `use_mesh` binds an `LmMesh` for the model code
(`get_mesh`, `axis_size`); unlike the JAX package's ContextVar the
binding is one per process, so that autograd's device threads, which run
the per-layer recompute, see it too.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Optional, Sequence, Tuple

import torch

from .mesh import SnnMesh


def tree_map(fn, tree):
    """fn applied to each tensor of a tree (a tensor, or a NamedTuple,
    tuple or list of trees), in the tree's structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    parts = [tree_map(fn, t) for t in tree]
    return type(tree)(parts) if type(tree) in (tuple, list) else type(tree)(
        *parts)


def tree_leaves(tree) -> list:
    """The tree's tensors, depth first."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for t in tree for x in tree_leaves(t)]


def shard_put(mesh: SnnMesh, tree):
    """The rank's block [L, ...] of a stacked [H, ...] tree, copied to its
    device (the rest of the tree is not uploaded)."""
    lo, hi = mesh.block.start, mesh.block.stop

    def put(x):
        if x.shape[0] != mesh.n_shards:
            raise ValueError(f"shard_put: a leading axis of {x.shape[0]}, "
                             f"the mesh has {mesh.n_shards} shards")
        return x[lo:hi].to(mesh.device, copy=True).contiguous()
    return tree_map(put, tree)


def replicated_put(mesh: SnnMesh, tree):
    """The whole tree on the rank's device."""
    return tree_map(lambda x: x.to(mesh.device), tree)


# ---------------------------------------------------------------------------
# the LM: mesh binding
# ---------------------------------------------------------------------------

#: logical name -> physical mesh axes, in sharding-priority order: a logical
#: axis maps onto whichever of its physical axes the bound mesh has
LOGICAL_AXES = {
    "batch": ("pod", "data"),
    "data": ("data",),
    "model": ("model",),
    "experts": ("model",),   # expert parallelism rides the model axis
    "seq": ("model",),       # sequence sharding (long-context caches)
    "cells": ("cells",),     # SNN space-parallel axis
}

_ACTIVE_MESH = [None]


@contextlib.contextmanager
def use_mesh(mesh):
    """Bind `mesh` (an `LmMesh` bound to this rank's job) for the model
    code in this context; bindings nest.  Bind nothing and every
    placement helper of `dist.lm_blocks` is an identity."""
    prev = _ACTIVE_MESH[0]
    _ACTIVE_MESH[0] = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH[0] = prev


def get_mesh():
    """The mesh bound by the innermost `use_mesh`, or None outside one."""
    return _ACTIVE_MESH[0]


def axis_size(logical: str) -> int:
    """Product of the bound mesh's sizes of `logical`'s physical axes (1
    when no mesh is bound or none of its axes exist)."""
    mesh = get_mesh()
    if mesh is None:
        return 1
    names = LOGICAL_AXES.get(logical, (logical,))
    return math.prod(mesh.shape[a] for a in names if a in mesh.shape)


def _greedy_entry(dim: int, logical: Optional[str], mesh):
    """Physical spec entry for one dimension under a logical axis: keep
    each mapped axis while the cumulative shard count still divides
    `dim`."""
    if logical is None:
        return None
    kept, prod = [], 1
    for a in LOGICAL_AXES.get(logical, (logical,)):
        if a in mesh.shape and dim % (prod * mesh.shape[a]) == 0:
            kept.append(a)
            prod *= mesh.shape[a]
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else tuple(kept)


# ---------------------------------------------------------------------------
# the LM: rule fitting
# ---------------------------------------------------------------------------

Rule = Tuple[Any, ...]          # per-dim entries: None | axis | (axes...)
Spec = Tuple[Any, ...]

FSDP = ("pod", "data")          # fully-sharded-data-parallel axes
TP = "model"                    # tensor/expert-parallel axis
ALL = ("pod", "data", "model")  # "shard over everything" fallback


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _apply_rule(shape: Sequence[int], rule: Rule, mesh) -> Optional[Spec]:
    """Rule -> spec, or None if a mesh-present axis does not divide its
    dimension (axes the mesh lacks are dropped, not a failure)."""
    if len(rule) != len(shape):
        return None
    out = []
    for dim, entry in zip(shape, rule):
        names = [a for a in _entry_axes(entry) if a in mesh.shape]
        if names:
            if dim % math.prod(mesh.shape[a] for a in names) != 0:
                return None
            out.append(names[0] if len(names) == 1 else tuple(names))
        else:
            out.append(None)
    return tuple(out)


def _fit(shape: Sequence[int], candidate_rules: Sequence[Rule],
         mesh) -> Spec:
    """The first candidate rule that fits `shape` on `mesh`; replicated
    when none fits."""
    for rule in candidate_rules:
        spec = _apply_rule(shape, rule, mesh)
        if spec is not None:
            return spec
    return (None,) * len(shape)


def infer_param_spec(path: str, shape: Sequence[int], mesh) -> Spec:
    """Parameter placement by path + shape: embeddings vocab on TP and d
    on FSDP (an odd vocab falls back to d over every axis); stacked
    weights [L, d_in, d_out] d_in on FSDP, d_out on TP; expert weights
    [L, E, d, f] experts on TP (expert parallel) and f on FSDP, odd expert
    counts data-local with f on TP; vectors replicated."""
    nd = len(shape)
    leaf = path.rsplit("/", 1)[-1]
    if nd <= 1:
        return (None,) * nd
    if "embed" in leaf and nd == 2:
        if shape[0] >= shape[1]:                     # (vocab, d)
            rules = [(TP, FSDP), (None, ALL), (None, None)]
        else:                                        # (d, vocab)
            rules = [(FSDP, TP), (ALL, None), (None, None)]
        return _fit(shape, rules, mesh)
    if nd == 4:                                      # (L, E, d, f) experts
        return _fit(shape, [(None, TP, None, FSDP),
                            (None, None, None, TP),
                            (None, None, None, FSDP),
                            (None,) * 4], mesh)
    if nd == 3:                                      # (L, d_in, d_out)
        return _fit(shape, [(None, FSDP, TP),
                            (None, None, TP),
                            (None, None, ALL),
                            (None,) * 3], mesh)
    # plain 2-D dense (un-stacked: routers, shared experts, heads)
    return _fit(shape, [(FSDP, TP), (None, TP), (None, ALL),
                        (None, None)], mesh)


def infer_cache_spec(path: str, shape: Sequence[int], mesh) -> Spec:
    """KV / recurrent-state placement: batch on FSDP, sequence on TP."""
    nd = len(shape)
    if nd == 5:                                      # (L, B, S, H, D)
        rules = [(None, FSDP, TP, None, None),
                 (None, None, TP, None, None),
                 (None,) * 5]
    elif nd == 4:                                    # (B, S, H, D)
        rules = [(FSDP, TP, None, None),
                 (None, TP, None, None),
                 (None,) * 4]
    elif nd == 3:                                    # (B, S, d) enc_out /
        rules = [(FSDP, None, None), (None,) * 3]    # recurrent state
    elif nd == 2:                                    # (B, d)
        rules = [(FSDP, None), (None, None)]
    else:
        rules = [(None,) * nd]
    return _fit(shape, rules, mesh)


def infer_batch_spec(name: str, shape: Sequence[int], mesh) -> Spec:
    """Input batches: leading (batch) dim over FSDP, rest replicated."""
    nd = len(shape)
    if nd == 0:
        return ()
    return _fit(shape, [(FSDP,) + (None,) * (nd - 1), (None,) * nd], mesh)


def path_str(keys) -> str:
    """A leaf's path as the JAX package's `_path_str` writes it: its dict
    keys and sequence indices joined by '/' after a leading '/'."""
    return "/" + "/".join(str(k) for k in keys)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec names, in its order."""
    return tuple(a for e in spec for a in _entry_axes(e))


def block_range(dim: int, entry, mesh, coords) -> range:
    """The part of a dimension of size `dim` that the device at `coords`
    (axis -> index) holds under a spec entry: the axes' coordinates
    flattened major to minor, as a `NamedSharding` splits it."""
    axes = _entry_axes(entry)
    if not axes:
        return range(dim)
    n, b = 1, 0
    for a in axes:
        n *= mesh.shape[a]
        b = b * mesh.shape[a] + coords[a]
    step = dim // n
    return range(b * step, (b + 1) * step)
