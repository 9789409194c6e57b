"""Placement of the SNN's stacked trees on a mesh (the SNN part of
`repro.dist.sharding`; the LM sharding rules are ROADMAP queue 1, item
13.7).

A tree is a tensor or a NamedTuple (nested) of tensors whose leading axis
stacks the H shards, as `core.engine.build` returns them: a ShardPlan, an
EventPlan, a StreamedPlan, a ShardState or an EventState."""
from __future__ import annotations

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
