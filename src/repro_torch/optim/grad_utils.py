"""Gradient utilities (port of `repro.optim.grad_utils`): global-norm
clipping and bf16 gradient compression with error feedback (the
residual buffer keeps the quantization unbiased over time).

A tree is a dict of tensors keyed by the port's parameter names.  The
global norm adds the leaves' squared sums in the JAX package's leaf
order, `jax.tree.leaves` of its parameter tree (dict keys sorted, each
pattern unit's layers stacked into one leaf): pass that order as `groups`,
a list of lists of names (`[l.names for l in
models.convert.jax_leaf_groups(cfg)]`, a stacked leaf's names in unit
order); by default each key is a leaf, in the dict's order.

Over an `LmMesh` the tree holds the rank's blocks (`dist.lm_blocks`): each
leaf's partial sum of squares is taken over the blocks this rank leads
(one rank of each set holding the same block), the partials are summed
over the job in rank order, and the leaves' sums are added in the JAX
leaf order.  Clipping and compression are elementwise, block by block."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

F32 = torch.float32


def global_norm(tree: Dict[str, torch.Tensor],
                groups: Optional[List[List[str]]] = None,
                places: Optional[dict] = None, mesh=None) -> torch.Tensor:
    """The global L2 norm; over a mesh (`places`: each name's
    `lm_blocks.LeafPlace`) of the blocks every rank holds."""
    groups = groups if groups is not None else [[k] for k in tree]
    if mesh is None:
        return torch.sqrt(sum(sum(torch.sum(torch.square(tree[k].to(F32)))
                                  for k in g) for g in groups))
    from ..dist import lm_blocks as blk
    first = next(iter(tree.values()))
    zero = torch.zeros((), dtype=F32, device=first.device)
    partial = torch.stack([
        sum((torch.sum(torch.square(tree[k].to(F32))) for k in g
             if blk.replica_leader(places[k], mesh)), zero)
        for g in groups])
    leaves = blk.sum_over_job(partial, mesh)
    total = leaves[0]
    for s in leaves[1:]:
        total = total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                        groups: Optional[List[List[str]]] = None,
                        places: Optional[dict] = None, mesh=None
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    norm = global_norm(grads, groups, places, mesh)
    # a true division (a Python number over a tensor would multiply by the
    # tensor's reciprocal)
    num = torch.tensor(max_norm, dtype=F32, device=norm.device)
    scale = torch.clamp_max(num / torch.clamp_min(norm, 1e-9), 1.0)
    return {k: (g.to(F32) * scale).to(g.dtype)
            for k, g in grads.items()}, norm


def init_error_feedback(params: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(p.shape, dtype=F32, device=p.device)
            for k, p in params.items()}


def compress_with_feedback(grads: Dict[str, torch.Tensor],
                           residual: Dict[str, torch.Tensor]
                           ) -> Tuple[Dict, Dict]:
    """bf16-quantize grads (for the wire); the residual carries the error.
    Returns (bf16 grads, new residual)."""
    comp, res = {}, {}
    for k, g in grads.items():
        gf = g.to(F32) + residual[k]
        q = gf.to(torch.bfloat16)
        comp[k], res[k] = q, gf - q.to(F32)
    return comp, res
