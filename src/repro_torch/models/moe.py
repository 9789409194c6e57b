"""Mixture-of-Experts layer with capacity-bounded, sort-based dispatch (port
of `repro.models.moe`).

Routing is top-k over a softmax of an fp32 router; each batch row
dispatches its own T*K assignments (the JAX package's `vmap` over rows):
a stable sort by expert ranks the assignments inside each expert, the
first C of an expert keep a slot of its [C] buffer and the rest drop, as
AER saturation does.  The experts then run as batched products over
[B, E, C, d] slot tensors, so every expert's weights are read whatever
the routing, and each token adds its kept contributions back.

The order of every step follows the reference, because it decides bits
and, past capacity, which assignments drop:
- top-k breaks ties toward the lower expert index (`jax.lax.top_k`);
- the sort by expert is stable (`jnp.argsort`), so an expert's slots go
  to its assignments in token order, and a left-padded prompt's pads take
  slots before the real tokens;
- C = int(capacity_factor * T * K / E) or 1, rounded up to a multiple of
  8 and capped at T * K, per row;
- a token's contributions are added from +0.0 in ascending expert order
  in the model dtype, as `.at[token].add` over the sorted assignments
  does (`index_add_` on the card uses atomics, which fix no order).

Plain PyTorch on both devices.  The JAX package's sharding constraints
(`shard`, the 'experts' mesh axis) have no counterpart in one process;
expert parallelism over ranks comes with the LM sharding rules (ROADMAP
queue 1 item 13.7).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..configs.base import MoEConfig
from . import common

F32 = torch.float32


class MoE(torch.nn.Module):
    """router [d, E] fp32; w_in, w_gate (SwiGLU), w_out [E, ...]; the
    shared expert's s_in, s_gate, s_out."""

    def __init__(self, d_model: int, mcfg: MoEConfig, act: str, dtype,
                 device):
        super().__init__()
        self.mcfg, self.act = mcfg, act
        E, f = mcfg.n_experts, mcfg.d_ff_expert
        P = common.param
        self.router = P((d_model, E), F32, device)
        self.w_in = P((E, d_model, f), dtype, device)
        self.w_out = P((E, f, d_model), dtype, device)
        if act == "swiglu":
            self.w_gate = P((E, d_model, f), dtype, device)
        if mcfg.shared_expert:
            self.s_in = P((d_model, f), dtype, device)
            self.s_out = P((f, d_model), dtype, device)
            if act == "swiglu":
                self.s_gate = P((d_model, f), dtype, device)

    def forward(self, x):
        return moe(self, x, self.mcfg, self.act)


def init_moe(p: MoE, generator) -> None:
    for w in p.parameters():
        common.init_dense(w, generator)


def capacity(mcfg: MoEConfig, T: int) -> int:
    """Slots an expert has in one row of T tokens (the reference's
    expression, to the letter)."""
    E, K = mcfg.n_experts, mcfg.top_k
    C = int(mcfg.capacity_factor * T * K / E) or 1
    return min(-(-C // 8) * 8, T * K)


def top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index
    (`jax.lax.top_k`): a stable descending sort keeps equal values in
    index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dispatch(x: torch.Tensor, idx: torch.Tensor, E: int, C: int):
    """Per-row slot assignment (`_row_dispatch` of each row).  x [B, T, d],
    idx [B, T, K] experts -> (x_e [B, E, C, d], table [B, E*C] the token
    in each slot (T where empty), order, sorted_e, rank, keep [B, T*K]):
    the stable sort by expert and each sorted assignment's rank in its
    expert, kept below C."""
    B, T, K = idx.shape
    d = x.shape[-1]
    dev = x.device
    flat_e = idx.reshape(B, T * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(E, device=dev).expand(B, E).contiguous()
    seg_start = torch.searchsorted(sorted_e, experts)
    rank = torch.arange(T * K, device=dev) - torch.gather(seg_start, 1,
                                                          sorted_e)
    keep = rank < C
    slot = torch.where(keep, sorted_e * C + rank, E * C)
    table = torch.full((B, E * C + 1), T, dtype=torch.int64, device=dev)
    table = table.scatter_(1, slot, order // K)[:, :E * C]
    x_e = torch.gather(x, 1, table.clamp_max(T - 1)[..., None].expand(
        B, E * C, d))
    x_e = x_e.masked_fill((table >= T)[..., None], 0).view(B, E, C, d)
    return x_e, table, order, sorted_e, rank, keep


def combine(y_e, gates, idx, order, sorted_e, rank, keep, C: int):
    """Per-row combine (`_row_combine` of each row).  y_e [B, E, C, d]
    expert outputs, gates and idx [B, T, K] (gates in the model dtype),
    the rest from `dispatch` -> y [B, T, d] in y_e's dtype: each token's
    kept contributions, gated in the model dtype and added one by one from
    +0.0 in ascending expert order (a dropped one reads slot 0, gated by
    0)."""
    B, E, _, d = y_e.shape
    T, K = idx.shape[1], idx.shape[2]
    y_e = y_e.reshape(B, E * C, d)
    gate_of = torch.gather(gates.reshape(B, T * K), 1, order)
    gate_slot = torch.where(keep, gate_of, torch.zeros_like(gate_of))
    src = torch.where(keep, sorted_e * C + rank, 0)
    contrib = torch.gather(y_e, 1, src[..., None].expand(B, T * K, d)) \
        * gate_slot[..., None]
    # from sorted order back to each token's K, in ascending expert order
    inv = torch.argsort(order, dim=-1)
    by_expert = torch.argsort(idx, dim=-1, stable=True)
    pos = torch.gather(inv.view(B, T, K), 2, by_expert)
    parts = torch.gather(contrib, 1, pos.reshape(B, T * K, 1).expand(
        B, T * K, d)).view(B, T, K, d)
    y = torch.zeros((B, T, d), dtype=y_e.dtype, device=y_e.device)
    for j in range(K):
        y = y + parts[:, :, j]
    return y


def moe(p: MoE, x: torch.Tensor, mcfg: MoEConfig, act: str
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, d] -> (y [B, T, d], aux_loss fp32 scalar)."""
    B, T, d = x.shape
    E, K = mcfg.n_experts, mcfg.top_k
    N = B * T
    dev = x.device
    xf = x.reshape(N, d)

    probs = torch.softmax(xf.to(F32) @ p.router, dim=-1)     # [N, E]
    gates, idx = top_k(probs, K)                             # [N, K]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    # load-balancing auxiliary loss (Switch / GShard form); every addend
    # is the same constant, so any order of the adds gives the same bits
    me = probs.mean(dim=0)
    ce = torch.zeros(E, dtype=F32, device=dev).index_add_(
        0, idx.reshape(-1), torch.full((N * K,), 1.0 / (N * K), dtype=F32,
                                       device=dev))
    aux = E * torch.sum(me * ce)

    C = capacity(mcfg, T)
    idx_r = idx.reshape(B, T, K)
    x_e, _, order, sorted_e, rank, keep = dispatch(x, idx_r, E, C)

    h = torch.einsum("becd,edf->becf", x_e, p.w_in)
    if hasattr(p, "w_gate"):
        g = torch.einsum("becd,edf->becf", x_e, p.w_gate)
        h = common.activate(h, g, "swiglu")
    else:
        h = common.activate(h, None, "gelu")
    y_e = torch.einsum("becf,efd->becd", h, p.w_out)

    y = combine(y_e, gates.reshape(B, T, K).to(x.dtype), idx_r, order,
                sorted_e, rank, keep, C)

    if mcfg.shared_expert:
        hs = xf @ p.s_in
        if hasattr(p, "s_gate"):
            hs = common.activate(hs, xf @ p.s_gate, "swiglu")
        else:
            hs = common.activate(hs, None, "gelu")
        y = y + (hs @ p.s_out).view(B, T, d)
    return y, aux
