"""Dense MLP block (port of `repro.models.mlp`).  Its products go through
`dist.lm_blocks.linear`: the plain expression with no mesh bound."""
from __future__ import annotations

import torch

from ..dist import lm_blocks as blk
from . import common


class MLP(torch.nn.Module):
    """x @ w_in, gated by x @ w_gate (SwiGLU) or not, then @ w_out."""

    def __init__(self, d_model: int, d_ff: int, act: str, dtype, device):
        super().__init__()
        self.act = act
        self.w_in = common.param((d_model, d_ff), dtype, device)
        if act == "swiglu":
            self.w_gate = common.param((d_model, d_ff), dtype, device)
        self.w_out = common.param((d_ff, d_model), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(self, x, self.act)


def init_mlp(p: MLP, generator) -> None:
    for w in p.parameters():
        common.init_dense(w, generator)


def mlp(p: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    h = blk.linear(x, p.w_in)
    gate = blk.linear(x, p.w_gate) if hasattr(p, "w_gate") else None
    h = common.activate(h, gate, act)
    return blk.linear(h, p.w_out)
