"""The RG-LRU recurrent block of Griffin / RecurrentGemma (port of the
RG-LRU half of `repro.models.recurrent`).

  h_t = a_t (.) h_{t-1} + sqrt(1 - a_t^2) (.) (i_t (.) x_t),
  a_t = exp(-c softplus(L) (.) r_t),  c = 8,

with a gated depthwise causal conv1d in front (arXiv:2402.19427).  The
scan goes through `kernels.ops.rg_lru_scan`: the hand-written CUDA kernel
on the card, its plain sequential version on the CPU.

Decode state (the recurrent 'KV cache'):
  {h: [B, d_rnn] fp32, conv: [B, w-1, d_rnn] model dtype}

RWKV-6 is not ported yet (ROADMAP queue 1 item 13).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from . import common

F32 = torch.float32
_RG_C = 8.0


class RGLRU(torch.nn.Module):
    """Parameters of one RG-LRU block; `forward` is `rglru`."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        dr = cfg.rg_lru_width or d
        w = cfg.conv1d_width
        P = common.param
        self.w_x = P((d, dr), dtype, device)
        self.w_gate = P((d, dr), dtype, device)
        self.conv_w = P((w, dr), dtype, device)
        self.conv_b = P((dr,), dtype, device)
        self.wa = P((dr, dr), dtype, device)
        self.ba = P((dr,), F32, device)
        self.wi = P((dr, dr), dtype, device)
        self.bi = P((dr,), F32, device)
        self.log_lambda = P((dr,), F32, device)
        self.w_out = P((dr, d), dtype, device)

    def forward(self, x, state: Optional[dict] = None):
        return rglru(self.cfg, self, x, state)


def log_lambda_init(dr: int) -> torch.Tensor:
    """Lambda so that a lies in ~(0.9, 0.999) at r=1 (Griffin B.2), fp32:
    log(expm1(-log(linspace(0.9, 0.999, dr)) / c))."""
    a = torch.linspace(0.9, 0.999, dr, dtype=F32)
    return torch.log(torch.expm1(-torch.log(a) / _RG_C))


@torch.no_grad()
def init_rglru(p: RGLRU, generator) -> None:
    """Fill an RG-LRU block as `recurrent.init_rglru` does: fan-in
    truncated normals, zero biases, the Griffin Lambda."""
    for name in ("w_x", "w_gate", "conv_w", "wa", "wi", "w_out"):
        common.init_dense(getattr(p, name), generator)
    for name in ("conv_b", "ba", "bi"):
        getattr(p, name).zero_()
    p.log_lambda.copy_(log_lambda_init(p.log_lambda.shape[0]))


def _causal_conv1d(x, w, b, state=None):
    """x: [B,T,D]; w: [W,D] depthwise.  state: [B,W-1,D] tail of previous
    tokens (decode).  Returns (y, new_state).  The taps are summed in
    order i = 0 .. W-1, in the model dtype; the new state is the last W-1
    rows of the padded input (pad rows too when T < W-1)."""
    W = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                  # [B, T+W-1, D]
    T = x.shape[1]
    y = sum(xp[:, i:i + T] * w[i] for i in range(W)) + b
    new_state = xp[:, -(W - 1):] if W > 1 else None
    return y.to(x.dtype), new_state


def _rg_lru_scan(xb, a, h0=None):
    """h_t = a_t*h_{t-1} + b_t.  xb, a: [B,T,D] fp32.  Note the argument
    order: the kernel takes (a, b, h0)."""
    return kops.rg_lru_scan(a.contiguous(), xb.contiguous(),
                            None if h0 is None else h0.contiguous())


def rglru(cfg: ModelConfig, p: RGLRU, x, state: Optional[dict] = None
          ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: [B,T,d] -> (y, new_state)."""
    gate = common.activate(x @ p.w_gate, None, "gelu")
    xi = x @ p.w_x
    conv_state = None if state is None else state["conv"]
    xi, new_conv = _causal_conv1d(xi, p.conv_w, p.conv_b, conv_state)

    xf = xi.to(F32)
    r = torch.sigmoid(xf @ p.wa.to(F32) + p.ba)
    i = torch.sigmoid(xf @ p.wi.to(F32) + p.bi)
    log_a = -_RG_C * F.softplus(p.log_lambda) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xf)

    if state is None:
        h = _rg_lru_scan(b, a)
        new_state = None if x.shape[1] == 0 else {
            "h": h[:, -1].contiguous(), "conv": new_conv}
    else:
        h = _rg_lru_scan(b, a, h0=state["h"])
        new_state = {"h": h[:, -1].contiguous(), "conv": new_conv}

    y = (h.to(x.dtype) * gate) @ p.w_out
    return y, new_state


def init_rglru_state(cfg: ModelConfig, batch: int, dtype=F32, device=None):
    dr = cfg.rg_lru_width or cfg.d_model
    return {"h": torch.zeros((batch, dr), dtype=F32, device=device),
            "conv": torch.zeros((batch, cfg.conv1d_width - 1, dr),
                                dtype=dtype, device=device)}
