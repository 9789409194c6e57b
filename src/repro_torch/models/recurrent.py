"""Recurrent mixers: RG-LRU (Griffin / RecurrentGemma) and RWKV-6 (Finch)
(port of `repro.models.recurrent`).

  RG-LRU:  h_t = a_t (.) h_{t-1} + sqrt(1 - a_t^2) (.) (i_t (.) x_t),
           a_t = exp(-c softplus(L) (.) r_t),  c = 8,
           with a gated depthwise causal conv1d in front
           (arXiv:2402.19427).  The scan goes through
           `kernels.ops.rg_lru_scan`: the hand-written CUDA kernel on the
           card, its plain sequential version on the CPU.

  RWKV-6:  per-head state S in R^{dk x dv};
           o_t = r_t (S + u (.) k_t^T v_t);  S <- diag(w_t) S + k_t^T v_t,
           with a data-dependent per-channel decay w_t from a low-rank MLP
           (arXiv:2404.05892).  Plain PyTorch on both devices: a Python
           loop over T (the reference's `lax.scan`), fp32 state.

Decode state (the recurrent 'KV cache'):
  RG-LRU: {h: [B, d_rnn] fp32, conv: [B, w-1, d_rnn] model dtype}
  RWKV-6: {S: [B, H, dk, dv] fp32, xa: [B, d], xf: [B, d] model dtype}
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..dist import lm_blocks as blk
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
    gate = common.activate(blk.linear(x, p.w_gate), None, "gelu")
    xi = blk.linear(x, p.w_x)
    conv_state = None if state is None else state["conv"]
    xi, new_conv = _causal_conv1d(xi, blk.use(p.conv_w), blk.use(p.conv_b),
                                  conv_state)

    xf = xi.to(F32)
    r = torch.sigmoid(blk.linear(xf, p.wa, F32) + blk.use(p.ba))
    i = torch.sigmoid(blk.linear(xf, p.wi, F32) + blk.use(p.bi))
    log_a = -_RG_C * F.softplus(blk.use(p.log_lambda)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xf)

    if state is None:
        h = _rg_lru_scan(b, a)
        new_state = None if x.shape[1] == 0 else {
            "h": h[:, -1].contiguous(), "conv": new_conv}
    else:
        h = _rg_lru_scan(b, a, h0=state["h"])
        new_state = {"h": h[:, -1].contiguous(), "conv": new_conv}

    y = blk.linear(h.to(x.dtype) * gate, p.w_out)
    return y, new_state


def init_rglru_state(cfg: ModelConfig, batch: int, dtype=F32, device=None):
    dr = cfg.rg_lru_width or cfg.d_model
    return {"h": torch.zeros((batch, dr), dtype=F32, device=device),
            "conv": torch.zeros((batch, cfg.conv1d_width - 1, dr),
                                dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# RWKV-6 block: the time mix, and the channel mix (an MLP kind, 'cmix')
# ---------------------------------------------------------------------------


class RWKV(torch.nn.Module):
    """Parameters of one RWKV-6 time mix; `forward` is `rwkv_time_mix`."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        dh = cfg.rwkv_head_dim
        lora = max(32, d // 32)
        P = common.param
        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
            setattr(self, name, P((d,), F32, device))
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, P((d, d), dtype, device))
        self.decay_w0 = P((d,), F32, device)
        self.decay_a = P((d, lora), dtype, device)
        self.decay_b = P((lora, d), dtype, device)
        self.bonus_u = P((d // dh, dh), F32, device)
        self.ln_gamma = P((d,), F32, device)

    def forward(self, x, state: Optional[dict] = None):
        return rwkv_time_mix(self.cfg, self, x, state)


@torch.no_grad()
def init_rwkv(p: RWKV, generator) -> None:
    """Fill a time mix as `recurrent.init_rwkv` does: the lerp weights 0.5,
    decay_w0 -6, bonus_u 0, ln_gamma 1, fan-in truncated normals."""
    for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
        getattr(p, name).fill_(0.5)
    for name in ("w_r", "w_k", "w_v", "w_g", "w_o", "decay_a", "decay_b"):
        common.init_dense(getattr(p, name), generator)
    p.decay_w0.fill_(-6.0)
    p.bonus_u.zero_()
    p.ln_gamma.fill_(1.0)


def _token_shift(x, mu, xprev=None):
    """RWKV token shift: lerp(x_{t-1}, x_t, mu) in fp32, rounded back to
    x's dtype.  xprev: [B, d] carry (None: zeros before the first
    token)."""
    if xprev is None:
        prev = F.pad(x[:, :-1], (0, 0, 1, 0))
    else:
        prev = torch.cat([xprev[:, None].to(x.dtype), x[:, :-1]], dim=1)
    mu = mu.to(F32)
    return (x.to(F32) * mu + prev.to(F32) * (1.0 - mu)).to(x.dtype)


def rwkv_time_mix(cfg: ModelConfig, p: RWKV, x, state: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, dict]:
    """x: [B,T,d] -> (y, new_state {S, xa}); the channel mix adds xf."""
    B, T, d = x.shape
    dh = cfg.rwkv_head_dim
    H = d // dh
    xprev = None if state is None else state["xa"]

    r = blk.linear(_token_shift(x, blk.use(p.mu_r), xprev), p.w_r)
    k = blk.linear(_token_shift(x, blk.use(p.mu_k), xprev), p.w_k)
    v = blk.linear(_token_shift(x, blk.use(p.mu_v), xprev), p.w_v)
    g = blk.linear(_token_shift(x, blk.use(p.mu_g), xprev), p.w_g)
    xw = _token_shift(x, blk.use(p.mu_w), xprev)
    dec = blk.use(p.decay_w0) + blk.linear(torch.tanh(
        blk.linear(xw.to(F32), p.decay_a, F32)), p.decay_b, F32)
    w = torch.exp(-torch.exp(dec))                   # [B,T,d] in (0,1)

    r = r.view(B, T, H, dh).to(F32)
    k = k.view(B, T, H, dh).to(F32)
    v = v.view(B, T, H, dh).to(F32)
    w = w.view(B, T, H, dh)
    u = blk.use(p.bonus_u)[..., None]               # [H, dk, 1]

    S = x.new_zeros((B, H, dh, dh), dtype=F32) if state is None \
        else state["S"]
    outs = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # [B,H,dk,dv]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], S + u * kv))
        S = w[:, t, :, :, None] * S + kv
    y = torch.stack(outs, dim=1)                     # [B,T,H,dh] fp32

    # per-head group norm, silu(g) gate, output projection
    mu_ = y.mean(-1, keepdim=True)
    var = ((y - mu_) ** 2).mean(-1, keepdim=True)
    y = ((y - mu_) * torch.rsqrt(var + 1e-5)).reshape(B, T, d) \
        * blk.use(p.ln_gamma)
    y = blk.linear((y * F.silu(g.to(F32))).to(x.dtype), p.w_o)
    return y, {"S": S, "xa": x[:, -1]}


class RWKVCMix(torch.nn.Module):
    """Parameters of one RWKV-6 channel mix (the 'cmix' MLP kind)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        P = common.param
        self.mu_k = P((d,), F32, device)
        self.mu_r = P((d,), F32, device)
        self.w_k = P((d, f), dtype, device)
        self.w_v = P((f, d), dtype, device)
        self.w_r = P((d, d), dtype, device)


@torch.no_grad()
def init_rwkv_cmix(p: RWKVCMix, generator) -> None:
    p.mu_k.fill_(0.5)
    p.mu_r.fill_(0.5)
    for name in ("w_k", "w_v", "w_r"):
        common.init_dense(getattr(p, name), generator)


def rwkv_channel_mix(cfg: ModelConfig, p: RWKVCMix, x,
                     state: Optional[dict] = None):
    """Squared-ReLU MLP with token shift and an r gate.  Returns (y, the
    new xf carry)."""
    xprev = None if state is None else state["xf"]
    xk = _token_shift(x, blk.use(p.mu_k), xprev)
    xr = _token_shift(x, blk.use(p.mu_r), xprev)
    k = torch.square(F.relu(blk.linear(xk, p.w_k).to(F32)))
    rgate = torch.sigmoid(blk.linear(xr, p.w_r).to(F32))
    y = rgate * blk.linear(k.to(x.dtype), p.w_v).to(F32)
    return y.to(x.dtype), x[:, -1]


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                    device=None):
    d = cfg.d_model
    dh = cfg.rwkv_head_dim
    H = d // dh
    return {"S": torch.zeros((batch, H, dh, dh), dtype=F32, device=device),
            "xa": torch.zeros((batch, d), dtype=dtype, device=device),
            "xf": torch.zeros((batch, d), dtype=dtype, device=device)}
