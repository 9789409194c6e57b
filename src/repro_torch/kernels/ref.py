"""Plain PyTorch versions of every kernel of the port: the dense
DPSNN-STDP path, the RG-LRU scan of the LM (`rg_lru_scan`) and blockwise
attention (`attention`, last).

These are the port's counterparts of `repro.kernels.ref` and of the sorted
`jax.ops.segment_sum` in `repro.core.engine.phase_a_dynamics`.  On a CPU
tensor `kernels.ops` runs them; on a CUDA tensor it launches the
hand-written kernels under `csrc/`, which are held bit-for-bit against
these functions (attention within a tolerance).  They are written to give
the same bits as the JAX reference jitted on the CPU under
`XLA_FLAGS=--xla_cpu_max_isa=AVX` (no FMA contraction):

* every fp32 operation runs in the reference's order, with fp32
  literals (0-dim float32 tensors, never Python doubles);
* `exp` is `xla_exp`, XLA-CPU's own polynomial, not `torch.exp`;
* `x / tau` is `x * float32(1 / tau)`: XLA rewrites a division by a
  constant into a multiplication by its fp32 reciprocal;
* the per-target current sum adds in canonical synapse order from
  +0.0 (`segment_sum_ordered`), which is what XLA-CPU's sorted
  segment sum computes;
* XLA-CPU flushes denormals; run these inside `flush_denormal()` on the
  CPU (the engine does).

`rg_lru_scan` and `attention` agree with the JAX package within a
tolerance, not bit for bit (see their docstrings).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

F32 = torch.float32


def f32(x: float, device) -> torch.Tensor:
    """A 0-dim float32 constant (Python floats would be doubles)."""
    return torch.tensor(np.float32(x), dtype=F32, device=device)


def reciprocal_f32(x: float) -> np.float32:
    """float32(1) / float32(x), as XLA folds a division by a constant."""
    return np.float32(1.0) / np.float32(x)


def _flush_denormal_is_on() -> bool:
    # 2e-38 is normal; a quarter of it is denormal unless flushed.
    tiny = torch.tensor([2e-38], dtype=F32)
    return bool((tiny * 0.25)[0] == 0.0)


@contextlib.contextmanager
def flush_denormal():
    """Flush fp32 denormals to zero on the CPU (as XLA-CPU does) for the
    duration of the block, then restore the previous process-wide state.

    `torch.set_flush_denormal` sets the flag of the calling thread only;
    torch's intra-op worker threads keep their own.  So the block also runs
    torch on one thread, and every operation in it flushes."""
    before = _flush_denormal_is_on()
    threads = torch.get_num_threads()
    torch.set_flush_denormal(True)
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        torch.set_flush_denormal(before)


# XLA-CPU's exp: range clamp, n = round(x log2 e), two-constant ln 2
# reduction, degree-5 Horner polynomial, 2^n by the exponent bits.  Read
# from the IR XLA emits for `jnp.exp` (`--xla_dump_to`).  The CUDA copy is
# `csrc/xla_exp.cuh`; both keep this exact operation order.
EXP_LO = -87.80000305175781
EXP_HI = 88.80000305175781
EXP_LOG2E = 1.4426950216293335
EXP_LN2_HI = 0.693359375
EXP_LN2_LO = -0.00021219444170128554
EXP_POLY = (1.9875691214110702e-4, 1.398199936375022e-3,
            8.333452045917511e-3, 4.166579619050026e-2,
            0.1666666567325592, 0.5)


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """fp32 exp, bit-equal to jitted `jnp.exp` on XLA-CPU (AVX, FTZ)."""
    dev = x.device
    c = lambda v: f32(v, dev)
    x = torch.minimum(torch.maximum(x, c(EXP_LO)), c(EXP_HI))
    n = torch.floor(x * c(EXP_LOG2E) + c(0.5))
    n = torch.minimum(torch.maximum(n, c(-127.0)), c(127.0))
    r = (x - c(EXP_LN2_HI) * n) - c(EXP_LN2_LO) * n
    p = c(EXP_POLY[0])
    for k in EXP_POLY[1:]:
        p = p * r + c(k)
    y = c(1.0) + (r + p * (r * r))
    scale = ((n.to(torch.int32) + 127) << 23).view(F32)
    return y * scale


def izhikevich_update(v, u, current, a, b, c, d, *, v_peak: float,
                      dt: float = 1.0, substeps: int = 2):
    """Plain version of kernels.izhikevich.  Any shape, fp32."""
    dev = v.device
    h = f32(dt / substeps, dev)
    for _ in range(substeps):
        v = v + h * (((f32(0.04, dev) * v * v + f32(5.0, dev) * v)
                      + f32(140.0, dev)) - u + current)
    u = u + (f32(dt, dev) * a) * (b * v - u)
    spiked = v >= f32(v_peak, dev)
    v = torch.where(spiked, c, v)
    u = torch.where(spiked, u + d, u)
    return v, u, spiked


def _stdp_update(w, apply, last, tf, amp, tau, sign, w_min, w_max):
    """w where not `apply`, else clip(w +/- amp * exp((last - t) / tau)).

    Elementwise, so it is computed on the applying synapses only (a few
    percent of them per step): the same operations on the same elements
    give the same bits, at a fraction of the CPU time."""
    dev = w.device
    sel = torch.nonzero(apply.reshape(-1)).reshape(-1)
    wf = w.reshape(-1)
    ws = wf[sel]
    dw = f32(amp, dev) * xla_exp(
        (last.reshape(-1)[sel] - tf) * f32(reciprocal_f32(tau), dev))
    ws = ws + dw if sign > 0 else ws - dw
    out = wf.clone()
    out[sel] = torch.minimum(torch.maximum(ws, f32(w_min, dev)),
                             f32(w_max, dev))
    return out.view(w.shape)


def _arrival(arr, w, last_post_g, last_arr, plastic, tf, *, a_minus,
             tau_minus, w_min, w_max, neg_time):
    """The JAX package's `repro.kernels.ref.stdp_arrival` on gathered [E]
    arrays (arr = ring slot & valid, last_post_g = last_post[syn_tgt]) and
    t as a 0-dim fp32 tensor -> (w', last_arr', contrib), contrib the
    PRE-LTD weight where the synapse arrived, else 0."""
    dev = w.device
    apply = arr & plastic & (last_post_g > f32(neg_time / 2, dev))
    w_out = _stdp_update(w, apply, last_post_g, tf, a_minus, tau_minus, -1,
                         w_min, w_max)
    la_out = torch.where(arr, tf, last_arr)
    contrib = torch.where(arr, w, f32(0.0, dev))
    return w_out, la_out, contrib


def _ltp(post_g, w, last_arr, plastic, valid, tf, *, a_plus, tau_plus,
         w_min, w_max, neg_time):
    """The JAX package's `repro.kernels.ref.stdp_ltp` on gathered [E]
    arrays (post_g = spiked[syn_tgt]) -> w'."""
    apply = post_g & plastic & valid & (last_arr > f32(neg_time / 2,
                                                       w.device))
    return _stdp_update(w, apply, last_arr, tf, a_plus, tau_plus, +1,
                        w_min, w_max)


def stdp_arrival(arr_ring, r: int, syn_valid, syn_tgt, syn_plastic,
                 last_post, w, last_arr, t: float, *, a_minus, tau_minus,
                 w_min, w_max, neg_time):
    """Plain version of kernels.stdp.stdp_arrival: arr_ring [H, D, E] bool,
    slot r, syn_valid / syn_plastic [H, E] bool, syn_tgt [H, E] int64,
    last_post [H, N] fp32, w / last_arr [H, E] fp32; `t` is a Python
    number (the step), used as float32.

    Pops slot r: arr = arr_ring[:, r] & syn_valid, LTD against
    last_post[syn_tgt] where arr and plastic, last_arr = t where arr.
    Updates w, last_arr and arr_ring[:, r] (cleared) in place; returns
    (contrib [H, E], the pre-LTD weight where arr else 0, and n_arrived
    [H] int64)."""
    arr = arr_ring[:, r] & syn_valid
    lp = torch.gather(last_post, 1, syn_tgt)
    w_out, la_out, contrib = _arrival(
        arr, w, lp, last_arr, syn_plastic, f32(t, w.device), a_minus=a_minus,
        tau_minus=tau_minus, w_min=w_min, w_max=w_max, neg_time=neg_time)
    w.copy_(w_out)
    last_arr.copy_(la_out)
    arr_ring[:, r] = False
    return contrib, arr.sum(1)


def stdp_arrival_current(arr_ring, r: int, seg, syn_valid, syn_tgt,
                         syn_plastic, last_post, w, last_arr, t: float, *,
                         a_minus, tau_minus, w_min, w_max, neg_time):
    """Plain version of kernels.stdp.stdp_arrival_current: `stdp_arrival`
    followed by `segment_sum_ordered` of its contributions over `seg`
    (`make_segments(row_ptr, E)`, with its index).  Updates w, last_arr
    and arr_ring[:, r] in place as `stdp_arrival` does; returns (i_syn
    [H, N], each target's in-order sum of the pre-LTD weights that
    arrived, and n_arrived [H] int64)."""
    contrib, n_arrived = stdp_arrival(
        arr_ring, r, syn_valid, syn_tgt, syn_plastic, last_post, w, last_arr,
        t, a_minus=a_minus, tau_minus=tau_minus, w_min=w_min, w_max=w_max,
        neg_time=neg_time)
    return segment_sum_ordered(contrib, seg), n_arrived


def rows_of_synapses(row_ptr: torch.Tensor, n_syn: int) -> torch.Tensor:
    """[H, n_syn] int64: the CSR row (local target) holding each synapse,
    N for a synapse past row_ptr[h, N] (a pad).  Synapse e lies in row n
    iff row_ptr[h, n] <= e < row_ptr[h, n + 1], so its row is the number of
    rows that end at or before e."""
    H = row_ptr.shape[0]
    ends = row_ptr[:, 1:].to(torch.int64)
    marks = torch.zeros((H, n_syn + 1), dtype=torch.int64,
                        device=row_ptr.device)
    marks.scatter_add_(1, ends, torch.ones_like(ends))
    return marks.cumsum(1)[:, :n_syn]


def stdp_ltp(spiked, row_ptr, syn_plastic, last_arr, w, last_post,
             t: float, *, a_plus, tau_plus, w_min, w_max, neg_time) -> None:
    """Plain version of kernels.stdp.stdp_ltp: spiked [H, N] bool, row_ptr
    [H, N + 1] int32 (the per-target CSR of the valid synapses, pads
    outside every row), syn_plastic [H, E] bool, last_arr / w [H, E] fp32,
    last_post [H, N] fp32.

    LTP where post = spiked[syn_tgt], with syn_tgt and syn_valid read off
    row_ptr; updates w and last_post (= t where spiked) in place."""
    H, N = spiked.shape
    row = rows_of_synapses(row_ptr, w.shape[1])
    valid = row < N
    post = torch.cat([spiked, spiked.new_zeros(H, 1)], 1).gather(1, row)
    tf = f32(t, w.device)
    w.copy_(_ltp(post, w, last_arr, syn_plastic, valid, tf, a_plus=a_plus,
                 tau_plus=tau_plus, w_min=w_min, w_max=w_max,
                 neg_time=neg_time))
    last_post.copy_(torch.where(spiked, tf, last_post))


class Segments(NamedTuple):
    """The per-target CSR of the synapses, derived once from a plan.

    row_ptr [H, N + 1] int32 over each shard's valid synapses (sorted by
    target; pads lie outside every row); max_fan_in the longest row;
    index [H, max_fan_in * N] int64 or None, for row i of shard h at
    position k the synapse index row_ptr[h, i] + k, or E (a +0.0 column)
    past the row's end.  The kernel reads row_ptr; the plain version reads
    index, which only it needs."""
    row_ptr: torch.Tensor
    max_fan_in: int
    index: Optional[torch.Tensor]


def make_segments(row_ptr: torch.Tensor, n_syn: int, *,
                  with_index: bool = True) -> Segments:
    """Segments of row_ptr [H, N + 1] over [H, n_syn] synapse arrays; the
    plain version's gather index only `with_index`."""
    start = row_ptr[:, :-1].to(torch.int64)                     # [H, N]
    length = (row_ptr[:, 1:] - row_ptr[:, :-1]).to(torch.int64)
    max_fan_in = int(length.max()) if length.numel() else 0
    if not with_index:
        return Segments(row_ptr, max_fan_in, None)
    k = torch.arange(max_fan_in, device=row_ptr.device).view(1, -1, 1)
    index = torch.where(k < length[:, None], start[:, None] + k, n_syn)
    return Segments(row_ptr, max_fan_in,
                    index.reshape(row_ptr.shape[0], -1))


def segment_sum_ordered(contrib: torch.Tensor,
                        seg: Segments) -> torch.Tensor:
    """Per-target fp32 sum in canonical synapse order.

    contrib [H, E] fp32 -> [H, N]: row i of shard h is
    ((0 + contrib[h, p0]) + contrib[h, p0 + 1]) + ... over
    p0 = row_ptr[h, i] .. row_ptr[h, i + 1] - 1.  Written as a loop over
    the position k within a row, so the order of additions is fixed on
    any device.  The rows are gathered into a [H, max_fan_in, N] table
    padded past each row's end with +0.0: adding +0.0 leaves a sum that
    starts at +0.0 unchanged bit for bit (it can never be -0.0)."""
    if seg.index is None:
        raise ValueError("the plain ordered sum needs "
                         "make_segments(..., with_index=True)")
    H, N = contrib.shape[0], seg.row_ptr.shape[1] - 1
    padded = torch.cat([contrib, contrib.new_zeros(H, 1)], dim=1)
    rows = torch.gather(padded, 1, seg.index).view(H, seg.max_fan_in, N)
    acc = torch.zeros((H, N), dtype=F32, device=contrib.device)
    for k in range(seg.max_fan_in):
        acc = acc + rows[:, k]
    return acc


def rg_lru_scan(a: torch.Tensor, b: torch.Tensor,
                h0: torch.Tensor) -> torch.Tensor:
    """Plain version of kernels.rg_lru: h_t = a_t * h_{t-1} + b_t.

    a, b [B, T, D] fp32, h0 [B, D] fp32 -> h [B, T, D].  A sequential loop
    over T, a multiply then an add (two roundings, no FMA): what the Pallas
    body (`repro/kernels/rg_lru.py::_kernel`) computes, and what
    `csrc/rg_lru.cu` computes bit for bit.  (The JAX package's CPU oracle
    is an associative scan, equal to this to about 1e-5.)"""
    out = torch.empty_like(a)
    h = h0
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of kernels.flash_attention: q [BH, T, D], k/v [BH, S,
    D] -> o [BH, T, D] in q's dtype.

    Step for step `repro/kernels/ref.py::attention`: fp32 products, the
    scale applied after them, softcap, absolute positions q_pos = i + (S -
    T) and k_pos = j, the causal mask k_pos <= q_pos and the window mask
    k_pos > q_pos - window (one-sided, also when not causal), masked
    scores set to -1e30, a softmax, the product with v, a cast.  The kernel
    agrees with it within 2e-5 (fp32) and one bf16 ulp (bf16): it sums in
    another order, tile by tile, in fp32, and rounds once at the output."""
    t, d = q.shape[1], q.shape[2]
    s_len = k.shape[1]
    scale = (d ** -0.5) if scale is None else scale
    s = torch.einsum("btd,bsd->bts", q.to(F32), k.to(F32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(t, device=q.device)[:, None] + (s_len - t)
    k_pos = torch.arange(s_len, device=q.device)[None, :]
    mask = torch.ones((t, s_len), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = s.masked_fill(~mask[None], -1.0e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bts,bsd->btd", p, v.to(F32)).to(q.dtype)
