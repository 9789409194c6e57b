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
import functools
import inspect
from typing import NamedTuple, Optional

import numpy as np
import torch

F32 = torch.float32


def f32(x: float, device) -> torch.Tensor:
    """A 0-dim float32 constant (Python floats would be doubles)."""
    return torch.tensor(np.float32(x), dtype=F32, device=device)


def _shard_rows(x, lo: int, hi: int, H: int):
    """x's shards [lo, hi): a tensor with a leading [H] axis as a view of
    those rows, a tuple (Segments, coefficients) element by element, any
    other value as it is."""
    if isinstance(x, torch.Tensor):
        return x[lo:hi] if x.dim() and x.shape[0] == H else x
    if isinstance(x, tuple):
        parts = [_shard_rows(y, lo, hi, H) for y in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return x


def _join(parts: list):
    """The per-run results of a shardwise call joined along the shard
    axis (tensors concatenated, tuples element by element)."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts, 0)
    if isinstance(first, tuple):
        joined = [_join(list(p)) for p in zip(*parts)]
        return type(first)(*joined) if hasattr(first, "_fields") \
            else tuple(joined)
    return first


def shardwise_step(fn):
    """Let a plain version take its step `t` as an int or as an int64 [H]
    tensor of per-shard steps (a batch of independent simulations folded
    onto the shard axis, each at its own step, as the kernels' `t_base`
    gives it).  With a tensor, fn runs once for each run of consecutive
    shards that share a step, on views of their rows (every argument whose
    leading axis is the [H] of the first), with that step as an int, and
    with its ring slot `r`, where fn takes one, as step mod D (D the first
    argument's second axis); the results are joined along the shard axis.
    Every shard thus goes through the same operations as it would alone."""
    sig = inspect.signature(fn)
    t_at = list(sig.parameters).index("t")

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        t = args[t_at] if len(args) > t_at else kwargs.get("t")
        if not isinstance(t, torch.Tensor):
            return fn(*args, **kwargs)
        bound = sig.bind(*args, **kwargs)
        first = next(iter(bound.arguments.values()))
        H = first.shape[0]
        if t.dtype != torch.int64 or tuple(t.shape) != (H,):
            raise ValueError(f"{fn.__name__}: per-shard steps must be int64 "
                             f"[{H}], got {t.dtype}{tuple(t.shape)}")
        steps = t.tolist()
        parts, lo = [], 0
        for hi in range(1, H + 1):
            if hi < H and steps[hi] == steps[lo]:
                continue
            sub = {k: _shard_rows(v, lo, hi, H)
                   for k, v in bound.arguments.items()}
            sub["t"] = int(steps[lo])
            if "r" in sub:
                sub["r"] = int(steps[lo]) % first.shape[1]
            parts.append(fn(**sub))
            lo = hi
        return _join(parts)
    return wrapped


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


def stim_current(index: torch.Tensor, amp: torch.Tensor,
                 n_local: int) -> torch.Tensor:
    """[H, n_local] fp32 external current of one step from its (index,
    amp) row of `core.stimulus.stim_inputs` ([H, C*K] each): each neuron's
    amplitudes added in list order from +0.0 (a `scatter_add_` on one CPU
    thread).  Every addend is stim_amplitude or +0.0, so the sum is exact
    in any order (`scatter_add_` may use atomics on the card)."""
    out = torch.zeros(index.shape[0], n_local, dtype=F32,
                      device=index.device)
    return out.scatter_add_(1, index, amp)


def izh_coefficients(exc_mask: torch.Tensor, izh) -> tuple:
    """(a, b, c, d), each [H, N] fp32: the excitatory or inhibitory
    constant of `izh` (a `core.params.IzhikevichParams`) picked by
    exc_mask [H, N], as the phase-A kernel picks it per neuron."""
    dev = exc_mask.device
    return tuple(torch.where(exc_mask, f32(getattr(izh, f"{k}_exc"), dev),
                             f32(getattr(izh, f"{k}_inh"), dev))
                 for k in "abcd")


@shardwise_step
def stdp_phase_a(arr_ring, r: int, seg, syn_valid, syn_tgt, syn_plastic,
                 exc_mask, neuron_valid, stim_idx, stim_amp, v, u,
                 last_post, w, last_arr, t: float, *, izh, stdp,
                 neg_time: float, with_ltp: bool, coeffs=None):
    """Plain version of kernels.stdp.stdp_phase_a: phase A of a step, the
    plain versions in the engine's order.

    `stdp_arrival_current` (pop slot r, LTD, last-arrival refresh, i_syn),
    i_tot = i_syn + `stim_current(stim_idx, stim_amp)`, `izhikevich_update`
    with a, b, c, d = `coeffs` (built once by the caller with
    `izh_coefficients`, or here), spiked &= neuron_valid, and with
    `with_ltp` `stdp_ltp` of the targets that spiked.  `izh` and `stdp` are
    `core.params` IzhikevichParams and StdpParams.  Updates v, u, w,
    last_arr, arr_ring[:, r] and (with LTP) last_post in place; returns
    (spiked [H, N] bool, n_arrived [H], spike count [H])."""
    ltd = dict(a_minus=stdp.a_minus, tau_minus=stdp.tau_minus,
               w_min=stdp.w_min, w_max=stdp.w_max, neg_time=neg_time)
    i_syn, n_arrived = stdp_arrival_current(
        arr_ring, r, seg, syn_valid, syn_tgt, syn_plastic, last_post, w,
        last_arr, t, **ltd)
    i_tot = i_syn + stim_current(stim_idx, stim_amp, v.shape[1])
    a, b, c, d = coeffs if coeffs is not None else izh_coefficients(
        exc_mask, izh)
    v2, u2, spiked = izhikevich_update(v, u, i_tot, a, b, c, d,
                                       v_peak=izh.v_peak, dt=izh.dt,
                                       substeps=izh.v_substeps)
    v.copy_(v2)
    u.copy_(u2)
    spiked = spiked & neuron_valid
    if with_ltp:
        stdp_ltp(spiked, seg.row_ptr, syn_plastic, last_arr, w, last_post,
                 t, a_plus=stdp.a_plus, tau_plus=stdp.tau_plus,
                 w_min=stdp.w_min, w_max=stdp.w_max, neg_time=neg_time)
    return spiked, n_arrived, spiked.sum(1)


@shardwise_step
def arborize(arr_ring, spiked_src, syn_src, syn_delay, syn_valid, t: int):
    """Plain version of kernels.arborize.arborize: phase B, the reference's
    broadcast-compare (`repro.core.engine.phase_b`) with the [H] axis.

    active = spiked_src gathered by syn_src, & syn_valid; slot = (t +
    delay) mod D (floor mod, as `jnp.mod`); the flags of active synapses
    at their slot are ORed into arr_ring [H, D, E] in place.  Returns
    arr_ring."""
    D = arr_ring.shape[1]
    active = torch.gather(spiked_src, 1, syn_src) & syn_valid       # [H, E]
    slot = torch.remainder(syn_delay + t, D)                        # [H, E]
    slots = torch.arange(D, dtype=slot.dtype, device=slot.device)
    hit = active[:, None, :] & (slot[:, None, :] == slots[None, :, None])
    arr_ring |= hit
    return arr_ring


def ordered_sum(index: torch.Tensor, values: torch.Tensor,
                n: int) -> torch.Tensor:
    """[n] fp32: out[j] = ((+0.0 + values[i0]) + values[i1]) + ... over the
    positions i0 < i1 < ... with index[i] == j, in list order, on any
    device.  Each round adds, for every place, its first remaining value
    (the position found by a `scatter_reduce` "amin", which no order
    changes), so a round adds at most once to a place and no two adds
    race; rounds = the most values of one place."""
    out = torch.zeros(n, dtype=F32, device=values.device)
    pos = torch.arange(index.shape[0], device=index.device)
    while pos.numel():
        idx = index[pos]
        first = torch.full((n,), index.shape[0], dtype=torch.int64,
                           device=index.device).scatter_reduce_(
            0, idx, pos, "amin")
        take = first[idx] == pos
        out.index_add_(0, idx[take], values[pos[take]])
        pos = pos[~take]
    return out


@shardwise_step
def event_arrival(ev_ring, ev_count, r: int, syn_tgt, syn_plastic,
                  last_post, w, last_arr, t: int, *, a_minus, tau_minus,
                  w_min, w_max, neg_time):
    """Plain version of kernels.event.event_arrival: the event backend's
    arrivals (`repro.core.event_engine.phase_a_dynamics`, its first half)
    with the [H] axis.

    ev_ring [H, D, cap] int32 synapse ids (-1 pad), ev_count [H, D] int32,
    slot r, the plan's syn_tgt [H, E] int64 and syn_plastic [H, E] bool,
    last_post [H, N] fp32, w / last_arr [H, E] fp32.  Every entry of slot r
    that is >= 0 arrives: each target's current is the sum of its events'
    pre-LTD weights in list order from +0.0 (`ordered_sum`: what XLA-CPU's
    scatter-add computes, walking its updates in order; the reference's
    pads add +0.0 to synapse 0's target, which changes no sum), LTD
    against the target's last spike where the synapse is plastic, and
    last_arr = t.  Updates w, last_arr, ev_ring[:, r] (all -1) and
    ev_count[:, r] (0) in place; returns (i_syn [H, N] fp32, n_arrived [H]
    int64)."""
    H, N = last_post.shape
    tf = f32(t, w.device)
    ev = ev_ring[:, r].to(torch.int64)                           # [H, cap]
    listed = ev >= 0
    h, k = torch.nonzero(listed, as_tuple=True)   # by shard, in list order
    e = ev[h, k]
    w_ev = w[h, e]
    tgt = syn_tgt[h, e]
    i_syn = ordered_sum(h * N + tgt, w_ev, H * N)
    lp = last_post[h, tgt]
    apply = syn_plastic[h, e] & (lp > f32(neg_time / 2, w.device))
    # each synapse is in a slot at most once: no two writes meet
    w[h, e] = _stdp_update(w_ev, apply, lp, tf, a_minus, tau_minus, -1,
                           w_min, w_max)
    last_arr[h, e] = tf
    ev_ring[:, r] = -1
    ev_count[:, r] = 0
    return i_syn.view(H, N), listed.sum(1)


@shardwise_step
def event_compact(spiked, last_post, sat, t: int, *, c_post: int):
    """Plain version of kernels.event.event_compact: the bookkeeping of the
    event backend's LTP (`repro.core.event_engine.phase_a_plasticity`,
    before its LTP) with the [H] axis.

    spiked [H, N] bool, last_post [H, N] fp32, sat [H] int32.  The first
    c_post spiking neurons are listed (`core.aer.compact_indices`: ids
    [H, c_post] int32 ascending, then the fill N), last_post = t where
    spiked (every spiking neuron, listed or not), sat += the spikes past
    c_post; in place.  Returns (count [H] int64, ids)."""
    from ..core.aer import compact_indices
    N = spiked.shape[1]
    ids, dropped = compact_indices(spiked, c_post, fill=N)
    last_post.copy_(torch.where(spiked, f32(t, last_post.device), last_post))
    sat += dropped.to(sat.dtype)
    return spiked.sum(1), ids


@shardwise_step
def event_neurons(i_syn, stim_idx, stim_amp, exc_mask, neuron_valid, v, u,
                  last_post, sat, t: int, *, izh, c_post: Optional[int],
                  coeffs=None):
    """Plain version of kernels.event.event_neurons: the event backend's
    phase A between the arrivals and LTP (`repro.core.event_engine.
    phase_a_dynamics` from the stimulus on, and with c_post the
    bookkeeping of `phase_a_plasticity`) with the [H] axis, as the port
    ran it in PyTorch operations before the kernel.

    i_tot = i_syn + `stim_current(stim_idx, stim_amp)` (the step's row
    [H, C*K]), `izhikevich_update` with a, b, c, d = `coeffs` (built once
    by the caller with `izh_coefficients`, or here) written into v and u,
    spiked = spike & neuron_valid, and with c_post `event_compact`
    (last_post, sat and the list); `izh` is a `core.params.
    IzhikevichParams`.  Returns (spiked [H, N] bool, count [H] int64, ids
    [H, c_post] int32); without c_post ids is empty ([H, 0]) and last_post
    and sat are not touched."""
    H, N = v.shape
    i_tot = i_syn + stim_current(stim_idx, stim_amp, N)
    a, b, c, d = coeffs if coeffs is not None else izh_coefficients(
        exc_mask, izh)
    v2, u2, spiked = izhikevich_update(v, u, i_tot, a, b, c, d,
                                       v_peak=izh.v_peak, dt=izh.dt,
                                       substeps=izh.v_substeps)
    v.copy_(v2)
    u.copy_(u2)
    spiked = spiked & neuron_valid
    if c_post is None:
        return (spiked, spiked.sum(1),
                torch.zeros((H, 0), dtype=torch.int32, device=v.device))
    return (spiked, *event_compact(spiked, last_post, sat, t,
                                   c_post=c_post))


@shardwise_step
def event_ltp(ids, count, row_ptr, syn_plastic, last_arr, w, t: int, *,
              a_plus, tau_plus, w_min, w_max, neg_time) -> None:
    """Plain version of kernels.event.event_ltp: the event backend's LTP
    (`repro.core.event_engine.phase_a_plasticity`'s) with the [H] axis.

    ids [H, C] int32 (the first C spiking neurons ascending, then the fill
    N; `event_compact`), row_ptr [H, N + 1] int32 (the per-target CSR: row
    n is the JAX plan's `in_rows[n]`), syn_plastic [H, E] bool, last_arr /
    w [H, E] fp32: LTP on the rows of the listed neurons, w in place.
    count (`event_compact`'s) is how the kernel finds the list's length;
    the plain version reads the list alone, whose fill N lists nothing."""
    H, N = row_ptr.shape[0], row_ptr.shape[1] - 1
    listed = torch.zeros((H, N + 1), dtype=torch.bool, device=w.device)
    listed.scatter_(1, ids.to(torch.int64), True)
    row = rows_of_synapses(row_ptr, w.shape[1])
    post = listed.gather(1, row)          # column N: pads and the fill
    w.copy_(_ltp(post, w, last_arr, syn_plastic, row < N, f32(t, w.device),
                 a_plus=a_plus, tau_plus=tau_plus, w_min=w_min, w_max=w_max,
                 neg_time=neg_time))


@shardwise_step
def event_emit(src_ids, n_dropped, fwd_rows, syn_delay, ev_ring, ev_count,
               sat, t: int) -> None:
    """Plain version of kernels.event.event_emit: the event backend's phase
    B (`repro.core.event_engine.phase_b`) with the [H] axis, literally.

    src_ids [H, C] int32, the first C spiking sources ascending and then
    the fill S (`core.aer.compact_indices(spiked_src, C, fill=S)`),
    n_dropped [H] int32 its overflow, fwd_rows [H, S, Kf] int32 (-1 pad),
    the plan's syn_delay [H, E] int32, ev_ring [H, D, cap] int32, ev_count
    [H, D] int32, sat [H] int32.  The listed sources' rows, flattened in
    (source rank, row position) order, go to slot (t + delay) mod D (floor
    mod), each after the slot's events so far (a cumsum over the [D, L]
    one-hot by slot); events past cap are dropped and counted.  Updates
    ev_ring, ev_count and sat in place."""
    H, D, cap = ev_ring.shape
    S = fwd_rows.shape[1]
    dev = ev_ring.device
    src = src_ids.to(torch.int64)
    rows = torch.gather(fwd_rows, 1, torch.clamp(src, max=S - 1)[:, :, None]
                        .expand(-1, -1, fwd_rows.shape[2]))     # [H, C, Kf]
    ids = torch.where((src < S)[:, :, None], rows, -1).reshape(H, -1)
    valid = ids >= 0
    idc = torch.clamp(ids, min=0).to(torch.int64)
    slot = torch.remainder(torch.gather(syn_delay, 1, idc) + t,
                           D).to(torch.int64)                   # [H, L]
    onehot = valid[:, None, :] & (
        slot[:, None, :] == torch.arange(D, device=dev)[None, :, None])
    ranks = torch.cumsum(onehot, 2) - 1                          # [H, D, L]
    rank = torch.gather(ranks, 1, slot[:, None, :])[:, 0]        # [H, L]
    per_slot = onehot.sum(2, dtype=torch.int32)                  # [H, D]
    pos = torch.gather(ev_count, 1, slot).to(torch.int64) + rank
    ok = valid & (pos < cap)
    flat = torch.where(ok, slot * cap + pos, D * cap)            # spare slot
    ring = torch.cat([ev_ring.reshape(H, -1),
                      ev_ring.new_full((H, 1), -1)], 1)
    ring.scatter_(1, flat, ids)
    ev_ring.copy_(ring[:, :D * cap].view(H, D, cap))
    total = ev_count + per_slot
    overflow = torch.clamp(total - cap, min=0).sum(1, dtype=torch.int32)
    ev_count.copy_(torch.clamp(total, max=cap))
    sat += (n_dropped + overflow).to(sat.dtype)


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


# ----------------------------------------------------------------------------
# streamed connectivity: chunk regeneration and the chunk-window passes
# ----------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


class ChunkGeometry(NamedTuple):
    """The host integers of chunk regeneration (`core.stream_engine`)."""
    M: int                    # synapses a source
    npc: int                  # neurons a column
    nexc: int                 # excitatory neurons a column
    gx: int
    gy: int
    n_neurons: int
    delay_min: int
    dspan: int                # delay_max - delay_min + 1
    q: int                    # owned-neuron slots a chunk
    n_chunks: int
    c_cap: int                # candidate sources a chunk (padded)
    scatter: bool             # placement: scatter (else block)
    lanes: tuple              # the four draw lanes' seeds (uint64 ints)
    row_cap: int              # the longest target row of any chunk
    n_shards: int             # the plan's shards (scatter's modulus)


class ChunkSource(NamedTuple):
    """What regenerates a chunk's tables, on one device.  src_gid [H, S]
    int64 (the plan's source table, -1 pad), cand [H, n_chunks, c_cap]
    int32 (each chunk's candidate rows of src_gid, ascending, -1 pad),
    e_start [H, n_chunks + 1] int32 (each chunk's first state position),
    the profile's ring offsets off [K, 2] int32, ring starts start [R + 2]
    int32 and thresholds thresh [R + 1] int64 (U[k] = ceil(fr[k] * 2^53):
    the ring is the number of k with bits53 >= U[k]), the block bounds
    bounds [H + 1] int64 (unused under scatter), the kernel's modulus
    constants fastmod [4 + R + 1, 3] int64 (`fastmod_table` of npc, nexc,
    dspan, H and each ring's size; the plain version takes remainders
    with `%`), and the geometry."""
    src_gid: torch.Tensor
    cand: torch.Tensor
    e_start: torch.Tensor
    off: torch.Tensor
    start: torch.Tensor
    thresh: torch.Tensor
    bounds: torch.Tensor
    fastmod: torch.Tensor
    shard_id: torch.Tensor
    geom: ChunkGeometry


class ChunkTables(NamedTuple):
    """One regenerated chunk of every shard, canonical (tgt, src, j) order.

    row_ptr [H, q + 1] int32: row k (local target c*q + k) of shard h is
    the state positions [row_ptr[h, k], row_ptr[h, k + 1]), so row_ptr[h,
    0] is the chunk's e_start; entry i of src / delay / plastic [H, K]
    (int32 src-table row, int32 delay, bool) is the synapse at position
    row_ptr[h, 0] + i, for i below the chunk's kept count row_ptr[h, q] -
    row_ptr[h, 0] (<= K); entries past it are unspecified."""
    row_ptr: torch.Tensor
    src: torch.Tensor
    delay: torch.Tensor
    plastic: torch.Tensor


def _lo_mul32(a, b):
    """The low 32 bits of a * b, for a, b in [0, 2^32) held in int64 (16-bit
    halves: no product leaves int64)."""
    a0, a1 = a & _M16, a >> 16
    b0, b1 = b & _M16, b >> 16
    return (a0 * b0 + (((a0 * b1 + a1 * b0) & _M16) << 16)) & _M32


def _mul32(a, b):
    """The full 64-bit product of two 32-bit limbs as (hi, lo) limbs."""
    a0, a1 = a & _M16, a >> 16
    b0, b1 = b & _M16, b >> 16
    t00, t01, t10 = a0 * b0, a0 * b1, a1 * b0
    mid = (t00 >> 16) + (t01 & _M16) + (t10 & _M16)
    lo = (t00 & _M16) | ((mid & _M16) << 16)
    hi = a1 * b1 + (mid >> 16) + (t01 >> 16) + (t10 >> 16)
    return hi & _M32, lo


def _add64(ah, al, bh, bl):
    lo = al + bl
    return (ah + bh + (lo >> 32)) & _M32, lo & _M32


def _shr64(h, l, k: int):
    """(h, l) >> k for 0 < k < 32; every limb is non-negative, so int64's
    arithmetic shift is the logical one."""
    return h >> k, ((l >> k) | (h << (32 - k))) & _M32


def _mul64(ah, al, bh, bl):
    """The low 64 bits of the product (wrapping, as uint64)."""
    hi, lo = _mul32(al, bl)
    return (hi + _lo_mul32(al, bh) + _lo_mul32(ah, bl)) & _M32, lo


def _c64(x: int):
    return x >> 32, x & _M32


def splitmix64_limbs(h, l):
    """splitmix64 (`core.connectivity.splitmix64`) on 32-bit limbs held in
    int64 tensors: the JAX package's uint32-limb scheme, for a torch that
    has no uint64 arithmetic."""
    h, l = _add64(h, l, *_c64(0x9E3779B97F4A7C15))
    xh, xl = _shr64(h, l, 30)
    h, l = _mul64(h ^ xh, l ^ xl, *_c64(0xBF58476D1CE4E5B9))
    xh, xl = _shr64(h, l, 27)
    h, l = _mul64(h ^ xh, l ^ xl, *_c64(0x94D049BB133111EB))
    xh, xl = _shr64(h, l, 31)
    return h ^ xh, l ^ xl


def _mod64(h, l, m):
    """(h * 2^32 + l) mod m for 0 < m < 2^16 (a tensor or an int)."""
    r32 = (1 << 32) % m
    return ((h % m) * r32 + l % m) % m


_M64 = (1 << 64) - 1


def fastmod_constants(m: int) -> tuple:
    """(2^32 mod m, c) for 0 < m < 2^16, c = ceil(2^64 / m) mod 2^64 (0 at
    m = 1): the constants of Lemire's exact 32-bit remainder and quotient
    (`fastmod_u32`, `fastdiv_u32`), which `csrc/stream.cu` takes from the
    host instead of dividing."""
    if not 0 < m < (1 << 16):
        raise ValueError(f"modulus {m} outside (0, 2^16)")
    return (1 << 32) % m, (_M64 // m + 1) & _M64


def fastmod_table(moduli) -> np.ndarray:
    """[n, 3] int64 rows (m, 2^32 mod m, c as int64 bits) of each modulus."""
    rows = []
    for m in moduli:
        r32, c = fastmod_constants(int(m))
        rows.append((int(m), r32, c - (1 << 64) if c >> 63 else c))
    return np.asarray(rows, dtype=np.int64).reshape(-1, 3)


def _mulhi_u32(x: np.ndarray, y) -> np.ndarray:
    """The high 64 bits of x * y for uint64 x and y < 2^32 (uint64)."""
    y = np.uint64(y) if np.isscalar(y) else y
    return ((x >> np.uint64(32)) * y
            + (((x & np.uint64(_M32)) * y) >> np.uint64(32))) >> np.uint64(32)


def fastmod_u32(a: np.ndarray, m: int, c: int) -> np.ndarray:
    """a mod m for uint64 a < 2^32: (c * a mod 2^64) * m >> 64, as the
    kernel's `fm_mod`."""
    with np.errstate(over="ignore"):
        return _mulhi_u32(np.uint64(c) * a, m)


def fastdiv_u32(a: np.ndarray, c: int) -> np.ndarray:
    """a // m for uint64 a < 2^32: c * a >> 64, a itself at m = 1 (c = 0),
    as the kernel's `fm_div`."""
    return _mulhi_u32(np.full_like(a, c), a) if c else a.copy()


def fastmod64(x: np.ndarray, m: int, r32: int, c: int) -> np.ndarray:
    """x mod m for uint64 x, m < 2^16, as the kernel's `fm_mod64`."""
    hi = fastmod_u32(x >> np.uint64(32), m, c)
    lo = fastmod_u32(x & np.uint64(_M32), m, c)
    return fastmod_u32(hi * np.uint64(r32) + lo, m, c)


def _chunk_slots(source: ChunkSource, c: int) -> dict:
    """Every generation slot of chunk c, [H, c_cap, M] (candidate-major):
    the draws of `core.connectivity.forward_synapses` (lanes 0-3 at counter
    g * M + j, splitmix64 on limbs) and the reference's ownership and range
    test.  Keys: cvalid, sidx, g [H, c_cap]; exc [H, c_cap, 1]; ring, tcol,
    tgt, delay, tloc, keep (bool) [H, c_cap, M]; jj [M]."""
    g_ = source.geom
    dev = source.cand.device
    i64 = torch.int64
    H = source.cand.shape[0]
    cand = source.cand[:, c].to(i64)                          # [H, c_cap]
    cvalid = cand >= 0
    sidx = torch.where(cvalid, cand, 0)
    g = torch.where(cvalid, torch.gather(source.src_gid, 1, sidx), 0)
    jj = torch.arange(g_.M, dtype=i64, device=dev)
    counter = g[:, :, None] * g_.M + jj                      # [H, c_cap, M]
    ch, cl = counter >> 32, counter & _M32

    def draw(lane):
        sh, sl = _c64(g_.lanes[lane])
        return splitmix64_limbs(ch ^ sh, cl ^ sl)

    b0h, b0l = draw(0)
    bits53 = (b0h << 21) | (b0l >> 11)
    ring = (bits53[..., None] >= source.thresh).sum(-1)
    reach = source.start.shape[0] - 2
    ring = torch.clamp(ring, 0, reach)
    start = source.start.to(i64)
    rsize = start[ring + 1] - start[ring]
    member = _mod64(*draw(1), rsize)
    off = source.off.to(i64)[start[ring] + member]           # [.., 2]
    col = torch.div(g, g_.npc, rounding_mode="floor")[:, :, None]
    cx, cy = col % g_.gx, torch.div(col, g_.gx, rounding_mode="floor")
    tcol = (torch.remainder(cy + off[..., 1], g_.gy) * g_.gx
            + torch.remainder(cx + off[..., 0], g_.gx))
    b2h, b2l = draw(2)
    tgt_exc = tcol * g_.npc + _mod64(b2h, b2l, g_.npc)
    tgt_inh = col * g_.npc + _mod64(b2h, b2l, g_.nexc)
    exc = (g % g_.npc < g_.nexc)[:, :, None]
    tgt = torch.where(exc, tgt_exc, tgt_inh)
    delay = torch.where(exc, g_.delay_min + _mod64(*draw(3), g_.dspan),
                        g_.delay_min)
    # ownership (engine.make_gid_to_local) and the chunk's range
    if g_.scatter:
        hh = source.shard_id.view(H, 1, 1)
        owned = ((tgt % g_.n_shards == hh) & (tgt >= 0)
                 & (tgt < g_.n_neurons))
        tloc = torch.div(tgt, g_.n_shards, rounding_mode="floor")
    else:
        lo_b = source.bounds[:-1].view(H, 1, 1)
        owned = (tgt >= lo_b) & (tgt < source.bounds[1:].view(H, 1, 1))
        tloc = tgt - lo_b
    lo = c * g_.q
    keep = cvalid[:, :, None] & owned & (tloc >= lo) & (tloc < lo + g_.q)
    return dict(cvalid=cvalid, sidx=sidx, g=g, exc=exc, ring=ring,
                tcol=torch.where(exc, tcol, col), tgt=tgt, delay=delay,
                tloc=tloc, keep=keep, jj=jj)


def chunk_tables(source: ChunkSource, c: int, k: int, *,
                 with_j: bool = False):
    """Plain version of kernels.stream.chunk_tables: chunk c of every
    shard regenerated from the draw lanes, K = k entries a shard ->
    ChunkTables (entries past a shard's kept count 0), and with `with_j`
    also j [H, K] int32 (each entry's forward slot).

    Each candidate source g of the chunk draws lanes 0-3 at counter g * M
    + j (splitmix64 on limbs): the ring by integer threshold, the member
    of the ring, the target neuron and the delay, exactly as
    `core.connectivity.forward_synapses`; the synapses whose target the
    shard owns at a local index in [c*q, c*q + q) are kept, in generation
    order (source ascending, then j), and stably sorted by target.  Raises
    ValueError where a shard's kept count is not its e_start difference
    or exceeds K, or a row is longer than the geometry's row_cap."""
    g_ = source.geom
    dev = source.cand.device
    i64 = torch.int64
    H = source.cand.shape[0]
    sl = _chunk_slots(source, c)
    keep = sl["keep"].reshape(H, -1)
    lo = c * g_.q
    rel = torch.where(keep, sl["tloc"].reshape(H, -1) - lo, g_.q)
    _, order = torch.sort(rel, dim=1, stable=True)
    kept = keep.sum(1)
    want = (source.e_start[:, c + 1] - source.e_start[:, c]).to(i64)
    if not torch.equal(kept, want) or int(kept.max()) > k:
        raise ValueError(f"chunk {c}: kept {kept.tolist()} synapses, the "
                         f"plan says {want.tolist()} (at most {k})")
    order = order[:, :k] if order.shape[1] >= k else torch.cat(
        [order, order.new_zeros(H, k - order.shape[1])], 1)
    live = torch.arange(k, device=dev)[None, :] < kept[:, None]
    take = lambda x: torch.where(live, torch.gather(
        x.expand(H, g_.c_cap, g_.M).reshape(H, -1), 1, order), 0)
    counts = torch.zeros((H, g_.q + 1), dtype=i64, device=dev)
    counts.scatter_add_(1, rel, torch.ones_like(rel))
    longest = int(counts[:, :g_.q].max())
    if longest > g_.row_cap:
        raise ValueError(f"chunk {c}: a row of {longest} synapses, the plan "
                         f"says at most {g_.row_cap}")
    row_ptr = (source.e_start[:, c:c + 1].to(i64) + torch.cat(
        [counts.new_zeros(H, 1), counts[:, :g_.q].cumsum(1)], 1))
    tables = ChunkTables(
        row_ptr=row_ptr.to(torch.int32),
        src=take(sl["sidx"][:, :, None]).to(torch.int32),
        delay=take(sl["delay"]).to(torch.int32),
        plastic=take(sl["exc"].to(i64)).to(torch.bool))
    if not with_j:
        return tables
    return tables, take(sl["jj"].view(1, 1, -1)).to(torch.int32)


class Prefilter(NamedTuple):
    """The draw order of `csrc/stream.cu`, slot by slot ([H, c_cap, M]
    bool): the slots still possible after lane 0 (an excitatory slot
    whose ring can reach the chunk's columns; every slot of an inhibitory
    candidate whose own column is among them), after lane 1 (the target
    column among them), and the slots the reference keeps."""
    lane0: torch.Tensor
    lane1: torch.Tensor
    keep: torch.Tensor


def chunk_columns(source: ChunkSource, c: int) -> tuple:
    """(lo, hi) [H] int64: the column interval holding every target of
    chunk c of each shard, as the kernel finds it (hi < lo: no target)."""
    g_ = source.geom
    h = source.shard_id
    first = c * g_.q
    if g_.scatter:
        gid_lo = h + g_.n_shards * first
        gid_hi = torch.clamp(h + g_.n_shards * (first + g_.q - 1),
                             max=g_.n_neurons - 1)
    else:
        gid_lo = source.bounds[:-1] + first
        gid_hi = torch.minimum(gid_lo + g_.q, source.bounds[1:]) - 1
    empty = gid_hi < gid_lo
    lo = torch.where(empty, 1, torch.div(gid_lo, g_.npc,
                                         rounding_mode="floor"))
    hi = torch.where(empty, 0, torch.div(gid_hi, g_.npc,
                                         rounding_mode="floor"))
    return lo, hi


def chunk_prefilter(source: ChunkSource, c: int) -> Prefilter:
    """The kernel's ring and column prefilter on chunk c, a plain model:
    each candidate's ring set (the rings with an offset whose wrapped
    target column lies in `chunk_columns`; every ring where the profile
    has 64 or more), then lane 0 (the ring in the set) and lane 1 (the
    column in the interval).  Only necessary conditions: every kept slot
    passes both."""
    g_ = source.geom
    sl = _chunk_slots(source, c)
    lo, hi = (x.view(-1, 1, 1) for x in chunk_columns(source, c))
    col = torch.div(sl["g"], g_.npc, rounding_mode="floor")[:, :, None]
    cx, cy = col % g_.gx, torch.div(col, g_.gx, rounding_mode="floor")
    off = source.off.to(torch.int64)
    tc = (torch.remainder(cy + off[:, 1], g_.gy) * g_.gx
          + torch.remainder(cx + off[:, 0], g_.gx))     # [H, c_cap, n_off]
    hit = (tc >= lo) & (tc <= hi)
    start = source.start.tolist()
    reach = len(start) - 2
    rings = torch.stack([hit[..., start[r]:start[r + 1]].any(-1)
                         for r in range(reach + 1)], -1)
    if reach >= 64:
        rings = torch.ones_like(rings)
    exc = sl["exc"]
    in_cols = (col >= lo) & (col <= hi)
    lane0 = sl["cvalid"][:, :, None] & torch.where(
        exc, torch.gather(rings, 2, sl["ring"]), in_cols)
    lane1 = lane0 & (sl["tcol"] >= lo) & (sl["tcol"] <= hi)
    return Prefilter(lane0=lane0, lane1=lane1, keep=sl["keep"])


class _Window(NamedTuple):
    """A chunk's state positions: pos [H, K] (clamped into [0, E)), valid
    [H, K] (below the kept count), rows [lo, hi), the window's local CSR
    lrp [H, hi - lo + 1] and each entry's local row [H, K] (hi - lo past
    the kept count)."""
    pos: torch.Tensor
    valid: torch.Tensor
    lo: int
    hi: int
    lrp: torch.Tensor
    row: torch.Tensor


def _window(tables: ChunkTables, lo: int, N: int, E: int) -> _Window:
    rp = tables.row_ptr.to(torch.int64)
    K = tables.src.shape[1]
    hi = min(lo + rp.shape[1] - 1, N)
    e0 = rp[:, :1]
    lrp = rp[:, :hi - lo + 1] - e0
    k = torch.arange(K, device=rp.device)[None, :]
    valid = k < rp[:, -1:] - e0
    pos = torch.clamp(e0 + k, max=E - 1)
    return _Window(pos, valid, lo, hi, lrp, rows_of_synapses(lrp, K))


def _put(dst: torch.Tensor, win: _Window, values: torch.Tensor) -> None:
    """dst[h, pos] = values where valid (dst [H, E])."""
    h, i = torch.nonzero(win.valid, as_tuple=True)
    dst[h, win.pos[h, i]] = values[h, i]


def _by_row(x: torch.Tensor, win: _Window) -> torch.Tensor:
    """x[h, row] of each entry (x [H, hi - lo], the window's rows; 0 or
    False past the kept count)."""
    return torch.cat([x, x.new_zeros(x.shape[0], 1)], 1).gather(1, win.row)


def _ltp_window(spk, win, tables, last_arr, w, last_post, tf, *, a_plus,
                tau_plus, w_min, w_max, neg_time) -> None:
    """LTP on the window's rows that spiked (spk [H, hi - lo]), in place."""
    w_win = w.gather(1, win.pos)
    w_new = _ltp(_by_row(spk, win), w_win,
                 last_arr.gather(1, win.pos), tables.plastic, win.valid, tf,
                 a_plus=a_plus, tau_plus=tau_plus, w_min=w_min, w_max=w_max,
                 neg_time=neg_time)
    _put(w, win, w_new)
    part = last_post[:, win.lo:win.hi]
    part.copy_(torch.where(spk, tf, part))


def stdp_phase_a_chunk(arr_ring, r: int, tables: ChunkTables, lo: int,
                       exc_mask, neuron_valid, stim_idx, stim_amp, v, u,
                       last_post, w, last_arr, t: int, spiked, counts, *,
                       accumulate: bool, izh, stdp, neg_time: float,
                       with_ltp: bool, coeffs=None) -> None:
    """Plain version of kernels.stdp.stdp_phase_a_chunk: `stdp_phase_a` on
    the rows [lo, min(lo + q, N)) of one regenerated chunk (`tables`), its
    synapses at the state positions of their CSR rows.

    Pops slot r at the chunk's synapses (LTD, last-arrival refresh, each
    row's in-order current), adds the rows' stimulus, updates their
    neurons, masks the spikes by neuron_valid, and with `with_ltp` applies
    LTP to the rows that spiked.  Writes v, u, w, last_arr, arr_ring[:, r]
    (cleared at the chunk's synapses), last_post (with LTP) and spiked
    [H, N] at those rows and synapses only; counts [2, H] int64 (arrivals,
    spikes) gets the chunk's counts, added to it with `accumulate`."""
    H, D, E = arr_ring.shape
    N = v.shape[1]
    win = _window(tables, lo, N, E)
    tf = f32(t, w.device)
    arr = arr_ring[:, r].gather(1, win.pos) & win.valid
    lp = _by_row(last_post[:, lo:win.hi], win)
    w_win, la_win = w.gather(1, win.pos), last_arr.gather(1, win.pos)
    w_new, la_new, contrib = _arrival(
        arr, w_win, lp, la_win, tables.plastic & win.valid, tf,
        a_minus=stdp.a_minus, tau_minus=stdp.tau_minus, w_min=stdp.w_min,
        w_max=stdp.w_max, neg_time=neg_time)
    _put(w, win, w_new)
    _put(last_arr, win, la_new)
    h, i = torch.nonzero(win.valid, as_tuple=True)
    arr_ring[h, r, win.pos[h, i]] = False
    i_syn = segment_sum_ordered(contrib, make_segments(
        win.lrp.to(torch.int32), contrib.shape[1]))
    rows = slice(lo, win.hi)
    i_tot = i_syn + stim_current(stim_idx, stim_amp, N)[:, rows]
    a, b, c, d = (x[:, rows] for x in (coeffs if coeffs is not None
                                       else izh_coefficients(exc_mask, izh)))
    v2, u2, spk = izhikevich_update(v[:, rows], u[:, rows], i_tot, a, b, c,
                                    d, v_peak=izh.v_peak, dt=izh.dt,
                                    substeps=izh.v_substeps)
    v[:, rows] = v2
    u[:, rows] = u2
    spk = spk & neuron_valid[:, rows]
    spiked[:, rows] = spk
    if with_ltp:
        _ltp_window(spk, win, tables, last_arr, w, last_post, tf,
                    a_plus=stdp.a_plus, tau_plus=stdp.tau_plus,
                    w_min=stdp.w_min, w_max=stdp.w_max, neg_time=neg_time)
    new = torch.stack([arr.sum(1), spk.sum(1)])
    if accumulate:
        counts += new
    else:
        counts.copy_(new)


def stdp_ltp_chunk(spiked, tables: ChunkTables, lo: int, last_arr, w,
                   last_post, t: int, *, a_plus, tau_plus, w_min, w_max,
                   neg_time) -> None:
    """Plain version of kernels.stdp.stdp_ltp_chunk: `stdp_ltp` on the rows
    [lo, min(lo + q, N)) of one regenerated chunk; w and last_post (= t
    where spiked) in place at those rows' synapses and neurons."""
    N = spiked.shape[1]
    win = _window(tables, lo, N, w.shape[1])
    _ltp_window(spiked[:, lo:win.hi], win, tables, last_arr, w, last_post,
                f32(t, w.device), a_plus=a_plus, tau_plus=tau_plus,
                w_min=w_min, w_max=w_max, neg_time=neg_time)


def arborize_chunk(arr_ring, spiked_src, tables: ChunkTables,
                   t: int) -> None:
    """Plain version of kernels.arborize.arborize_chunk: phase B on one
    regenerated chunk.  For each of the chunk's synapses whose source
    (its src-table row, in spiked_src [H, S]) spiked, the flag at slot
    (t + delay) mod D (floor mod) of its state position is set in place."""
    H, D, E = arr_ring.shape
    win = _window(tables, 0, tables.row_ptr.shape[1] - 1, E)
    active = (torch.gather(spiked_src, 1, tables.src.to(torch.int64))
              & win.valid)
    slot = torch.remainder(tables.delay.to(torch.int64) + t, D)
    h, i = torch.nonzero(active, as_tuple=True)
    arr_ring[h, slot[h, i], win.pos[h, i]] = True


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
