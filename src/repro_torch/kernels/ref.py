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
