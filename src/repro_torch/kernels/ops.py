"""Public kernel entry points: dispatch on the tensor's device.

A CPU tensor goes to the plain PyTorch version (`kernels.ref`), run with
fp32 denormals flushed as XLA-CPU does.  A CUDA tensor goes to the
hand-written kernel, which launches or raises: no CUDA tensor ever falls
back to the plain version, and any other device raises.

Each wrapper counts its kernel's launches in one registry
(`_build.counted`); `launch_counts` reads it and `reset_launch_counts`
sets it to 0, so a run can show that it went through the kernels.
"""
from __future__ import annotations

import torch

from . import _build
from . import arborize as _arb
from . import event as _ev
from . import flash_attention as _fa
from . import izhikevich as _izh
from . import ref
from . import rg_lru as _rg
from . import segment_sum as _seg
from . import stdp as _stdp
from . import stream as _stream

#: The kernels of the DPSNN-STDP step, of the LM's RG-LRU layers, and of
#: the `attention` entry point (which no model of the port calls).  The
#: main path runs phase A as one kernel (`stdp_phase_a`) and phase B as
#: another (`arborize`, source-major over the plan's forward CSR), each
#: once a step.  The three kernels that `stdp_phase_a` replaced stay off
#: the main path (`PHASE_A_KERNELS`), as its yardstick and for the paths
#: that split phase A; so do the pair that `stdp_arrival_current`
#: replaced (`PAIR_KERNELS`) and the element-major phase B that
#: `arborize` replaced (`PHASE_B_KERNELS`), as their yardsticks.
#: The event backend (`core.event_engine`) runs its own four ops each
#: step (`EVENT_KERNELS`): the arrivals, the neurons with the spike list,
#: LTP and the emission; the split schedule lists the spikes apart
#: (`EVENT_SPLIT_KERNELS`), and the LTP kernel `event_ltp` replaced stays
#: as its yardstick (`EVENT_YARDSTICKS`; `izhikevich_update` is the
#: neuron pass's).  Streamed connectivity (`core.stream_engine`) runs, for
#: each chunk of each step, `chunk_tables` then the phase-A row kernel on
#: the chunk's rows, and `chunk_tables` then phase B's element walk on its
#: synapses (`STREAM_KERNELS`); its split schedule runs LTP chunk by chunk
#: (`STREAM_SPLIT_KERNELS`).
SNN_KERNELS = ("stdp_phase_a", "arborize")
STREAM_KERNELS = ("chunk_tables", "stdp_phase_a_chunk", "arborize_chunk")
STREAM_SPLIT_KERNELS = ("stdp_ltp_chunk",)
PHASE_A_KERNELS = ("izhikevich_update", "stdp_arrival_current", "stdp_ltp")
PAIR_KERNELS = ("stdp_arrival", "segment_sum_ordered")
PHASE_B_KERNELS = ("arborize_elements",)
EVENT_KERNELS = ("event_arrival", "event_neurons", "event_ltp", "event_emit")
EVENT_SPLIT_KERNELS = ("event_compact",)
EVENT_YARDSTICKS = ("event_ltp_rows",)
LM_KERNELS = ("rg_lru_scan",)
ATTN_KERNELS = ("flash_attention",)
KERNELS = (SNN_KERNELS + PHASE_A_KERNELS + PAIR_KERNELS + PHASE_B_KERNELS
           + EVENT_KERNELS + EVENT_SPLIT_KERNELS + EVENT_YARDSTICKS
           + STREAM_KERNELS + STREAM_SPLIT_KERNELS + LM_KERNELS
           + ATTN_KERNELS)


def _route(x: torch.Tensor, name: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {x.device}")


def izhikevich_update(v, u, current, a, b, c, d, *, v_peak, dt=1.0,
                      substeps=2):
    """[N] fp32 tensors -> (v', u', spiked)."""
    kw = dict(v_peak=v_peak, dt=dt, substeps=substeps)
    if _route(v, "izhikevich_update"):
        return _izh.izhikevich_update(v, u, current, a, b, c, d, **kw)
    with ref.flush_denormal():
        return ref.izhikevich_update(v, u, current, a, b, c, d, **kw)


def _plain_step(t, name: str, t_base=None):
    """A plain version's step: an int (the device step counter is the
    kernels' alone), or with per-shard step offsets t_base (int64 [H] on
    the CPU) the int64 [H] tensor t + t_base (`ref.shardwise_step`)."""
    if isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: the plain version takes the step as an "
                        f"int, not a step counter")
    if t_base is None:
        return t
    if (not isinstance(t_base, torch.Tensor) or t_base.device.type != "cpu"
            or t_base.dtype != torch.int64 or t_base.dim() != 1):
        raise ValueError(f"{name}: t_base must be an int64 [H] tensor on "
                         f"the CPU for the plain version")
    return t_base + int(t)


def stdp_phase_a(arr_ring, r, seg: ref.Segments, syn_valid, syn_tgt,
                 syn_plastic, exc_mask, neuron_valid, stim_idx, stim_amp, v,
                 u, last_post, w, last_arr, t, *, izh, stdp, neg_time,
                 with_ltp, coeffs=None, t_base=None):
    """Phase A of a step: pop ring slot r (LTD, last-arrival refresh, each
    target's in-order current), add the step's stimulus (its (index, amp)
    row [H, C*K]), update the Izhikevich neurons with a, b, c, d picked by
    exc_mask from `izh`, mask the spikes by neuron_valid and, with
    `with_ltp`, apply LTP to the targets that spiked and set their
    last_post to t.  Updates v, u, w, last_arr, arr_ring[:, r] and
    last_post in place -> (spiked [H, N], n_arrived [H], spike count [H]).

    `coeffs`, the plain version's (a, b, c, d) built once by the caller
    (`ref.izh_coefficients`), is used on the CPU only: the kernel takes the
    constants as launch arguments (`kernels.stdp.stdp_phase_a`).  On the
    card `t` may be the device step counter, with r None and the stimulus
    a window [W, H, C*K] read at the counter's row.

    `t_base` (None, or int64 [H] on the tensors' device) gives each shard
    its own step, t + t_base[h] (a batch of simulations folded onto the
    shard axis); r is then each shard's own slot."""
    kw = dict(izh=izh, stdp=stdp, neg_time=neg_time, with_ltp=with_ltp)
    if _route(w, "stdp_phase_a"):
        return _stdp.stdp_phase_a(arr_ring, r, seg, syn_plastic, exc_mask,
                                  neuron_valid, stim_idx, stim_amp, v, u,
                                  last_post, w, last_arr, t, t_base=t_base,
                                  **kw)
    with ref.flush_denormal():
        return ref.stdp_phase_a(arr_ring, r, seg, syn_valid, syn_tgt,
                                syn_plastic, exc_mask, neuron_valid,
                                stim_idx, stim_amp, v, u, last_post, w,
                                last_arr,
                                _plain_step(t, "stdp_phase_a", t_base),
                                coeffs=coeffs, **kw)


def stdp_arrival_current(arr_ring, r, seg: ref.Segments, syn_valid,
                         syn_tgt, syn_plastic, last_post, w, last_arr, t, *,
                         a_minus, tau_minus, w_min, w_max, neg_time):
    """Pop ring slot r and sum the current: LTD and last-arrival refresh of
    the synapses that arrive at step t, and each target's in-order sum of
    their pre-LTD weights.  arr_ring [H, D, E], `seg` over the plan's CSR
    `row_ptr` [H, N + 1] (with its index on the CPU), the plan's [H, E]
    synapse arrays, last_post [H, N], w / last_arr [H, E] -> (i_syn [H, N],
    n_arrived [H]); updates w, last_arr and arr_ring[:, r] in place.  The
    kernel reads the targets off `seg.row_ptr` and never syn_valid or
    syn_tgt (`kernels.stdp.stdp_arrival_current`)."""
    kw = dict(a_minus=a_minus, tau_minus=tau_minus, w_min=w_min,
              w_max=w_max, neg_time=neg_time)
    if _route(w, "stdp_arrival_current"):
        return _stdp.stdp_arrival_current(arr_ring, r, seg, syn_plastic,
                                          last_post, w, last_arr, t, **kw)
    with ref.flush_denormal():
        return ref.stdp_arrival_current(arr_ring, r, seg, syn_valid, syn_tgt,
                                        syn_plastic, last_post, w, last_arr,
                                        t, **kw)


def stdp_arrival(arr_ring, r, syn_valid, syn_tgt, syn_plastic, last_post,
                 w, last_arr, t, *, a_minus, tau_minus, w_min, w_max,
                 neg_time):
    """Pop ring slot r: LTD, last-arrival refresh and current contributions
    of the synapses that arrive at step t.  arr_ring [H, D, E], the plan's
    [H, E] synapse arrays, last_post [H, N], w / last_arr [H, E] ->
    (contrib [H, E], n_arrived [H]); updates w, last_arr and arr_ring[:, r]
    in place (`kernels.stdp.stdp_arrival`)."""
    args = (arr_ring, r, syn_valid, syn_tgt, syn_plastic, last_post, w,
            last_arr, t)
    kw = dict(a_minus=a_minus, tau_minus=tau_minus, w_min=w_min,
              w_max=w_max, neg_time=neg_time)
    if _route(w, "stdp_arrival"):
        return _stdp.stdp_arrival(*args, **kw)
    with ref.flush_denormal():
        return ref.stdp_arrival(*args, **kw)


def stdp_ltp(spiked, row_ptr, syn_plastic, last_arr, w, last_post, t, *,
             a_plus, tau_plus, w_min, w_max, neg_time) -> None:
    """LTP on the incoming synapses of the targets that spiked at step t,
    through the per-target CSR row_ptr [H, N + 1]; updates w [H, E] and
    last_post [H, N] in place (`kernels.stdp.stdp_ltp`)."""
    args = (spiked, row_ptr, syn_plastic, last_arr, w, last_post, t)
    kw = dict(a_plus=a_plus, tau_plus=tau_plus, w_min=w_min, w_max=w_max,
              neg_time=neg_time)
    if _route(w, "stdp_ltp"):
        return _stdp.stdp_ltp(*args, **kw)
    with ref.flush_denormal():
        return ref.stdp_ltp(*args, **kw)


def arborize(arr_ring, spiked_src, syn_src, syn_delay, syn_valid, fwd_ptr,
             fwd_ids, fwd_delay, t, t_base=None):
    """Phase B: for every valid synapse whose source spiked, set its flag
    at ring slot (t + delay) mod D.  arr_ring [H, D, E] bool (updated in
    place and returned), spiked_src [H, S] bool, the plan's syn_src [H, E]
    int64, syn_delay [H, E] int32 and syn_valid [H, E] bool (what the
    plain version reads, and the kernel where most sources spiked) and its
    forward CSR fwd_ptr [H, S + 1], fwd_ids [H, E] and fwd_delay [H, E]
    int32 (what the kernel walks: `core.engine.make_fwd_csr`); t an int,
    or on the card the device step counter (`kernels.arborize.arborize`);
    `t_base` as `stdp_phase_a`'s."""
    args = (arr_ring, spiked_src, syn_src, syn_delay, syn_valid)
    if _route(arr_ring, "arborize"):
        return _arb.arborize(*args, fwd_ptr, fwd_ids, fwd_delay, t, t_base)
    return ref.arborize(*args, _plain_step(t, "arborize", t_base))


def chunk_tables(source: ref.ChunkSource, c: int, out: ref.ChunkTables,
                 status) -> ref.ChunkTables:
    """Regenerate chunk c of every shard (`ref.ChunkSource`) into the live
    tables `out` (`ref.ChunkTables`, [H, q + 1] and [H, K]) and return
    them.  On the card a kept count that differs from the plan's e_start,
    or exceeds K, sets a bit of `status` [1] int32 (read it after the card
    has finished, never in the step); the plain version raises at once
    (`kernels.stream.chunk_tables`)."""
    if _route(source.cand, "chunk_tables"):
        return _stream.chunk_tables(source, c, out, status)
    new = ref.chunk_tables(source, c, out.src.shape[1])
    for dst, src in zip(out, new):
        dst.copy_(src)
    return out


def stdp_phase_a_chunk(arr_ring, r, tables: ref.ChunkTables, lo: int,
                       exc_mask, neuron_valid, stim_idx, stim_amp, v, u,
                       last_post, w, last_arr, t, spiked, counts, *,
                       accumulate, izh, stdp, neg_time, with_ltp,
                       coeffs=None) -> None:
    """`stdp_phase_a` on one regenerated chunk: the rows [lo, lo + q) (cut
    at N) of `tables` (`ref.ChunkTables`), their synapses at the state
    positions of the chunk's CSR.  Writes the rows' spikes into spiked
    [H, N] and their counts into counts [2, H] int64 (arrivals, spikes;
    added with `accumulate`), and updates the state at the chunk's rows
    and synapses in place.  On the card `t` may be the device step
    counter, with r None and the stimulus a window [W, H, C*K]
    (`kernels.stdp.stdp_phase_a_chunk`)."""
    kw = dict(izh=izh, stdp=stdp, neg_time=neg_time, with_ltp=with_ltp,
              accumulate=accumulate)
    args = (arr_ring, r, tables, lo, exc_mask, neuron_valid, stim_idx,
            stim_amp, v, u, last_post, w, last_arr)
    if _route(w, "stdp_phase_a_chunk"):
        return _stdp.stdp_phase_a_chunk(*args, t, spiked, counts, **kw)
    with ref.flush_denormal():
        return ref.stdp_phase_a_chunk(
            *args, _plain_step(t, "stdp_phase_a_chunk"), spiked, counts,
            coeffs=coeffs, **kw)


def stdp_ltp_chunk(spiked, tables: ref.ChunkTables, lo: int, last_arr, w,
                   last_post, t, *, a_plus, tau_plus, w_min, w_max,
                   neg_time) -> None:
    """`stdp_ltp` on one regenerated chunk's rows [lo, lo + q) (cut at N):
    w and last_post in place (`kernels.stdp.stdp_ltp_chunk`)."""
    args = (spiked, tables, lo, last_arr, w, last_post)
    kw = dict(a_plus=a_plus, tau_plus=tau_plus, w_min=w_min, w_max=w_max,
              neg_time=neg_time)
    if _route(w, "stdp_ltp_chunk"):
        return _stdp.stdp_ltp_chunk(*args, t, **kw)
    with ref.flush_denormal():
        return ref.stdp_ltp_chunk(*args, _plain_step(t, "stdp_ltp_chunk"),
                                  **kw)


def arborize_chunk(arr_ring, spiked_src, tables: ref.ChunkTables,
                   t) -> None:
    """Phase B on one regenerated chunk: the flag at slot (t + delay) mod D
    of each of its synapses whose source spiked, in place; t an int or on
    the card the device step counter (`kernels.arborize.arborize_chunk`)."""
    if _route(arr_ring, "arborize_chunk"):
        return _arb.arborize_chunk(arr_ring, spiked_src, tables, t)
    return ref.arborize_chunk(arr_ring, spiked_src, tables,
                              _plain_step(t, "arborize_chunk"))


def event_arrival(ev_ring, ev_count, syn_tgt, row_ptr, syn_plastic,
                  last_post, w, last_arr, t, *, a_minus, tau_minus, w_min,
                  w_max, neg_time, t_base=None):
    """The event backend's arrivals at step t: slot t mod D of ev_ring
    [H, D, cap] int32 (its events in [0, ev_count[:, slot]), -1 after),
    each target's current the in-list-order sum of its events' pre-LTD
    weights from +0.0, LTD where plastic, last_arr = t; the slot's entries
    and count are cleared.  The plan's syn_tgt [H, E] int64, row_ptr
    [H, N + 1] int32 (the kernel's buckets; the plain version needs none)
    and syn_plastic [H, E] bool, last_post [H, N], w / last_arr [H, E] ->
    (i_syn [H, N], n_arrived [H] int64), in place
    (`kernels.event.event_arrival`); `t_base` as `stdp_phase_a`'s."""
    kw = dict(a_minus=a_minus, tau_minus=tau_minus, w_min=w_min,
              w_max=w_max, neg_time=neg_time)
    state = (syn_plastic, last_post, w, last_arr)
    if _route(w, "event_arrival"):
        return _ev.event_arrival(ev_ring, ev_count, syn_tgt, row_ptr,
                                 *state, t, t_base=t_base, **kw)
    r = 0 if t_base is not None else t % ev_ring.shape[1]
    t = _plain_step(t, "event_arrival", t_base)
    with ref.flush_denormal():
        return ref.event_arrival(ev_ring, ev_count, r, syn_tgt, *state, t,
                                 **kw)


def event_neurons(i_syn, stim_idx, stim_amp, exc_mask, neuron_valid, v, u,
                  last_post, sat, t, *, izh, c_post, coeffs=None,
                  t_base=None):
    """The event backend's phase A after the arrivals, up to LTP: the
    stimulus (its (index, amp) row [H, C*K]), i_syn [H, N] + it, the
    Izhikevich update with a, b, c, d picked by exc_mask from `izh` (a
    `core.params.IzhikevichParams`) into v and u in place, and the spikes
    masked by neuron_valid.  With c_post (an int) the first c_post spiking
    neurons are listed in index order, last_post = t where spiked and sat
    += the spikes past c_post, in place -> (spiked [H, N] bool, count [H]
    int64, ids [H, c_post] int32, then the fill N); with c_post None
    nothing is listed (ids [H, 0]) and last_post and sat are untouched.

    `coeffs`, the plain version's (a, b, c, d) built once by the caller
    (`ref.izh_coefficients`), is used on the CPU only: the kernel takes the
    constants as launch arguments (`kernels.event.event_neurons`).  On the
    card `t` may be the device step counter, the stimulus then a window
    [W, H, C*K] read at the counter's row.  `t_base` as `stdp_phase_a`'s."""
    args = (i_syn, stim_idx, stim_amp, exc_mask, neuron_valid, v, u,
            last_post, sat)
    if _route(v, "event_neurons"):
        return _ev.event_neurons(*args, t, izh=izh, c_post=c_post,
                                 t_base=t_base)
    with ref.flush_denormal():
        return ref.event_neurons(*args,
                                 _plain_step(t, "event_neurons", t_base),
                                 izh=izh, c_post=c_post, coeffs=coeffs)


def event_compact(spiked, last_post, sat, t, *, c_post):
    """The event backend's bookkeeping before LTP, from a spike mask
    spiked [H, N] (the split schedule's plasticity half): the first c_post
    spiking neurons listed as `event_neurons` lists them, last_post = t
    where spiked and sat += the spikes past c_post, in place -> (count [H]
    int64, ids [H, c_post] int32) (`kernels.event.event_compact`)."""
    args = (spiked, last_post, sat)
    if _route(spiked, "event_compact"):
        return _ev.event_compact(*args, t, c_post=c_post)
    return ref.event_compact(*args, _plain_step(t, "event_compact"),
                             c_post=c_post)


def event_ltp(ids, count, row_ptr, syn_plastic, last_arr, w, t, *, a_plus,
              tau_plus, w_min, w_max, neg_time, t_base=None) -> None:
    """The event backend's LTP at step t: LTP on the CSR rows (row_ptr
    [H, N + 1]) of the neurons listed in ids [H, C] (with count as
    `event_neurons` or `event_compact` gave it), w [H, E] in place
    (`kernels.event.event_ltp`); `t_base` as `stdp_phase_a`'s."""
    kw = dict(a_plus=a_plus, tau_plus=tau_plus, w_min=w_min, w_max=w_max,
              neg_time=neg_time)
    args = (ids, count, row_ptr, syn_plastic, last_arr, w)
    if _route(w, "event_ltp"):
        return _ev.event_ltp(*args, t, t_base=t_base, **kw)
    with ref.flush_denormal():
        return ref.event_ltp(*args, _plain_step(t, "event_ltp", t_base),
                             **kw)


def event_emit(src_ids, n_dropped, fwd_rows, syn_delay, ev_ring, ev_count,
               sat, t, t_base=None) -> None:
    """The event backend's phase B at step t: the forward rows (fwd_rows
    [H, S, Kf] int32, -1 pad) of the sources listed in src_ids [H, C] int32
    (the first C spiking sources, then the fill S) appended to slot
    (t + delay) mod D of ev_ring [H, D, cap] in (source rank, row
    position) order, ev_count [H, D] updated, sat [H] += n_dropped + the
    events past cap; in place (`kernels.event.event_emit`); `t_base` as
    `stdp_phase_a`'s."""
    args = (src_ids, n_dropped, fwd_rows, syn_delay, ev_ring, ev_count, sat)
    if _route(ev_ring, "event_emit"):
        return _ev.event_emit(*args, t, t_base)
    return ref.event_emit(*args, _plain_step(t, "event_emit", t_base))


def segment_sum_ordered(contrib, seg: ref.Segments):
    """contrib [H, E] -> per-target sums [H, N] over `ref.make_segments`."""
    if _route(contrib, "segment_sum_ordered"):
        return _seg.segment_sum_ordered(contrib, seg)
    return ref.segment_sum_ordered(contrib, seg)


def rg_lru_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t.  a, b [B, T, D] fp32; h0 [B, D] or None
    (zeros) -> h [B, T, D]."""
    if h0 is None:
        h0 = a.new_zeros((a.shape[0], a.shape[2]))
    if _route(a, "rg_lru_scan"):
        return _rg.rg_lru_scan(a, b, h0)
    with ref.flush_denormal():
        return ref.rg_lru_scan(a, b, h0)


def attention(q, k, v, *, causal=True, window=None, softcap=None,
              scale=None):
    """Blockwise attention: q [BH, T, D], k/v [BH, S, D] -> o [BH, T, D]
    in q's dtype (fp32 or bf16 on the card, D <= 256).  GQA: repeat the KV
    heads to BH before the call.

    The contract, the JAX package's `repro.kernels.ops.attention` without
    its TPU tiling (`block_q`, `block_k`) and test plumbing (`use_pallas`,
    `interpret`):

    * queries are the last T of S positions (q_pos = i + S - T, k_pos = j);
    * `causal`: a query sees k_pos <= q_pos;
    * `window` (>= 1): a query sees k_pos > q_pos - window, also when not
      causal (the window is one-sided);
    * `softcap` (> 0): scores become softcap * tanh(s / softcap);
    * `scale` defaults to D ** -0.5, applied after the product.

    Causal with T > S raises ValueError: the first T - S rows would see no
    key, and there the JAX package's kernel (which writes 0) and its oracle
    (which writes the mean of v) disagree."""
    bh, t, d = q.shape
    s_len = k.shape[1]
    if tuple(k.shape) != (bh, s_len, d) or v.shape != k.shape:
        raise ValueError(f"attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: expected "
                         f"[BH, T, D] and [BH, S, D] twice")
    if causal and t > s_len:
        raise ValueError(f"attention: causal with T > S ({t} > {s_len}): "
                         f"the first {t - s_len} query rows see no key")
    if window is not None and window < 1:
        raise ValueError(f"attention: window {window} < 1 sees no key")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"attention: softcap {softcap} is not > 0")
    kw = dict(causal=causal, window=window, softcap=softcap,
              scale=(d ** -0.5) if scale is None else scale)
    if _route(q, "attention"):
        return _fa.flash_attention(q, k, v, **kw)
    with ref.flush_denormal():
        return ref.attention(q, k, v, **kw)


def launch_counts() -> dict:
    """Launches of each kernel since the last reset (`_build.counted`).  A
    replayed CUDA graph launches its kernels without passing through a
    wrapper, so its launches are not in these counts
    (`core.engine.CapturedRun.replayed_launches`)."""
    return {name: _build.launches[name] for name in KERNELS}


def reset_launch_counts() -> None:
    _build.launches.clear()
    _build.recorded.clear()
    for kind in _fa.variant_launches:
        _fa.variant_launches[kind] = 0
