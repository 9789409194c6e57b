"""CUDA wrappers of the event backend's step: the arrivals of a ring slot
and the emission into the ring (`csrc/event.cu`), and the rest of phase A,
the neurons and LTP (`csrc/event_phase_a.cu`).

Replace `repro/core/event_engine.py` (plain jnp, whose neuron update is
the Pallas kernel `repro/kernels/izhikevich.py::izhikevich_update`):
`phase_a_dynamics`' arrivals (`event_arrival`) and its stimulus and
neurons with, in the fused phase A, `phase_a_plasticity`'s compaction
(`event_neurons`); that compaction alone for the split schedule
(`event_compact`); the LTP (`event_ltp`); and `phase_b` (`event_emit`).
Each updates the event state in place and reads nothing back, so the step
never waits on the card; the step t is an int, or the device step counter
(int64 [2], `_build.step_counter`) that a captured CUDA graph advances.
Each call counts one launch of its op (`event_arrival` runs two kernels
on the stream, the others one; the sources' notes); their integer scratch
is `_build.scratch`'s, zero between launches.  Elements are read one at a
time, so no alignment is required.  The plain versions, with the same
in-place contract, are the functions of the same names in
`kernels.ref`.  `event_ltp_rows`, the LTP kernel that `event_ltp`
replaced (`csrc/stdp.cu::event_ltp_kernel`), stays as its yardstick.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .ref import reciprocal_f32

#: Listed sources a tile of the emission scan holds, a row a warp
#: (`csrc/event.cu::kEmitWarps`); a row of more than EMIT_ROW_REGS entries
#: is read twice (`kRowRegs` rounds of 32 in registers).
EMIT_ROWS, EMIT_ROW_REGS = 8, 256
#: Neurons a tile of the neuron pass's scan holds
#: (`csrc/event_phase_a.cu::kTile`: 256 threads, 4 neurons a thread).
NEURON_TILE = 1024


def _stream():
    return torch.cuda.current_stream().cuda_stream


def event_arrival(ev_ring, ev_count, syn_tgt, row_ptr, syn_plastic,
                  last_post, w, last_arr, t, *, a_minus, tau_minus, w_min,
                  w_max, neg_time):
    """ev_ring [H, D, cap] int32, ev_count [H, D] int32, syn_tgt [H, E]
    int64, row_ptr [H, N + 1] int32 (the per-target CSR of the valid
    synapses, `core.engine.make_row_ptr`), syn_plastic [H, E] bool,
    last_post [H, N] fp32, w / last_arr [H, E] fp32, all contiguous CUDA
    tensors on one device; t an int or the step counter -> (i_syn [H, N]
    fp32, n_arrived [H] int64).  Slot t mod D holds its events in
    [0, ev_count) and -1 after them, each synapse at most once; updates w,
    last_arr, that slot's entries (-1) and its count (0) in place.  The
    kernel finds each event's target as `csrc/event.cu`'s
    REPRO_ARRIVAL_TARGET says (the CSR row of row_ptr holding the synapse,
    or syn_tgt): the same target for every valid synapse."""
    name = "event_arrival"
    H, D, cap = ev_ring.shape
    N = last_post.shape[1]
    E = w.shape[1]
    dev = w.device
    _build.require(name, torch.int32, (H, D, cap), ev_ring=ev_ring)
    _build.require(name, torch.int32, (H, D), ev_count=ev_count)
    _build.require(name, torch.int64, (H, E), syn_tgt=syn_tgt)
    _build.require(name, torch.int32, (H, N + 1), row_ptr=row_ptr)
    _build.require(name, torch.bool, (H, E), syn_plastic=syn_plastic)
    _build.require(name, torch.float32, (H, N), last_post=last_post)
    _build.require(name, torch.float32, (H, E), w=w, last_arr=last_arr)
    _build.one_device(name, ev_ring, ev_count, syn_tgt, row_ptr,
                      syn_plastic, last_post, w, last_arr)
    i_syn = torch.empty((H, N), dtype=torch.float32, device=dev)
    n_arrived = torch.empty(H, dtype=torch.int64, device=dev)
    if H * N == 0 or D == 0:
        return i_syn.zero_(), n_arrived.zero_()
    ctr, t_int = _build.step_counter(name, t, dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = _stream()
        # fill counts, buckets of (list index, weight bits) pairs (a
        # target's is its CSR row), and the arrivals per shard as uint64
        scratch = [_build.scratch(dev, k, n, dtype) for k, n, dtype in (
            ("arrival_fill", H * N, torch.int32),
            ("arrival_pairs", H * E, torch.int64),
            ("arrival_total", 2 * H, torch.int32))]
        ptrs = (ctypes.c_void_p * 14)(
            ev_ring.data_ptr(), ev_count.data_ptr(), syn_tgt.data_ptr(),
            row_ptr.data_ptr(), syn_plastic.data_ptr(), last_post.data_ptr(),
            w.data_ptr(), last_arr.data_ptr(), i_syn.data_ptr(),
            n_arrived.data_ptr(), *(b.data_ptr() for b in scratch), ctr)
        ints = (ctypes.c_int64 * 6)(H, D, cap, E, N, t_int)
        floats = (ctypes.c_float * 5)(
            a_minus, reciprocal_f32(tau_minus), w_min, w_max, neg_time / 2)
        err = lib.repro_event_arrival(ptrs, ints, floats, stream)
    _build.check(err, name)
    _build.counted(name)
    return i_syn, n_arrived


def _scan(name, spiked, last_post, sat, t, c_post, neurons=None, blocks=0):
    """Launch `csrc/event_phase_a.cu::neuron_scan` -> (count, ids):
    with `neurons` = (i_syn, stim_idx, stim_amp, exc_mask, neuron_valid, v,
    u, izh) the neuron pass writing `spiked`, else the scan of `spiked`
    alone.  Without c_post nothing is listed and last_post and sat are not
    touched.  `blocks` > 0 caps the grid's blocks a shard (each then walks
    several tiles; for tests), 0 sizes it to the card."""
    H, N = spiked.shape
    C = 0 if c_post is None else int(c_post)
    dev = spiked.device
    if not 0 <= C <= N:
        raise ValueError(f"{name}: c_post = {C} outside [0, N = {N}]")
    count = torch.empty(H, dtype=torch.int64, device=dev)
    ids = torch.empty((H, C), dtype=torch.int32, device=dev)
    if H * N == 0:
        return count.zero_(), ids.fill_(N)
    ctr, t_int = _build.step_counter(name, t, dev)
    book = (last_post.data_ptr(), sat.data_ptr()) if c_post is not None \
        else (None, None)
    if neurons is None:
        ins, K, izh = (None,) * 7, 0, None
        consts = (0.0,) * 11
    else:
        *ins, izh = neurons
        ins = [x.data_ptr() for x in ins]
        K = neurons[1].shape[1]
        consts = (izh.a_exc, izh.a_inh, izh.b_exc, izh.b_inh, izh.c_exc,
                  izh.c_inh, izh.d_exc, izh.d_inh, izh.v_peak,
                  np.float32(izh.dt / izh.v_substeps), izh.dt)
    i_syn, stim_idx, stim_amp, exc, valid, v, u = ins
    tiles = -(-N // NEURON_TILE)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = _stream()
        # per tile the look-back word; per shard the tile counter and the
        # blocks that have left
        words = _build.scratch(dev, "neuron_words", H * tiles, torch.int64)
        ctrl = _build.scratch(dev, "neuron_ctrl", 2 * H)
        ptrs = (ctypes.c_void_p * 15)(
            i_syn, stim_idx, stim_amp, exc, valid, v, u, spiked.data_ptr(),
            *book, count.data_ptr(), ids.data_ptr(), words.data_ptr(),
            ctrl.data_ptr(), ctr)
        ints = (ctypes.c_int64 * 9)(
            H, N, C, K, tiles, t_int,
            0 if neurons is None else izh.v_substeps, neurons is not None,
            blocks)
        floats = (ctypes.c_float * 11)(*consts)
        err = lib.repro_event_neurons(ptrs, ints, floats, stream)
    _build.check(err, name)
    _build.counted(name)
    return count, ids


def event_neurons(i_syn, stim_idx, stim_amp, exc_mask, neuron_valid, v, u,
                  last_post, sat, t, *, izh, c_post, blocks=0):
    """i_syn [H, N] fp32, the stimulus (index [H, C*K] int64, amp [H, C*K]
    fp32: the step's row; with the step counter the window [W, H, C*K],
    read at the counter's row), exc_mask / neuron_valid [H, N] bool,
    v / u / last_post [H, N] fp32, sat [H] int32, all contiguous CUDA
    tensors on one device; t an int or the step counter; `izh` the
    `core.params` constants (launch arguments).  The Izhikevich update of
    i_syn + the stimulus into v and u in place, the spikes masked by
    neuron_valid, and with c_post the first c_post spiking neurons listed,
    last_post = t where spiked and sat += the spikes past c_post ->
    (spiked [H, N] bool, count [H] int64, ids [H, c_post] int32); without
    c_post, ids [H, 0], and last_post and sat untouched.  `blocks`:
    `_scan`'s."""
    name = "event_neurons"
    H, N = v.shape
    if isinstance(t, torch.Tensor):
        if stim_idx.dim() != 3 or stim_idx.shape[1] != H \
                or stim_amp.shape != stim_idx.shape:
            raise ValueError(
                f"{name}: the stimulus window must be [W, H = {H}, K] for "
                f"index and amp alike, got {tuple(stim_idx.shape)} and "
                f"{tuple(stim_amp.shape)}")
        window, _, k = stim_idx.shape
        stim_idx = stim_idx.view(window * H, k)
        stim_amp = stim_amp.view(window * H, k)
    rows, K = stim_idx.shape
    if H == 0 or rows % H:
        raise ValueError(f"{name}: stimulus rows {rows} are not a multiple "
                         f"of H = {H}")
    _build.require(name, torch.int64, (rows, K), stim_idx=stim_idx)
    _build.require(name, torch.float32, (rows, K), stim_amp=stim_amp)
    _build.require(name, torch.float32, (H, N), i_syn=i_syn, v=v, u=u,
                   last_post=last_post)
    _build.require(name, torch.bool, (H, N), exc_mask=exc_mask,
                   neuron_valid=neuron_valid)
    _build.require(name, torch.int32, (H,), sat=sat)
    _build.one_device(name, i_syn, stim_idx, stim_amp, exc_mask,
                      neuron_valid, v, u, last_post, sat)
    spiked = torch.empty((H, N), dtype=torch.bool, device=v.device)
    return (spiked, *_scan(name, spiked, last_post, sat, t, c_post,
                           (i_syn, stim_idx, stim_amp, exc_mask,
                            neuron_valid, v, u, izh), blocks))


def event_compact(spiked, last_post, sat, t, *, c_post, blocks=0):
    """spiked [H, N] bool, last_post [H, N] fp32, sat [H] int32, all
    contiguous CUDA tensors on one device; t an int or the step counter.
    The first c_post spiking neurons listed, last_post = t where spiked,
    sat += the spikes past c_post, in place -> (count [H] int64, ids
    [H, c_post] int32), as `event_neurons` lists them; `blocks`:
    `_scan`'s."""
    name = "event_compact"
    H, N = spiked.shape
    _build.require(name, torch.bool, (H, N), spiked=spiked)
    _build.require(name, torch.float32, (H, N), last_post=last_post)
    _build.require(name, torch.int32, (H,), sat=sat)
    _build.one_device(name, spiked, last_post, sat)
    return _scan(name, spiked, last_post, sat, t, c_post, blocks=blocks)


def event_ltp(ids, count, row_ptr, syn_plastic, last_arr, w, t, *, a_plus,
              tau_plus, w_min, w_max, neg_time, blocks=0) -> None:
    """ids [H, C] int32 (the first C spiking neurons ascending, then the
    fill N) and count [H] int64 (`event_neurons`' or `event_compact`'s),
    row_ptr [H, N + 1] int32, syn_plastic [H, E] bool, last_arr / w
    [H, E] fp32, all contiguous CUDA tensors on one device; t an int or
    the step counter.  LTP on the rows of the first min(count, C) listed
    neurons, w in place (`csrc/event_phase_a.cu::ltp_synapses`: a warp a
    row, the list's length read on the device); `blocks` > 0 sets the
    blocks a shard instead of the card's resident count (for tests: each
    warp then takes many rows)."""
    name = "event_ltp"
    H, C = ids.shape
    N = row_ptr.shape[1] - 1
    E = w.shape[1]
    dev = w.device
    _build.require(name, torch.int32, (H, C), ids=ids)
    _build.require(name, torch.int64, (H,), count=count)
    _build.require(name, torch.int32, (H, N + 1), row_ptr=row_ptr)
    _build.require(name, torch.bool, (H, E), syn_plastic=syn_plastic)
    _build.require(name, torch.float32, (H, E), last_arr=last_arr, w=w)
    _build.one_device(name, ids, count, row_ptr, syn_plastic, last_arr, w)
    if H * C == 0:
        return
    ctr, t_int = _build.step_counter(name, t, dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        ptrs = (ctypes.c_void_p * 7)(
            ids.data_ptr(), count.data_ptr(), row_ptr.data_ptr(),
            syn_plastic.data_ptr(), last_arr.data_ptr(), w.data_ptr(), ctr)
        ints = (ctypes.c_int64 * 6)(H, N, E, C, t_int, blocks)
        floats = (ctypes.c_float * 5)(a_plus, reciprocal_f32(tau_plus), w_min,
                                      w_max, neg_time / 2)
        err = lib.repro_event_ltp(ptrs, ints, floats, _stream())
    _build.check(err, name)
    _build.counted(name)


def event_ltp_rows(spk_ids, n_dropped, spiked, row_ptr, syn_plastic,
                   last_arr, w, last_post, sat, t, *, a_plus, tau_plus,
                   w_min, w_max, neg_time) -> None:
    """The LTP kernel that `event_ltp` replaced, kept as its yardstick
    (`csrc/stdp.cu::event_ltp_kernel`, a warp a listed neuron): spk_ids
    [H, C] int32 (the first C spiking neurons ascending, then the fill N),
    n_dropped [H] int32, spiked [H, N] bool, row_ptr [H, N + 1] int32,
    syn_plastic [H, E] bool, last_arr / w [H, E] fp32, last_post [H, N]
    fp32, sat [H] int32, all contiguous CUDA tensors on one device; t an
    int or the step counter.  LTP on the listed neurons' rows, last_post =
    t where spiked, sat += n_dropped, in place: what `event_compact` then
    `event_ltp` do."""
    name = "event_ltp_rows"
    H, N = spiked.shape
    C = spk_ids.shape[1]
    E = w.shape[1]
    dev = w.device
    _build.require(name, torch.int32, (H, C), spk_ids=spk_ids)
    _build.require(name, torch.int32, (H,), n_dropped=n_dropped, sat=sat)
    _build.require(name, torch.bool, (H, N), spiked=spiked)
    _build.require(name, torch.int32, (H, N + 1), row_ptr=row_ptr)
    _build.require(name, torch.bool, (H, E), syn_plastic=syn_plastic)
    _build.require(name, torch.float32, (H, E), last_arr=last_arr, w=w)
    _build.require(name, torch.float32, (H, N), last_post=last_post)
    _build.one_device(name, spk_ids, n_dropped, spiked, row_ptr,
                      syn_plastic, w, last_post, sat)
    if H == 0:
        return
    ctr, t_int = _build.step_counter(name, t, dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.repro_event_ltp_rows(
            spk_ids.data_ptr(), n_dropped.data_ptr(), spiked.data_ptr(),
            row_ptr.data_ptr(), syn_plastic.data_ptr(), last_arr.data_ptr(),
            w.data_ptr(), last_post.data_ptr(), sat.data_ptr(), ctr, t_int,
            H, N, E, C, float(a_plus), float(reciprocal_f32(tau_plus)),
            float(w_min), float(w_max), float(neg_time / 2), _stream())
    _build.check(err, name)
    _build.counted(name)


def event_emit(src_ids, n_dropped, fwd_rows, syn_delay, ev_ring, ev_count,
               sat, t) -> None:
    """src_ids [H, C] int32 (the first C spiking sources ascending, then
    the fill S), n_dropped [H] int32, fwd_rows [H, S, Kf] int32 (-1 pad),
    syn_delay [H, E] int32, ev_ring [H, D, cap] int32, ev_count [H, D]
    int32, sat [H] int32, all contiguous CUDA tensors on one device, any
    D >= 1 (the kernel scans 16 slots a pass); t an int or the step
    counter.  Appends the listed sources' rows to slot (t + delay) mod D
    in (source rank, row position) order; updates ev_ring, ev_count and
    sat (+ n_dropped + the events past cap) in place."""
    name = "event_emit"
    H, D, cap = ev_ring.shape
    C = src_ids.shape[1]
    S, Kf = fwd_rows.shape[1:]
    E = syn_delay.shape[1]
    dev = ev_ring.device
    _build.require(name, torch.int32, (H, C), src_ids=src_ids)
    _build.require(name, torch.int32, (H,), n_dropped=n_dropped, sat=sat)
    _build.require(name, torch.int32, (H, S, Kf), fwd_rows=fwd_rows)
    _build.require(name, torch.int32, (H, E), syn_delay=syn_delay)
    _build.require(name, torch.int32, (H, D, cap), ev_ring=ev_ring)
    _build.require(name, torch.int32, (H, D), ev_count=ev_count)
    _build.one_device(name, src_ids, n_dropped, fwd_rows, syn_delay,
                      ev_ring, ev_count, sat)
    if H == 0 or D == 0:
        return
    ctr, t_int = _build.step_counter(name, t, dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = _stream()
        # per tile and slot a status and value word; per shard the tile
        # counter and the blocks that have left
        tiles = max(1, -(-C // EMIT_ROWS))
        words = _build.scratch(dev, "emit_words", H * tiles * D,
                               torch.int64)
        ctrl = _build.scratch(dev, "emit_ctrl", 2 * H)
        ptrs = (ctypes.c_void_p * 10)(
            src_ids.data_ptr(), n_dropped.data_ptr(), fwd_rows.data_ptr(),
            syn_delay.data_ptr(), ev_ring.data_ptr(), ev_count.data_ptr(),
            sat.data_ptr(), words.data_ptr(), ctrl.data_ptr(), ctr)
        ints = (ctypes.c_int64 * 9)(H, D, cap, E, S, Kf, C, t_int, tiles)
        err = lib.repro_event_emit(ptrs, ints, stream)
    _build.check(err, name)
    _build.counted(name)
