"""CUDA wrappers of the event backend's delivery: the arrivals of a ring
slot and the emission into the ring (`csrc/event.cu`), and its LTP
(`csrc/stdp.cu::event_ltp_kernel`, beside the LTP walk of the dense path).

Replace the plain jnp of `repro/core/event_engine.py` (no Pallas kernel
there): `phase_a_dynamics`' arrivals (`event_arrival`), `phase_a_
plasticity` (`event_ltp`) and `phase_b` (`event_emit`).  Each updates the
event state in place and reads nothing back, so the step never waits on
the card; the step t is an int, or the device step counter (int64 [2],
`_build.step_counter`) that a captured CUDA graph advances.  Each call
counts one launch of its op (`event_arrival` runs two kernels on the
stream, `event_emit` one; `csrc/event.cu`'s note); their integer scratch
is `_build.scratch`'s, zero between launches.  Ids are read one element
at a time, so no alignment is required.  The plain versions,
with the same in-place contract, are `kernels.ref.event_arrival`,
`kernels.ref.event_ltp` and `kernels.ref.event_emit`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import reciprocal_f32

#: The most delay slots `event_emit` takes (`csrc/event.cu::kMaxSlots`).
MAX_SLOTS = 16
#: Listed sources a tile of the emission scan holds, a row a warp
#: (`csrc/event.cu::kEmitWarps`); a row of more than EMIT_ROW_REGS entries
#: is read twice (`kRowRegs` rounds of 32 in registers).
EMIT_ROWS, EMIT_ROW_REGS = 8, 256


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


def event_ltp(spk_ids, n_dropped, spiked, row_ptr, syn_plastic, last_arr,
              w, last_post, sat, t, *, a_plus, tau_plus, w_min, w_max,
              neg_time) -> None:
    """spk_ids [H, C] int32 (the first C spiking neurons ascending, then
    the fill N), n_dropped [H] int32, spiked [H, N] bool, row_ptr [H, N + 1]
    int32, syn_plastic [H, E] bool, last_arr / w [H, E] fp32, last_post
    [H, N] fp32, sat [H] int32, all contiguous CUDA tensors on one device;
    t an int or the step counter.  LTP on the listed neurons' rows,
    last_post = t where spiked, sat += n_dropped, in place."""
    name = "event_ltp"
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
        err = lib.repro_event_ltp(
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
    int32, sat [H] int32, all contiguous CUDA tensors on one device, D <=
    16; t an int or the step counter.  Appends the listed sources' rows to
    slot (t + delay) mod D in (source rank, row position) order; updates
    ev_ring, ev_count and sat (+ n_dropped + the events past cap) in
    place."""
    name = "event_emit"
    H, D, cap = ev_ring.shape
    C = src_ids.shape[1]
    S, Kf = fwd_rows.shape[1:]
    E = syn_delay.shape[1]
    dev = ev_ring.device
    if D > MAX_SLOTS:
        raise ValueError(f"{name}: D = {D} delay slots, at most "
                         f"{MAX_SLOTS}")
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
