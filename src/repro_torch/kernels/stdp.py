"""CUDA wrappers of the STDP passes and of phase A (`csrc/stdp.cu`).

Replace the Pallas TPU kernels `repro/kernels/stdp.py::stdp_arrival` and
`::stdp_ltp`, with the first the sorted `jax.ops.segment_sum` of the
contributions (`repro/core/engine.py:230`), and in phase A also
`repro/kernels/izhikevich.py::izhikevich_update`.  Each takes the engine's
plan and state arrays, does its own gather by target, and updates the
state in place, in one launch:

* `stdp_phase_a` (the main path) runs phase A of a step: the arrival pass
  below, then in each target row's own lanes the stimulus, the Izhikevich
  update with its constants as launch arguments and the spike, and with
  `with_ltp` LTP of the rows that spiked; it returns the spikes, the
  arrivals and the spike count per shard;
* `stdp_arrival_current` pops ring slot r (the flags it finds set are
  cleared), applies LTD and refreshes `last_arr` where a valid synapse
  arrived, and returns each target's in-order sum of the pre-LTD weights
  that arrived, and the arrivals per shard;
* `stdp_arrival` does the same but returns the pre-LTD contributions
  [H, E] for `segment_sum.segment_sum_ordered` to add: the pair the second
  replaced, kept as its yardstick;
* `stdp_ltp` applies LTP on the rows of the targets that spiked, through
  the per-target CSR `row_ptr` (which holds exactly the valid synapses,
  pads outside every row), and sets their `last_post` to t.

For streamed connectivity, `stdp_phase_a_chunk` and `stdp_ltp_chunk` run
the same kernels (`row_kernel<true>`, `ltp_kernel`) on a chunk window: the
rows [lo, lo + q) of one regenerated chunk (`ref.ChunkTables`), its CSR in
absolute state positions and its own plastic table.

All are memory-bound and read of most synapses only what says that
nothing happens there (`csrc/stdp.cu`'s note gives the bounds).  The
arrival kernels read the ring slot as 8-byte words (`stdp_arrival` also
`syn_valid` and `syn_plastic`, and `w`, `last_arr` and `contrib` as
float4), so their wrappers refuse E % 8 != 0 and misaligned pointers; LTP
reads and writes single elements.  The plain versions, with the same
in-place contract, are `kernels.ref.stdp_phase_a`,
`kernels.ref.stdp_arrival_current`, `kernels.ref.stdp_arrival` and
`kernels.ref.stdp_ltp`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .ref import ChunkTables, Segments, reciprocal_f32


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _scratch(device: torch.device, H: int) -> torch.Tensor:
    """uint64 [3 * H] (arrivals, spikes, ticket per shard) of the kernels'
    counts; every launch leaves it zero."""
    return _build.scratch(device, "stdp_counts", 3 * H, torch.int64)


def _check_ring(name: str, arr_ring, r: int) -> None:
    """E % 8 == 0 and slot r on an 8-byte boundary: then every shard's slot
    is, and the kernel reads it as aligned 8-byte words."""
    H, D, E = arr_ring.shape
    if E % 8:
        raise ValueError(f"{name}: E = {E} is not a multiple of 8 "
                         f"(the kernel reads 8 ring flags at once)")
    if not 0 <= r < D:
        raise ValueError(f"{name}: slot {r} outside the ring's {D}")
    _build.require(name, torch.bool, (H, D, E), arr_ring=arr_ring)
    _build.require_aligned(name, 8, arr_ring_slot=arr_ring[:, r])


def stdp_arrival_current(arr_ring, r: int, seg: Segments, syn_plastic,
                         last_post, w, last_arr, t: float, *, a_minus,
                         tau_minus, w_min, w_max, neg_time):
    """arr_ring [H, D, E] bool, slot r, `seg.row_ptr` [H, N + 1] int32 (the
    per-target CSR of the valid synapses, pads outside every row),
    syn_plastic [H, E] bool, last_post [H, N] fp32, w / last_arr [H, E]
    fp32, all contiguous CUDA tensors, E % 8 == 0, slot r 8-byte aligned
    -> (i_syn [H, N] fp32, n_arrived [H] int64).  Updates w, last_arr and
    arr_ring[:, r] in place.  No flag of a pad may be set (phase B sets
    none): the kernel reads and clears the flags inside rows only."""
    name = "stdp_arrival_current"
    H, D, E = arr_ring.shape
    row_ptr = seg.row_ptr
    N = row_ptr.shape[1] - 1
    _check_ring(name, arr_ring, r)
    _build.require(name, torch.int32, (H, N + 1), row_ptr=row_ptr)
    _build.require(name, torch.bool, (H, E), syn_plastic=syn_plastic)
    _build.require(name, torch.float32, (H, N), last_post=last_post)
    _build.require(name, torch.float32, (H, E), w=w, last_arr=last_arr)
    _build.one_device(name, arr_ring, row_ptr, syn_plastic, last_post, w,
                      last_arr)
    i_syn = torch.empty((H, N), dtype=torch.float32, device=w.device)
    n_arrived = torch.empty(H, dtype=torch.int64, device=w.device)
    if H * N == 0:
        return i_syn, n_arrived.zero_()
    lib = _build.library()
    with torch.cuda.device(w.device):
        stream = _stream()
        err = lib.repro_stdp_arrival_current(
            arr_ring.data_ptr(), row_ptr.data_ptr(), syn_plastic.data_ptr(),
            last_post.data_ptr(), w.data_ptr(), last_arr.data_ptr(),
            i_syn.data_ptr(), n_arrived.data_ptr(),
            _scratch(w.device, H).data_ptr(), H, D, E, N, int(r),
            float(t), float(a_minus), float(reciprocal_f32(tau_minus)),
            float(w_min), float(w_max), float(neg_time / 2), stream)
    _build.check(err, name)
    _build.counted(name)
    return i_syn, n_arrived


def _phase_a_floats(t, izh, stdp, neg_time):
    """The phase-A kernel's float launch arguments."""
    return (ctypes.c_float * 19)(
        float(t), stdp.a_minus, reciprocal_f32(stdp.tau_minus), stdp.a_plus,
        reciprocal_f32(stdp.tau_plus), stdp.w_min, stdp.w_max, neg_time / 2,
        izh.a_exc, izh.a_inh, izh.b_exc, izh.b_inh, izh.c_exc, izh.c_inh,
        izh.d_exc, izh.d_inh, izh.v_peak, np.float32(izh.dt / izh.v_substeps),
        izh.dt)


def _step_stimulus(name, H, r, t, stim_idx, stim_amp):
    """(counted, stim_idx, stim_amp [rows, K]): the step counter's window
    flattened to [W * H, K], or the step's own row."""
    counted = isinstance(t, torch.Tensor)
    if counted != (r is None):
        raise ValueError(f"{name}: give r with a step t, or r=None with the "
                         f"step counter")
    if counted:
        window, _, k = stim_idx.shape
        stim_idx = stim_idx.view(window * H, k)
        stim_amp = stim_amp.view(window * H, k)
    rows, K = stim_idx.shape
    if rows % H:
        raise ValueError(f"{name}: stimulus rows {rows} are not a multiple "
                         f"of H = {H}")
    _build.require(name, torch.int64, (rows, K), stim_idx=stim_idx)
    _build.require(name, torch.float32, (rows, K), stim_amp=stim_amp)
    return counted, stim_idx, stim_amp


def stdp_phase_a(arr_ring, r, seg: Segments, syn_plastic, exc_mask,
                 neuron_valid, stim_idx, stim_amp, v, u, last_post, w,
                 last_arr, t, *, izh, stdp, neg_time: float,
                 with_ltp: bool, t_base=None):
    """Phase A of a step in one launch: `stdp_arrival_current`'s pass, then
    in each row's own lanes the stimulus, the Izhikevich update and the
    spike, and with `with_ltp` LTP of the rows that spiked.

    arr_ring [H, D, E] bool, slot r, `seg.row_ptr` [H, N + 1] int32,
    syn_plastic [H, E] bool, exc_mask / neuron_valid [H, N] bool, stim_idx
    [H, C*K] int64 and stim_amp [H, C*K] fp32 (the step's row of
    `core.stimulus.stim_inputs`), v / u / last_post [H, N] fp32, w /
    last_arr [H, E] fp32, all contiguous CUDA tensors, E % 8 == 0, slot r
    8-byte aligned; `izh` and `stdp` the `core.params` constants, passed
    as launch arguments -> (spiked [H, N] bool, n_arrived [H] int64, spike
    count [H] int64).  Updates v, u, w, last_arr, arr_ring[:, r] and (with
    LTP) last_post in place.  No flag of a pad may be set.

    With `t` the device step counter (int64 [2]: t, and the row of the
    stimulus window; `_build.step_counter`) and r None, the kernel reads t,
    r = t mod D and the row itself: stim_idx / stim_amp are then a window
    [W, H, C*K], and nothing of the step is a launch argument (what a
    captured CUDA graph needs).

    With `t_base`, per-shard step offsets (int64 [H] on the card,
    `_build.step_base`), shard h steps at t + t_base[h] (the counter's t,
    or an int t, whose r is then ignored): its ring slot, its LTD / LTP
    time differences and its last_arr / last_post stamps.  None is the
    solo launch, unchanged."""
    name = "stdp_phase_a"
    H, D, E = arr_ring.shape
    row_ptr = seg.row_ptr
    N = row_ptr.shape[1] - 1
    counted, stim_idx, stim_amp = _step_stimulus(name, H, r, t, stim_idx,
                                                 stim_amp)
    K = stim_idx.shape[1]
    # every slot is aligned when slot 0 is (E % 8 == 0)
    _check_ring(name, arr_ring, 0 if counted else r)
    _build.require(name, torch.int32, (H, N + 1), row_ptr=row_ptr)
    _build.require(name, torch.bool, (H, E), syn_plastic=syn_plastic)
    _build.require(name, torch.bool, (H, N), exc_mask=exc_mask,
                   neuron_valid=neuron_valid)
    _build.require(name, torch.float32, (H, N), v=v, u=u,
                   last_post=last_post)
    _build.require(name, torch.float32, (H, E), w=w, last_arr=last_arr)
    _build.one_device(name, arr_ring, row_ptr, syn_plastic, exc_mask,
                      stim_idx, stim_amp, v, w)
    base = _build.step_base(name, t_base, H, w.device)
    spiked = torch.empty((H, N), dtype=torch.bool, device=w.device)
    counts = torch.empty((2, H), dtype=torch.int64, device=w.device)
    if H * N == 0:
        return spiked, counts[0].zero_(), counts[1].zero_()
    ctr, t_int = _build.step_counter(name, t, w.device)
    lib = _build.library()
    with torch.cuda.device(w.device):
        stream = _stream()
        ptrs = (ctypes.c_void_p * 18)(
            arr_ring.data_ptr(), row_ptr.data_ptr(), syn_plastic.data_ptr(),
            exc_mask.data_ptr(), neuron_valid.data_ptr(), stim_idx.data_ptr(),
            stim_amp.data_ptr(), v.data_ptr(), u.data_ptr(),
            last_post.data_ptr(), w.data_ptr(), last_arr.data_ptr(),
            spiked.data_ptr(), counts[0].data_ptr(), counts[1].data_ptr(),
            _scratch(w.device, H).data_ptr(), ctr, base)
        ints = (ctypes.c_int64 * 9)(H, D, E, N, 0 if counted else int(r), K,
                                    int(izh.v_substeps), int(with_ltp),
                                    t_int)
        floats = _phase_a_floats(t_int if counted else t, izh, stdp,
                                 neg_time)
        err = lib.repro_stdp_phase_a(ptrs, ints, floats, stream)
    _build.check(err, name)
    _build.counted(name)
    return spiked, counts[0], counts[1]


def _check_chunk(name, tables: ChunkTables, H: int, N: int,
                 lo: int) -> int:
    """The chunk's rows [lo, lo + rows) cut at N; its tables on the card."""
    q = tables.row_ptr.shape[1] - 1
    K = tables.src.shape[1]
    _build.require(name, torch.int32, (H, q + 1), row_ptr=tables.row_ptr)
    _build.require(name, torch.bool, (H, K), plastic=tables.plastic)
    if not 0 <= lo < max(N, 1):
        raise ValueError(f"{name}: chunk rows from {lo} outside N = {N}")
    return min(q, N - lo)


def stdp_phase_a_chunk(arr_ring, r, tables: ChunkTables, lo: int, exc_mask,
                       neuron_valid, stim_idx, stim_amp, v, u, last_post, w,
                       last_arr, t, spiked, counts, *, accumulate: bool, izh,
                       stdp, neg_time: float, with_ltp: bool) -> None:
    """`stdp_phase_a` on the rows [lo, lo + q) (cut at N) of one regenerated
    chunk: `tables.row_ptr` [H, q + 1] int32 (the chunk's CSR in absolute
    state positions; its synapses' ring flags, w and last_arr are the
    state's) and `tables.plastic` [H, K] bool (the chunk's own table, read
    at position - row_ptr[h, 0]); the other arguments as `stdp_phase_a`'s,
    and spiked [H, N] bool and counts [2, H] int64 (arrivals, spikes) the
    step's outputs: the rows' spikes are written, the chunk's counts
    written, or with `accumulate` added.  In place, no value read back."""
    name = "stdp_phase_a_chunk"
    H, D, E = arr_ring.shape
    N = v.shape[1]
    counted, stim_idx, stim_amp = _step_stimulus(name, H, r, t, stim_idx,
                                                 stim_amp)
    rows = _check_chunk(name, tables, H, N, lo)
    _check_ring(name, arr_ring, 0 if counted else r)
    _build.require(name, torch.bool, (H, N), exc_mask=exc_mask,
                   neuron_valid=neuron_valid, spiked=spiked)
    _build.require(name, torch.float32, (H, N), v=v, u=u,
                   last_post=last_post)
    _build.require(name, torch.float32, (H, E), w=w, last_arr=last_arr)
    _build.require(name, torch.int64, (2, H), counts=counts)
    _build.one_device(name, arr_ring, tables.row_ptr, tables.plastic,
                      exc_mask, stim_idx, stim_amp, v, w, spiked, counts)
    ctr, t_int = _build.step_counter(name, t, w.device)
    lib = _build.library()
    with torch.cuda.device(w.device):
        stream = _stream()
        ptrs = (ctypes.c_void_p * 17)(
            arr_ring.data_ptr(), tables.row_ptr.data_ptr(),
            tables.plastic.data_ptr(), exc_mask.data_ptr(),
            neuron_valid.data_ptr(), stim_idx.data_ptr(),
            stim_amp.data_ptr(), v.data_ptr(), u.data_ptr(),
            last_post.data_ptr(), w.data_ptr(), last_arr.data_ptr(),
            spiked.data_ptr(), counts[0].data_ptr(), counts[1].data_ptr(),
            _scratch(w.device, H).data_ptr(), ctr)
        ints = (ctypes.c_int64 * 13)(
            H, D, E, N, 0 if counted else int(r), stim_idx.shape[1],
            int(izh.v_substeps), int(with_ltp), int(lo), rows,
            tables.row_ptr.shape[1], tables.plastic.shape[1],
            int(accumulate))
        floats = _phase_a_floats(t_int if counted else t, izh, stdp,
                                 neg_time)
        err = lib.repro_stdp_phase_a_chunk(ptrs, ints, floats, stream)
    _build.check(err, name)
    _build.counted(name)


def stdp_ltp_chunk(spiked, tables: ChunkTables, lo: int, last_arr, w,
                   last_post, t: int, *, a_plus, tau_plus, w_min, w_max,
                   neg_time) -> None:
    """`stdp_ltp` on the rows [lo, lo + q) (cut at N) of one regenerated
    chunk (`stdp_phase_a_chunk`'s tables): w and last_post in place; t an
    int (the split phases run eagerly)."""
    name = "stdp_ltp_chunk"
    if isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: takes the step as an int")
    H, N = spiked.shape
    E = w.shape[1]
    rows = _check_chunk(name, tables, H, N, lo)
    _build.require(name, torch.bool, (H, N), spiked=spiked)
    _build.require(name, torch.float32, (H, E), last_arr=last_arr, w=w)
    _build.require(name, torch.float32, (H, N), last_post=last_post)
    _build.one_device(name, spiked, tables.row_ptr, tables.plastic, last_arr,
                      w, last_post)
    lib = _build.library()
    with torch.cuda.device(w.device):
        err = lib.repro_stdp_ltp_chunk(
            spiked.data_ptr(), tables.row_ptr.data_ptr(),
            tables.plastic.data_ptr(), last_arr.data_ptr(), w.data_ptr(),
            last_post.data_ptr(), H, N, E, int(lo), rows,
            tables.row_ptr.shape[1], tables.plastic.shape[1], float(t),
            float(a_plus), float(reciprocal_f32(tau_plus)), float(w_min),
            float(w_max), float(neg_time / 2), _stream())
    _build.check(err, name)
    _build.counted(name)


def stdp_arrival(arr_ring, r: int, syn_valid, syn_tgt, syn_plastic,
                 last_post, w, last_arr, t: float, *, a_minus, tau_minus,
                 w_min, w_max, neg_time):
    """arr_ring [H, D, E] bool, slot r, syn_valid / syn_plastic [H, E] bool,
    syn_tgt [H, E] int64, last_post [H, N] fp32, w / last_arr [H, E] fp32,
    all contiguous CUDA tensors, E % 8 == 0, slot r, syn_valid and
    syn_plastic 8-byte aligned, w and last_arr 16-byte aligned ->
    (contrib [H, E] fp32, n_arrived [H] int64).  Updates w, last_arr and
    arr_ring[:, r] in place."""
    H, D, E = arr_ring.shape
    N = last_post.shape[1]
    _check_ring("stdp_arrival", arr_ring, r)
    _build.require("stdp_arrival", torch.bool, (H, E), syn_valid=syn_valid,
                   syn_plastic=syn_plastic)
    _build.require("stdp_arrival", torch.int64, (H, E), syn_tgt=syn_tgt)
    _build.require("stdp_arrival", torch.float32, (H, N),
                   last_post=last_post)
    _build.require("stdp_arrival", torch.float32, (H, E), w=w,
                   last_arr=last_arr)
    _build.one_device("stdp_arrival", arr_ring, syn_valid, syn_tgt,
                      syn_plastic, last_post, w, last_arr)
    _build.require_aligned("stdp_arrival", 8, syn_valid=syn_valid,
                           syn_plastic=syn_plastic)
    _build.require_aligned("stdp_arrival", 16, w=w, last_arr=last_arr)
    contrib = torch.empty_like(w)
    _build.require_aligned("stdp_arrival", 16, contrib=contrib)
    n_arrived = torch.empty(H, dtype=torch.int64, device=w.device)
    if H * E == 0:
        return contrib, n_arrived.zero_()
    lib = _build.library()
    with torch.cuda.device(w.device):
        stream = _stream()
        err = lib.repro_stdp_arrival(
            arr_ring.data_ptr(), syn_valid.data_ptr(), syn_tgt.data_ptr(),
            syn_plastic.data_ptr(), last_post.data_ptr(), w.data_ptr(),
            last_arr.data_ptr(), contrib.data_ptr(), n_arrived.data_ptr(),
            _scratch(w.device, H).data_ptr(), H, D, E, N, int(r),
            float(t), float(a_minus), float(reciprocal_f32(tau_minus)),
            float(w_min), float(w_max), float(neg_time / 2), stream)
    _build.check(err, "stdp_arrival")
    _build.counted("stdp_arrival")
    return contrib, n_arrived


def stdp_ltp(spiked, row_ptr, syn_plastic, last_arr, w, last_post,
             t: float, *, a_plus, tau_plus, w_min, w_max, neg_time) -> None:
    """spiked [H, N] bool, row_ptr [H, N + 1] int32, syn_plastic [H, E]
    bool, last_arr / w [H, E] fp32, last_post [H, N] fp32, all contiguous
    CUDA tensors.  Updates w and last_post in place."""
    H, N = spiked.shape
    E = w.shape[1]
    _build.require("stdp_ltp", torch.bool, (H, N), spiked=spiked)
    _build.require("stdp_ltp", torch.int32, (H, N + 1), row_ptr=row_ptr)
    _build.require("stdp_ltp", torch.bool, (H, E), syn_plastic=syn_plastic)
    _build.require("stdp_ltp", torch.float32, (H, E), last_arr=last_arr,
                   w=w)
    _build.require("stdp_ltp", torch.float32, (H, N), last_post=last_post)
    _build.one_device("stdp_ltp", spiked, row_ptr, syn_plastic, last_arr, w,
                      last_post)
    if H * N == 0:
        return
    lib = _build.library()
    with torch.cuda.device(w.device):
        err = lib.repro_stdp_ltp(
            spiked.data_ptr(), row_ptr.data_ptr(), syn_plastic.data_ptr(),
            last_arr.data_ptr(), w.data_ptr(), last_post.data_ptr(), H, N, E,
            float(t), float(a_plus), float(reciprocal_f32(tau_plus)),
            float(w_min), float(w_max), float(neg_time / 2), _stream())
    _build.check(err, "stdp_ltp")
    _build.counted("stdp_ltp")
