"""CUDA wrappers of the STDP passes (`csrc/stdp.cu`).

Replace the Pallas TPU kernels `repro/kernels/stdp.py::stdp_arrival` and
`::stdp_ltp`, and with the first the sorted `jax.ops.segment_sum` of the
contributions (`repro/core/engine.py:230`).  Each takes the engine's plan
and state arrays, does its own gather by target, and updates the state in
place, in one launch:

* `stdp_arrival_current` (the main path) pops ring slot r (the flags it
  finds set are cleared), applies LTD and refreshes `last_arr` where a
  valid synapse arrived, and returns each target's in-order sum of the
  pre-LTD weights that arrived, and the arrivals per shard;
* `stdp_arrival` does the same but returns the pre-LTD contributions
  [H, E] for `segment_sum.segment_sum_ordered` to add: the pair the first
  replaced, kept as its yardstick;
* `stdp_ltp` applies LTP on the rows of the targets that spiked, through
  the per-target CSR `row_ptr` (which holds exactly the valid synapses,
  pads outside every row), and sets their `last_post` to t.

All are memory-bound and read of most synapses only what says that
nothing happens there (`csrc/stdp.cu`'s note gives the bounds).  The
arrival kernels read the ring slot as 8-byte words (`stdp_arrival` also
`syn_valid` and `syn_plastic`, and `w`, `last_arr` and `contrib` as
float4), so their wrappers refuse E % 8 != 0 and misaligned pointers; LTP
reads and writes single elements.  The plain versions, with the same
in-place contract, are `kernels.ref.stdp_arrival_current`,
`kernels.ref.stdp_arrival` and `kernels.ref.stdp_ltp`.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import Segments, reciprocal_f32

#: Kernel launches since the last reset (`ops.reset_launch_counts`).
launches = {"stdp_arrival_current": 0, "stdp_arrival": 0, "stdp_ltp": 0}

# (device, stream) -> uint64 [2 * H] (accumulator, ticket per shard) of the
# arrival kernel's count; every launch leaves it zero.
_count_scratch = {}


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _scratch(device: torch.device, stream: int, H: int) -> torch.Tensor:
    key = (device, stream)
    buf = _count_scratch.get(key)
    if buf is None or buf.numel() < 2 * H:
        buf = torch.zeros(2 * H, dtype=torch.int64, device=device)
        _count_scratch[key] = buf
    return buf


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
            _scratch(w.device, stream, H).data_ptr(), H, D, E, N, int(r),
            float(t), float(a_minus), float(reciprocal_f32(tau_minus)),
            float(w_min), float(w_max), float(neg_time / 2), stream)
    _build.check(err, name)
    launches[name] += 1
    return i_syn, n_arrived


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
            _scratch(w.device, stream, H).data_ptr(), H, D, E, N, int(r),
            float(t), float(a_minus), float(reciprocal_f32(tau_minus)),
            float(w_min), float(w_max), float(neg_time / 2), stream)
    _build.check(err, "stdp_arrival")
    launches["stdp_arrival"] += 1
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
    launches["stdp_ltp"] += 1
