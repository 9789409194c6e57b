"""CUDA wrappers of the two STDP passes (`csrc/stdp.cu`).

Replace the Pallas TPU kernels `repro/kernels/stdp.py::stdp_arrival` and
`::stdp_ltp`.  Each takes the engine's plan and state arrays, does its own
gather by target, and updates the state in place, in one launch:

* `stdp_arrival` pops ring slot r (the flags it finds set are cleared),
  applies LTD and refreshes `last_arr` where a valid synapse arrived, and
  returns the pre-LTD contributions and the arrivals per shard;
* `stdp_ltp` applies LTP on the rows of the targets that spiked, through
  the per-target CSR `row_ptr` (which holds exactly the valid synapses,
  pads outside every row), and sets their `last_post` to t.

Both are memory-bound and read of most synapses only what says that
nothing happens there (`csrc/stdp.cu`'s note gives the bounds).  The plain
versions, with the same in-place contract, are `kernels.ref.stdp_arrival`
and `kernels.ref.stdp_ltp`.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import reciprocal_f32

#: Kernel launches since the last reset (`ops.reset_launch_counts`).
launches = {"stdp_arrival": 0, "stdp_ltp": 0}

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


def stdp_arrival(arr_ring, r: int, syn_valid, syn_tgt, syn_plastic,
                 last_post, w, last_arr, t: float, *, a_minus, tau_minus,
                 w_min, w_max, neg_time):
    """arr_ring [H, D, E] bool, slot r, syn_valid / syn_plastic [H, E] bool,
    syn_tgt [H, E] int64, last_post [H, N] fp32, w / last_arr [H, E] fp32,
    all contiguous CUDA tensors, E % 8 == 0 -> (contrib [H, E] fp32,
    n_arrived [H] int64).  Updates w, last_arr and arr_ring[:, r] in
    place."""
    H, D, E = arr_ring.shape
    N = last_post.shape[1]
    if E % 8:
        raise ValueError(f"stdp_arrival: E = {E} is not a multiple of 8 "
                         f"(the kernel reads 8 ring flags at once)")
    if not 0 <= r < D:
        raise ValueError(f"stdp_arrival: slot {r} outside the ring's {D}")
    _build.require("stdp_arrival", torch.bool, (H, D, E), arr_ring=arr_ring)
    _build.require("stdp_arrival", torch.bool, (H, E), syn_valid=syn_valid,
                   syn_plastic=syn_plastic)
    _build.require("stdp_arrival", torch.int64, (H, E), syn_tgt=syn_tgt)
    _build.require("stdp_arrival", torch.float32, (H, N),
                   last_post=last_post)
    _build.require("stdp_arrival", torch.float32, (H, E), w=w,
                   last_arr=last_arr)
    _build.one_device("stdp_arrival", arr_ring, syn_valid, syn_tgt,
                      syn_plastic, last_post, w, last_arr)
    contrib = torch.empty_like(w)
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
