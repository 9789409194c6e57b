"""CUDA wrappers of the fused STDP passes (`csrc/stdp.cu`).

Replace the Pallas TPU kernels `repro/kernels/stdp.py::stdp_arrival` and
`::stdp_ltp`.  Both are elementwise over the flat synapse arrays and
memory-bound (26 and 15 B/synapse).  The plain versions are
`kernels.ref.stdp_arrival` and `kernels.ref.stdp_ltp`.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import reciprocal_f32

#: Kernel launches since the last reset (`ops.reset_launch_counts`).
launches = {"stdp_arrival": 0, "stdp_ltp": 0}


def _stream():
    return torch.cuda.current_stream().cuda_stream


def stdp_arrival(arr, w, last_post_g, last_arr, plastic, t: float, *,
                 a_minus, tau_minus, w_min, w_max, neg_time):
    """Same-shape contiguous CUDA tensors (arr, plastic bool; the rest
    fp32) and the step t -> (w', last_arr', contrib)."""
    _build.require("stdp_arrival", torch.float32, w.shape, w=w,
                   last_post_g=last_post_g, last_arr=last_arr)
    _build.require("stdp_arrival", torch.bool, w.shape, arr=arr,
                   plastic=plastic)
    w_out, la_out = torch.empty_like(w), torch.empty_like(w)
    contrib = torch.empty_like(w)
    n = w.numel()
    if n == 0:
        return w_out, la_out, contrib
    lib = _build.library()
    with torch.cuda.device(w.device):
        err = lib.repro_stdp_arrival(
            arr.data_ptr(), w.data_ptr(), last_post_g.data_ptr(),
            last_arr.data_ptr(), plastic.data_ptr(), w_out.data_ptr(),
            la_out.data_ptr(), contrib.data_ptr(), n, float(t),
            float(a_minus), float(reciprocal_f32(tau_minus)), float(w_min),
            float(w_max), float(neg_time / 2), _stream())
    _build.check(err, "stdp_arrival")
    launches["stdp_arrival"] += 1
    return w_out, la_out, contrib


def stdp_ltp(post_g, w, last_arr, plastic, valid, t: float, *, a_plus,
             tau_plus, w_min, w_max, neg_time):
    """Same-shape contiguous CUDA tensors (post_g, plastic, valid bool;
    w, last_arr fp32) and the step t -> w'."""
    _build.require("stdp_ltp", torch.float32, w.shape, w=w,
                   last_arr=last_arr)
    _build.require("stdp_ltp", torch.bool, w.shape, post_g=post_g,
                   plastic=plastic, valid=valid)
    w_out = torch.empty_like(w)
    n = w.numel()
    if n == 0:
        return w_out
    lib = _build.library()
    with torch.cuda.device(w.device):
        err = lib.repro_stdp_ltp(
            post_g.data_ptr(), w.data_ptr(), last_arr.data_ptr(),
            plastic.data_ptr(), valid.data_ptr(), w_out.data_ptr(), n,
            float(t), float(a_plus), float(reciprocal_f32(tau_plus)),
            float(w_min), float(w_max), float(neg_time / 2), _stream())
    _build.check(err, "stdp_ltp")
    launches["stdp_ltp"] += 1
    return w_out
