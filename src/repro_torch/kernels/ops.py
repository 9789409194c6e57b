"""Public kernel entry points: dispatch on the tensor's device.

A CPU tensor goes to the plain PyTorch version (`kernels.ref`), run with
fp32 denormals flushed as XLA-CPU does.  A CUDA tensor goes to the
hand-written kernel, which launches or raises: no CUDA tensor ever falls
back to the plain version, and any other device raises.

Each kernel counts its launches (a plain int in its wrapper module);
`launch_counts` reads them and `reset_launch_counts` sets them to 0, so a
run can show that it went through the kernels.
"""
from __future__ import annotations

import torch

from . import izhikevich as _izh
from . import ref
from . import rg_lru as _rg
from . import segment_sum as _seg
from . import stdp as _stdp

#: The kernels of the DPSNN-STDP step, and of the LM's RG-LRU layers.
SNN_KERNELS = ("izhikevich_update", "stdp_arrival", "stdp_ltp",
               "segment_sum_ordered")
LM_KERNELS = ("rg_lru_scan",)
KERNELS = SNN_KERNELS + LM_KERNELS


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


def stdp_arrival(arr, w, last_post_g, last_arr, plastic, t, *, a_minus,
                 tau_minus, w_min, w_max, neg_time):
    """[E] tensors + step t -> (w', last_arr', contrib)."""
    kw = dict(a_minus=a_minus, tau_minus=tau_minus, w_min=w_min,
              w_max=w_max, neg_time=neg_time)
    if _route(w, "stdp_arrival"):
        return _stdp.stdp_arrival(arr, w, last_post_g, last_arr, plastic, t,
                                  **kw)
    with ref.flush_denormal():
        return ref.stdp_arrival(arr, w, last_post_g, last_arr, plastic, t,
                                **kw)


def stdp_ltp(post_g, w, last_arr, plastic, valid, t, *, a_plus, tau_plus,
             w_min, w_max, neg_time):
    """[E] tensors + step t -> w'."""
    kw = dict(a_plus=a_plus, tau_plus=tau_plus, w_min=w_min, w_max=w_max,
              neg_time=neg_time)
    if _route(w, "stdp_ltp"):
        return _stdp.stdp_ltp(post_g, w, last_arr, plastic, valid, t, **kw)
    with ref.flush_denormal():
        return ref.stdp_ltp(post_g, w, last_arr, plastic, valid, t, **kw)


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


def launch_counts() -> dict:
    """Launches of each kernel since the last reset."""
    return {"izhikevich_update": _izh.launches,
            "stdp_arrival": _stdp.launches["stdp_arrival"],
            "stdp_ltp": _stdp.launches["stdp_ltp"],
            "segment_sum_ordered": _seg.launches,
            "rg_lru_scan": _rg.launches}


def reset_launch_counts() -> None:
    _izh.launches = 0
    _stdp.launches["stdp_arrival"] = 0
    _stdp.launches["stdp_ltp"] = 0
    _seg.launches = 0
    _rg.launches = 0
