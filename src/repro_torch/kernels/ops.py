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

from . import flash_attention as _fa
from . import izhikevich as _izh
from . import ref
from . import rg_lru as _rg
from . import segment_sum as _seg
from . import stdp as _stdp

#: The kernels of the DPSNN-STDP step, of the LM's RG-LRU layers, and of
#: the `attention` entry point (which no model of the port calls).  The
#: arrival pass and the ordered sum as two kernels (`stdp_arrival`,
#: `segment_sum_ordered`) are off the main path, which runs them fused
#: (`stdp_arrival_current`); they stay as its yardstick.
SNN_KERNELS = ("izhikevich_update", "stdp_arrival_current", "stdp_ltp")
PAIR_KERNELS = ("stdp_arrival", "segment_sum_ordered")
LM_KERNELS = ("rg_lru_scan",)
ATTN_KERNELS = ("flash_attention",)
KERNELS = SNN_KERNELS + PAIR_KERNELS + LM_KERNELS + ATTN_KERNELS


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
    """Launches of each kernel since the last reset."""
    return {"izhikevich_update": _izh.launches,
            "stdp_arrival_current": _stdp.launches["stdp_arrival_current"],
            "stdp_arrival": _stdp.launches["stdp_arrival"],
            "stdp_ltp": _stdp.launches["stdp_ltp"],
            "segment_sum_ordered": _seg.launches,
            "rg_lru_scan": _rg.launches,
            "flash_attention": _fa.launches}


def reset_launch_counts() -> None:
    _izh.launches = 0
    for name in _stdp.launches:
        _stdp.launches[name] = 0
    _seg.launches = 0
    _rg.launches = 0
    _fa.launches = 0
    for kind in _fa.variant_launches:
        _fa.variant_launches[kind] = 0
