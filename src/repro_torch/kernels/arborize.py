"""CUDA wrapper of phase B, the deferred axonal arborization
(`csrc/arborize.cu`).

Replaces `repro/core/engine.py::phase_b` (plain jnp; no Pallas kernel):
for every valid synapse whose source spiked, set its arrival flag at ring
slot (t + delay) mod D, in place, in one launch.  Nothing is read back
and nothing is sized on the device, so the step does not wait on the
card here.  The kernel reads every tensor an element at a time, so any
view of the right dtype is aligned enough and the wrapper checks no
alignment.  The plain version is `kernels.ref.arborize`.
"""
from __future__ import annotations

import torch

from . import _build


def arborize(arr_ring, spiked_src, syn_src, syn_delay, syn_valid, t):
    """arr_ring [H, D, E] bool, spiked_src [H, S] bool, syn_src [H, E]
    int64 (indices into spiked_src's rows, each in [0, S) where valid),
    syn_delay [H, E] int32, syn_valid [H, E] bool, all contiguous CUDA
    tensors on one device; t an int, or the device step counter (int64
    [2], `_build.step_counter`), read by the kernel.  Sets the flags in
    place and returns arr_ring."""
    name = "arborize"
    H, D, E = arr_ring.shape
    S = spiked_src.shape[1]
    _build.require(name, torch.bool, (H, D, E), arr_ring=arr_ring)
    _build.require(name, torch.bool, (H, S), spiked_src=spiked_src)
    _build.require(name, torch.int64, (H, E), syn_src=syn_src)
    _build.require(name, torch.int32, (H, E), syn_delay=syn_delay)
    _build.require(name, torch.bool, (H, E), syn_valid=syn_valid)
    _build.one_device(name, arr_ring, spiked_src, syn_src, syn_delay,
                      syn_valid)
    if H * E == 0 or D == 0:
        return arr_ring
    ctr, t_int = _build.step_counter(name, t, arr_ring.device)
    lib = _build.library()
    with torch.cuda.device(arr_ring.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_arborize(
            arr_ring.data_ptr(), spiked_src.data_ptr(), syn_src.data_ptr(),
            syn_delay.data_ptr(), syn_valid.data_ptr(), H, D, E, S, t_int,
            ctr, stream)
    _build.check(err, name)
    _build.counted("arborize")
    return arr_ring
