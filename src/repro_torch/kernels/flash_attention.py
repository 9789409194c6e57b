"""CUDA wrapper of blockwise attention (`csrc/flash_attention.cu`).

Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py::
flash_attention`.  One block owns 16 query rows of one (bh) slice and
walks the kv tiles in ascending order with each row's online-softmax state
in registers; fp32 arithmetic on the CUDA cores for fp32 and bf16 inputs.
The plain version is `kernels.ref.attention`; `kernels.ops.attention` is
the entry point (it checks the masking contract and the default scale).
"""
from __future__ import annotations

import torch

from . import _build

#: Kernel launches since the last reset (`ops.reset_launch_counts`).
launches = 0

#: The dtypes the kernel takes, with their code in the C interface.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def flash_attention(q, k, v, *, causal: bool, window, softcap, scale: float):
    """q [BH, T, D] and k, v [BH, S, D]: contiguous CUDA tensors of one
    dtype (fp32 or bf16) -> o [BH, T, D] in that dtype.  `window` None or
    >= 1, `softcap` None or > 0."""
    global launches
    BH, T, D = q.shape
    S = k.shape[1]
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype}, expected one "
                         f"of {sorted(map(str, DTYPES))}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} outside "
                         f"[1, {MAX_HEAD_DIM}]")
    _build.require("flash_attention", q.dtype, (BH, T, D), q=q)
    _build.require("flash_attention", q.dtype, (BH, S, D), k=k, v=v)
    if q.device != k.device:
        raise ValueError(f"flash_attention: q on {q.device}, k and v on "
                         f"{k.device}")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), BH, T, S,
            D, DTYPES[q.dtype], int(causal),
            -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap), float(scale), stream)
    _build.check(err, "flash_attention")
    launches += 1
    return o
