"""CUDA wrappers of blockwise attention: three hand-written kernels and the
rule that picks one by shape.

All three replace the Pallas TPU kernel `repro/kernels/flash_attention.py::
flash_attention` and compute the same function (`kernels.ref.attention`
is the plain version; `kernels.ops.attention` is the entry point, which
checks the masking contract and the default scale):

* ``"wgmma"`` (`csrc/flash_attention_sm90.cu`): bf16 prefill on the tensor
  cores, q, k and v tiles brought by TMA; a block of 64 query rows whose
  two consumer warpgroups take half of its keys each;
* ``"splitkv"`` (`csrc/flash_decode.cu`): fewer than 64 query rows, the
  keys split across blocks and the splits merged in ascending order;
* ``"simt"`` (`csrc/flash_attention.cu`): the rest (fp32 prefill, head
  dims not a multiple of 8, pointers not 16-byte aligned), fp32 on the
  CUDA cores.

Choosing among them by shape is dispatch, not a fallback: each launches or
raises.
"""
from __future__ import annotations

import torch

from . import _build

#: The calls since the last reset (`ops.reset_launch_counts`) by kernel
#: (`variant`); each also counts one `flash_attention` launch, whichever
#: kernel ran.
variant_launches = {"wgmma": 0, "splitkv": 0, "simt": 0}

#: The dtypes the kernels take, with their code in the C interface.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
#: Query rows from which a call is prefill (one wgmma M tile).
PREFILL_ROWS = 64
#: Keys of one split of the decode kernel.
DECODE_SPLIT = 128


def variant(dtype, T: int, S: int, D: int, aligned: bool) -> str:
    """The kernel that takes q [BH, T, D] and k, v [BH, S, D] of `dtype`;
    `aligned`: q, k and v start on 16-byte boundaries (TMA and the decode
    kernel's vector loads need that, and rows of a multiple of 16 bytes)."""
    if dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {dtype}, expected one "
                         f"of {sorted(map(str, DTYPES))}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} outside "
                         f"[1, {MAX_HEAD_DIM}]")
    if not aligned or D % 8 != 0:
        return "simt"
    if T < PREFILL_ROWS:
        return "splitkv"
    if dtype == torch.bfloat16 and S >= 1:
        return "wgmma"
    return "simt"


def flash_attention(q, k, v, *, causal: bool, window, softcap, scale: float):
    """q [BH, T, D] and k, v [BH, S, D]: contiguous CUDA tensors of one
    dtype (fp32 or bf16) -> o [BH, T, D] in that dtype.  `window` None or
    >= 1, `softcap` None or > 0."""
    BH, T, D = q.shape
    S = k.shape[1]
    aligned = all(x.data_ptr() % 16 == 0 for x in (q, k, v))
    kind = variant(q.dtype, T, S, D, aligned)
    _build.require("flash_attention", q.dtype, (BH, T, D), q=q)
    _build.require("flash_attention", q.dtype, (BH, S, D), k=k, v=v)
    if q.device != k.device:
        raise ValueError(f"flash_attention: q on {q.device}, k and v on "
                         f"{k.device}")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    lib = _build.library()
    window = -1 if window is None else int(window)
    softcap = 0.0 if softcap is None else float(softcap)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
        if kind == "wgmma":
            err = lib.repro_flash_attention_sm90(
                *ptrs, BH, T, S, D, int(causal), window, softcap,
                float(scale), stream)
        elif kind == "splitkv":
            n_splits = -(-S // DECODE_SPLIT)
            f32 = dict(dtype=torch.float32, device=q.device)
            part_ml = torch.empty((BH * T, n_splits, 2), **f32)
            part_acc = torch.empty((BH * T, n_splits, D), **f32)
            err = lib.repro_flash_decode(
                *ptrs, part_ml.data_ptr(), part_acc.data_ptr(), BH, T, S, D,
                DECODE_SPLIT, DTYPES[q.dtype], int(causal), window, softcap,
                float(scale), stream)
        else:
            err = lib.repro_flash_attention(
                *ptrs, BH, T, S, D, DTYPES[q.dtype], int(causal), window,
                softcap, float(scale), stream)
    _build.check(err, f"flash_attention ({kind})")
    _build.counted("flash_attention")
    variant_launches[kind] += 1
    return o
