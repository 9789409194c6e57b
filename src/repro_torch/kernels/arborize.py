"""CUDA wrappers of phase B, the deferred axonal arborization
(`csrc/arborize.cu`).

Replace `repro/core/engine.py::phase_b` (plain jnp; no Pallas kernel):
for every valid synapse whose source spiked, set its arrival flag at ring
slot (t + delay) mod D, in place, in one launch.  Nothing is read back
and nothing is sized on the device, so the step does not wait on the
card here.  The kernels read every tensor an element at a time, so any
view of the right dtype is aligned enough and the wrappers check no
alignment.  The plain version is `kernels.ref.arborize`.

`arborize`, the path's kernel, walks the rows of the sources that spiked
in the plan's forward CSR (`core.engine.make_fwd_csr`), or, where a fixed
sample of the spike flags shows DENSE_PERCENT or more of a shard's
sources spiking, every synapse of the shard element-major (the cheaper
walk there; `walks_elements` says which a launch takes).
`arborize_elements`, the element-major kernel it replaced, is that walk
alone and stays as its yardstick.  `arborize_chunk` is the element walk
over one regenerated chunk of streamed connectivity (`ref.ChunkTables`).
"""
from __future__ import annotations

import torch

from . import _build

#: The sample `arborize` counts (`csrc/arborize.cu::kRowThreads`: sources
#: k * S // SAMPLE, k < SAMPLE) and the spiking share in it, in percent,
#: from which it walks element-major (`kDensePercent`).
SAMPLE, DENSE_PERCENT = 256, 18


def walks_elements(spiked_src: torch.Tensor) -> list:
    """Per shard, whether `arborize` walks element-major on this spike
    mask [H, S] (reads it on the host: for tests and reports)."""
    S = spiked_src.shape[1]
    if S == 0:
        return [False] * spiked_src.shape[0]
    k = torch.arange(SAMPLE, device=spiked_src.device) * S // SAMPLE
    n = spiked_src[:, k].sum(1)
    return [int(x) * 100 >= DENSE_PERCENT * SAMPLE for x in n.tolist()]


def _launch(name, entry, arr_ring, spiked_src, tables, t, t_base):
    H, D, E = arr_ring.shape
    S = spiked_src.shape[1]
    _build.one_device(name, arr_ring, spiked_src, *tables)
    base = _build.step_base(name, t_base, H, arr_ring.device)
    if H * E == 0 or D == 0:
        return arr_ring
    ctr, t_int = _build.step_counter(name, t, arr_ring.device)
    lib = _build.library()
    with torch.cuda.device(arr_ring.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            arr_ring.data_ptr(), spiked_src.data_ptr(),
            *(x.data_ptr() for x in tables), H, D, E, S, t_int, ctr, base,
            stream)
    _build.check(err, name)
    _build.counted(name)
    return arr_ring


def _require_ring(name, arr_ring, spiked_src):
    H, D, E = arr_ring.shape
    S = spiked_src.shape[1]
    _build.require(name, torch.bool, (H, D, E), arr_ring=arr_ring)
    _build.require(name, torch.bool, (H, S), spiked_src=spiked_src)
    return H, E, S


def _require_elements(name, H, E, syn_src, syn_delay, syn_valid):
    _build.require(name, torch.int64, (H, E), syn_src=syn_src)
    _build.require(name, torch.int32, (H, E), syn_delay=syn_delay)
    _build.require(name, torch.bool, (H, E), syn_valid=syn_valid)


def arborize(arr_ring, spiked_src, syn_src, syn_delay, syn_valid, fwd_ptr,
             fwd_ids, fwd_delay, t, t_base=None):
    """arr_ring [H, D, E] bool, spiked_src [H, S] bool, the plan's
    syn_src [H, E] int64 (indices into spiked_src's rows, each in [0, S)
    where valid), syn_delay [H, E] int32, syn_valid [H, E] bool, and its
    forward CSR: fwd_ptr [H, S + 1] int32 (row s of shard h is
    fwd_ids[h, fwd_ptr[h, s]:fwd_ptr[h, s + 1]]), fwd_ids [H, E] int32
    (each valid synapse once, in the row of its source) and fwd_delay
    [H, E] int32 (their delays, in the same order), all contiguous CUDA
    tensors on one device; t an int, or the device step counter (int64
    [2], `_build.step_counter`), read by the kernel; t_base None, or
    per-shard step offsets (int64 [H] on the card, `_build.step_base`):
    shard h then steps at t + t_base[h].  Sets the flags in place and
    returns arr_ring."""
    name = "arborize"
    H, E, S = _require_ring(name, arr_ring, spiked_src)
    _require_elements(name, H, E, syn_src, syn_delay, syn_valid)
    _build.require(name, torch.int32, (H, S + 1), fwd_ptr=fwd_ptr)
    _build.require(name, torch.int32, (H, E), fwd_ids=fwd_ids,
                   fwd_delay=fwd_delay)
    return _launch(name, "repro_arborize", arr_ring, spiked_src,
                   (fwd_ptr, fwd_ids, fwd_delay, syn_src, syn_delay,
                    syn_valid), t, t_base)


def arborize_elements(arr_ring, spiked_src, syn_src, syn_delay, syn_valid,
                      t, t_base=None):
    """The element-major walk alone (off the path; `arborize`'s
    yardstick): arguments as `arborize`'s without the forward CSR.  The
    same flags as `arborize`, in place; returns arr_ring."""
    name = "arborize_elements"
    H, E, S = _require_ring(name, arr_ring, spiked_src)
    _require_elements(name, H, E, syn_src, syn_delay, syn_valid)
    return _launch(name, "repro_arborize_elements", arr_ring, spiked_src,
                   (syn_src, syn_delay, syn_valid), t, t_base)


def arborize_chunk(arr_ring, spiked_src, tables, t):
    """Phase B on one regenerated chunk: arr_ring [H, D, E] bool,
    spiked_src [H, S] bool, the chunk's tables (`ref.ChunkTables`:
    row_ptr [H, q + 1] int32 in absolute state positions, src and delay
    [H, K] int32), t an int or the device step counter.  Sets the flag at
    slot (t + delay) mod D of every entry below the shard's kept count
    whose source spiked, in place; returns arr_ring."""
    name = "arborize_chunk"
    H, E, S = _require_ring(name, arr_ring, spiked_src)
    q1 = tables.row_ptr.shape[1]
    K = tables.src.shape[1]
    _build.require(name, torch.int32, (H, q1), row_ptr=tables.row_ptr)
    _build.require(name, torch.int32, (H, K), src=tables.src,
                   delay=tables.delay)
    _build.one_device(name, arr_ring, spiked_src, tables.row_ptr,
                      tables.src, tables.delay)
    D = arr_ring.shape[1]
    if H * E == 0 or D == 0:
        return arr_ring
    ctr, t_int = _build.step_counter(name, t, arr_ring.device)
    lib = _build.library()
    with torch.cuda.device(arr_ring.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.repro_arborize_chunk(
            arr_ring.data_ptr(), spiked_src.data_ptr(),
            tables.row_ptr.data_ptr(), tables.src.data_ptr(),
            tables.delay.data_ptr(), H, D, E, S, K, q1, t_int, ctr, stream)
    _build.check(err, name)
    _build.counted(name)
    return arr_ring
