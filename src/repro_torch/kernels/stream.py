"""CUDA wrapper of chunk regeneration (`csrc/stream.cu`).

Replaces `repro/core/stream_engine.py::make_chunk_tables` (plain jnp, not
Pallas): chunk c of every shard's incoming synapses rebuilt from the draw
lanes into the live tables (`ref.ChunkTables`: the chunk's CSR row_ptr
[H, q + 1] in absolute state positions, and per kept synapse in canonical
order its source row, delay and plastic flag, [H, K]), in three launches
(gen, scan, sort) and with no value read back, so a captured CUDA graph
holds it (c is a launch argument, one node a chunk).  Each target's keys
go to a bucket of `geom.row_cap` (the plan's longest row of any chunk)
and a warp sorts each row: rows of up to 512 keys in registers, longer
ones by counting.  A shard whose kept count differs from the plan's
e_start difference, or exceeds K, or a row longer than row_cap, sets a
bit of `status`, which the caller reads after the card has finished.
Under scatter placement row h is shard `source.shard_id[h]` of
`geom.n_shards`, so a rank's block of rows regenerates its own shards.  The
plain version is `kernels.ref.chunk_tables`; the kernel's draw order is
modelled by `kernels.ref.chunk_prefilter`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import ChunkSource, ChunkTables

#: int32 elements between two targets' counters in the scratch (one 128-B
#: line each, so that the kept synapses' atomics spread over the cache)
COUNT_STRIDE = 32


def chunk_tables(source: ChunkSource, c: int, out: ChunkTables,
                 status: torch.Tensor) -> ChunkTables:
    """source (`ref.ChunkSource`, its tensors contiguous on one CUDA
    device), chunk c, the live tables out ([H, q + 1] int32, [H, K] int32,
    int32, bool) and status [1] int32 -> out, rewritten with chunk c."""
    name = "chunk_tables"
    g = source.geom
    H, n_chunks, c_cap = source.cand.shape
    S = source.src_gid.shape[1]
    K = out.src.shape[1]
    reach = source.start.shape[0] - 2
    jbits = (g.M - 1).bit_length()
    if not 0 <= c < n_chunks or n_chunks != g.n_chunks or c_cap != g.c_cap:
        raise ValueError(f"{name}: chunk {c} of a [{H}, {n_chunks}, {c_cap}] "
                         f"candidate table (geometry {g.n_chunks} chunks, "
                         f"c_cap {g.c_cap})")
    if (S << jbits) >= 1 << 32 or g.n_neurons >= 1 << 32 \
            or H * g.q >= 1 << 32:
        raise ValueError(f"{name}: keys (S {S}, M {g.M}), gids "
                         f"({g.n_neurons}) or H * q ({H * g.q}) do not fit "
                         f"32 bits")
    _build.require(name, torch.int64, (H, S), src_gid=source.src_gid)
    _build.require(name, torch.int32, (H, n_chunks, c_cap), cand=source.cand)
    _build.require(name, torch.int32, (H, n_chunks + 1),
                   e_start=source.e_start)
    _build.require(name, torch.int32, tuple(source.off.shape),
                   off=source.off)
    _build.require(name, torch.int32, tuple(source.start.shape),
                   start=source.start)
    _build.require(name, torch.int64, (reach + 1,), thresh=source.thresh)
    _build.require(name, torch.int64, (H + 1,), bounds=source.bounds)
    _build.require(name, torch.int64, (4 + reach + 1, 3),
                   fastmod=source.fastmod)
    _build.require(name, torch.int64, (H,), shard_id=source.shard_id)
    _build.require(name, torch.int32, (H, g.q + 1), row_ptr=out.row_ptr)
    _build.require(name, torch.int32, (H, K), src=out.src, delay=out.delay)
    _build.require(name, torch.bool, (H, K), plastic=out.plastic)
    _build.require(name, torch.int32, (1,), status=status)
    dev = source.cand.device
    _build.one_device(name, source.src_gid, source.cand, source.e_start,
                      source.off, source.start, source.thresh,
                      source.bounds, source.fastmod, source.shard_id, *out,
                      status)
    B = max(g.row_cap, 1)
    scratch = (_build.scratch(dev, "chunk_bucket", H * g.q * B, torch.int32),
               _build.scratch(dev, "chunk_count", H * g.q * COUNT_STRIDE,
                              torch.int32))
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (ctypes.c_void_p * 16)(
            *(x.data_ptr() for x in (
                source.src_gid, source.cand, source.e_start, source.off,
                source.start, source.thresh, source.bounds, source.fastmod,
                *out, status, *scratch, source.shard_id)))
        ints = (ctypes.c_int64 * 20)(
            H, S, n_chunks, c_cap, g.M, g.npc, g.nexc, g.gx, g.gy,
            g.delay_min, g.q, K, int(c), reach, int(g.scatter), g.n_neurons,
            B, COUNT_STRIDE, jbits, g.n_shards)
        lanes = (ctypes.c_uint64 * 4)(*g.lanes)
        err = lib.repro_chunk_tables(ptrs, ints, lanes, stream)
    _build.check(err, name)
    _build.counted(name)
    return out
