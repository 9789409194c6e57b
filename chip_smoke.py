"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port only (it imports neither jax nor the JAX package) and
prints one JSON line per phase.  The plain versions it runs on the CPU as
yardsticks run with ATen's and MKL's CPU kernels pinned to the code paths
every x86-64 host runs alike (`ATEN_CPU_CAPABILITY=default`,
`MKL_CBWR=COMPATIBLE`), so their bits do not depend on the host.

  card     the card's name and power limit (nvidia-smi), torch's name, the
           CPU kernels' instruction set;
  build    nvcc builds the kernels from `src/repro_torch/csrc` (one nvcc
           per source, all at once), and beside them `event.cu` alone
           with the arrivals' other target lookup (REPRO_ARRIVAL_TARGET
           flipped), the yardstick of the lookup the library keeps;
  attn_sass  `-Xptxas -v` of the bf16 prefill and the decode attention
           sources (registers, spills) and the count of wgmma (HGMMA) and
           TMA load (UTMALDG) instructions in the prefill kernel's SASS
           (`cuobjdump`); fails if either is missing;
  kernels  each kernel on numpy-seeded inputs at the 8x8 main-path shapes
           (E = 12.8 M synapses, N = 64,000 neurons), bit-equal to its
           plain PyTorch version on a CPU copy of the inputs (the ordered
           sum and the STDP passes also to their plain versions on the
           card), timed with CUDA events beside its plain version, its
           memory/compute bound and, for the ordered sum, `index_add_`.
           The STDP passes (the main path's phase-A kernel
           `stdp_phase_a`, the fused arrival pass and ordered sum
           `stdp_arrival_current`, LTP, and the arrival pass alone) run on
           the 8x8 plan's own synapse arrays and row pointers, with the
           ring and spikes drawn at the main path's density (2.15%) and at
           10x it; they update their inputs in place, so every timed call
           starts from restored inputs and only the kernel is timed
           (events around it, profiler device time by its own name), and
           their bound counts the bytes these inputs make them move.  The
           phase-A row is also timed against the sequence it replaced
           (`stdp_arrival_current`, the stimulus, the constants,
           `izhikevich_update`, the mask and sum, `stdp_ltp`), and the
           fused arrival row against the pair it replaced (`stdp_arrival`
           then `segment_sum_ordered`), each bit-equal to what it
           replaced, on the same restored inputs: no PyTorch call does
           either; the phase-A kernel is also timed with t read from the
           step counter (as the path runs it) and with t a launch
           argument, in turns, twice each (the same bits).  Phase B's kernel (`arborize`, source-major over the
           plan's forward CSR; element-major where a sample of the spike
           flags shows 18% or more spiking) runs on the 8x8 plan's own
           tables with 2.15%, 10.75%, 21.5% and 43% of the sources
           spiking, bit-equal to its plain
           version (the reference's broadcast-compare) on a CPU copy and
           on the card, to the element-major kernel it replaced
           (`arborize_elements`) and to the sequence before that (gather,
           `nonzero`, index put), both timed beside it, its bound from the
           bytes the work needs (and counted by 32-B sectors, and the
           element-major design's); an all-False mask at t = -1 must set
           nothing.
           The event delivery's four ops (`event_arrival`,
           `event_neurons`, `event_ltp`, `event_emit`) run on the 8x8
           event plan's own tables with the ring's list, the neurons, the
           spikes and the sources drawn at 2.15% and 21.5% and compacted
           with the timed run's capacities (c_post = N, c_src = S), and at
           21.5% with c_post = 1,024 and the default c_src (both cut: sat
           counts the rest), each bit-equal to its plain version on a CPU
           copy and on the card, timed beside its bound, its plain version
           and, for the arrivals, `index_add_`, the same op built with
           the other target lookup (syn_tgt or a search of row_ptr; the
           same bits) at the main density and 10x, each one's place
           kernel alone, and the op's accesses at its events'
           synapses alone (w and plastic gathered, last_arr written, as
           PyTorch indexing calls); for the neuron pass (t and the
           stimulus row from the step counter, as the path calls it), the
           sequence it replaced (the window's rows, the stimulus,
           `izhikevich_update`, the copies, mask, sum and
           `compact_indices`) and, from i_syn to the end of LTP, the pass
           with `event_ltp` against that sequence with the LTP kernel
           they replaced (`event_ltp_rows`), each bit-equal, with device time
           and operations; for LTP, `event_compact` then `event_ltp` on a
           spike mask (the list, count, w, last_post and sat bit-equal to
           the plain versions on a CPU copy and on the card) beside
           `event_ltp_rows` on the same mask; for
           the emission, its delay loads alone (one indexing call).
           `event_emit` also runs on rings of
           21 and 40 slots (a 2x2 event plan at full width, delay_max 20
           and 39: the kernel scans 16 slots a pass), bit-equal to its
           plain version on a CPU copy and on the card, timed beside it
           (rows `d21`, `d40`).  The phase also prints ptxas's
           registers and spills of `stdp.cu`, `arborize.cu`, `event.cu`
           and `event_phase_a.cu`;
  check    both deliveries (`StepProgram(..., device="cuda").run`; the
           event one with capacities that drop nothing,
           `event_engine.no_drop_caps` and a ring of E events a slot) at
           4x4, full width, 150 steps, at H=1 block, H=4 block, H=4
           scatter: raster and weight signatures equal to the committed
           AVX-pinned JAX reference (`src/repro_torch/data/
           jax_reference.json`, `runs` and `event_runs`), `sat` 0, every
           kernel of the delivery's path (dense: `ops.SNN_KERNELS`; event:
           `ops.EVENT_KERNELS`) launched once per
           step by the eager loop (`graph=False`) and every other SNN
           kernel never.  Each run is the first of its program (an eager
           window, then the capture, then replays), and a second run
           (replays only) and the eager loop must give the same bits; the
           graph runs' eager launches plus their replays' (what the
           capture recorded, times the replays) must be one a step too.  A whole run of
           replays runs under `torch.cuda.set_sync_debug_mode("error")`,
           and after each H=4 run a few whole steps (phase A, the
           exchange, phase B) of each exchange wire (allgather, halo, hier
           in 2 groups) too (it fails if one synchronises);
  timed    each delivery at 8x8 (12.8 M synapses), H=1, 500 steps after a
           warm-up that captures the graph, as the captured graph's run
           and as the eager loop (the same bits): ms/step, launches (the
           eager loop's counted by the wrappers; the graph run's replays
           from what the capture recorded), peak
           memory, the paper's normalised metric
           (`bench.timing.norm_seconds`), synaptic events/s, the phase A /
           exchange / B split from `StepProgram.time_phases` (the
           synchronised pass), the sync-debug steps of each exchange wire
           at H=1, rate, raster signature, and for the event run `sat`
           (must be 0) and whether its raster equals the dense one;
  profile  device time by kernel, device busy and idle share, and device
           operations (kernels and copies) per step: the dense path over
           steps 0-19 (nearly silent), and each delivery, graph and eager,
           over the timed run's 500 steps (activity comes in bursts);
  stream_kernels  streamed connectivity's kernels: `chunk_tables` on the
           8x8 streamed plan's (K = 1, built on the card) first, an
           interior and the last chunk and on the ragged last chunk of a
           4x4 K = 3 plan at H = 4, bit-equal (row pointers and every kept
           entry) to the plain version on the card (and on a CPU copy for
           the interior and the ragged chunk), its flag clear, timed beside
           its plain version and two bounds (operations: SPLITMIX_OPS
           integer instructions a draw lane, counted in the SASS, at the
           int32 issue rate): the least work (the lanes the prefilter
           cannot skip, from `kref.chunk_prefilter` on this chunk, whose
           pass shares it prints) and the reference's draw order (three
           lanes a slot); each stage's device time (gen, scan, sort; a
           stage that reads none fails); the chunk windows of the phase-A row
           kernel (with LTP, t from the step counter), of LTP and of the
           element walk on the interior chunk at the main density,
           bit-equal to their plain versions on a CPU copy, timed on
           restored inputs; ptxas's registers and spills of `stream.cu`;
  stream_check  streamed connectivity at 4x4 full width, 150 steps, K = 1
           and 3 (ragged at H = 4), three layouts: raster and weight
           signatures equal to `jax_reference.json`'s runs (the modes are
           bit-identical), graph = replays = eager, launches (chunk_tables
           twice a chunk a step, the row kernel and the element walk once),
           the flag clear, a run of replays under sync-debug; at K = 1,
           H = 1 the reference's host builder, timed, equals the plan and
           weights built on the card;
  stream_timed  the streamed 8x8 program (K = 1, H = 1, 64 chunks)
           STREAM_STEPS steps, graph and eager (the same bits, and the
           materialized run's raster and weights): ms a step, the capture's
           seconds, launches, device busy, operations a step and idle
           share, and the program's device bytes beside the materialized
           program's;
  mesh_check  the mesh (`core.distributed` over `torch.distributed`
           ranks, `bench.subproc.Ranks`; the ranks load the library
           the `build` phase made): R = 2 and R = 4 ranks sharing the one
           card (the wire gloo, staged through pinned host memory; NCCL
           where every rank has a card of its own) and one rank under
           NCCL, H = 4 shards, at 4x4 full width, 150 steps: dense
           {allgather, halo, hier} x {sync, pipelined}, scatter with
           allgather, event with allgather and halo (`no_drop_caps`, sat
           0) and streamed K = 1 with halo sync and pipelined (NCCL:
           dense halo and allgather, and at R = 1 streamed K = 1 with
           scatter placement and halo, which more ranks refuse); each
           cell's gathered raster and
           weights equal to `jax_reference.json`'s H = 4 run, every
           rank's kernels launched as the path launches them (eager), and
           the wire the one the runtime names; a failed rank fails the
           phase.  With two or more cards R = 2 also runs under NCCL
           (`nccl_multi_rank` says whether it ran);
  mesh_timed  the 8x8 dense halo program at H = 4 (12.8 M synapses),
           MESH_STEPS_8X8 steps, stacked in this process (R = 1: the
           captured graph's run) and over 4 ranks (eager), under each
           schedule: ms a step, `time_phases`' phase split and exchange
           share (its fence includes the wire), the raster equal across
           all four, beside the card's name and power limit;
  ckpt_check  checkpoints (`core.checkpoint`, `StepProgram.load`) at 4x4
           full width, 150 steps: each case of CKPT_CASES (dense H = 1 ->
           H = 4 block, H = 4 block -> scatter, event H = 4 -> H = 1 with
           the capacities that drop nothing, streamed K = 1 -> K = 2 at
           H = 4, and dense H = 4 -> H = 1 restored at t = 30, off the
           graph's window) runs 0 -> t on the card, saves, loads into a
           fresh program of the other layout and runs t -> 150: both
           windows' events give `jax_reference.json`'s raster signature
           and the final weights the restoring layout's weight signature;
           at 2x2 full width the file the card writes at t = 50 (dense,
           event) has the payload digest of the CPU plain path's; an R = 2
           job saves and an R = 4 job restores (sharing the card); at 8x8
           dense the keys', save's and load's seconds and the file's
           bytes (host work), beside the card and the host's CPUs;
  cluster_check  `repro_torch.cluster run --supervise --ckpt-every 50`
           at 4x4 full width, H = 4 over 2 ranks sharing the card, 150
           steps, with `crash@step=50:rank=1` and with
           `corrupt_ckpt@step=100` (the two at once): each restarts,
           resumes at t = 50 (the corrupt epoch fails its sha256) and
           gives the h4_block signatures; restarts, steps salvaged and
           walls beside the card;
  bench    the ported suites (`repro_torch.bench`) on the card, one line
           per report (its env, config, deterministic and wall keys):
           `table1` quick (1x1, 4x4, 150 steps; the 4x4 row's raster
           signature must be the committed JAX reference's), `table1` at
           1x1, 4x4, 8x4, 8x8 and 16x16 (51.2 M synapses), 300 steps, with
           each row's build seconds and peak memory, `table2` (2x2, H=1,
           halo, 200 steps) under `sync` and again under `pipelined`
           (equal raster signatures), `profile` (exchange x placement
           at 2x2, H=4, 150 steps; it raises unless every cell gives the
           same raster and totals), and `event_vs_dense`'s single-device
           rows (2x2, 500 neurons a column, 200 steps, stim 1 and 0: both
           deliveries' rasters must be equal), and `cluster_scaling` quick
           (1 and 2 ranks on the card: the rasters must be equal).

Then the LM serving path (`recurrentgemma-2b`, `repro_torch.serve`):

  lm_kernels  the RG-LRU scan kernel on numpy-seeded inputs at its prefill
              (1, 512, 2560), decode (4, 1, 2560), tail (3, 100, 96) and
              ragged (2, 77, 100) shapes and at prefill on views 4 bytes
              past an aligned address, bit-equal to its plain version on
              a CPU copy and on the card, timed beside its plain version
              and its bound;
  attn_kernels  the port's `kernels.ops.attention` (three hand-written
              attention kernels, picked by `kernels.flash_attention.variant`:
              "wgmma" for bf16 prefill, "splitkv" for T < 64, "simt" for
              the rest) at seven shapes: RecurrentGemma-2B's local attention
              (10 query heads over 1 KV head of 256, window 2048, bf16) at a
              2048-token prefill, a 4096-token prefill, batch-4 decode and a
              ragged 1000-token prefill, and fp32, softcap and ragged
              bidirectional shapes.  One call per shape with the launch
              counts reset before and read after; each row names the kernel
              the call took (`variant`), which must be the one the rule
              names; each output within 2e-5 (fp32) / one bf16 ulp (bf16:
              rtol 2^-7, atol 1e-4) of the plain version on a CPU copy and
              on the card; timed beside the plain version, its bound, and
              `scaled_dot_product_attention` at the same shape and scale
              (events and device time);
  lm_check    SMOKE size, fp32 and bf16, weights from the numpy seed of
              the committed JAX reference
              (`src/repro_torch/data/lm_reference.json`): `ServeEngine`
              (batch 2, s_max 48, the 32-slot window ring wraps) gives the
              reference's greedy tokens in fp32, request 0 gives the same
              tokens alone, the teacher-forced logits are within 2e-4
              (fp32) and 0.1 (bf16) of the reference, and the scan kernel
              ran once per RG-LRU layer and forward call;
  lm_serve    full width (26 layers, d 2560, vocab 256,000, bf16, the
              port's own init from a seeded CUDA generator): 8 requests
              (prompts of 16-512 tokens, 32 new tokens each) through
              `ServeEngine(batch=4, s_max=1024)`: parameter count and
              bytes, init seconds, prefill tokens/s, decode ms/step and
              tokens/s, peak memory, kernel launches (18 per forward
              call), every sampled logit finite, and the kernel bit-equal
              to its plain version on the real inputs the first admission
              gives layer 0;
  lm_profile  device time by kernel and the device's idle share over a
              short serving run at full width.

Then the `{"kernels": [...]}` line (launches from the timed eager run of
the delivery whose path the kernel is on, or the streamed timed eager
run, counted by the wrappers, from the lm_serve run, and from
attn_kernels' one call per shape) and, last,
`{"ok": true, "device": {...}}`.  Any failed phase exits non-zero before
that line.  Without a CUDA device, or without the rest of the repository
beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (data sheet)
PEAK_FP32_PER_S = 67e12        # H100 SXM fp32, outside the tensor cores
PEAK_BF16_PER_S = 989e12       # H100 SXM bf16, dense tensor cores
PEAK_INT32_PER_S = 64 * 132 * 1.98e9   # H100 SXM int32: 64 lanes an SM
MAIN_STEPS = 500
SYNC_DEBUG_STEPS = 5     # timed: whole steps under sync-debug "error"
EXCHANGES = ("allgather", "halo", "hier")   # (hier: one group at H=1)
# bench: table1's rows (the JAX suite's four and the paper's 256-column
# row, 51.2 M synapses) at the suite's 300 steps
TABLE1_ROWS = [(1, 1), (4, 4), (8, 4), (8, 8), (16, 16)]
# kernels phase: the STDP passes' inputs flag this share of the valid
# synapses and spike this share of the neurons (the 8x8 timed run's mean:
# 275,342 arrivals a step among 12.8 M synapses, 21.52 Hz), and 10x it
STDP_DENSITY = 0.0215
# kernels phase: the event neurons' and LTP's c_post in the third event row
# (21.5% of 64,000 neurons spike: the list is cut and sat counts the rest)
SMALL_C_POST = 1024
STDP_REPLACES = {"stdp_phase_a": "src/repro/kernels/izhikevich.py:37, "
                                 "src/repro/kernels/stdp.py:57, "
                                 "src/repro/kernels/stdp.py:81",
                 "stdp_arrival_current": "src/repro/kernels/stdp.py:57",
                 "stdp_arrival": "src/repro/kernels/stdp.py:57",
                 "stdp_ltp": "src/repro/kernels/stdp.py:81"}
# the event delivery's ops: their sources, the JAX lines they replace
# (plain jnp, no Pallas kernel) and the profiler's names of their kernels
EVENT_SOURCES = {"event_arrival": "src/repro_torch/csrc/event.cu",
                 "event_neurons": "src/repro_torch/csrc/event_phase_a.cu",
                 "event_ltp": "src/repro_torch/csrc/event_phase_a.cu",
                 "event_emit": "src/repro_torch/csrc/event.cu"}
# event_neurons: the Pallas neuron update on the event path (with the
# stimulus, mask and compaction of event_engine.py:141-228 around it)
EVENT_REPLACES = {"event_arrival": "src/repro/core/event_engine.py:150",
                  "event_neurons": "src/repro/kernels/izhikevich.py:37",
                  "event_ltp": "src/repro/core/event_engine.py:199",
                  "event_emit": "src/repro/core/event_engine.py:245"}
# csrc/event.cu's REPRO_ARRIVAL_TARGET: how the arrivals' place pass finds
# an event's target
ARRIVAL_TARGETS = {0: "syn_tgt", 1: "row_ptr search"}
EVENT_KERNEL_NAMES = {"event_arrival": ("arrival_place", "arrival_sum"),
                      "event_neurons": "neuron_scan",
                      "event_ltp": "ltp_synapses",
                      "event_ltp_rows": "event_ltp_kernel",
                      "event_emit": "emit_scan"}
# streamed connectivity: the check's chunk sizes (K = 3 leaves a ragged
# last chunk at H = 4, 4 columns a shard), the 8x8 timed run's steps (64
# chunks, each regenerated twice a step), the integer instructions of one
# splitmix64 draw lane (counted in the SASS of a kernel that draws one
# lane, less that of the same kernel copying its input, sm_90a, the port's
# flags), and chunk_tables' kernels, as the profiler names them
STREAM_CHECK_CHUNKS = (1, 3)
STREAM_STEPS = 100
SPLITMIX_OPS = 22
CHUNK_KERNELS = ("gen_kernel", "scan_kernel", "sort_kernel")
# the profiler's names of the STDP kernels (row_kernel<true, false> is
# phase A; <true, true> its chunk window on the streamed path)
STDP_KERNEL_NAMES = {"stdp_phase_a": "row_kernel<true, false>",
                     "stdp_arrival_current": "row_kernel<false, false>",
                     "stdp_arrival": "arrival_kernel",
                     "stdp_ltp": "ltp_kernel"}
LM_ARCH = "recurrentgemma-2b"
# (label, shape, bytes past an aligned address of the inputs on the card)
LM_SCAN_SHAPES = (("prefill", (1, 512, 2560), 0), ("decode", (4, 1, 2560), 0),
                  ("tail", (3, 100, 96), 0), ("ragged", (2, 77, 100), 0),
                  ("offset", (1, 512, 2560), 4))
LM_TOL = {"float32": 2e-4, "bfloat16": 0.1}
# attn_kernels: B x heads query heads over B x kv_heads KV heads (repeated
# to B x heads before the call).  Tolerances (rtol, atol): fp32 that of
# tests/test_kernels.py; bf16 one bf16 ulp of the output, since the kernel
# and the plain version both compute in fp32 and round once at the output
# (a typical |o| at these shapes is about 0.03, so 2e-2 would pass a kernel
# that drops a whole kv tile)
RG_LOCAL = dict(heads=10, kv_heads=1, D=256, dtype="bfloat16", causal=True,
                window=2048, softcap=None, qk_scale=1.0)
ATTN_SHAPES = (
    ("rg_local_prefill", dict(RG_LOCAL, B=1, T=2048, S=2048)),
    ("rg_local_long", dict(RG_LOCAL, B=1, T=4096, S=4096)),
    ("rg_local_decode", dict(RG_LOCAL, B=4, T=1, S=2048)),
    ("fp32_causal", dict(B=1, heads=16, kv_heads=16, T=1024, S=1024, D=128,
                         dtype="float32", causal=True, window=None,
                         softcap=None, qk_scale=1.0)),
    ("softcap", dict(B=1, heads=8, kv_heads=8, T=512, S=512, D=128,
                     dtype="bfloat16", causal=True, window=256, softcap=50.0,
                     qk_scale=4.0)),
    ("bidir_ragged", dict(B=1, heads=3, kv_heads=3, T=100, S=300, D=80,
                          dtype="float32", causal=False, window=64,
                          softcap=None, qk_scale=1.0)),
    ("rg_local_ragged", dict(RG_LOCAL, B=1, T=1000, S=1000)),
)
# each attention kernel's source, and the one `kernels.flash_attention.
# variant` must pick for each shape
ATTN_SOURCES = {"wgmma": "src/repro_torch/csrc/flash_attention_sm90.cu",
                "splitkv": "src/repro_torch/csrc/flash_decode.cu",
                "simt": "src/repro_torch/csrc/flash_attention.cu"}
ATTN_VARIANTS = {"rg_local_prefill": "wgmma", "rg_local_long": "wgmma",
                 "rg_local_decode": "splitkv", "fp32_causal": "simt",
                 "softcap": "wgmma", "bidir_ragged": "simt",
                 "rg_local_ragged": "wgmma"}
ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2.0 ** -7, 1e-4)}


class PhaseFailed(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bit_equal(a, b) -> bool:
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        return bool((a.view(torch.int32) == b.view(torch.int32)).all())
    return bool((a == b).all())


def max_abs_err(a, b) -> float:
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.dtype == torch.bool:
        return float((a != b).sum())
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def cuda_ms(fn, calls: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Time of one fn() call in ms: CUDA events around `calls` calls back to
    back, over the count; the median of `reps` such runs.  For a kernel
    shorter than its launch this is the launch's cost, which is what the
    step pays; `device_ms` below has the kernel alone."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_kernel_events(prof):
    """(name, device microseconds, calls) of the CUDA kernels a
    torch.profiler run recorded (operator rows are left out: they repeat
    their kernels' time)."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            rows.append((e.key, e.self_device_time_total, e.count))
    return rows


def device_ms(fn, calls: int = 10, restore=None, kernel="",
              skip="Memcpy DtoD") -> float:
    """The device time per call in ms (torch.profiler) of the CUDA kernels
    and copies whose name holds `kernel` (or one of a tuple of names; all
    of fn's by default) and not `skip` (the device-to-device copies of
    `restore()`, which runs before every call where fn updates its inputs
    in place).  A session whose profiler hands back no event of those
    kernels (CUPTI now and then returns none, also for kernels that ran)
    is profiled again, up to three sessions; None if none reads."""
    from torch.profiler import ProfilerActivity, profile
    restore = restore or (lambda: None)
    restore()
    fn()
    torch.cuda.synchronize()
    names = (kernel,) if isinstance(kernel, str) else kernel
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                restore()
                fn()
            torch.cuda.synchronize()
        rows = [us for k, us, _ in device_kernel_events(prof)
                if any(n in k for n in names) and skip not in k]
        if rows:
            return sum(rows) * 1e-3 / calls
    return None


def bound(n_bytes: float, n_flops: float,
          peak_flops: float = PEAK_FP32_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over `peak_flops` (the fp32 peak unless given)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ----------------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------------


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise PhaseFailed(f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    name, power = (s.strip() for s in line.split(",", 1))
    emit({"phase": "card", "name": name, "power_limit": power,
          "torch_device_name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "cpu_capability": torch.backends.cpu.get_cpu_capability(),
          "mkl_cbwr": os.environ.get("MKL_CBWR")})
    return line


def phase_build():
    """Build the library, and `event.cu` alone with the arrivals' other
    target lookup beside it; returns the latter's (kept lookup, other
    lookup, loaded library)."""
    t0 = time.perf_counter()
    src = _build.CSRC / "event.cu"
    kept = int(re.search(r"#define REPRO_ARRIVAL_TARGET (\d)",
                         src.read_text()).group(1))
    other = 1 - kept
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj = _build.BUILD_DIR / f"event_target{other}.o"
    proc = subprocess.Popen(
        [_build.nvcc(), *_build.flags(src), f"-DREPRO_ARRIVAL_TARGET={other}",
         "-c", str(src), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    path = _build.build()
    _build.library()
    log, rc = proc.communicate()[0], proc.returncode
    so = obj.with_suffix(".so")
    if rc == 0:
        link = subprocess.run(
            [_build.nvcc(), *_build.ARCH, "-shared", "-o", str(so), str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log, rc = log + link.stdout, link.returncode
    if rc != 0:
        raise PhaseFailed(f"event.cu with REPRO_ARRIVAL_TARGET={other} did "
                          f"not build:\n{log}")
    lib = ctypes.CDLL(str(so))
    lib.repro_event_arrival.argtypes = _build.SIGNATURES[
        "repro_event_arrival"]
    lib.repro_event_arrival.restype = ctypes.c_int
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(path, HERE),
          "arrival_target": ARRIVAL_TARGETS[kept],
          "yardstick": os.path.relpath(so, HERE)})
    return kept, other, lib


@contextlib.contextmanager
def _kernel_library(lib):
    """The wrappers' launches inside the block go to `lib` (a library
    that holds the entry points they call there)."""
    saved, _build._lib = _build._lib, lib
    try:
        yield
    finally:
        _build._lib = saved


def phase_attn_sass():
    """What ptxas says of the bf16 prefill and the decode attention sources
    (registers, spills), and the prefill kernel's wgmma (HGMMA) and TMA
    load (UTMALDG) instructions in its SASS, where a disassembler is."""
    reports = [_build.inspect(name) for name in ("flash_attention_sm90.cu",
                                                 "flash_decode.cu")]
    emit({"phase": "attn_sass", "reports": reports})
    counts = reports[0]["sass_counts"]
    if counts is not None and not (counts["HGMMA"] and counts["UTMALDG"]):
        raise PhaseFailed(f"flash_attention_sm90.cu's SASS lacks wgmma or "
                          f"TMA loads: {counts}")


def _neuron_inputs(rng, N: int):
    """numpy-seeded Izhikevich inputs at the main-path width."""
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))
    exc = np.arange(N) % 5 != 4
    return dict(
        v=f(rng.uniform(-80.0, 29.9, N)), u=f(rng.uniform(-20.0, 10.0, N)),
        current=f(rng.uniform(-10.0, 25.0, N)),
        a=f(np.where(exc, 0.02, 0.1)), b=f(np.full(N, 0.2)),
        c=f(np.full(N, -65.0)), d=f(np.where(exc, 8.0, 2.0)))


def _stdp_state(rng, plan_cpu: dict, D: int, r: int, t: float,
                density: float) -> dict:
    """numpy-seeded dynamic inputs of the STDP passes on a plan's arrays
    (CPU tensors): ring slot r flagged on `density` of the valid synapses
    (as phase B flags them), `density` of the neurons spiking, weights in
    [0, 10], last spike and arrival times within 200 steps or never."""
    valid = plan_cpu["valid"].numpy()
    H, E = valid.shape
    N = plan_cpu["row_ptr"].shape[1] - 1
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))

    def times(shape):
        return f(np.where(rng.random(shape) < 0.7,
                          rng.uniform(t - 200.0, t, shape), engine.NEG_TIME))
    ring = np.zeros((H, D, E), bool)
    ring[:, r] = (rng.random((H, E)) < density) & valid
    return dict(ring=torch.from_numpy(ring), last_post=times((H, N)),
                w=f(rng.uniform(0.0, 10.0, (H, E))), last_arr=times((H, E)),
                spiked=torch.from_numpy(rng.random((H, N)) < density))


def _stdp_traffic(plan_cpu: dict, st: dict, r: int, half_neg: float):
    """({name: (bytes, flops)}, counts): what each STDP pass must move and
    compute on these inputs, each input byte read once and each output
    byte written once, counting only the synapses the data makes them
    touch (`csrc/stdp.cu`'s note)."""
    valid, plastic = plan_cpu["valid"], plan_cpu["plastic"]
    tgt, row_ptr = plan_cpu["tgt"], plan_cpu["row_ptr"]
    H, E = valid.shape
    N = row_ptr.shape[1] - 1
    flags = st["ring"][:, r]
    arr = flags & valid
    lp = torch.gather(st["last_post"], 1, tgt)
    arr_pl = arr & plastic
    ltd = arr_pl & (lp > half_neg)
    n = lambda m: int(m.sum())
    # per synapse: ring flag in, contrib out; per flag: valid in, flag
    # cleared; per arrival: plastic and w in, last_arr out; per plastic
    # arrival: syn_tgt and last_post[tgt] in; per LTD: w out; n_arrived
    a_bytes = (H * E * (1 + 4) + n(flags) * 2 + n(arr) * (1 + 4 + 4)
               + n(arr_pl) * (8 + 4) + n(ltd) * 4 + H * 8)
    # the fused pass: every ring flag, the row pointers and last_post in,
    # i_syn out; per arrival: plastic and w in, last_arr out, the flag
    # cleared; per LTD: w out; n_arrived
    c_bytes = (H * E + nbytes(row_ptr) + H * N * (4 + 4)
               + n(arr) * (1 + 4 + 4 + 1) + n(ltd) * 4 + H * 8)
    row = kref.rows_of_synapses(row_ptr, E)
    post = torch.cat([st["spiked"], st["spiked"].new_zeros(H, 1)],
                     1).gather(1, row)
    post_pl = post & plastic
    ltp = post_pl & (st["last_arr"] > half_neg)
    # per neuron: spiked in; per spiking neuron: its two row pointers in,
    # last_post out; per synapse of a spiking target: plastic in; per
    # plastic one: last_arr in; per LTP: w in and out
    l_bytes = (H * N + n(st["spiked"]) * (8 + 4) + n(post) + n(post_pl) * 4
               + n(ltp) * 8)
    counts = dict(flagged=n(flags), arrivals=n(arr), ltd=n(ltd),
                  spiking=n(st["spiked"]), synapses_of_spiking=n(post),
                  ltp=n(ltp))
    return {"stdp_arrival_current": (c_bytes, n(ltd) * 25 + n(arr)),
            "stdp_arrival": (a_bytes, n(ltd) * 25),
            "stdp_ltp": (l_bytes, n(ltp) * 25)}, counts


def in_place_ms(fn, restore, calls: int = 20, warmup: int = 3) -> float:
    """Time of one call of a kernel that updates its inputs, in ms: the
    inputs restored before every call, CUDA events around the call alone;
    the median of `calls`."""
    for _ in range(warmup):
        restore()
        fn()
    times = []
    for _ in range(calls):
        restore()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _phase_a_inputs(rng, plan_cpu: dict, st: dict, stim, density: float):
    """numpy-seeded neuron state for the phase-A kernel beside `st`: about
    `density` of the neurons at or past the threshold (they spike), the
    others at rest, and the step's stimulus row `stim` (index, amp)."""
    H, N = plan_cpu["exc"].shape
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))
    v = np.where(rng.random((H, N)) < density, rng.uniform(30.0, 40.0, (H, N)),
                 rng.uniform(-80.0, -60.0, (H, N)))
    return dict(st, v=f(v), u=f(rng.uniform(-20.0, 10.0, (H, N))),
                stim_idx=stim[0].cpu(), stim_amp=stim[1].cpu())


def _phase_a_traffic(plan_cpu: dict, st: dict, spiked, r: int, t: float,
                     half_neg: float, current_bytes: int):
    """(bytes, flops) the phase-A kernel must move and compute on these
    inputs: the fused arrival pass's bytes less i_syn, 19 bytes a neuron
    (v and u in and out, its two flags, the spike out), the stimulus list,
    and LTP of the rows of the neurons that spiked (`spiked`, the plain
    version's): their row pointers and last_post, and per synapse plastic,
    per plastic one last_arr, per update w in and out."""
    plastic, row_ptr = plan_cpu["plastic"], plan_cpu["row_ptr"]
    H, E = plastic.shape
    N = row_ptr.shape[1] - 1
    n = lambda m: int(m.sum())
    row = kref.rows_of_synapses(row_ptr, E)
    post = torch.cat([spiked, spiked.new_zeros(H, 1)], 1).gather(1, row)
    post_pl = post & plastic
    # LTP reads last_arr after the arrival pass set it to t
    la = torch.where(st["ring"][:, r] & plan_cpu["valid"],
                     torch.tensor(np.float32(t)), st["last_arr"])
    ltp = post_pl & (la > half_neg)
    k = st["stim_idx"].shape[1]
    n_bytes = (current_bytes - H * N * 4 + H * N * 19 + H * k * 12 + H * 8
               + n(spiked) * (8 + 4) + n(post) + n(post_pl) * 4 + n(ltp) * 8)
    counts = dict(spiking=n(spiked), synapses_of_spiking=n(post),
                  ltp=n(ltp))
    return n_bytes, n(ltp) * 25 + H * N * 20, counts


def _stdp_rows(plan8, spec8):
    """The STDP passes (phase A in one kernel, the fused arrival and sum,
    the arrival pass alone, LTP) on plan8's own arrays at the main path's
    density (2.15% of the valid synapses arrive, 2.15% of the neurons
    spike) and at 10x it: bit-equal to the plain version on a CPU copy and
    on the card, in every output and updated state tensor, and timed
    alone; phase A also beside the sequence of kernels and ops it replaced
    (`stdp_arrival_current`, the stimulus, the constants, `izhikevich_update`,
    the mask and sum, `stdp_ltp`), and the fused arrival pass beside the
    pair it replaced, each bit-equal to what it replaced."""
    stdp, izh = spec8.stdp, spec8.izh
    H, E = plan8.syn_valid.shape
    N = plan8.gid.shape[1]
    D = spec8.cfg.n_delay_slots
    t = 1000.0
    r = int(t) % D
    half_neg = engine.NEG_TIME / 2
    ltd_kw = dict(a_minus=stdp.a_minus, tau_minus=stdp.tau_minus,
                  w_min=stdp.w_min, w_max=stdp.w_max,
                  neg_time=engine.NEG_TIME)
    ltp_kw = dict(a_plus=stdp.a_plus, tau_plus=stdp.tau_plus,
                  w_min=stdp.w_min, w_max=stdp.w_max,
                  neg_time=engine.NEG_TIME)
    izh_kw = dict(v_peak=izh.v_peak, dt=izh.dt, substeps=izh.v_substeps)
    pa_kw = dict(izh=izh, stdp=stdp, neg_time=engine.NEG_TIME,
                 with_ltp=True)
    pg = dict(valid=plan8.syn_valid, tgt=plan8.syn_tgt,
              plastic=plan8.syn_plastic, row_ptr=plan8.row_ptr,
              exc=plan8.exc_mask, neuron_valid=plan8.neuron_valid)
    pc = {k: v.cpu() for k, v in pg.items()}
    pg["seg"] = kref.make_segments(plan8.row_ptr, E)
    pc["seg"] = kref.make_segments(pc["row_ptr"], E)
    gids = torch.from_numpy(stimulus.stim_table(
        spec8.cfg, plan8.columns.cpu().numpy(), int(t), 1)).cuda()
    stim = stimulus.stim_inputs(spec8.cfg, plan8.columns,
                                engine.make_gid_to_local(spec8,
                                                         plan8.shard_id),
                                gids.to(torch.int64), spec8.n_local)
    stim = (stim[0][0], stim[1][0])
    rng = np.random.default_rng(2015)
    rows, failed = [], []
    for i, (label, density) in enumerate((("main", STDP_DENSITY),
                                          ("10x", 10 * STDP_DENSITY))):
        st = _stdp_state(rng, pc, D, r, t, density)
        traffic, counts = _stdp_traffic(pc, st, r, half_neg)
        st = _phase_a_inputs(np.random.default_rng(2017 + i), pc, st, stim,
                             density)
        saved = {k: v.cuda() for k, v in st.items()}
        work = {k: v.clone() for k, v in saved.items()}

        def restore(*names):
            for k in names:
                src, dst = saved[k], work[k]
                (dst[:, r] if k == "ring" else dst).copy_(
                    src[:, r] if k == "ring" else src)

        def phase_a(impl, d, p):
            spiked, n_arr, n_spk = impl.stdp_phase_a(
                d["ring"], r, p["seg"], *(
                    (p["valid"], p["tgt"]) if impl is kref else ()),
                p["plastic"], p["exc"], p["neuron_valid"], d["stim_idx"],
                d["stim_amp"], d["v"], d["u"], d["last_post"], d["w"],
                d["last_arr"], t, **pa_kw)
            return (spiked, n_arr, n_spk, d["v"], d["u"], d["w"],
                    d["last_arr"], d["last_post"], d["ring"])

        def sequence(d, p):
            # what the engine ran for phase A before the phase-A kernel
            i_syn, n_arr = kstdp.stdp_arrival_current(
                d["ring"], r, p["seg"], p["plastic"], d["last_post"],
                d["w"], d["last_arr"], t, **ltd_kw)
            i_tot = i_syn + kref.stim_current(d["stim_idx"], d["stim_amp"],
                                              N)
            a, b, c, dd = kref.izh_coefficients(p["exc"], izh)
            v, u, spiked = kizh.izhikevich_update(d["v"], d["u"], i_tot, a,
                                                  b, c, dd, **izh_kw)
            spiked = spiked & p["neuron_valid"]
            n_spk = spiked.sum(1)
            kstdp.stdp_ltp(spiked, p["row_ptr"], p["plastic"],
                           d["last_arr"], d["w"], d["last_post"], t,
                           **ltp_kw)
            return (spiked, n_arr, n_spk, v, u, d["w"], d["last_arr"],
                    d["last_post"], d["ring"])

        def stim_ops():
            return kref.stim_current(work["stim_idx"], work["stim_amp"], N)

        def no_ltp(d, p):
            return kstdp.stdp_phase_a(
                d["ring"], r, p["seg"], p["plastic"], p["exc"],
                p["neuron_valid"], d["stim_idx"], d["stim_amp"], d["v"],
                d["u"], d["last_post"], d["w"], d["last_arr"], t,
                **dict(pa_kw, with_ltp=False))

        def split(d, p):
            # the split schedule: phase A without LTP, then the LTP kernel
            spiked, n_arr, n_spk = no_ltp(d, p)
            kstdp.stdp_ltp(spiked, p["row_ptr"], p["plastic"],
                           d["last_arr"], d["w"], d["last_post"], t,
                           **ltp_kw)
            return (spiked, n_arr, n_spk, d["v"], d["u"], d["w"],
                    d["last_arr"], d["last_post"], d["ring"])

        def current(impl, d, p):
            if impl is kstdp:
                i_syn, n_arr = kstdp.stdp_arrival_current(
                    d["ring"], r, p["seg"], p["plastic"], d["last_post"],
                    d["w"], d["last_arr"], t, **ltd_kw)
            else:
                i_syn, n_arr = kref.stdp_arrival_current(
                    d["ring"], r, p["seg"], p["valid"], p["tgt"],
                    p["plastic"], d["last_post"], d["w"], d["last_arr"], t,
                    **ltd_kw)
            return i_syn, n_arr, d["w"], d["last_arr"], d["ring"]

        def pair(d, p):
            # the kernels the fused one replaced, on the same inputs
            contrib, n_arr = kstdp.stdp_arrival(
                d["ring"], r, p["valid"], p["tgt"], p["plastic"],
                d["last_post"], d["w"], d["last_arr"], t, **ltd_kw)
            i_syn = kseg.segment_sum_ordered(contrib, p["seg"])
            return i_syn, n_arr, d["w"], d["last_arr"], d["ring"]

        def arrival(impl, d, p):
            contrib, n_arr = impl.stdp_arrival(
                d["ring"], r, p["valid"], p["tgt"], p["plastic"],
                d["last_post"], d["w"], d["last_arr"], t, **ltd_kw)
            return contrib, n_arr, d["w"], d["last_arr"], d["ring"]

        def ltp(impl, d, p):
            impl.stdp_ltp(d["spiked"], p["row_ptr"], p["plastic"],
                          d["last_arr"], d["w"], d["last_post"], t, **ltp_kw)
            return d["w"], d["last_post"]

        for name, fn, state in (
                ("stdp_phase_a", phase_a,
                 ("ring", "w", "last_arr", "v", "u", "last_post")),
                ("stdp_arrival_current", current, ("ring", "w", "last_arr")),
                ("stdp_arrival", arrival, ("ring", "w", "last_arr")),
                ("stdp_ltp", ltp, ("w", "last_post"))):
            restore(*saved)
            got = [x.clone() for x in fn(kstdp, work, pg)]
            torch.cuda.synchronize()
            cpu = {k: v.clone() for k, v in st.items()}
            with kref.flush_denormal():
                want = fn(kref, cpu, pc)
            restore(*state)
            want_gpu = fn(kref, work, pg)
            equal = all(bit_equal(a, b) and bit_equal(a, c)
                        for a, b, c in zip(got, want, want_gpu))
            err = max(max(max_abs_err(a, b), max_abs_err(a, c))
                      for a, b, c in zip(got, want, want_gpu))
            again = lambda: restore(*state)
            extra, shape = {}, dict(counts)
            n_bytes, n_flops = traffic.get(name, (None, None))
            if name == "stdp_phase_a":
                n_bytes, n_flops, spiking = _phase_a_traffic(
                    pc, st, want[0], r, t, half_neg,
                    traffic["stdp_arrival_current"][0])
                shape.update(spiking, stim_entries=int(
                    st["stim_idx"].numel()))
                again()
                equal &= all(bit_equal(a, b) for a, b in
                             zip(got, sequence(work, pg)))
                extra = dict(
                    replaced="stdp_arrival_current (row_kernel<false>), "
                             "stim_current, the add, a, b, c, d from 8 "
                             "constants, izhikevich_update, & "
                             "neuron_valid, the spike sum, stdp_ltp",
                    replaced_ms=in_place_ms(lambda: sequence(work, pg),
                                            again),
                    replaced_device_ms=device_ms(lambda: sequence(work, pg),
                                                 restore=again),
                    replaced_device_ops=device_ops(lambda: sequence(work, pg),
                                                   again),
                    no_ltp_device_ms=device_ms(
                        lambda: no_ltp(work, pg), restore=again,
                        kernel=STDP_KERNEL_NAMES[name]),
                    split_device_ms=device_ms(
                        lambda: split(work, pg), restore=again,
                        kernel=(STDP_KERNEL_NAMES[name], "ltp_kernel")),
                    # the stimulus: the kernel's own test of the list
                    # (against an empty list), and the two ops that would
                    # sum it outside (zeros, then scatter_add_)
                    no_stimulus_device_ms=device_ms(
                        lambda: phase_a(kstdp, dict(
                            work, stim_idx=work["stim_idx"][:, :0],
                            stim_amp=work["stim_amp"][:, :0]), pg),
                        restore=again, kernel=STDP_KERNEL_NAMES[name]),
                    stim_current_ms=cuda_ms(stim_ops),
                    stim_current_device_ms=device_ms(stim_ops))
                again()
                equal &= all(bit_equal(a, b) for a, b in
                             zip(got, split(work, pg)))
                # t as the path reads it (the step counter, r = t mod D,
                # the stimulus a window) against t and r as launch
                # arguments, in turns: the same bits, and each form's
                # device time twice
                ctr = torch.tensor([int(t), 0], dtype=torch.int64,
                                   device="cuda")
                counter = lambda: kstdp.stdp_phase_a(
                    work["ring"], None, pg["seg"], pg["plastic"], pg["exc"],
                    pg["neuron_valid"], work["stim_idx"][None],
                    work["stim_amp"][None], work["v"], work["u"],
                    work["last_post"], work["w"], work["last_arr"], ctr,
                    **pa_kw)
                again()
                equal &= all(bit_equal(a, b) for a, b in zip(
                    got, (*counter(), work["v"], work["u"], work["w"],
                          work["last_arr"], work["last_post"],
                          work["ring"])))
                args = lambda: phase_a(kstdp, work, pg)
                forms = {"t_argument": [], "step_counter": []}
                for _ in range(2):
                    for form, call in (("t_argument", args),
                                       ("step_counter", counter)):
                        forms[form].append(device_ms(
                            call, restore=again,
                            kernel=STDP_KERNEL_NAMES[name]))
                extra.update({f"{k}_device_ms": v for k, v in forms.items()})
            if name == "stdp_arrival_current":
                again()
                equal &= all(bit_equal(a, b) for a, b in
                             zip(got, pair(work, pg)))
                extra = dict(
                    pair="stdp_arrival (arrival_kernel) then "
                         "segment_sum_ordered (segment_sum_kernel)",
                    pair_ms=in_place_ms(lambda: pair(work, pg), again),
                    pair_device_ms=device_ms(
                        lambda: pair(work, pg), restore=again,
                        kernel=("arrival_kernel", "segment_sum_kernel")))
            if not equal:
                failed.append(f"{name} ({label})")
            bms, by = bound(n_bytes, n_flops)
            launch = lambda: fn(kstdp, work, pg)
            rows.append(dict(
                name=name, route="cuda", source="src/repro_torch/csrc/stdp.cu",
                replaces=STDP_REPLACES[name], launches=None,
                max_abs_err=err, ms=in_place_ms(launch, again),
                device_ms=device_ms(launch, restore=again,
                                    kernel=STDP_KERNEL_NAMES[name]),
                plain_ms=in_place_ms(lambda: fn(kref, work, pg), again,
                                     calls=3, warmup=1),
                bound_ms=bms, bound_by=by, library_ms=None, equal=equal,
                tolerance="bit-equal (every output and updated state "
                          "tensor, 0 ulp), to the plain version on a CPU "
                          "copy and on the card",
                density=label, bytes=n_bytes, flops=n_flops,
                shape={"H": H, "E": E, "D": D, "N": N, **shape}, **extra))
        del saved, work
    return rows, failed


def device_ops(fn, restore, calls: int = 10) -> float:
    """Device operations (kernels and copies, torch.profiler) per call of
    fn, the device-to-device copies of `restore()` left out."""
    from torch.profiler import ProfilerActivity, profile
    restore()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            restore()
            fn()
        torch.cuda.synchronize()
    return sum(c for k, _, c in device_kernel_events(prof)
               if "Memcpy DtoD" not in k) / calls


def _replaced_phase_b(ring, spiked_src, syn_src, syn_delay, syn_valid, t):
    """The port's phase B before the arborize kernel, on the same inputs:
    gather by syn_src, `torch.nonzero` (which waits for the device to size
    its output), the slots, an index put."""
    D = ring.shape[1]
    active = torch.gather(spiked_src, 1, syn_src) & syn_valid
    h, e = torch.nonzero(active, as_tuple=True)
    slot = torch.remainder(syn_delay[h, e] + t, D).to(torch.int64)
    ring[h, slot, e] = True
    return ring


def _arborize_rows(plan8, spec8):
    """Phase B's kernel (`arborize`, source-major over the plan's forward
    CSR, element-major where a sample shows 18% or more of the sources
    spiking: `walk`) on plan8's own tables, with the sources spiking at
    the main path's share (2.15%) and at 5x, 10x and 20x it, at a t whose
    slots wrap:
    bit-equal to its plain version (the reference's broadcast-compare) on
    a CPU copy and on the card, to the element-major kernel it replaced
    (`arborize_elements`) and to the sequence before that; an all-False
    spike mask at t = -1 (the pipelined schedule's prologue) sets nothing.
    Timed beside its bound, the element-major kernel and the replaced
    sequence, on the same inputs.  Setting flags that are set changes
    nothing, so the calls need no restore between them."""
    H, E = plan8.syn_valid.shape
    S = plan8.src_gid.shape[1]
    D = spec8.cfg.n_delay_slots
    t = 1003                           # t mod D = 5: most slots wrap
    tables = (plan8.syn_src, plan8.syn_delay, plan8.syn_valid)
    csr = (plan8.fwd_ptr, plan8.fwd_ids, plan8.fwd_delay)
    tables_cpu = tuple(x.cpu() for x in tables)
    n_valid = int(plan8.syn_valid.sum())
    rng = np.random.default_rng(2019)
    ring0 = torch.from_numpy(rng.random((H, D, E), dtype=np.float32)
                             < STDP_DENSITY) & tables_cpu[2][:, None]
    rows, failed = [], []
    for label, density in (("main", STDP_DENSITY), ("5x", 5 * STDP_DENSITY),
                           ("10x", 10 * STDP_DENSITY),
                           ("20x", 20 * STDP_DENSITY)):
        spiked_cpu = torch.from_numpy(rng.random((H, S)) < density)
        spiked = spiked_cpu.cuda()
        ring = ring0.cuda()
        got = karb.arborize(ring, spiked, *tables, *csr, t).clone()
        torch.cuda.synchronize()
        want = kref.arborize(ring0.clone(), spiked_cpu, *tables_cpu, t)
        want_gpu = kref.arborize(ring0.cuda(), spiked, *tables, t)
        elements = karb.arborize_elements(ring0.cuda(), spiked, *tables, t)
        replaced = _replaced_phase_b(ring0.cuda(), spiked, *tables, t)
        silent = karb.arborize(ring0.cuda(), torch.zeros_like(spiked),
                               *tables, *csr, -1)
        equal = (bit_equal(got, want) and bit_equal(got, want_gpu)
                 and bit_equal(got, elements) and bit_equal(got, replaced)
                 and bit_equal(silent, ring0))
        if not equal:
            failed.append(f"arborize ({label})")
        err = max(max_abs_err(got, want), max_abs_err(got, want_gpu))
        del want, want_gpu, elements, replaced, silent
        n_active = int((torch.gather(spiked, 1, plan8.syn_src)
                        & plan8.syn_valid).sum())
        n_spiking = int(spiked_cpu.sum())
        # what the work needs: the spike flags once, the two row pointers
        # of each spiking source, and per synapse it sets its id and delay
        # in (int32 each) and its flag out
        n_bytes = H * S + n_spiking * 8 + n_active * (4 + 4 + 1)
        bms, by = bound(n_bytes, 0)
        # the same with each flag's store counted as the 32-B sector it
        # lands in; and the element-major design's bound (every valid flag
        # and int64 source, the spike flags, the active delays and flags)
        sector_bytes = H * S + n_spiking * 8 + n_active * (4 + 4 + 32)
        element_bytes = H * E + n_valid * 8 + H * S + n_active * (4 + 1)
        launch = lambda: karb.arborize(ring, spiked, *tables, *csr, t)
        old = lambda: karb.arborize_elements(ring, spiked, *tables, t)
        seq = lambda: _replaced_phase_b(ring, spiked, *tables, t)
        rows.append(dict(
            name="arborize", route="cuda",
            source="src/repro_torch/csrc/arborize.cu",
            replaces="src/repro/core/engine.py:315", launches=None,
            max_abs_err=err, ms=cuda_ms(launch),
            device_ms=device_ms(launch, kernel="arborize_rows"),
            plain_ms=cuda_ms(lambda: kref.arborize(ring, spiked, *tables, t),
                             calls=3),
            bound_ms=bms, bound_by=by,
            bound_note="the bytes the work needs: spike flags, two row "
                       "pointers a spiking source, 4 + 4 B in and a 1-B "
                       "flag out a synapse set",
            sector_bound_ms=bound(sector_bytes, 0)[0],
            element_major_bound_ms=bound(element_bytes, 0)[0],
            element_major_ms=cuda_ms(old),
            element_major_device_ms=device_ms(old,
                                              kernel="arborize_elements"),
            device_ms_again=device_ms(launch, kernel="arborize_rows"),
            library_ms=None,
            library_note="no single PyTorch call does phase B; the "
                         "sequence the element-major kernel replaced is in "
                         "replaced_*",
            replaced="gather by syn_src, & syn_valid, torch.nonzero (a host "
                     "synchronisation), the slots, an index put",
            replaced_ms=cuda_ms(seq, calls=5),
            replaced_device_ms=device_ms(seq),
            replaced_device_ops=device_ops(seq, lambda: None),
            equal=equal,
            tolerance="bit-equal (every flag of the ring), to the plain "
                      "version on a CPU copy and on the card, to the "
                      "element-major kernel and to the sequence before it; "
                      "an all-False mask at t = -1 sets nothing",
            walk=("element-major" if karb.walks_elements(spiked_cpu)[0]
                  else "source-major"),
            density=label, bytes=n_bytes, sector_bytes=sector_bytes,
            element_major_bytes=element_bytes, flops=0,
            shape={"H": H, "E": E, "D": D, "S": S, "t": t,
                   "valid": n_valid, "active": n_active,
                   "spiking_sources": n_spiking}))
        del ring, spiked
    return rows, failed


def _event_state(rng, plan_cpu, t: int, density: float, cap: int, D: int):
    """numpy-seeded event state on a plan's arrays (CPU tensors): ring slot
    t mod D listing `density` of each shard's valid synapses in random
    order (the other slots a third of that, as lists phase B left), each
    synapse at most once a slot; weights in [0, 10]; last spike and
    arrival times within 200 steps or never; sat 0."""
    valid = plan_cpu["valid"]
    H, E = valid.shape
    N = plan_cpu["row_ptr"].shape[1] - 1
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))

    def times(shape):
        return f(np.where(rng.random(shape) < 0.7,
                          rng.uniform(t - 200.0, t, shape), engine.NEG_TIME))
    ring = np.full((H, D, cap), -1, np.int32)
    count = np.zeros((H, D), np.int32)
    for h in range(H):
        nv = int(valid[h].sum())
        for d in range(D):
            k = min(cap, int((density if d == t % D else density / 3) * nv))
            ring[h, d, :k] = rng.permutation(nv)[:k]
            count[h, d] = k
    return dict(ev_ring=torch.from_numpy(ring),
                ev_count=torch.from_numpy(count), w=f(rng.uniform(
                    0.0, 10.0, (H, E))), last_post=times((H, N)),
                last_arr=times((H, E)),
                sat=torch.zeros(H, dtype=torch.int32))


def _event_rows(sp8e, lookup):
    """The event ops on the 8x8 event plan's own tables (the plan's
    targets, delays and CSR rows, the EventPlan's forward rows) with the
    ring, spikes and sources drawn at the main path's density (2.15%) and
    at 10x it: each bit-equal to its plain version on a CPU copy and on
    the card in every output and updated state tensor, timed alone on
    restored inputs beside its bound, its plain version and, for the
    arrivals' sum, `index_add_` (atomics, not ordered).  The spike lists
    are compacted with the timed run's capacities (`sp8e.caps`, c_post =
    N and c_src = S, `event_engine.no_drop_caps`), so the main rows run
    at the main path's sizes; a third row at 10x compacts with the
    default caps (c_post N / 2, c_src S / 8), which the sources overflow,
    so that `sat` counts the dropped spikes.  `lookup` is `phase_build`'s
    (kept, other, library): the arrivals built with the other target
    lookup are held to the same bits and timed in the first two rows."""
    spec, plan, eplan = sp8e.spec, sp8e.plan, sp8e.eplan
    stdp = spec.stdp
    H, E = plan.syn_valid.shape
    N, S = plan.gid.shape[1], plan.src_gid.shape[1]
    D = spec.cfg.n_delay_slots
    cap = sp8e.cap_ev
    caps = (sp8e.caps["c_post"], sp8e.caps["c_src"])
    t = 1003
    r = t % D
    ltd_kw = dict(a_minus=stdp.a_minus, tau_minus=stdp.tau_minus,
                  w_min=stdp.w_min, w_max=stdp.w_max,
                  neg_time=engine.NEG_TIME)
    ltp_kw = dict(a_plus=stdp.a_plus, tau_plus=stdp.tau_plus,
                  w_min=stdp.w_min, w_max=stdp.w_max,
                  neg_time=engine.NEG_TIME)
    pg = dict(valid=plan.syn_valid, tgt=plan.syn_tgt,
              plastic=plan.syn_plastic, row_ptr=plan.row_ptr,
              delay=plan.syn_delay, fwd=eplan.fwd_rows)
    pc = {k: v.cpu() for k, v in pg.items()}
    rng = np.random.default_rng(2021)
    half_neg = engine.NEG_TIME / 2
    rows, failed = [], []
    izh = spec.izh
    coeffs = kref.izh_coefficients(plan.exc_mask, izh)
    window = engine.StimWindow(spec, plan, t, 1)        # [1, H, C*K]
    ctr = torch.tensor([t, 0], dtype=torch.int64, device="cuda")
    pg.update(exc=plan.exc_mask, neuron_valid=plan.neuron_valid)
    pc.update(exc=pg["exc"].cpu(), neuron_valid=pg["neuron_valid"].cpu())
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))
    for label, density, (c_post, c_src) in (
            ("main", STDP_DENSITY, caps),
            ("10x", 10 * STDP_DENSITY, caps),
            ("10x_small_caps", 10 * STDP_DENSITY,
             (SMALL_C_POST, event_engine.default_caps(spec)[1]))):
        st = _event_state(rng, pc, t, density, cap, D)
        st["spiked"] = torch.from_numpy(rng.random((H, N)) < density)
        st["spiked_src"] = torch.from_numpy(rng.random((H, S)) < density)
        # the LTP's list, as event_compact lists the spikes
        st["post_count"], st["post_ids"] = kref.event_compact(
            st["spiked"], st["last_post"].clone(), st["sat"].clone(), t,
            c_post=c_post)
        ids, drop = aer.compact_indices(st["spiked"], c_post, fill=N)
        st["rows_ids"], st["rows_drop"] = ids.contiguous(), drop
        ids, drop = aer.compact_indices(st["spiked_src"], c_src, fill=S)
        st["src_ids"], st["src_drop"] = ids.contiguous(), drop
        # the neuron pass's: about `density` of the neurons at or past the
        # threshold, the others at rest, the arrivals' current, the step's
        # stimulus
        st["i_syn"] = f(rng.uniform(-5.0, 20.0, (H, N)))
        st["v"] = f(np.where(rng.random((H, N)) < density,
                             rng.uniform(30.0, 40.0, (H, N)),
                             rng.uniform(-80.0, -60.0, (H, N))))
        st["u"] = f(rng.uniform(-20.0, 10.0, (H, N)))
        st["stim_idx"], st["stim_amp"] = (window.index.cpu(),
                                          window.amp.cpu())
        saved = {k: v.cuda() for k, v in st.items()}
        work = {k: v.clone() for k, v in saved.items()}

        def restore(*names):
            for k in names:
                work[k].copy_(saved[k])

        def arrival(impl, d, p):
            if impl is kref:
                i_syn, n = kref.event_arrival(
                    d["ev_ring"], d["ev_count"], r, p["tgt"], p["plastic"],
                    d["last_post"], d["w"], d["last_arr"], t, **ltd_kw)
            else:
                i_syn, n = kev.event_arrival(
                    d["ev_ring"], d["ev_count"], p["tgt"], p["row_ptr"],
                    p["plastic"], d["last_post"], d["w"], d["last_arr"], t,
                    **ltd_kw)
            return (i_syn, n, d["w"], d["last_arr"], d["ev_ring"],
                    d["ev_count"])

        def neurons(impl, d, p):
            # the kernel as the path calls it: t and the stimulus row from
            # the step counter, the stimulus a window
            step, k = (ctr, slice(None)) if impl is kev else (t, 0)
            out = impl.event_neurons(
                d["i_syn"], d["stim_idx"][k], d["stim_amp"][k], p["exc"],
                p["neuron_valid"], d["v"], d["u"], d["last_post"], d["sat"],
                step, izh=izh, c_post=c_post)
            return (*out, d["v"], d["u"], d["last_post"], d["sat"])

        def ltp(impl, d, p):
            impl.event_ltp(d["post_ids"], d["post_count"], p["row_ptr"],
                           p["plastic"], d["last_arr"], d["w"], t, **ltp_kw)
            return (d["w"],)

        def emit(impl, d, p):
            impl.event_emit(d["src_ids"], d["src_drop"], p["fwd"],
                            p["delay"], d["ev_ring"], d["ev_count"],
                            d["sat"], t)
            return d["ev_ring"], d["ev_count"], d["sat"]

        # what each op must move on these inputs (csrc/event.cu's note)
        n = lambda m: int(m.sum())
        ev = st["ev_ring"][:, r]
        listed = ev >= 0
        eve = torch.clamp(ev, min=0).to(torch.int64)
        tgt_ev = torch.gather(pc["tgt"], 1, eve)
        plast_ev = torch.gather(pc["plastic"], 1, eve) & listed
        ltd = plast_ev & (torch.gather(st["last_post"], 1, tgt_ev)
                          > half_neg)
        n_ev = n(listed)
        # per event: its list entry in and cleared, its target (syn_tgt's
        # 8 B where the kernel reads it), plastic, w in, last_arr out; per
        # LTD w out; per neuron last_post in, row pointers in and i_syn
        # out; the counts
        tgt_bytes = 8 if lookup[0] == 0 else 0
        a_bytes = (n_ev * (4 + 4 + tgt_bytes + 1 + 4 + 4) + n(ltd) * 4
                   + H * N * (4 + 4) + H * (N + 1) * 4 + H * D * 4 + H * 8)
        post_ids = st["post_ids"]
        listed_n = torch.zeros((H, N + 1), dtype=torch.bool).scatter_(
            1, post_ids.to(torch.int64), True)[:, :N]
        row = kref.rows_of_synapses(pc["row_ptr"], E)
        post = torch.cat([listed_n, listed_n.new_zeros(H, 1)],
                         1).gather(1, row)
        post_pl = post & pc["plastic"]
        ltp_n = post_pl & (st["last_arr"] > half_neg)
        # per listed neuron its list entry and its row's two pointers;
        # per synapse of a listed one plastic, per plastic one last_arr,
        # per LTP w in / out; the counts
        l_bytes = (n(listed_n) * (4 + 4 + 4) + n(post) + n(post_pl) * 4
                   + n(ltp_n) * 8 + H * 8)
        src_ids = st["src_ids"]
        ok = src_ids < S
        fwd = torch.gather(pc["fwd"], 1, torch.clamp(
            src_ids, max=S - 1).to(torch.int64)[:, :, None].expand(
            -1, -1, pc["fwd"].shape[2]))
        emitted = n((fwd >= 0) & ok[:, :, None])
        # the list; per emitted event its row entry and delay in and its
        # id out; the counts and sat
        e_bytes = src_ids.numel() * 4 + emitted * (4 + 4 + 4) + H * D * 8
        traffic = {"event_arrival": (a_bytes, n_ev + n(ltd) * 25),
                   "event_neurons": None,       # from the plain output
                   "event_ltp": (l_bytes, n(ltp_n) * 25),
                   "event_emit": (e_bytes, 0)}
        shape = dict(H=H, E=E, N=N, S=S, D=D, cap_ev=cap, t=t,
                     c_post=c_post, c_src=c_src,
                     events=n_ev, ltd=n(ltd), spiking=n(st["spiked"]),
                     listed_neurons=n(listed_n), ltp=n(ltp_n),
                     spiking_sources=n(st["spiked_src"]),
                     listed_sources=n(ok), emitted=emitted)
        # index_add_'s operands: each event's flat target and weight
        lib_tgt = (tgt_ev + torch.arange(H)[:, None] * N)[listed].cuda()
        lib_w = torch.gather(st["w"], 1, eve)[listed].cuda()
        library = lambda: torch.zeros(H * N, device="cuda").index_add_(
            0, lib_tgt, lib_w)
        for name, fn, state in (
                ("event_arrival", arrival,
                 ("ev_ring", "ev_count", "w", "last_arr")),
                ("event_neurons", neurons, ("v", "u", "last_post", "sat")),
                ("event_ltp", ltp, ("w",)),
                ("event_emit", emit, ("ev_ring", "ev_count", "sat"))):
            restore(*saved)
            got = [x.clone() for x in fn(kev, work, pg)]
            torch.cuda.synchronize()
            cpu = {k: v.clone() for k, v in st.items()}
            with kref.flush_denormal():
                want = fn(kref, cpu, pc)
            restore(*state)
            want_gpu = fn(kref, work, pg)
            equal = all(bit_equal(a, b) and bit_equal(a, c)
                        for a, b, c in zip(got, want, want_gpu))
            err = max(max(max_abs_err(a, b), max_abs_err(a, c))
                      for a, b, c in zip(got, want, want_gpu))
            if not equal:
                failed.append(f"{name} ({label})")
            again = lambda: restore(*state)
            if name == "event_neurons":
                # per neuron v and u in and out, i_syn, its two flags, the
                # spike; per spiking one last_post; the list (the fill
                # too), the stimulus list, the counts and sat
                spiking = n(want[0])
                traffic[name] = (
                    H * N * (16 + 4 + 2 + 1) + spiking * 4
                    + H * c_post * 4
                    + nbytes(window.index[0], window.amp[0]) + H * 12,
                    H * N * 20)
                shape = dict(shape, neuron_spikes=spiking,
                             neuron_listed=n(want[2] < N),
                             neuron_sat=want[-1].tolist(),
                             stim_entries=int(window.index[0].numel()))
            n_bytes, n_flops = traffic[name]
            bms, by = bound(n_bytes, n_flops)
            launch = lambda: fn(kev, work, pg)
            rows.append(dict(
                name=name, route="cuda", source=EVENT_SOURCES[name],
                replaces=EVENT_REPLACES[name], launches=None,
                max_abs_err=err, ms=in_place_ms(launch, again),
                device_ms=device_ms(launch, restore=again,
                                    kernel=EVENT_KERNEL_NAMES[name]),
                device_ops=device_ops(launch, again),
                plain_ms=in_place_ms(lambda: fn(kref, work, pg), again,
                                     calls=3, warmup=1),
                bound_ms=bms, bound_by=by,
                library_ms=(cuda_ms(library) if name == "event_arrival"
                            else None),
                library_note=("index_add_ of the events' weights by target "
                              "(atomics, not in list order)"
                              if name == "event_arrival" else
                              "no single PyTorch call does this"),
                equal=equal,
                tolerance="bit-equal (every output and updated state "
                          "tensor, 0 ulp), to the plain version on a CPU "
                          "copy and on the card",
                density=label, bytes=n_bytes, flops=n_flops, shape=shape))
            if name == "event_arrival":
                # the op's accesses at its events' random synapses alone
                # (w and plastic gathered, last_arr written), as PyTorch
                # indexing calls on the same restored inputs
                syn = (eve + torch.arange(H)[:, None] * E)[listed].cuda()

                def touch():
                    work["w"].view(-1).index_select(0, syn)
                    pg["plastic"].view(-1).index_select(0, syn)
                    work["last_arr"].view(-1).index_fill_(0, syn, float(t))
                rows[-1].update(
                    target_lookup=ARRIVAL_TARGETS[lookup[0]],
                    place_device_ms=device_ms(
                        launch, restore=again, kernel="arrival_place"),
                    synapse_access_device_ms=device_ms(touch, restore=again))
            if name == "event_arrival" and label != "10x_small_caps":
                # the op built with the other target lookup: the same bits,
                # timed on the same restored inputs
                def alt():
                    with _kernel_library(lookup[2]):
                        return launch()
                restore(*state)
                alt_equal = all(bit_equal(a, b) for a, b in zip(alt(), got))
                if not alt_equal:
                    failed.append(f"{name} target from "
                                  f"{ARRIVAL_TARGETS[lookup[1]]} ({label})")
                rows[-1].update(
                    other_lookup=ARRIVAL_TARGETS[lookup[1]],
                    other_lookup_equal=alt_equal,
                    other_lookup_device_ms=device_ms(
                        alt, restore=again, kernel=EVENT_KERNEL_NAMES[name]),
                    other_lookup_place_device_ms=device_ms(
                        alt, restore=again, kernel="arrival_place"))
            if name == "event_neurons":
                def sequence():
                    # what the event path ran from i_syn to the list before
                    # the neuron pass (`event_engine.phase_a`)
                    row = ctr[1:]
                    i_ext = kref.stim_current(
                        work["stim_idx"].index_select(0, row)[0],
                        work["stim_amp"].index_select(0, row)[0], N)
                    v, u, spiked = kizh.izhikevich_update(
                        work["v"], work["u"], work["i_syn"] + i_ext, *coeffs,
                        v_peak=izh.v_peak, dt=izh.dt,
                        substeps=izh.v_substeps)
                    work["v"].copy_(v)
                    work["u"].copy_(u)
                    spiked = spiked & pg["neuron_valid"]
                    count = spiked.sum(1)
                    ids, drop = aer.compact_indices(spiked, c_post, fill=N)
                    return spiked, count, ids.contiguous(), drop

                def tail():
                    # from i_syn to the end of LTP: the neuron pass, LTP
                    out = neurons(kev, work, pg)
                    kev.event_ltp(out[2], out[1], pg["row_ptr"],
                                  pg["plastic"], work["last_arr"], work["w"],
                                  ctr, **ltp_kw)
                    return (out[0], work["v"], work["u"], work["w"],
                            work["last_post"], work["sat"])

                def replaced_tail():
                    spiked, count, ids, drop = sequence()
                    kev.event_ltp_rows(ids, drop, spiked, pg["row_ptr"],
                                       pg["plastic"], work["last_arr"],
                                       work["w"], work["last_post"],
                                       work["sat"], ctr, **ltp_kw)
                    return (spiked, work["v"], work["u"], work["w"],
                            work["last_post"], work["sat"])
                again()
                seq = sequence()
                seq_equal = all(bit_equal(a, b) for a, b in zip(
                    seq[:3] + (work["v"], work["u"]),
                    tuple(got[:3]) + (got[3], got[4])))
                tail_state = state + ("w",)
                again_tail = lambda: restore(*tail_state)
                again_tail()
                a = [x.clone() for x in tail()]
                again_tail()
                tail_equal = all(bit_equal(x, y)
                                 for x, y in zip(a, replaced_tail()))
                if not (seq_equal and tail_equal):
                    failed.append(f"{name} against what it replaced "
                                  f"({label})")
                rows[-1].update(
                    replaced="index_select x2 (the window's row), "
                             "stim_current (zeros, scatter_add_), the add, "
                             "izhikevich_update, copy_ x2, & neuron_valid, "
                             "the spike sum, compact_indices, contiguous",
                    replaced_equal=seq_equal,
                    replaced_ms=in_place_ms(sequence, again),
                    replaced_device_ms=device_ms(sequence, restore=again),
                    replaced_device_ops=device_ops(sequence, again),
                    tail="event_neurons then event_ltp: phase A from i_syn "
                         "to the end of LTP",
                    replaced_tail="the replaced sequence then "
                                  "event_ltp_rows (last_post, sat, LTP)",
                    tail_equal=tail_equal,
                    tail_ms=in_place_ms(tail, again_tail),
                    tail_device_ms=device_ms(tail, restore=again_tail),
                    tail_device_ops=device_ops(tail, again_tail),
                    replaced_tail_ms=in_place_ms(replaced_tail, again_tail),
                    replaced_tail_device_ms=device_ms(replaced_tail,
                                                      restore=again_tail),
                    replaced_tail_device_ops=device_ops(replaced_tail,
                                                        again_tail))
            if name == "event_ltp":
                # what does the LTP's work now (event_compact, then
                # event_ltp) against its plain versions on a CPU copy and
                # on the card, and the kernel it replaced (a warp a listed
                # row; it also set last_post and sat), on the same inputs
                rows_state = ("w", "last_post", "sat")
                again_rows = lambda: restore(*rows_state)

                def compact_ltp_with(impl, d, p):
                    count, ids = impl.event_compact(
                        d["spiked"], d["last_post"], d["sat"], t,
                        c_post=c_post)
                    impl.event_ltp(ids, count, p["row_ptr"], p["plastic"],
                                   d["last_arr"], d["w"], t, **ltp_kw)
                    return count, ids, d["w"], d["last_post"], d["sat"]

                def rows_kernel():
                    kev.event_ltp_rows(work["rows_ids"], work["rows_drop"],
                                       work["spiked"], pg["row_ptr"],
                                       pg["plastic"], work["last_arr"],
                                       work["w"], work["last_post"],
                                       work["sat"], t, **ltp_kw)
                    return work["w"], work["last_post"], work["sat"]

                compact_ltp = lambda: compact_ltp_with(kev, work, pg)
                again_rows()
                a = [x.clone() for x in rows_kernel()]
                again_rows()
                b = [x.clone() for x in compact_ltp()]
                cpu = {k: v.clone() for k, v in st.items()}
                with kref.flush_denormal():
                    want_cl = compact_ltp_with(kref, cpu, pc)
                again_rows()
                want_cl_gpu = compact_ltp_with(kref, work, pg)
                compact_equal = all(
                    bit_equal(x, y) and bit_equal(x, z)
                    for x, y, z in zip(b, want_cl, want_cl_gpu))
                if not compact_equal:
                    failed.append(f"{name} event_compact then event_ltp "
                                  f"against the plain versions ({label})")
                rows_equal = (all(bit_equal(x, y) for x, y in zip(a, b[2:]))
                              and bit_equal(b[2], got[0]))
                if not rows_equal:
                    failed.append(f"{name} against event_ltp_rows ({label})")
                rows[-1].update(
                    compact_and_ltp_equal=compact_equal,
                    compact_and_ltp_max_abs_err=max(
                        max(max_abs_err(x, y), max_abs_err(x, z))
                        for x, y, z in zip(b, want_cl, want_cl_gpu)),
                    rows_kernel="event_ltp_rows (csrc/stdp.cu::"
                                "event_ltp_kernel: a warp a "
                                "listed row; last_post and sat)",
                    rows_kernel_equal=rows_equal,
                    rows_kernel_device_ms=device_ms(
                        rows_kernel, restore=again_rows,
                        kernel=EVENT_KERNEL_NAMES["event_ltp_rows"]),
                    compact_and_ltp_device_ms=device_ms(
                        compact_ltp, restore=again_rows,
                        kernel=("neuron_scan", "ltp_synapses")),
                    compact_device_ms=device_ms(
                        compact_ltp, restore=again_rows,
                        kernel="neuron_scan"))
            if name == "event_emit":
                # its loads at random synapses alone: each emitted event's
                # delay, as one PyTorch indexing call on restored inputs
                hh = torch.arange(H)[:, None, None].expand_as(fwd)
                dsyn = (fwd.to(torch.int64) + hh * E)[
                    (fwd >= 0) & ok[:, :, None]].cuda()
                rows[-1]["delay_access_device_ms"] = device_ms(
                    lambda: pg["delay"].view(-1).index_select(0, dsyn),
                    restore=again)
        del saved, work
    return rows, failed


def _event_emit_long_rings():
    """`event_emit` on rings of 21 and 40 slots (delay_max 20 and 39; the
    kernel scans 16 slots a pass): a 2x2 event plan at full width (800,000
    synapses), ring slots listing a share of the valid synapses as phase B
    left them, 2.15% of the sources spiking, all listed (c_src = S):
    bit-equal to its plain version on a CPU copy and on the card in ring,
    counts and sat, timed beside its bound and its plain version."""
    rows, failed = [], []
    rng = np.random.default_rng(2023)
    for label, delay_max in (("d21", 20), ("d40", 39)):
        sp = StepProgram(GridConfig(grid_x=2, grid_y=2, delay_max=delay_max),
                         EngineConfig(delivery="event"), device="cuda")
        plan, eplan = sp.plan, sp.eplan
        H, E = plan.syn_valid.shape
        S = plan.src_gid.shape[1]
        D, cap, t = sp.spec.cfg.n_delay_slots, sp.cap_ev, 1003
        pg = dict(fwd=eplan.fwd_rows, delay=plan.syn_delay)
        pc = {k: v.cpu() for k, v in pg.items()}
        st = _event_state(rng, dict(valid=plan.syn_valid.cpu(),
                                    row_ptr=plan.row_ptr.cpu()),
                          t + 1, STDP_DENSITY, cap, D)
        spiked_src = torch.from_numpy(rng.random((H, S)) < STDP_DENSITY)
        ids, drop = aer.compact_indices(spiked_src, S, fill=S)
        ins = dict(src_ids=ids.contiguous(), src_drop=drop,
                   ev_ring=st["ev_ring"], ev_count=st["ev_count"],
                   sat=st["sat"])
        saved = {k: v.cuda() for k, v in ins.items()}
        work = {k: v.clone() for k, v in saved.items()}

        def restore():
            for k in ("ev_ring", "ev_count", "sat"):
                work[k].copy_(saved[k])

        def emit_op(impl, d, p):
            impl.event_emit(d["src_ids"], d["src_drop"], p["fwd"],
                            p["delay"], d["ev_ring"], d["ev_count"],
                            d["sat"], t)
            return d["ev_ring"], d["ev_count"], d["sat"]

        got = [x.clone() for x in emit_op(kev, work, pg)]
        torch.cuda.synchronize()
        want = emit_op(kref, {k: v.clone() for k, v in ins.items()}, pc)
        restore()
        want_gpu = emit_op(kref, work, pg)
        equal = all(bit_equal(a, b) and bit_equal(a, c)
                    for a, b, c in zip(got, want, want_gpu))
        if not equal:
            failed.append(f"event_emit ({label})")
        err = max(max(max_abs_err(a, b), max_abs_err(a, c))
                  for a, b, c in zip(got, want, want_gpu))
        listed = ids < S
        fwd = torch.gather(pc["fwd"], 1, torch.clamp(ids, max=S - 1).to(
            torch.int64)[:, :, None].expand(-1, -1, pc["fwd"].shape[2]))
        emitted = int(((fwd >= 0) & listed[:, :, None]).sum())
        # the list; per emitted event its row entry and delay in and its
        # id out; the counts and sat
        n_bytes = ids.numel() * 4 + emitted * (4 + 4 + 4) + H * D * 8
        bms, by = bound(n_bytes, 0)
        launch = lambda: emit_op(kev, work, pg)
        rows.append(dict(
            name="event_emit", route="cuda", source=EVENT_SOURCES["event_emit"],
            replaces=EVENT_REPLACES["event_emit"], launches=None,
            max_abs_err=err, ms=in_place_ms(launch, restore),
            device_ms=device_ms(launch, restore=restore, kernel="emit_scan"),
            plain_ms=in_place_ms(lambda: emit_op(kref, work, pg), restore,
                                 calls=3, warmup=1),
            bound_ms=bms, bound_by=by, library_ms=None,
            library_note="no single PyTorch call does this", equal=equal,
            tolerance="bit-equal (ring, counts, sat), to the plain version "
                      "on a CPU copy and on the card",
            density=label, bytes=n_bytes, flops=0,
            shape=dict(H=H, E=E, S=S, D=D, cap_ev=cap, t=t,
                       max_delay=int(plan.syn_delay.max()),
                       listed_sources=int(listed.sum()), emitted=emitted,
                       sat=int(got[2].sum()))))
        del sp, plan, eplan, pg, saved, work
    return rows, failed


def phase_kernels(plan8, spec8, sp8e, lookup):
    """Each kernel against its plain version at the 8x8 shapes (`lookup`:
    `phase_build`'s arrivals yardstick); returns the rows of the `kernels`
    line (the STDP passes at the main density)."""
    H, E = plan8.syn_valid.shape
    N = plan8.gid.shape[1]
    rng = np.random.default_rng(2013)
    neuron = {k: v.view(H, N) for k, v in _neuron_inputs(rng, H * N).items()}
    izh = spec8.izh
    gn = {k: v.cuda() for k, v in neuron.items()}
    izh_kw = dict(v_peak=izh.v_peak, dt=izh.dt, substeps=izh.v_substeps)
    nargs = lambda d: (d["v"], d["u"], d["current"], d["a"], d["b"], d["c"],
                       d["d"])
    contrib_cpu = torch.from_numpy(
        rng.uniform(-5.0, 10.0, (H, E)).astype(np.float32))
    contrib = contrib_cpu.cuda()
    seg_cpu = kref.make_segments(plan8.row_ptr.cpu(), E)
    seg = kref.make_segments(plan8.row_ptr, E)
    n_valid = int(plan8.row_ptr[:, -1].sum())
    # index_add_'s operands: the valid synapses' flat targets and values
    valid = torch.nonzero(plan8.syn_valid.reshape(-1)).reshape(-1)
    lib_tgt = (plan8.syn_tgt + (torch.arange(H, device="cuda") * N)[:, None]
               ).reshape(-1)[valid]
    lib_contrib = contrib.reshape(-1)[valid]

    cases = [
        dict(name="izhikevich_update",
             source="src/repro_torch/csrc/izhikevich.cu",
             replaces="src/repro/kernels/izhikevich.py:37",
             kernel=lambda: kizh.izhikevich_update(*nargs(gn), **izh_kw),
             plain_gpu=lambda: kref.izhikevich_update(*nargs(gn), **izh_kw),
             plain_cpu=lambda: kref.izhikevich_update(*nargs(neuron),
                                                      **izh_kw),
             bytes=nbytes(*nargs(gn)) + H * N * (4 + 4 + 1),
             flops=H * N * 20, library=None),
        dict(name="segment_sum_ordered",
             source="src/repro_torch/csrc/segment_sum.cu",
             replaces="src/repro/core/engine.py:230",
             kernel=lambda: kseg.segment_sum_ordered(contrib, seg),
             plain_gpu=lambda: kref.segment_sum_ordered(contrib, seg),
             plain_cpu=lambda: kref.segment_sum_ordered(contrib_cpu,
                                                        seg_cpu),
             bytes=n_valid * 4 + nbytes(plan8.row_ptr) + H * N * 4,
             flops=n_valid,
             library=lambda: torch.zeros(H * N, device="cuda").index_add_(
                 0, lib_tgt, lib_contrib)),
    ]
    rows, failed = [], []
    for c in cases:
        got = c["kernel"]()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        with kref.flush_denormal():
            want = c["plain_cpu"]()
        want = want if isinstance(want, tuple) else (want,)
        equal = all(bit_equal(a, b) for a, b in zip(got, want))
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        if c["name"] == "segment_sum_ordered":
            equal &= bit_equal(got[0], c["plain_gpu"]())
        if not equal:
            failed.append(c["name"])
        bms, by = bound(c["bytes"], c["flops"])
        rows.append(dict(
            name=c["name"], route="cuda", source=c["source"],
            replaces=c["replaces"], launches=None, max_abs_err=err,
            ms=cuda_ms(c["kernel"]), device_ms=device_ms(c["kernel"]),
            plain_ms=cuda_ms(c["plain_gpu"], calls=3),
            bound_ms=bms, bound_by=by,
            library_ms=(cuda_ms(c["library"]) if c["library"] else None),
            equal=equal, tolerance="bit-equal (every output, 0 ulp)",
            shape={"E": H * E, "N": H * N,
                                "synapses_summed": n_valid}))
    stdp_rows, stdp_failed = _stdp_rows(plan8, spec8)
    rows[1:1] = stdp_rows
    failed += stdp_failed
    arb_rows, arb_failed = _arborize_rows(plan8, spec8)
    rows += arb_rows
    failed += arb_failed
    ev_rows, ev_failed = _event_rows(sp8e, lookup)
    rows += ev_rows
    failed += ev_failed
    long_rows, long_failed = _event_emit_long_rings()
    rows += long_rows
    failed += long_failed
    # registers, shared memory and spills of the STDP kernels (row_kernel<
    # true> is phase A, row_kernel<false> the fused arrival pass) and of
    # phase B's
    emit({"phase": "kernels", "stdp_ptxas": _build.inspect("stdp.cu")["ptxas"],
          "arborize_ptxas": _build.inspect("arborize.cu")["ptxas"],
          "event_ptxas": _build.inspect("event.cu")["ptxas"],
          "event_phase_a_ptxas": _build.inspect("event_phase_a.cu")["ptxas"],
          "rows": rows})
    if failed:
        raise PhaseFailed(f"kernels differ from their plain versions: "
                          f"{failed}")
    return [r for r in rows if r.get("density", "main") == "main"]


def _first_divergence(a: np.ndarray, b: np.ndarray):
    diff = np.nonzero((a != b).reshape(a.shape[0], -1).any(axis=1))[0]
    return int(diff[0]) if diff.size else None


def _snn_counted(kops=None) -> tuple:
    """The SNN kernels whose launches `check` and `timed` read: the dense
    path's, those it replaced (off the path: `izhikevich_update`, the
    pair, `arborize_elements`), the event path's, the split schedule's
    `event_compact`, the LTP kernel the event path's replaced, and the
    streamed path's.  (`kops`: the ops module, where the caller is a rank
    that imported it itself.)"""
    kops = kops or ops
    return (kops.SNN_KERNELS + kops.PHASE_A_KERNELS + kops.PAIR_KERNELS
            + kops.PHASE_B_KERNELS + kops.EVENT_KERNELS
            + kops.EVENT_SPLIT_KERNELS + kops.EVENT_YARDSTICKS
            + kops.STREAM_KERNELS + kops.STREAM_SPLIT_KERNELS)


def _path_kernels(delivery: str) -> tuple:
    """The kernels a step of `delivery` launches once each."""
    return ops.SNN_KERNELS if delivery == "dense" else ops.EVENT_KERNELS


def _main_path_counts(steps: int, delivery: str = "dense") -> dict:
    """Each kernel of the delivery's path once a step, every other SNN
    kernel never."""
    return dict(dict.fromkeys(_snn_counted(), 0),
                **dict.fromkeys(_path_kernels(delivery), steps))


def _program(cfg, eng, device: str = "cuda") -> "StepProgram":
    """The program of (cfg, eng) on the card (or `device`); under event
    delivery with capacities that drop nothing
    (`event_engine.no_drop_caps`, a ring of E events a slot), as the
    committed reference's event runs."""
    sp = StepProgram(cfg, eng, device=device)
    if eng.delivery == "event":
        state0 = event_engine.init_event_state(
            sp.spec, sp.init_state().base, sp.spec.e_cap)
        sp = StepProgram.from_parts(sp.spec, sp.plan, state0, eplan=sp.eplan,
                                    caps=event_engine.no_drop_caps(sp.spec))
    return sp


def _signatures(sp, state, raster) -> tuple:
    raster_np = raster.cpu().numpy()
    return (observables.raster_signature(
        raster_np, sp.plan.gid.cpu().numpy()).hex(),
        sp.weight_signature(state).hex(), raster_np)


def _same_run(a, b) -> bool:
    """Two runs' outputs (state, raster, timings) bit for bit."""
    return (torch.equal(a[1], b[1])
            and all(bit_equal(x, y) for x, y in zip(
                engine.state_tensors(a[0]), engine.state_tensors(b[0])))
            and all(torch.equal(x, y) for x, y in zip(a[2], b[2])))


def _graph_replays_sync_debug(sp, state, t0: int, n_steps: int):
    """A whole run of the captured graph's replays (state in, windows,
    outputs, state out) under sync-debug "error", its stimulus drawn
    before; None, or the error's text."""
    index, amp = engine.stim_rows(sp.spec, sp.plan, t0, n_steps)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sp.runner.run(state, t0, n_steps, index, amp)
        return None
    except RuntimeError as e:
        return str(e)[:300]
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def phase_check():
    """4x4 full width, 150 steps, three layouts, dense and event delivery,
    against the committed AVX-pinned JAX reference; the graph run again
    (replays only) and the eager loop give the same bits; whole replays
    and whole steps of every exchange raise nothing under sync-debug."""
    with open(os.path.join(HERE, "src", "repro_torch", "data",
                           "jax_reference.json")) as f:
        ref = json.load(f)
    cfg = GridConfig(**ref["grid"],
                     neurons_per_column=ref["neurons_per_column"],
                     synapses_per_neuron=ref["synapses_per_neuron"])
    steps = ref["steps"]
    results, failed = {}, []
    cases = [("dense", name, r) for name, r in ref["runs"].items()]
    cases += [("event", name, r) for name, r in ref["event_runs"].items()]
    for delivery, name, r in cases:
        key = name if delivery == "dense" else f"event_{name}"
        eng = EngineConfig(n_shards=r["n_shards"], placement=r["placement"],
                           delivery=delivery)
        sp = _program(cfg, eng)
        state0 = sp.init_state()
        t0 = time.perf_counter()
        first, graph_counts = _counted_run(sp, state0, steps, True)
        wall = time.perf_counter() - t0
        rsig, wsig, raster_np = _signatures(sp, first[0], first[1])
        per_step = raster_np.sum(axis=(1, 2)).astype(int)
        replayed = sp.run(state0, 0, steps)
        eager, counts = _counted_run(sp, state0, steps, False)
        same = _same_run(first, replayed) and _same_run(first, eager)
        sat = (first[0].sat.cpu().tolist() if delivery == "event" else None)
        want = _main_path_counts(steps, delivery)
        ok = (rsig == r["raster_signature"] and wsig == r["weight_signature"]
              and counts["counted"] == want and graph_counts["total"] == want
              and same
              and (sat is None or (sat == r["sat"] and not any(sat))))
        res = dict(raster_equal=rsig == r["raster_signature"],
                   weights_equal=wsig == r["weight_signature"],
                   graph_equal_to_replays_and_eager=same, sat=sat,
                   spikes=int(per_step.sum()), launches=counts["counted"],
                   graph_launches=graph_counts, wall_s=wall,
                   window=engine.RUN_WINDOW)
        if not ok:
            failed.append(key)
            res["first_step_spike_count_differs"] = _first_divergence(
                per_step, np.asarray(r["spikes_per_step"]))
            cpu = StepProgram(cfg, eng, device="cpu", caps=sp.caps)
            _, raster_cpu, _ = cpu.run(cpu.init_state(), 0, steps)
            res["first_step_gpu_differs_from_cpu_port"] = _first_divergence(
                raster_np, raster_cpu.numpy())
        err = _graph_replays_sync_debug(sp, state0, 0, steps)
        res["graph_replays_sync_debug_error"] = err
        if err is not None:
            failed.append(f"{key} (graph replays, sync-debug)")
        if r["n_shards"] > 1:
            # the exchange wires across several shards and at group stride
            errs = _whole_steps_sync_debug(sp.spec, sp.plan, first[0], steps,
                                           hier_groups=2, eplan=sp.eplan,
                                           caps=sp.caps)
            res["whole_steps_sync_debug_errors"] = errs
            if any(e is not None for e in errs.values()):
                failed.append(f"{key} (sync-debug)")
        results[key] = res
        del sp, first, replayed, eager
    emit({"phase": "check", "grid": "4x4", "steps": steps,
          "runs": results})
    if failed:
        raise PhaseFailed(f"main path differs from the JAX reference: "
                          f"{failed}")


def _whole_steps_sync_debug(spec, plan, s, t0: int, hier_groups,
                            eplan=None, caps=None) -> dict:
    """No step may synchronise with the host: a few whole steps (phase A,
    the exchange, phase B) through the phase handles of each exchange
    wire under sync-debug "error" (a pageable copy or a read of a device
    value raises), from state `s` (updated in place) at step t0.
    Returns each wire's error text, or None."""
    errors = {}
    for ex in EXCHANGES:
        sp = StepProgram.from_parts(
            spec._replace(eng=dataclasses.replace(spec.eng, exchange=ex)),
            plan, s, eplan=eplan, caps=caps, hier_groups=hier_groups)
        pp = sp.phase_fns()
        # one step outside: it draws the stimulus window of t0
        s, spiked, _ = pp.phase_a(s, t0)
        s = pp.phase_b(s, pp.exchange(spiked), t0)
        t0 += 1
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for t_ in range(t0, t0 + SYNC_DEBUG_STEPS):
                s, spiked, _ = pp.phase_a(s, t_)
                s = pp.phase_b(s, pp.exchange(spiked), t_)
            errors[ex] = None
        except RuntimeError as e:
            errors[ex] = str(e)[:300]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        t0 += SYNC_DEBUG_STEPS
        del sp, pp
    return errors


def _counted_run(sp, state0, steps: int, graph: bool):
    """`sp.run` with its launches -> (outputs, {"counted": the SNN
    kernels' launches the wrappers counted (the eager steps'), "replayed":
    the replays' (`CapturedRun.replayed_launches`), "total": their sum})."""
    ops.reset_launch_counts()
    out = sp.run(state0, 0, steps, graph=graph)
    torch.cuda.synchronize()
    counted = {k: ops.launch_counts()[k] for k in _snn_counted()}
    replayed = sp.runner.replayed_launches()
    total = {k: n + replayed.get(k, 0) for k, n in counted.items()}
    return out, dict(counted=counted, replayed=replayed, total=total)


def _timed_run(sp, state0, graph: bool) -> dict:
    """MAIN_STEPS steps of `sp.run` after a warm-up run that captures the
    graph: the run's outputs, wall, launches and peak memory."""
    sp.run(state0, 0, 2 * engine.RUN_WINDOW, graph=graph)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, counts = _counted_run(sp, state0, MAIN_STEPS, graph)
    wall = time.perf_counter() - t0
    return dict(out=out, wall=wall, counts=counts,
                peak=torch.cuda.max_memory_allocated())


def phase_timed(sp8, sp8e):
    """The 8x8 main path, H=1, MAIN_STEPS steps, for each delivery: the
    captured graph's run and the eager loop's (the same bits), ms/step,
    the synchronised phase split, the sync-debug steps of each exchange.
    Returns the launches of each delivery's path kernels in its eager run,
    as the wrappers counted them."""
    cfg = sp8.spec.cfg
    launches, dense_raster = {}, None
    for delivery, sp in (("dense", sp8), ("event", sp8e)):
        state0 = sp.init_state()
        runs = {"graph": _timed_run(sp, state0, True),
                "eager": _timed_run(sp, state0, False)}
        g = runs["graph"]["out"]
        same = _same_run(g, runs["eager"]["out"])
        raster_np = g[1].cpu().numpy()
        rate = observables.mean_rate_hz(raster_np, cfg.n_neurons)
        events = int(g[2].arrivals.sum())
        line = dict(phase="timed", delivery=delivery,
                    grid=f"{cfg.grid_x}x{cfg.grid_y}",
                    neurons=cfg.n_neurons, synapses=cfg.n_synapses,
                    shards=sp.spec.eng.n_shards, steps=MAIN_STEPS,
                    window=engine.RUN_WINDOW, caps=sp.caps,
                    graph_equal_to_eager=same, rate_hz=rate,
                    synaptic_events=events,
                    raster_signature=observables.raster_signature(
                        raster_np, sp.plan.gid.cpu().numpy()).hex(),
                    weight_signature=sp.weight_signature(g[0]).hex())
        want = _main_path_counts(MAIN_STEPS, delivery)
        for mode, r in runs.items():
            counts = r["counts"]
            line[mode] = dict(
                wall_s=r["wall"], ms_per_step=r["wall"] / MAIN_STEPS * 1e3,
                s_per_synapse_per_sim_s_per_hz=timing.norm_seconds(
                    r["wall"], cfg.n_synapses, MAIN_STEPS, rate),
                synaptic_events_per_s=events / r["wall"],
                max_memory_allocated_bytes=r["peak"],
                launches=counts["counted"],
                replayed_launches=counts["replayed"],
                launches_once_a_step=counts["total"] == want)
        # the eager loop's launches, each counted where it was made
        line["eager"]["launches_once_a_step"] &= (
            runs["eager"]["counts"]["counted"] == want)
        if delivery == "event":
            line["sat"] = g[0].sat.cpu().tolist()
            line["raster_equal_to_dense"] = bool(np.array_equal(
                raster_np, dense_raster))
        else:
            dense_raster = raster_np
        # separate synchronised pass: the per-phase split (paper Table 2),
        # through StepProgram.time_phases under the 'sync' schedule; it
        # works on a copy of state0 and returns the state after
        n_split = 100
        s, split, _, _ = sp.time_phases(state0, 0, n_split)
        line["split_sync_pass"] = {
            k.replace("_s", "_ms_per_step"): v / n_split * 1e3
            for k, v in split.items()}
        errs = _whole_steps_sync_debug(sp.spec, sp.plan, s, n_split,
                                       hier_groups=1, eplan=sp.eplan,
                                       caps=sp.caps)
        line["whole_steps_sync_debug_steps"] = SYNC_DEBUG_STEPS
        line["whole_steps_sync_debug_errors"] = errs
        emit(line)
        if any(e is not None for e in errs.values()):
            raise PhaseFailed(f"a {delivery} step synchronised with the "
                              f"host under sync-debug 'error': {errs}")
        if not same:
            raise PhaseFailed(f"the {delivery} graph run differs from the "
                              f"eager loop")
        if not all(line[m]["launches_once_a_step"] for m in runs):
            raise PhaseFailed(f"{delivery}: kernels not launched once per "
                              f"step (or another SNN kernel launched): "
                              f"{line['graph']}, {line['eager']}")
        if delivery == "event" and any(line["sat"]):
            raise PhaseFailed(f"the event run dropped events: {line['sat']}")
        launches.update({k: runs["eager"]["counts"]["counted"][k]
                         for k in _path_kernels(delivery)})
        del runs, g
    return launches


def phase_profile(sp8, sp8e, n_steps: int = 20):
    """Device time by kernel (torch.profiler), device busy and idle share,
    and device operations per step: the dense path over its first
    `n_steps` steps from the initial state (nearly silent), and each
    delivery over the timed run's MAIN_STEPS steps (activity comes in
    bursts, so only the whole run gives the kernels' mean), as the
    captured graph's replays and as the eager loop."""
    from torch.profiler import ProfilerActivity, profile
    windows = {}
    cases = [("dense_first", sp8, n_steps, True)]
    cases += [(f"{d}_{m}", sp, MAIN_STEPS, m == "graph")
              for d, sp in (("dense", sp8), ("event", sp8e))
              for m in ("graph", "eager")]
    for label, sp, steps, graph in cases:
        state0 = sp.init_state()
        sp.run(state0, 0, steps, graph=graph)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            c0 = time.perf_counter()
            _, _, tm = sp.run(state0, 0, steps, graph=graph)
            torch.cuda.synchronize()
            wall = time.perf_counter() - c0
        rows = sorted(((us, k, c) for k, us, c in device_kernel_events(prof)),
                      reverse=True)
        busy_us = sum(r[0] for r in rows)
        windows[label] = dict(
            steps=steps, graph=graph, wall_s=wall,
            arrivals_per_step=int(tm.arrivals.sum()) / steps,
            spikes_per_step=int(tm.spikes.sum()) / steps,
            device_busy_s=busy_us * 1e-6 if rows else None,
            device_busy_ms_per_step=busy_us * 1e-3 / steps if rows
            else None,
            device_idle_share=(1.0 - busy_us * 1e-6 / wall) if rows
            else None,
            device_ops_per_step=sum(r[2] for r in rows) / steps,
            top=[dict(name=k[:90], device_ms_per_step=us * 1e-3 / steps,
                      calls=c) for us, k, c in rows[:15]])
    emit({"phase": "profile", "windows": windows})


def _report_line(suite: str, rep: dict, **more) -> None:
    emit({"phase": "bench", "suite": suite, "env": rep["env"],
          "config": rep["config"], "deterministic": rep["deterministic"],
          "wall": rep["wall"], **more})


def phase_bench():
    """The ported bench suites on the card (`repro_torch.bench`), one line
    per report: `table1` quick (its 4x4 row's raster signature and spike
    count must be the committed JAX reference's h1_block run: the same
    grid, layout and 150 steps), `table1` at TABLE1_ROWS and its 300
    steps (build seconds and peak memory by row), `table2` under
    `sync` and its cell again under `pipelined` (equal raster
    signatures), and `profile` (which raises unless every exchange x
    placement cell gives the same raster and totals)."""
    with open(os.path.join(HERE, "src", "repro_torch", "data",
                           "jax_reference.json")) as f:
        want = json.load(f)["runs"]["h1_block"]
    quick = table1.run_suite(quick=True, device="cuda")
    det = quick["deterministic"]
    quick_ok = (det["sig_4x4"] == want["raster_signature"]
                and det["spikes_4x4"] == want["spikes"])
    _report_line("table1_quick", quick, rows=quick["extra"]["rows"],
                 equal_to_jax_reference=quick_ok)
    full = table1.run_suite(device="cuda", rows=TABLE1_ROWS)
    _report_line("table1", full, rows=full["extra"]["rows"])
    t2 = table2.run_suite(device="cuda")
    row = t2["extra"]["row"]
    pipelined = bench_profile.profile_cell(
        GridConfig(grid_x=2, grid_y=2, neurons_per_column=1000),
        EngineConfig(n_shards=1, exchange="halo",
                     exchange_schedule="pipelined"), row["steps"],
        device="cuda")
    same = (pipelined["raster_sig"] == row["raster_sig"]
            and pipelined["spikes"] == row["spikes"])
    _report_line("table2", t2, row=row, pipelined=pipelined,
                 schedules_equal=same)
    prof = bench_profile.run_profile(device="cuda")
    _report_line("profile", prof, cells=prof["extra"]["cells"])
    evd = event_vs_dense.run_suite(device="cuda", distributed=False)
    _report_line("event_vs_dense", evd, rows=evd["extra"]["rows"])
    try:
        cs = cluster_cli.sweep_report(quick=True, device="cuda")
    except Exception as e:          # a failed launch or unequal rasters
        raise PhaseFailed(f"cluster_scaling: {str(e)[-3000:]}")
    _report_line("cluster_scaling", cs, points=cs["extra"]["points"])
    if not cs["deterministic"]["identical_across_procs"]:
        raise PhaseFailed("cluster_scaling's rasters differ across process "
                          "counts")
    if not quick_ok:
        raise PhaseFailed(f"table1's 4x4 row differs from the JAX "
                          f"reference: {det}")
    if not same:
        raise PhaseFailed("table2 differs between the sync and pipelined "
                          "schedules")


# ----------------------------------------------------------------------------
# the LM serving path (recurrentgemma-2b)
# ----------------------------------------------------------------------------


def _scan_inputs(rng, shape):
    B, T, D = shape
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return (f(rng.uniform(0.5, 0.999, shape)),
            f(rng.standard_normal(shape) * 0.1),
            f(rng.standard_normal((B, D))))


def _on_card(x, offset: int):
    """A copy of x on the card whose first element lies `offset` bytes past
    an aligned address (a view into a larger buffer)."""
    k = offset // x.element_size()
    buf = torch.empty(x.numel() + k, dtype=x.dtype, device="cuda")
    view = buf[k:].view(x.shape)
    view.copy_(x)
    return view


def phase_lm_kernels():
    """The RG-LRU scan kernel against its plain version at three shapes."""
    rng = np.random.default_rng(12)
    rows, failed = [], []
    for label, shape, offset in LM_SCAN_SHAPES:
        cpu = _scan_inputs(rng, shape)
        gpu = tuple(_on_card(x, offset) for x in cpu)
        got = krg.rg_lru_scan(*gpu)
        torch.cuda.synchronize()
        with kref.flush_denormal():
            want_cpu = kref.rg_lru_scan(*cpu)
        want_gpu = kref.rg_lru_scan(*gpu)
        equal = bit_equal(got, want_cpu) and bit_equal(got, want_gpu)
        if not equal:
            failed.append(label)
        B, T, D = shape
        bms, by = bound(nbytes(*gpu) + B * T * D * 4, 2 * B * T * D)
        rows.append(dict(
            name="rg_lru_scan", route="cuda",
            source="src/repro_torch/csrc/rg_lru.cu",
            replaces="src/repro/kernels/rg_lru.py:39", launches=None,
            max_abs_err=max(max_abs_err(got, want_cpu),
                            max_abs_err(got, want_gpu)),
            ms=cuda_ms(lambda: krg.rg_lru_scan(*gpu)),
            device_ms=device_ms(lambda: krg.rg_lru_scan(*gpu)),
            plain_ms=cuda_ms(lambda: kref.rg_lru_scan(*gpu), calls=3),
            bound_ms=bms, bound_by=by, library_ms=None, equal=equal,
            tolerance="bit-equal (0 ulp), to the plain version on a CPU "
                      "copy and on the card",
            shape={"label": label, "B": B, "T": T, "D": D,
                   "offset_bytes": offset}))
    emit({"phase": "lm_kernels", "rows": rows})
    if failed:
        raise PhaseFailed(f"rg_lru_scan differs from its plain version at "
                          f"{failed}")
    return rows


def _attn_inputs(rng, c):
    """numpy-seeded fp32 q [BH, T, D] and k, v [B * kv_heads, S, D], cast
    to the row's dtype and the KV heads repeated to BH (GQA)."""
    bh, g = c["B"] * c["heads"], c["heads"] // c["kv_heads"]
    dtype = getattr(torch, c["dtype"])
    f = lambda shape, scale: torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)
    q = f((bh, c["T"], c["D"]), c["qk_scale"])
    kv_shape = (c["B"] * c["kv_heads"], c["S"], c["D"])
    k = f(kv_shape, c["qk_scale"]).repeat_interleave(g, 0).contiguous()
    v = f(kv_shape, 1.0).repeat_interleave(g, 0).contiguous()
    return q, k, v


def _attn_mask(c):
    """The [T, S] visibility mask of the contract (kernels.ref.attention)."""
    T, S = c["T"], c["S"]
    q_pos = torch.arange(T)[:, None] + (S - T)
    k_pos = torch.arange(S)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool)
    if c["causal"]:
        mask &= k_pos <= q_pos
    if c["window"] is not None:
        mask &= k_pos > q_pos - c["window"]
    return mask


def _within(got, want, tol) -> bool:
    rtol, atol = tol
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def _sdpa(q, k, v, c, mask, scale):
    """(fn, how) for scaled_dot_product_attention at the same function, or
    (None, reason).  PyTorch's is_causal aligns the mask top-left, the
    contract bottom-right (q_pos = i + S - T): is_causal only where the
    two agree, an explicit boolean mask otherwise."""
    import torch.nn.functional as F
    if c["softcap"] is not None:
        return None, "no PyTorch call applies a logit softcap"
    q4, k4, v4 = q[None], k[None], v[None]
    if bool(mask.all()):
        kw, how = {}, "no mask (every key visible)"
    elif c["T"] == c["S"] and torch.equal(mask, torch.ones_like(mask).tril()):
        kw, how = dict(is_causal=True), "is_causal=True"
    else:
        kw, how = dict(attn_mask=mask.cuda()), "explicit boolean mask"
    return (lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale,
                                                   **kw)[0]), how


def phase_attn_kernels():
    """The attention kernels through `ops.attention` at seven shapes: one
    call each with the launch counts reset before and read after, the kernel
    each call took against the rule's, then each output against the plain
    version and the kernel timed."""
    rng = np.random.default_rng(13)
    cases = []
    for label, c in ATTN_SHAPES:
        cpu = _attn_inputs(rng, c)
        cases.append((label, c, cpu, tuple(x.cuda() for x in cpu)))
    kw = lambda c: dict(causal=c["causal"], window=c["window"],
                        softcap=c["softcap"])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    outs, taken = [], []
    for _, c, _, gpu in cases:
        before = dict(kfa.variant_launches)
        outs.append(ops.attention(*gpu, **kw(c)))
        taken.append([k for k, n in kfa.variant_launches.items()
                      if n != before[k]])
    torch.cuda.synchronize()
    launches = ops.launch_counts()["flash_attention"]
    variant_launches = dict(kfa.variant_launches)
    rows, failed = [], []
    for (label, c, cpu, gpu), got, kinds in zip(cases, outs, taken):
        rule = kfa.variant(gpu[0].dtype, c["T"], c["S"], c["D"], all(
            x.data_ptr() % 16 == 0 for x in gpu))
        kind = kinds[0] if len(kinds) == 1 else None
        if kind != rule or kind != ATTN_VARIANTS[label]:
            failed.append(f"{label} took {kinds}, the rule names {rule}")
        tol = ATTN_TOL[c["dtype"]]
        want_cpu = kref.attention(*cpu, **kw(c))
        want_gpu = kref.attention(*gpu, **kw(c))
        ok = (got.dtype == gpu[0].dtype and bool(torch.isfinite(got).all())
              and _within(got, want_cpu, tol) and _within(got, want_gpu, tol))
        err = max(max_abs_err(got, want_cpu), max_abs_err(got, want_gpu))
        del want_cpu
        if not ok:
            failed.append(label)
        scale = c["D"] ** -0.5
        kkw = dict(kw(c), scale=scale)
        mask = _attn_mask(c)
        bh = c["B"] * c["heads"]
        pairs = bh * int(mask.sum())
        peak = PEAK_BF16_PER_S if c["dtype"] == "bfloat16" else PEAK_FP32_PER_S
        bms, by = bound(nbytes(*gpu) + nbytes(got), 4 * c["D"] * pairs, peak)
        lib, how = _sdpa(*gpu, c, mask, scale)
        lib_err = max_abs_err(lib(), want_gpu) if lib else None
        ms = cuda_ms(lambda: kfa.flash_attention(*gpu, **kkw))
        dev_ms = device_ms(lambda: kfa.flash_attention(*gpu, **kkw))
        lib_ms = cuda_ms(lib) if lib else None
        lib_dev_ms = device_ms(lib) if lib else None
        rows.append(dict(
            name="flash_attention", route="cuda",
            source=ATTN_SOURCES[rule], variant=kind,
            replaces="src/repro/kernels/flash_attention.py:92",
            launches=None,
            max_abs_err=err,
            ms=ms, device_ms=dev_ms,
            plain_ms=cuda_ms(lambda: kref.attention(*gpu, **kw(c)), calls=3),
            bound_ms=bms, bound_by=by,
            library_ms=lib_ms, library_device_ms=lib_dev_ms,
            ms_over_library=ms / lib_ms if lib else None,
            device_ms_over_library=(dev_ms / lib_dev_ms
                                    if lib and dev_ms and lib_dev_ms
                                    else None),
            library_call=("torch.nn.functional.scaled_dot_product_attention, "
                          + how) if lib else None,
            library_max_abs_err=lib_err,
            library_note=None if lib else how, within_tolerance=ok,
            tolerance=f"rtol = {tol[0]}, atol = {tol[1]} against the plain "
                      f"version on a CPU copy and on the card",
            visible_pairs=pairs, flops=4 * c["D"] * pairs,
            bytes=nbytes(*gpu) + nbytes(got),
            shape=dict(label=label, BH=bh, T=c["T"], S=c["S"], D=c["D"],
                       dtype=c["dtype"], causal=c["causal"],
                       window=c["window"], softcap=c["softcap"],
                       kv_heads=c["B"] * c["kv_heads"])))
        del want_gpu
    emit({"phase": "attn_kernels", "launches": launches,
          "variant_launches": variant_launches, "rows": rows})
    del cases, outs
    torch.cuda.empty_cache()
    if launches != len(ATTN_SHAPES):
        raise PhaseFailed(f"ops.attention launched the kernel {launches} "
                          f"times for {len(ATTN_SHAPES)} calls")
    if failed:
        raise PhaseFailed(f"flash_attention differs from its plain version "
                          f"or took another kernel than its rule's at "
                          f"{failed}")
    return rows, launches


def _n_rg(cfg) -> int:
    return sum(kinds[0] == "rg" for kinds in cfg.layers)


def _requests(prompts, max_new):
    return [serve_engine.Request(prompt=np.asarray(p), max_new=m)
            for p, m in zip(prompts, max_new)]


def phase_lm_check():
    """SMOKE serving in fp32 and bf16 against the committed JAX
    reference."""
    with open(os.path.join(HERE, "src", "repro_torch", "data",
                           "lm_reference.json")) as f:
        ref = json.load(f)
    prompts = [q["prompt"] for q in ref["requests"]]
    max_new = [q["max_new"] for q in ref["requests"]]
    results, failed = {}, []
    for dtype, r in ref["variants"].items():
        cfg = get_smoke_config(ref["arch"]).scaled(dtype=dtype)
        params = convert.lm_params_from_jax(
            convert.numpy_params(cfg, ref["weights_seed"]), cfg, "cuda")
        eng = serve_engine.ServeEngine(cfg, params, batch=ref["batch"],
                                       s_max=ref["s_max"], device="cuda")
        ops.reset_launch_counts()
        done = eng.run(_requests(prompts, max_new))
        launches = ops.launch_counts()["rg_lru_scan"]
        calls = eng.stats["admissions"] + eng.stats["decode_steps"]
        tokens = [q.out.tolist() for q in done]
        solo = eng.run(_requests(prompts[:1], max_new[:1]))[0].out.tolist()
        ops.reset_launch_counts()
        tf = serve_engine.teacher_forced_logits(
            cfg, params, prompts[0], r["tokens"][0], ref["t_pad"],
            ref["s_max"])
        tf_launches = ops.launch_counts()["rg_lru_scan"]
        err = max_abs_err(tf, torch.tensor(r["teacher_forced_logits"]))
        res = dict(
            tokens_equal=tokens == r["tokens"], solo_equal=solo == tokens[0],
            teacher_forced_max_abs_err=err, tolerance=LM_TOL[dtype],
            finite=bool(torch.isfinite(tf).all()),
            launches=launches, forward_calls=calls,
            expected_launches=_n_rg(cfg) * calls,
            teacher_forced_launches=tf_launches,
            teacher_forced_expected=_n_rg(cfg) * (len(r["tokens"][0]) + 1))
        ok = (res["solo_equal"] and res["finite"] and err <= LM_TOL[dtype]
              and launches == res["expected_launches"]
              and tf_launches == res["teacher_forced_expected"]
              and (res["tokens_equal"] or dtype != "float32"))
        if not ok:
            failed.append(dtype)
        results[dtype] = res
    emit({"phase": "lm_check", "arch": ref["arch"], "config": "SMOKE",
          "runs": results})
    if failed:
        raise PhaseFailed(f"LM serving differs from the JAX reference: "
                          f"{failed}")


def _full_width_requests(cfg, n=8, lo=16, hi=512, max_new=32):
    rng = np.random.default_rng(0)
    lens = rng.integers(lo, hi + 1, n)
    return _requests([rng.integers(0, cfg.vocab_size, int(k)) for k in lens],
                     [max_new] * n)


def phase_lm_serve():
    """recurrentgemma-2b at full width: serve 8 requests."""
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = serve_engine.ServeEngine(cfg, params, batch=4, s_max=1024,
                                   device="cuda")
    eng.run(_requests([np.arange(16)] * 2, [2, 2]))          # warm-up

    captured, finite = {}, []
    real_scan, real_greedy = ops.rg_lru_scan, sampling.greedy

    def capture(a, b, h0=None):
        if not captured:
            captured.update(a=a.clone(), b=b.clone(),
                            h0=None if h0 is None else h0.clone())
        return real_scan(a, b, h0)

    def checked(logits):
        finite.append(torch.isfinite(logits).all())
        return real_greedy(logits)

    reqs = _full_width_requests(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.rg_lru_scan, sampling.greedy = capture, checked
    ops.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ops.rg_lru_scan, sampling.greedy = real_scan, real_greedy
    launches = ops.launch_counts()["rg_lru_scan"]
    peak = torch.cuda.max_memory_allocated()
    st = eng.stats
    calls = st["admissions"] + st["decode_steps"]
    n_tok = sum(r.out.shape[0] for r in done)
    decode_tok = n_tok - st["admissions"]

    a, b, h0 = captured["a"], captured["b"], captured["h0"]
    if h0 is None:
        h0 = a.new_zeros((a.shape[0], a.shape[2]))
    layer0_equal = bit_equal(krg.rg_lru_scan(a, b, h0),
                             kref.rg_lru_scan(a, b, h0))
    all_finite = bool(torch.stack(finite).all())
    n_params = lm.param_count(params)
    emit({"phase": "lm_serve", "arch": LM_ARCH, "dtype": cfg.dtype,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab_size, "params": n_params,
          "param_bytes": sum(w.numel() * w.element_size()
                             for w in params.parameters()),
          "init_s": init_s, "requests": len(done), "batch": eng.batch,
          "s_max": eng.s_max,
          "prompt_lens": [int(r.prompt.shape[0]) for r in done],
          "padded_prompt_len": st["prompt_tokens"] // st["admissions"],
          "tokens": n_tok, "wall_s": wall,
          "admissions": st["admissions"], "prefill_s": st["prefill_s"],
          "prefill_tokens_per_s": st["prompt_tokens"] / st["prefill_s"],
          "decode_steps": st["decode_steps"], "decode_s": st["decode_s"],
          "decode_ms_per_step": st["decode_s"] / st["decode_steps"] * 1e3,
          "decode_tokens_per_s": decode_tok / st["decode_s"],
          "tokens_per_s": n_tok / wall,
          "max_memory_allocated_bytes": peak,
          "rg_lru_scan_launches": launches,
          "expected_launches": _n_rg(cfg) * calls,
          "all_logits_finite": all_finite,
          "layer0_scan_shape": list(a.shape),
          "layer0_scan_bit_equal": layer0_equal})
    if not (all_finite and layer0_equal
            and launches == _n_rg(cfg) * calls):
        raise PhaseFailed("full-width serving failed its gates")
    return params, launches


def phase_lm_profile(params):
    """Device time by kernel over a short full-width serving run (4
    requests of 128 tokens, 8 new tokens each), and the device's idle
    share: 1 - device busy time (torch.profiler, device activity only)
    over the wall of the same run unprofiled."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(LM_ARCH)
    eng = serve_engine.ServeEngine(cfg, params, batch=4, s_max=1024,
                                   device="cuda")
    reqs = lambda: _requests([np.arange(128) % cfg.vocab_size] * 4, [8] * 4)
    eng.run(reqs())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(reqs())
        torch.cuda.synchronize()
        wall_profiled = time.perf_counter() - t0
    rows = sorted(((us, k, c) for k, us, c in device_kernel_events(prof)),
                  reverse=True)
    busy_us = sum(r[0] for r in rows)
    emit({"phase": "lm_profile", "wall_s": wall,
          "wall_profiled_s": wall_profiled, "stats": eng.stats,
          "device_busy_s": busy_us * 1e-6 if rows else None,
          "device_idle_share": (1.0 - busy_us * 1e-6 / wall) if rows
          else None,
          "top": [dict(name=k[:90], device_ms=us * 1e-3, calls=c)
                  for us, k, c in rows[:15]]})


# ----------------------------------------------------------------------------
# streamed connectivity
# ----------------------------------------------------------------------------


def _stream_program(cfg, chunk: int, h: int = 1, placement: str = "block"):
    """The streamed program of (cfg, K = chunk) on the card: its plan is
    built on the card (`stream_engine.build`'s chunk counts)."""
    return StepProgram(cfg, EngineConfig(
        n_shards=h, placement=placement,
        connectivity=f"streamed:chunk={chunk}"), device="cuda")


def _stream_counts(steps: int, n_chunks: int) -> dict:
    """A streamed run's launches: per step and chunk, chunk_tables twice,
    the phase-A row kernel and the element walk once; every other SNN
    kernel never."""
    return dict(dict.fromkeys(_snn_counted(), 0),
                chunk_tables=2 * n_chunks * steps,
                stdp_phase_a_chunk=n_chunks * steps,
                arborize_chunk=n_chunks * steps)


def _program_bytes(*trees) -> int:
    """Device bytes of the tensors of NamedTuples of tensors."""
    return sum(nbytes(x) for t in trees for x in engine.state_tensors(t)
               if isinstance(x, torch.Tensor) and x.is_cuda)


def _chunk_tables_ops(source, c: int, tables, kept) -> tuple:
    """(integer operations of the least work, of the reference's draw
    order, bytes, shape) of one chunk_tables call on these inputs, at
    SPLITMIX_OPS a draw lane.  Least work: lane 0 on every excitatory
    slot, lane 2 on every inhibitory one, lane 1 on the slots whose ring
    can reach the chunk and lane 2 on those whose target column lies in
    it (`kref.chunk_prefilter` on this chunk), lane 3 on each kept
    excitatory synapse.  The reference's draw order: lanes 0-2 on every
    excitatory slot, lane 2 on every inhibitory one, lane 3 on each kept
    excitatory synapse.  Bytes: the candidates read, their gids gathered,
    the tables written."""
    g = source.geom
    cand = source.cand[:, c].to(torch.int64)
    ok = cand >= 0
    gid = torch.gather(source.src_gid, 1, torch.where(ok, cand, 0))
    exc = ok & (gid % g.npc < g.nexc)
    n_exc, n_inh = int(exc.sum()), int((ok & ~exc).sum())
    kept_exc = sum(int(tables.plastic[h, :k].sum())
                   for h, k in enumerate(kept))
    pf = kref.chunk_prefilter(source, c)
    excm = exc[:, :, None]
    lane1 = int((pf.lane0 & excm).sum())
    lane2_exc = int((pf.lane1 & excm).sum())
    del pf
    lanes = g.M * (n_exc + n_inh) + lane1 + lane2_exc + kept_exc
    ops_ = SPLITMIX_OPS * lanes
    draw_order_ops = SPLITMIX_OPS * (g.M * (3 * n_exc + n_inh) + kept_exc)
    n_bytes = (nbytes(source.cand[:, c]) + int(ok.sum()) * 8
               + sum(kept) * (4 + 4 + 1) + nbytes(tables.row_ptr))
    exc_slots = max(g.M * n_exc, 1)
    return ops_, draw_order_ops, n_bytes, dict(
        candidates=int(ok.sum()), slots=int(ok.sum()) * g.M,
        kept=sum(kept), kept_excitatory=kept_exc, lanes=lanes,
        lane1_draws=lane1, lane2_excitatory_draws=lane2_exc,
        prefilter_lane0_share_of_excitatory=lane1 / exc_slots,
        prefilter_lane1_share_of_excitatory=lane2_exc / exc_slots,
        prefilter_lane1_share=(lane2_exc + g.M * n_inh)
        / max(int(ok.sum()) * g.M, 1))


def _chunk_tables_rows(sp8s, sp4r) -> tuple:
    """`chunk_tables` on the 8x8 streamed plan's first, an interior and
    the last chunk, and the last (ragged) chunk of a 4x4 K = 3 plan at H =
    4: bit-equal (row pointers, and each shard's kept entries) to the plain
    version on the card and, for the interior and the ragged chunk, on a
    CPU copy; its flag clear.  Timed beside its plain version, stage by
    stage (CHUNK_KERNELS; a stage that reads no device time fails), and
    beside two bounds (operations: the draw lanes at the int32 issue
    rate): the least work and the reference's draw order
    (`_chunk_tables_ops`)."""
    rows, failed = [], []
    n8 = sp8s.spec.stream.n_chunks
    cases = [("first", sp8s, 0), ("interior", sp8s, n8 // 2),
             ("last", sp8s, n8 - 1),
             ("ragged_k3", sp4r, sp4r.spec.stream.n_chunks - 1)]
    for label, sp, c in cases:
        live = stream_engine.ChunkStream(sp.spec, sp.plan, sp.splan)
        src, K = live.source, live.tables.src.shape[1]
        got = live.regenerate(c)
        torch.cuda.synchronize()
        want_gpu = kref.chunk_tables(src, c, K)
        want = [want_gpu]
        if label in ("interior", "ragged_k3"):
            src_cpu = kref.ChunkSource(*(x.cpu() if isinstance(
                x, torch.Tensor) else x for x in src))
            want.append(kref.chunk_tables(src_cpu, c, K))
        kept = (want_gpu.row_ptr[:, -1] - want_gpu.row_ptr[:, 0]).tolist()
        equal = int(live.status[0]) == 0
        for w in want:
            equal &= bit_equal(got.row_ptr, w.row_ptr)
            for h, e in enumerate(kept):
                equal &= all(bit_equal(a[h, :e], b[h, :e])
                             for a, b in zip(got[1:], w[1:]))
        if not equal:
            failed.append(f"chunk_tables ({label})")
        n_ops, draw_ops, n_bytes, shape = _chunk_tables_ops(src, c, got,
                                                            kept)
        bms, by = bound(n_bytes, n_ops, PEAK_INT32_PER_S)
        launch = lambda: live.regenerate(c)
        by_kernel = {k: device_ms(launch, kernel=k) for k in CHUNK_KERNELS}
        if not all(by_kernel.values()):
            failed.append(f"chunk_tables ({label}): a stage read no device "
                          f"time: {by_kernel}")
        rows.append(dict(
            name="chunk_tables", route="cuda",
            source="src/repro_torch/csrc/stream.cu",
            replaces="src/repro/core/stream_engine.py:172", launches=None,
            max_abs_err=0.0 if equal else float("nan"),
            ms=cuda_ms(launch), device_ms=device_ms(
                launch, kernel=CHUNK_KERNELS),
            device_ms_by_kernel=by_kernel,
            plain_ms=cuda_ms(lambda: kref.chunk_tables(src, c, K), calls=2,
                             reps=3, warmup=1),
            bound_ms=bms, bound_by=by,
            bound_note=f"operations, the least work: {SPLITMIX_OPS} integer "
                       f"instructions a splitmix64 lane (counted in the "
                       f"SASS), lane 0 on every excitatory slot, lane 2 on "
                       f"every inhibitory one, lanes 1 and 2 where the "
                       f"prefilter passes, lane 3 a kept excitatory "
                       f"synapse, at the int32 issue rate "
                       f"{PEAK_INT32_PER_S:.4g}/s",
            draw_order_bound_ms=bound(n_bytes, draw_ops,
                                      PEAK_INT32_PER_S)[0],
            draw_order_note="the reference's draw order: lanes 0-2 on every "
                            "excitatory slot, as a thread a slot draws them",
            ops=n_ops, draw_order_ops=draw_ops, bytes=n_bytes,
            library_ms=None,
            library_note="no PyTorch call regenerates the tables",
            equal=equal, status=int(live.status[0]),
            tolerance="bit-equal (row pointers and every kept entry) to the "
                      "plain version on the card"
                      + (" and on a CPU copy" if len(want) > 1 else ""),
            density="main" if label == "interior" else label,
            shape=dict(shape, chunk=c, H=sp.spec.eng.n_shards,
                       K=sp.spec.stream.chunk_cols, q=sp.spec.stream.q,
                       c_cap=sp.spec.stream.c_cap, live_width=K)))
        del live, got, want, want_gpu
    return rows, failed


def _window_rows(sp8s) -> tuple:
    """The chunk windows of the phase-A row kernel (with LTP, as `run`
    calls it, t from the step counter), of LTP (`stdp_ltp_chunk`) and of
    the element walk (`arborize_chunk`, t from the counter) on the 8x8
    streamed plan's interior chunk, its synapses' flags and the neurons'
    spikes drawn at the main density: bit-equal (the whole state, the
    spikes and counts) to their plain versions on a CPU copy, timed on
    restored inputs beside their plain versions on the card and bounds
    from the bytes these inputs make them move."""
    spec, plan, splan = sp8s.spec, sp8s.plan, sp8s.splan
    H, N = plan.gid.shape
    D = spec.cfg.n_delay_slots
    ss = spec.stream
    c = ss.n_chunks // 2
    lo = c * ss.q
    live = stream_engine.ChunkStream(spec, plan, splan)
    tb = live.regenerate(c)
    tb_cpu = kref.ChunkTables(*(x.cpu() for x in tb))
    e0 = int(tb_cpu.row_ptr[0, 0])
    kept = int(tb_cpu.row_ptr[0, -1]) - e0
    t = 1003
    rng = np.random.default_rng(2023)
    state = sp8s.init_state()
    E = state.w.shape[1]
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    ring = np.zeros((H, D, E), bool)
    ring[:, :, e0:e0 + kept] = rng.random((H, D, kept)) < STDP_DENSITY
    times = lambda shape: f(np.where(rng.random(shape) < 0.7,
                                     rng.uniform(t - 2000.0, t, shape),
                                     -1.0e9))
    cpu = dict(ring=torch.from_numpy(ring),
               w=f(rng.uniform(0, 10, (H, E))), last_arr=times((H, E)),
               last_post=times((H, N)),
               v=f(np.where(rng.random((H, N)) < STDP_DENSITY, 35.0,
                            rng.uniform(-80.0, 0.0, (H, N)))),
               u=f(rng.uniform(-20.0, 10.0, (H, N))),
               spiked=torch.from_numpy(rng.random((H, N)) < STDP_DENSITY),
               spiked_src=torch.from_numpy(
                   rng.random(tuple(plan.src_gid.shape)) < STDP_DENSITY),
               out=torch.zeros((H, N), dtype=torch.bool),
               counts=torch.zeros((2, H), dtype=torch.int64),
               ctr=torch.tensor([t, 0], dtype=torch.int64))
    index, amp = engine.stim_rows(spec, plan, t, 1)
    cpu.update(stim_idx=index.cpu(), stim_amp=amp.cpu())
    gpu = {k: v.cuda() for k, v in cpu.items()}
    exc, nv = plan.exc_mask, plan.neuron_valid
    kw = dict(izh=spec.izh, stdp=spec.stdp, neg_time=engine.NEG_TIME)
    ltp_kw = dict(a_plus=spec.stdp.a_plus, tau_plus=spec.stdp.tau_plus,
                  w_min=spec.stdp.w_min, w_max=spec.stdp.w_max,
                  neg_time=engine.NEG_TIME)

    def phase_a(d, tables, counter: bool):
        step = d["ctr"] if counter else t
        stim = ((d["stim_idx"], d["stim_amp"]) if counter else
                (d["stim_idx"][0], d["stim_amp"][0]))
        ops.stdp_phase_a_chunk(
            d["ring"], None if counter else t % D, tables, lo,
            exc.to(d["w"].device), nv.to(d["w"].device), *stim, d["v"],
            d["u"], d["last_post"], d["w"], d["last_arr"], step, d["out"],
            d["counts"], accumulate=False, with_ltp=True, **kw)

    def ltp(d, tables):
        ops.stdp_ltp_chunk(d["spiked"], tables, lo, d["last_arr"], d["w"],
                           d["last_post"], t, **ltp_kw)

    def arb(d, tables, counter: bool):
        ops.arborize_chunk(d["ring"], d["spiked_src"], tables,
                           d["ctr"] if counter else t)

    keys = ("ring", "w", "last_arr", "last_post", "v", "u", "out",
            "counts")
    rows, failed = [], []
    cases = (("stdp_phase_a_chunk", phase_a, True,
              "src/repro/kernels/izhikevich.py:37, src/repro/kernels/"
              "stdp.py:57, src/repro/kernels/stdp.py:81",
              "row_kernel<true, true>", "src/repro_torch/csrc/stdp.cu"),
             ("stdp_ltp_chunk", ltp, None, "src/repro/kernels/stdp.py:81",
              "ltp_kernel<true>", "src/repro_torch/csrc/stdp.cu"),
             ("arborize_chunk", arb, True,
              "src/repro/core/stream_engine.py:389", "arborize_chunk",
              "src/repro_torch/csrc/arborize.cu"))
    for name, fn, counter, replaces, kname, source in cases:
        args = (counter,) if counter is not None else ()
        g = {k: v.clone() for k, v in gpu.items()}
        fn(g, tb, *args)
        torch.cuda.synchronize()
        w = {k: v.clone() for k, v in cpu.items()}
        with kref.flush_denormal():
            fn(w, tb_cpu, *((False,) if counter else ()))
        equal = all(bit_equal(g[k], w[k]) for k in keys)
        err = max(max_abs_err(g[k], w[k]) for k in keys if k != "ring")
        if not equal:
            failed.append(name)
        # bytes these inputs make it move
        rp = tb_cpu.row_ptr[0].to(torch.int64)
        rows_n = min(ss.q, N - lo)
        spk_rows = torch.nonzero(w["out"][0, lo:lo + rows_n] if name
                                 == "stdp_phase_a_chunk" else
                                 cpu["spiked"][0, lo:lo + rows_n]).reshape(-1)
        syn_spk = int((rp[spk_rows + 1] - rp[spk_rows]).sum())
        arrived = int(cpu["ring"][0, t % D, e0:e0 + kept].sum())
        active = int(cpu["spiked_src"][0][tb_cpu.src[0, :kept].long()].sum())
        if name == "stdp_phase_a_chunk":
            n_bytes = (kept + (ss.q + 1) * 4 + rows_n * 19
                       + arrived * (1 + 4 + 4 + 1 + 4)
                       + spk_rows.numel() * 8 + syn_spk * 13)
        elif name == "stdp_ltp_chunk":
            n_bytes = rows_n + spk_rows.numel() * 8 + syn_spk * 13
        else:
            n_bytes = (ss.q + 1) * 4 + kept * (4 + 4) + active * 1
        bms, by = bound(n_bytes, 0)
        restore = lambda: [g[k].copy_(gpu[k]) for k in keys]
        launch = lambda: fn(g, tb, *args)
        plain = lambda: fn(g, tb, *((False,) if counter else ()))
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=None, max_abs_err=err,
            ms=in_place_ms(launch, restore),
            device_ms=device_ms(launch, restore=restore, kernel=kname.split(
                "<")[0]),
            plain_ms=None, bound_ms=bms, bound_by=by, library_ms=None,
            library_note="no PyTorch call does it", equal=equal,
            tolerance="bit-equal (ring, w, last_arr, last_post, v, u, spikes "
                      "and counts) to the plain version on a CPU copy",
            kernel=kname, density="main", bytes=n_bytes,
            shape=dict(chunk=c, rows=rows_n, kept=kept, arrived=arrived,
                       spiking_rows=int(spk_rows.numel()),
                       synapses_of_spiking=syn_spk, active=active, t=t)))
        # the plain version on the card (the same ops on CUDA tensors)
        rows[-1]["plain_ms"] = _plain_on_card_ms(name, g, tb, lo, t, D, exc,
                                                 nv, kw, ltp_kw, restore)
        del g, w
    return rows, failed


def _plain_on_card_ms(name, g, tb, lo, t, D, exc, nv, kw, ltp_kw, restore):
    """The plain version's ms on the card, on restored inputs (its ops on
    CUDA tensors; t an int)."""
    if name == "stdp_phase_a_chunk":
        fn = lambda: kref.stdp_phase_a_chunk(
            g["ring"], t % D, tb, lo, exc, nv, g["stim_idx"][0],
            g["stim_amp"][0], g["v"], g["u"], g["last_post"], g["w"],
            g["last_arr"], t, g["out"], g["counts"], accumulate=False,
            with_ltp=True, **kw)
    elif name == "stdp_ltp_chunk":
        fn = lambda: kref.stdp_ltp_chunk(g["spiked"], tb, lo, g["last_arr"],
                                         g["w"], g["last_post"], t, **ltp_kw)
    else:
        fn = lambda: kref.arborize_chunk(g["ring"], g["spiked_src"], tb, t)
    return in_place_ms(fn, restore, calls=3, warmup=1)


def phase_stream_kernels(sp8s):
    """`chunk_tables` and the chunk-window kernels against their plain
    versions (`_chunk_tables_rows`, `_window_rows`); returns the rows of
    the `kernels` line (chunk_tables at the 8x8 interior chunk, the
    windows)."""
    t0 = time.perf_counter()
    sp4r = _stream_program(GridConfig(grid_x=4, grid_y=4), 3, 4, "block")
    build_s = time.perf_counter() - t0
    rows, failed = _chunk_tables_rows(sp8s, sp4r)
    w_rows, w_failed = _window_rows(sp8s)
    rows += w_rows
    failed += w_failed
    emit({"phase": "stream_kernels", "ragged_plan_build_s": build_s,
          "stream_ptxas": _build.inspect("stream.cu")["ptxas"],
          "rows": rows})
    if failed:
        raise PhaseFailed(f"streamed kernels differ from their plain "
                          f"versions: {failed}")
    return [r for r in rows if r.get("density") == "main"]


def _host_build_equal(sp) -> dict:
    """The reference's host builder (`connectivity.build_all_streamed`,
    numpy) on sp's configuration, timed, against the plan and initial
    weights `stream_engine.build` made on the card."""
    t0 = time.perf_counter()
    shards = connectivity.build_all_streamed(
        sp.spec.cfg, sp.spec.eng, sp.spec.stream.chunk_cols)
    seconds = time.perf_counter() - t0
    w = sp.init_state().w.cpu().numpy()
    e_start = sp.splan.e_start.cpu().numpy()
    equal = all(
        np.array_equal(e_start[h], s.e_start)
        and np.array_equal(sp.splan.cand[h].cpu().numpy(), s.cand)
        and np.array_equal(sp.plan.src_gid[h].cpu().numpy(), s.src_gid)
        and np.array_equal(w[h, :s.n_valid], s.weight0)
        and not w[h, s.n_valid:].any() for h, s in enumerate(shards))
    return dict(equal=equal, host_builder_s=seconds)


def phase_stream_check():
    """Streamed connectivity at 4x4 full width, 150 steps, K = 1 and K = 3
    (at H = 4 a shard owns 4 columns: the last chunk is ragged), three
    layouts: the captured graph's run, a second run (replays only) and the
    eager loop give the same bits, and the raster and weight signatures
    of the committed JAX reference's (materialized) runs, the modes being
    bit-identical; each chunk regenerated twice a step, the phase-A row
    kernel and the element walk once a chunk, no other SNN kernel; the
    flag clear; a whole run of replays under sync-debug "error"."""
    with open(os.path.join(HERE, "src", "repro_torch", "data",
                           "jax_reference.json")) as f:
        ref = json.load(f)
    cfg = GridConfig(**ref["grid"],
                     neurons_per_column=ref["neurons_per_column"],
                     synapses_per_neuron=ref["synapses_per_neuron"])
    steps = ref["steps"]
    results, failed = {}, []
    for chunk in STREAM_CHECK_CHUNKS:
        for name, r in ref["runs"].items():
            key = f"k{chunk}_{name}"
            t0 = time.perf_counter()
            sp = _stream_program(cfg, chunk, r["n_shards"], r["placement"])
            build_s = time.perf_counter() - t0
            host = None
            if (chunk, name) == (1, "h1_block"):
                host = _host_build_equal(sp)
            state0 = sp.init_state()
            t0 = time.perf_counter()
            first, graph_counts = _counted_run(sp, state0, steps, True)
            wall = time.perf_counter() - t0
            rsig, wsig, raster_np = _signatures(sp, first[0], first[1])
            per_step = raster_np.sum(axis=(1, 2)).astype(int)
            replayed = sp.run(state0, 0, steps)
            eager, counts = _counted_run(sp, state0, steps, False)
            torch.cuda.synchronize()
            status = int(sp.runner.chunks.status[0])
            same = _same_run(first, replayed) and _same_run(first, eager)
            want = _stream_counts(steps, sp.spec.stream.n_chunks)
            ok = (rsig == r["raster_signature"]
                  and wsig == r["weight_signature"]
                  and counts["counted"] == want
                  and graph_counts["total"] == want and same and status == 0)
            err = _graph_replays_sync_debug(sp, state0, 0, steps)
            res = dict(raster_equal=rsig == r["raster_signature"],
                       weights_equal=wsig == r["weight_signature"],
                       graph_equal_to_replays_and_eager=same, status=status,
                       spikes=int(per_step.sum()),
                       n_chunks=sp.spec.stream.n_chunks,
                       live_width=sp.runner.chunks.tables.src.shape[1],
                       launches=counts["counted"],
                       graph_launches=graph_counts, wall_s=wall,
                       build_s=build_s, host_build=host,
                       graph_replays_sync_debug_error=err)
            if host is not None and not host["equal"]:
                failed.append(f"{key} (the card's build differs from the "
                              f"host builder's)")
            if not ok:
                failed.append(key)
                res["first_step_spike_count_differs"] = _first_divergence(
                    per_step, np.asarray(r["spikes_per_step"]))
            if err is not None:
                failed.append(f"{key} (graph replays, sync-debug)")
            results[key] = res
            del sp, first, replayed, eager
            torch.cuda.empty_cache()
    emit({"phase": "stream_check", "grid": "4x4", "steps": steps,
          "chunks": list(STREAM_CHECK_CHUNKS), "runs": results})
    if failed:
        raise PhaseFailed(f"the streamed path differs from the JAX "
                          f"reference: {failed}")


def phase_stream_timed(sp8s, sp8, build_s: float):
    """The streamed 8x8 program (K = 1, H = 1, 64 chunks), STREAM_STEPS
    steps after a warm-up that captures the graph, as the graph's run and
    as the eager loop (the same bits): ms a step, the capture's seconds,
    launches, device busy, operations a step and idle share over the graph
    run (torch.profiler), and device memory beside the materialized
    program's (sp8, this script's dense 8x8 program): the program's own
    bytes (plan, streamed plan, state, live tables) and the run's peak
    above what was allocated before it.  Returns the eager run's launches
    of the streamed kernels."""
    from torch.profiler import ProfilerActivity, profile
    cfg = sp8s.spec.cfg
    n_chunks = sp8s.spec.stream.n_chunks
    state0 = sp8s.init_state()
    W = engine.RUN_WINDOW
    runs = {}
    for mode in ("graph", "eager"):
        graph = mode == "graph"
        sp8s.run(state0, 0, 2 * W, graph=graph)     # warm (and capture)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, counts = _counted_run(sp8s, state0, STREAM_STEPS, graph)
        wall = time.perf_counter() - t0
        runs[mode] = dict(out=out, wall=wall, counts=counts,
                          peak_above=torch.cuda.max_memory_allocated() - base)
    runner = sp8s.runner
    sp8s.runner.chunks.check()
    # the capture alone: the same window's steps captured again
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (torch.cuda.stream(runner.stream),
          _build.own_scratch(runner.scratch)):
        runner._capture()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    same = _same_run(runs["graph"]["out"], runs["eager"]["out"])
    sp8s.run(state0, 0, STREAM_STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        c0 = time.perf_counter()
        sp8s.run(state0, 0, STREAM_STEPS)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - c0
    ev = sorted(((us, k, c) for k, us, c in device_kernel_events(prof)),
                reverse=True)
    busy_us = sum(e[0] for e in ev)
    g = runs["graph"]["out"]
    raster_np = g[1].cpu().numpy()
    rate = observables.mean_rate_hz(raster_np, cfg.n_neurons)
    dense_state = sp8.init_state()
    dense = sp8.run(dense_state, 0, STREAM_STEPS)
    equal_dense = (torch.equal(dense[1], g[1]) and sp8.weight_signature(
        dense[0]) == sp8s.weight_signature(g[0]))
    want = _stream_counts(STREAM_STEPS, n_chunks)
    line = dict(
        phase="stream_timed", grid=f"{cfg.grid_x}x{cfg.grid_y}",
        neurons=cfg.n_neurons, synapses=cfg.n_synapses, chunk=1,
        n_chunks=n_chunks, steps=STREAM_STEPS, window=W,
        graph_nodes_per_window=sum(runner.recorded.values()),
        capture_s=capture_s, build_s=build_s,
        graph_equal_to_eager=same, rate_hz=rate,
        synaptic_events=int(g[2].arrivals.sum()),
        raster_signature=observables.raster_signature(
            raster_np, sp8s.plan.gid.cpu().numpy()).hex(),
        weight_signature=sp8s.weight_signature(g[0]).hex(),
        raster_and_weights_equal_to_materialized=equal_dense,
        profile=dict(
            wall_s=prof_wall,
            device_busy_ms_per_step=busy_us * 1e-3 / STREAM_STEPS,
            device_idle_share=1.0 - busy_us * 1e-6 / prof_wall,
            device_ops_per_step=sum(e[2] for e in ev) / STREAM_STEPS,
            top=[dict(name=k[:90], device_ms_per_step=us * 1e-3
                      / STREAM_STEPS, calls=c) for us, k, c in ev[:10]]),
        memory=dict(
            streamed_program_bytes=_program_bytes(
                sp8s.plan, sp8s.splan, state0, runner.chunks.tables),
            streamed_live_table_bytes=stream_engine.live_table_bytes(
                sp8s.spec, sp8s.splan),
            reference_streamed_table_bytes=stream_engine.
            streamed_table_bytes(sp8s.spec),
            materialized_table_bytes=stream_engine.materialized_table_bytes(
                sp8.spec.e_cap),
            materialized_program_bytes=_program_bytes(sp8.plan,
                                                      dense_state)))
    for mode, r in runs.items():
        line[mode] = dict(
            wall_s=r["wall"], ms_per_step=r["wall"] / STREAM_STEPS * 1e3,
            s_per_synapse_per_sim_s_per_hz=timing.norm_seconds(
                r["wall"], cfg.n_synapses, STREAM_STEPS, rate),
            run_peak_above_program_bytes=r["peak_above"],
            launches=r["counts"]["counted"],
            replayed_launches=r["counts"]["replayed"],
            launches_as_expected=r["counts"]["total"] == want)
    line["eager"]["launches_as_expected"] &= (
        runs["eager"]["counts"]["counted"] == want)
    emit(line)
    if not same or not equal_dense:
        raise PhaseFailed(f"the streamed 8x8 run differs from its eager "
                          f"loop ({same}) or from the materialized run "
                          f"({equal_dense})")
    if not all(line[m]["launches_as_expected"] for m in runs):
        raise PhaseFailed(f"streamed: kernels not launched as expected: "
                          f"{line['graph']}, {line['eager']}")
    return {k: runs["eager"]["counts"]["counted"][k]
            for k in ops.STREAM_KERNELS + ops.STREAM_SPLIT_KERNELS}


# ----------------------------------------------------------------------------
# the mesh: torch.distributed ranks on the card
# ----------------------------------------------------------------------------

MESH_STEPS_8X8 = 200
MESH_SHARDS = 4
# each rank joins the job (cluster.runtime), then runs one function of this
# script, imported as a module: it imports what it needs itself
_MESH_RANK_CODE = """
import sys
sys.path[:0] = [{here!r}, {src!r}]
from repro_torch.cluster import runtime
runtime.ensure_initialized()
import chip_smoke
chip_smoke.{fn}({args!r})
"""


def _mesh_launches(kops, delivery: str, n_chunks, pipelined: bool,
                   n: int) -> dict:
    """The SNN kernels one rank launches in an eager run of n steps (the
    pipelined schedule: the split phase A and one phase B more, the
    prologue's all-False one)."""
    b = n + 1 if pipelined else n
    if n_chunks:
        # chunk_tables before each chunk of phase A, of LTP and of phase B
        want = dict(chunk_tables=n_chunks * (n + (n if pipelined else 0)
                                             + b),
                    stdp_phase_a_chunk=n_chunks * n,
                    arborize_chunk=n_chunks * b)
        if pipelined:
            want["stdp_ltp_chunk"] = n_chunks * n
    elif delivery == "event":
        want = dict.fromkeys(kops.EVENT_KERNELS, n)
        want["event_emit"] = b
        if pipelined:
            want["event_compact"] = n
    else:
        want = dict(stdp_phase_a=n, arborize=b)
        if pipelined:
            want["stdp_ltp"] = n
    return dict(dict.fromkeys(_snn_counted(kops), 0), **want)


def mesh_rank(args: dict) -> None:
    """Inside each rank of a mesh job on the card: each group of cells
    builds once (every rank the full host plan; its block on its card),
    then each cell runs `args["steps"]` steps through `StepProgram.run`
    over the mesh; the primary emits, a cell, whether the gathered raster
    and weights equal the reference's, the gathered `sat`, every rank's
    launches against what the path launches, and the wall."""
    import torch
    from repro_torch.bench.subproc import emit as emit_result
    from repro_torch.cluster import runtime
    from repro_torch.core import (EngineConfig, GridConfig, StepProgram,
                                  event_engine, observables)
    from repro_torch.dist.mesh import make_snn_mesh
    from repro_torch.kernels import ops as kops
    names = _snn_counted(kops)
    cfg, steps, H = GridConfig(**args["grid"]), args["steps"], MESH_SHARDS
    for g in args["groups"]:
        t0 = time.perf_counter()
        mesh = make_snn_mesh(H)
        sp0 = StepProgram(cfg, EngineConfig(n_shards=H, **g["build"]),
                          mesh=mesh)
        state0, caps = sp0.init_state(), None
        if sp0.eplan is not None:
            state0 = event_engine.init_event_state(
                sp0.spec, state0.base, sp0.spec.e_cap)
            caps = event_engine.no_drop_caps(sp0.spec)
        build_s = time.perf_counter() - t0
        for c in g["cells"]:
            eng = dataclasses.replace(sp0.spec.eng, exchange=c["exchange"],
                                      exchange_schedule=c["schedule"])
            sp = StepProgram.from_parts(
                sp0.spec._replace(eng=eng), sp0.plan, state0,
                eplan=sp0.eplan, splan=sp0.splan, caps=caps, mesh=mesh)
            block = sp.place(state0)
            torch.cuda.synchronize()
            kops.reset_launch_counts()
            t1 = time.perf_counter()
            st, raster, _ = sp.run(block, 0, steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            counts = kops.launch_counts()
            ranks = runtime.gather(torch.tensor([[counts[k]
                                                  for k in names]]))
            raster, full = sp.gather_raster(raster), sp.gather(st)
            if not runtime.is_primary():
                continue
            want = _mesh_launches(
                kops, eng.delivery,
                sp.spec.stream.n_chunks if sp.splan is not None else 0,
                eng.exchange_schedule == "pipelined", steps)
            ranks = [dict(zip(names, r)) for r in ranks.tolist()]
            ref = c["want"]
            rsig = observables.raster_signature(
                raster.numpy(), sp.plan.gid.numpy()).hex()
            sat = (full.sat.tolist() if sp.eplan is not None else None)
            emit_result(dict(
                name=c["name"], wire=mesh.backend, ranks=mesh.world,
                raster_equal=rsig == ref["raster_signature"],
                weights_equal=(sp.weight_signature(full).hex()
                               == ref["weight_signature"]),
                spikes=int(raster.sum()), sat=sat,
                sat_equal=sat is None or (sat == ref["sat"]
                                          and not any(sat)),
                launches_as_expected=all(r == want for r in ranks),
                launches={k: v for k, v in ranks[0].items() if v},
                wall_s=wall, build_s=build_s))


def mesh_timing_rank(args: dict) -> None:
    """Inside each rank: the 8x8 dense halo program at H = MESH_SHARDS,
    under each schedule: `time_phases` (the primary's phase walls, the
    exchange's fence including the wire) and the eager run's wall from a
    barrier to the last rank's end, each after a warm-up; the gathered
    raster's signature."""
    import torch
    from repro_torch.bench.subproc import emit as emit_result
    from repro_torch.cluster import runtime
    from repro_torch.core import (EngineConfig, GridConfig, StepProgram,
                                  observables)
    from repro_torch.dist.mesh import make_snn_mesh
    cfg, steps = GridConfig(**args["grid"]), args["steps"]
    t0 = time.perf_counter()
    mesh = make_snn_mesh(MESH_SHARDS)
    sp0 = StepProgram(cfg, EngineConfig(n_shards=MESH_SHARDS,
                                        exchange="halo"), mesh=mesh)
    build_s = time.perf_counter() - t0

    def barrier():
        torch.cuda.synchronize()
        mesh.wire.all_reduce_sum(torch.zeros(1, device=mesh.device))

    for sched in ("sync", "pipelined"):
        eng = dataclasses.replace(sp0.spec.eng, exchange_schedule=sched)
        sp = StepProgram.from_parts(sp0.spec._replace(eng=eng), sp0.plan,
                                    sp0.init_state(), mesh=mesh)
        block = sp.place(sp0.init_state())
        _, times, _, counts = sp.time_phases(block, 0, steps)
        sp.run(block, 0, 10)                         # warm-up
        barrier()
        t1 = time.perf_counter()
        _, raster, _ = sp.run(block, 0, steps)
        barrier()
        wall = time.perf_counter() - t1
        raster = sp.gather_raster(raster)
        if runtime.is_primary():
            total = sum(times.values())
            emit_result(dict(
                schedule=sched, ranks=mesh.world, wire=mesh.backend,
                run_ms_per_step=wall / steps * 1e3,
                phases_ms_per_step={k: v / steps * 1e3
                                    for k, v in times.items()},
                exchange_share=times["exchange_s"] / total,
                spikes=counts["spikes"], build_s=build_s,
                raster_signature=observables.raster_signature(
                    raster.numpy(), sp.plan.gid.numpy()).hex()))


def _start_mesh_job(fn: str, args: dict, n_ranks: int, timeout: float):
    from repro_torch.bench import subproc
    code = _MESH_RANK_CODE.format(here=HERE, src=os.path.join(HERE, "src"),
                                  fn=fn, args=args)
    return subproc.Ranks(code, n_ranks, device="cuda", timeout=timeout)


def _stacked_timing(grid: dict, steps: int) -> list:
    """R = 1: the same 8x8 halo program at H = MESH_SHARDS stacked on the
    card in this process: `time_phases` under each schedule and the
    captured graph's run, after a warm-up."""
    cfg = GridConfig(**grid)
    t0 = time.perf_counter()
    sp0 = StepProgram(cfg, EngineConfig(n_shards=MESH_SHARDS,
                                        exchange="halo"), device="cuda")
    build_s = time.perf_counter() - t0
    state0 = sp0.init_state()
    out = []
    for sched in ("sync", "pipelined"):
        eng = dataclasses.replace(sp0.spec.eng, exchange_schedule=sched)
        sp = StepProgram.from_parts(sp0.spec._replace(eng=eng), sp0.plan,
                                    state0)
        _, times, _, counts = sp.time_phases(state0, 0, steps)
        sp.run(state0, 0, 2 * engine.RUN_WINDOW)   # warm-up, capture
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, raster, _ = sp.run(state0, 0, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        total = sum(times.values())
        out.append(dict(
            schedule=sched, ranks=1, wire="stacked (one process)",
            run_ms_per_step=wall / steps * 1e3, run="captured graph",
            phases_ms_per_step={k: v / steps * 1e3
                                for k, v in times.items()},
            exchange_share=times["exchange_s"] / total,
            spikes=counts["spikes"], build_s=build_s,
            raster_signature=observables.raster_signature(
                raster.cpu().numpy(), sp.plan.gid.cpu().numpy()).hex()))
    return out


def phase_mesh(card: str):
    """The mesh on the card: R = 2 and R = 4 ranks of a torch.distributed
    job sharing the one GPU (the wire gloo, staged through pinned host
    memory), and one rank under NCCL; at 4x4 full width, 150 steps, each
    cell's gathered raster and weights equal to `jax_reference.json`, and
    every rank's kernels launched as the path launches them; then the 8x8
    dense halo program at H = 4, MESH_STEPS_8X8 steps, stacked (R = 1) and
    over 4 ranks, under each schedule: ms a step and the exchange's share
    of `time_phases`, beside the card's name and power limit."""
    from repro_torch.bench import subproc
    with open(os.path.join(HERE, "src", "repro_torch", "data",
                           "jax_reference.json")) as f:
        ref = json.load(f)
    grid = dict(ref["grid"], neurons_per_column=ref["neurons_per_column"],
                synapses_per_neuron=ref["synapses_per_neuron"])
    dense, scatter = ref["runs"]["h4_block"], ref["runs"]["h4_scatter"]
    event = ref["event_runs"]["h4_block"]

    def cells(want, pairs):
        return [dict(name=f"{ex}_{sc}", exchange=ex, schedule=sc,
                     want=want) for ex, sc in pairs]
    every = [(ex, sc) for ex in EXCHANGES for sc in ("sync", "pipelined")]
    groups = [
        dict(build=dict(delivery="dense"), cells=cells(dense, every)),
        dict(build=dict(placement="scatter"),
             cells=cells(scatter, [("allgather", "sync")])),
        dict(build=dict(delivery="event"), cells=[
            dict(c, name="event_" + c["name"]) for c in cells(
                event, [("allgather", "sync"), ("halo", "pipelined")])]),
        dict(build=dict(connectivity="streamed:chunk=1"), cells=[
            dict(c, name="streamed_" + c["name"]) for c in cells(
                dense, [("halo", "sync"), ("halo", "pipelined")])])]
    nccl_groups = [dict(build=dict(delivery="dense"), cells=cells(
        dense, [("halo", "sync"), ("allgather", "sync")]))]
    # one rank holding every shard runs streamed scatter, which more ranks
    # refuse (the chunk kernel reads a block row's index as its shard id)
    nccl_r1_groups = nccl_groups + [
        dict(build=dict(placement="scatter",
                        connectivity="streamed:chunk=1"),
             cells=[dict(c, name="streamed_scatter_" + c["name"])
                    for c in cells(scatter, [("halo", "sync")])])]
    args = dict(grid=grid, steps=ref["steps"], groups=groups)
    n_dev = torch.cuda.device_count()
    t0 = time.perf_counter()
    jobs = {f"R{R}": _start_mesh_job("mesh_rank", args, R, 420)
            for R in (2, 4)}
    jobs["nccl_R1"] = _start_mesh_job(
        "mesh_rank", dict(args, groups=nccl_r1_groups), 1, 420)
    if n_dev >= 2:
        jobs["nccl_R2"] = _start_mesh_job(
            "mesh_rank", dict(args, groups=nccl_groups), 2, 420)
    results, failed = {}, []
    for key, job in jobs.items():
        try:
            results[key] = subproc.results(job.wait())
        except subproc.RanksError as e:
            failed.append(key)
            results[key] = str(e)[-3000:]
    check_s = time.perf_counter() - t0
    for key, rows in results.items():
        if isinstance(rows, str):
            continue
        # NCCL where every rank has a GPU of its own (cluster.runtime)
        R = int(key.rsplit("R", 1)[1])
        want_wire = "nccl" if R <= n_dev else "gloo, host-staged"
        n_cells = sum(len(g["cells"]) for g in dict(
            nccl_R1=nccl_r1_groups, nccl_R2=nccl_groups).get(key, groups))
        ok = len(rows) == n_cells and all(
            r["raster_equal"] and r["weights_equal"] and r["sat_equal"]
            and r["launches_as_expected"] and r["wire"] == want_wire
            for r in rows)
        if not ok:
            failed.append(key)
    emit({"phase": "mesh_check", "grid": "4x4", "shards": MESH_SHARDS,
          "steps": ref["steps"], "device_count": n_dev,
          "nccl_multi_rank": ("run: R = 2" if n_dev >= 2
                              else "not run: 1 device"),
          "seconds": check_s, "jobs": results})
    if failed:
        raise PhaseFailed(f"mesh cells failed or differ from the JAX "
                          f"reference: {failed}")

    # 8x8 full width (12.8 M synapses): R = 1 stacked, then R = 4 ranks
    grid8 = dict(grid_x=8, grid_y=8)
    t0 = time.perf_counter()
    timing_rows = _stacked_timing(grid8, MESH_STEPS_8X8)
    torch.cuda.empty_cache()
    try:
        timing_rows += subproc.results(_start_mesh_job(
            "mesh_timing_rank", dict(grid=grid8, steps=MESH_STEPS_8X8),
            MESH_SHARDS, 420).wait())
    except subproc.RanksError as e:
        raise PhaseFailed(f"the 8x8 mesh timing failed: {str(e)[-3000:]}")
    print(card, flush=True)
    same = len({r["raster_signature"] for r in timing_rows}) == 1
    emit({"phase": "mesh_timed", "card": card, "grid": "8x8",
          "synapses": 12_800_000, "shards": MESH_SHARDS, "exchange": "halo",
          "steps": MESH_STEPS_8X8, "seconds": time.perf_counter() - t0,
          "rasters_equal": same, "rows": timing_rows})
    if not same or len(timing_rows) != 4:
        raise PhaseFailed("the 8x8 mesh runs differ from the stacked one")



# ----------------------------------------------------------------------------
# checkpoints and the supervised cluster runtime
# ----------------------------------------------------------------------------

CKPT_SAVE_T = 50        # ckpt_check's cases save at this step
CKPT_ODD_T = 30         # and one restores off the captured graph's window
# (name, saving layout, restoring layout, t): a layout is (delivery, H,
# placement, chunk K or None for materialized connectivity)
CKPT_CASES = (
    ("dense_h1_to_h4_block", ("dense", 1, "block", None),
     ("dense", 4, "block", None), CKPT_SAVE_T),
    ("dense_h4_block_to_h4_scatter", ("dense", 4, "block", None),
     ("dense", 4, "scatter", None), CKPT_SAVE_T),
    ("event_h4_block_to_h1", ("event", 4, "block", None),
     ("event", 1, "block", None), CKPT_SAVE_T),
    ("streamed_k1_to_k2_h4", ("dense", 4, "block", 1),
     ("dense", 4, "block", 2), CKPT_SAVE_T),
    ("dense_h4_block_to_h1_t30", ("dense", 4, "block", None),
     ("dense", 1, "block", None), CKPT_ODD_T))
CLUSTER_FAULTS = (("crash", "crash@step=50:rank=1"),
                  ("corrupt_ckpt", "corrupt_ckpt@step=100"))


def _ckpt8_state(sp8) -> tuple:
    """(spec, plan, state, t) of the dense 8x8 program after CKPT_SAVE_T
    steps, plan and state copied to the host: ckpt_check times a save and
    a load of it."""
    state, _, _ = sp8.run(sp8.init_state(), 0, CKPT_SAVE_T)
    cpu = lambda tree: engine.map_state(torch.Tensor.cpu, tree)
    return sp8.spec, cpu(sp8.plan), cpu(state), CKPT_SAVE_T


def _ckpt_program(cfg, layout, cache: dict, device: str = "cuda"):
    """The program of a CKPT_CASES layout on `device`, built once."""
    key = (layout, device)
    if key not in cache:
        delivery, h, placement, chunk = layout
        if chunk is None:
            cache[key] = _program(cfg, EngineConfig(
                n_shards=h, placement=placement, delivery=delivery),
                device=device)
        else:
            cache[key] = _stream_program(cfg, chunk, h, placement)
    return cache[key]


def _ckpt_want(ref: dict, layout) -> dict:
    """The reference run whose layout a restore has."""
    delivery, h, placement, _ = layout
    runs = ref["event_runs"] if delivery == "event" else ref["runs"]
    return runs[f"h{h}_{placement}"]


def _digest(path: str) -> str:
    with np.load(path) as z:
        return str(z["payload_sha256"])


def ckpt_rank(args: dict) -> None:
    """Inside each rank: H = 4 dense block shards over the job's ranks.
    "save": run 0 -> t, the primary saves the gathered state with the
    gathered raster's events; "load": every rank restores the file and
    places its block, runs t -> steps, and the primary reports the
    signatures of the file's events followed by its own, and the
    weights'."""
    from repro_torch.bench.subproc import emit as emit_result
    from repro_torch.cluster import runtime
    from repro_torch.core import (EngineConfig, GridConfig, StepProgram,
                                  checkpoint, observables)
    from repro_torch.dist.mesh import make_snn_mesh
    cfg, t = GridConfig(**args["grid"]), args["t"]
    mesh = make_snn_mesh(4)
    sp = StepProgram(cfg, EngineConfig(n_shards=4), mesh=mesh)
    gid = sp.plan.gid.numpy()
    if args["mode"] == "save":
        state, raster, _ = sp.run(sp.place(sp.init_state()), 0, t)
        raster, full = sp.gather_raster(raster), sp.gather(state)
        if runtime.is_primary():
            checkpoint.save(args["path"], sp.spec, sp.plan, full, t,
                            raster_events=observables.raster_events(
                                raster.numpy(), gid))
            emit_result(dict(saved=args["path"], ranks=mesh.world,
                             wire=mesh.backend))
        return
    state, t0 = sp.load(args["path"])
    state, raster, _ = sp.run(sp.place(state), t0, args["steps"] - t0)
    raster, full = sp.gather_raster(raster), sp.gather(state)
    if runtime.is_primary():
        ev_t, ev_g = checkpoint.load_raster_events(args["path"])
        ct, cg = observables.raster_events(raster.numpy(), gid, t0=t0)
        emit_result(dict(
            t=t0, ranks=mesh.world, wire=mesh.backend,
            raster_signature=observables.events_signature(
                np.concatenate([ev_t, ct]), np.concatenate([ev_g, cg])).hex(),
            weight_signature=sp.weight_signature(full).hex()))


def phase_ckpt(card: str, ckpt8: tuple):
    """Checkpoints on the card (`core.checkpoint`, `StepProgram.load`) at
    the full width of `jax_reference.json` (4x4, 150 steps): each case of
    CKPT_CASES runs 0 -> t on the card through the graph, saves, loads
    into a fresh program of another layout and runs t -> 150; the two
    windows' events give the reference's raster signature and the final
    weights the weight signature of the reference run of the restoring
    layout.  At 2x2 full width the file the card writes at t = 50 (dense
    and event) has the payload digest of the one the CPU plain path
    writes.  Over ranks, an R = 2 job saves and an R = 4 job restores
    (both sharing the card).  At 8x8 dense: save and load seconds and
    the file's bytes (host work), beside the card and the host's CPUs."""
    import tempfile
    from repro_torch.bench import subproc
    from repro_torch.core import checkpoint
    with open(os.path.join(HERE, "src", "repro_torch", "data",
                           "jax_reference.json")) as f:
        ref = json.load(f)
    grid = dict(ref["grid"], neurons_per_column=ref["neurons_per_column"],
                synapses_per_neuron=ref["synapses_per_neuron"])
    cfg, steps = GridConfig(**grid), ref["steps"]
    tmp = tempfile.mkdtemp(prefix="ckpt_check_")
    t_phase = time.perf_counter()
    rank_args = dict(grid=grid, t=CKPT_SAVE_T, steps=steps,
                     path=os.path.join(tmp, "ranks.npz"))
    job = _start_mesh_job("ckpt_rank", dict(rank_args, mode="save"), 2, 420)
    programs, cases, failed = {}, {}, []
    for name, a, b, t in CKPT_CASES:
        spa = _ckpt_program(cfg, a, programs)
        spb = _ckpt_program(cfg, b, programs)
        s_a, r_a, _ = spa.run(spa.init_state(), 0, t)
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        path = checkpoint.save(os.path.join(tmp, f"{name}.npz"), spa.spec,
                               spa.plan, s_a, t)
        save_s = time.perf_counter() - c0
        c0 = time.perf_counter()
        state, t_back = spb.load(path)
        load_s = time.perf_counter() - c0
        s_b, r_b, _ = spb.run(state, t_back, steps - t_back)
        ev = [observables.raster_events(r.cpu().numpy(),
                                        sp.plan.gid.cpu().numpy(), t0=t0)
              for r, sp, t0 in ((r_a, spa, 0), (r_b, spb, t_back))]
        rsig = observables.events_signature(
            np.concatenate([e[0] for e in ev]),
            np.concatenate([e[1] for e in ev])).hex()
        want = _ckpt_want(ref, b)
        res = dict(t=t_back, raster_equal=rsig == want["raster_signature"],
                   weights_equal=(spb.weight_signature(s_b).hex()
                                  == want["weight_signature"]),
                   restore_replays=spb.runner.replays, save_s=save_s,
                   load_s=load_s, file_bytes=os.path.getsize(path))
        if a[0] == "event":
            res["sat"] = int(s_b.sat.sum())
        cases[name] = res
        if not (res["raster_equal"] and res["weights_equal"]
                and t_back == t and not res.get("sat")):
            failed.append(name)
    del programs
    torch.cuda.empty_cache()

    # the card's file and the CPU plain path's, 2x2 full width, t = 50
    cfg2, devices = GridConfig(grid_x=2, grid_y=2), {}
    for delivery in ("dense", "event"):
        layout = (delivery, 2, "block", None)
        digests = []
        for device in ("cuda", "cpu"):
            sp = _ckpt_program(cfg2, layout, {}, device=device)
            s, _, _ = sp.run(sp.init_state(), 0, CKPT_SAVE_T)
            digests.append(_digest(checkpoint.save(os.path.join(
                tmp, f"cross_{delivery}_{device}.npz"), sp.spec, sp.plan,
                s, CKPT_SAVE_T)))
        devices[delivery] = dict(card=digests[0][:16],
                                 equal=digests[0] == digests[1])
        if not devices[delivery]["equal"]:
            failed.append(f"card vs cpu file ({delivery})")

    # R = 2 saves, R = 4 restores
    ranks = {}
    try:
        ranks["save"] = subproc.results(job.wait())
        ranks["load"] = subproc.results(_start_mesh_job(
            "ckpt_rank", dict(rank_args, mode="load"), 4, 420).wait())
        got, want = ranks["load"][0], ref["runs"]["h4_block"]
        ranks["equal"] = (got["raster_signature"] == want["raster_signature"]
                          and got["weight_signature"]
                          == want["weight_signature"]
                          and got["t"] == CKPT_SAVE_T)
    except (subproc.RanksError, IndexError, KeyError) as e:
        ranks["error"] = str(e)[-3000:]
    if not ranks.get("equal"):
        failed.append("R2 -> R4")

    # 8x8 dense, 12.8 M synapses: host work
    spec8, plan8, state8, t8 = ckpt8
    path8 = os.path.join(tmp, "dense_8x8.npz")
    c0 = time.perf_counter()
    checkpoint._global_keys(spec8, plan8)       # the layout's keys, once
    keys_s = time.perf_counter() - c0
    c0 = time.perf_counter()
    checkpoint.save(path8, spec8, plan8, state8, t8)
    save_s = time.perf_counter() - c0
    c0 = time.perf_counter()
    back, t_back = checkpoint.load(path8, spec8, plan8)
    load_s = time.perf_counter() - c0
    same8 = t_back == t8 and all(bit_equal(x, y) for x, y in zip(
        engine.state_tensors(back), engine.state_tensors(state8)))
    if not same8:
        failed.append("8x8 round trip")
    print(card, flush=True)
    emit({"phase": "ckpt_check", "card": card, "grid": "4x4",
          "steps": steps, "cases": cases, "card_vs_cpu_file_2x2": devices,
          "ranks_r2_to_r4": ranks,
          "dense_8x8": dict(
              synapses=int(plan8.row_ptr[:, -1].sum()), t=t8,
              keys_s=keys_s, save_s=save_s, load_s=load_s,
              file_bytes=os.path.getsize(path8), round_trip_equal=same8,
              note="host work; keys_s builds the layout's synapse keys "
                   "and their canonical order (once a process), which "
                   "the save and the load then reuse",
              host_cpus=os.cpu_count(),
              host_cpus_usable=len(os.sched_getaffinity(0))),
          "seconds": time.perf_counter() - t_phase})
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise PhaseFailed(f"checkpoint cases failed: {failed}")


def phase_cluster(card: str):
    """`repro_torch.cluster run --supervise --ckpt-every 50` at 4x4 full
    width, H = 4 over 2 ranks sharing the card, 150 steps, once with each
    fault of CLUSTER_FAULTS (the two launches at once): a crash of rank 1
    at step 50 restarts and restores at t = 50; the epoch at t = 100
    truncated after its write fails its sha256 and recovery falls back to
    t = 50.  Each recovered run's raster and weight signatures must be
    `jax_reference.json`'s h4_block run's.  Prints the restarts, the
    steps salvaged and the wall seconds beside the card."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.cluster import cli as ccli
    with open(os.path.join(HERE, "src", "repro_torch", "data",
                           "jax_reference.json")) as f:
        ref = json.load(f)
    want = ref["runs"]["h4_block"]
    tmp = tempfile.mkdtemp(prefix="cluster_check_")

    def scenario(item):
        name, fault = item
        args = ccli.workload_namespace(
            grid="x".join(str(ref["grid"][k]) for k in ("grid_x", "grid_y")),
            neurons_per_column=ref["neurons_per_column"],
            synapses=ref["synapses_per_neuron"], seed=GridConfig().seed,
            steps=ref["steps"], shards=4, phase_steps=0,
            ckpt_dir=os.path.join(tmp, name), ckpt_every=CKPT_SAVE_T,
            supervise=True, fault=fault, max_restarts=2,
            stall_timeout=240.0, device="cuda")
        t0 = time.perf_counter()
        try:
            row = ccli.run_point(args, 2, timeout=600)
        except Exception as e:          # a LaunchError, with its history
            return name, dict(error=str(e)[-4000:])
        return name, dict(row=row, wall_s=time.perf_counter() - t0)

    t_phase = time.perf_counter()
    with ThreadPoolExecutor(len(CLUSTER_FAULTS)) as ex:
        got = dict(ex.map(scenario, CLUSTER_FAULTS))
    results, failed = {}, []
    for name, fault in CLUSTER_FAULTS:
        g = got[name]
        if "error" in g:
            results[name] = g
            failed.append(name)
            continue
        row, rec = g["row"], g["row"]["recovery"]
        res = dict(fault=fault, restarts=rec["restarts"],
                   restored_t=rec["restored_t"],
                   steps_salvaged=rec["recovered_steps"],
                   attempts=rec["attempts"], wall_s=g["wall_s"],
                   run_wall_s=row["wall_s"], ckpt_wall_s=row["ckpt_wall_s"],
                   wire=row["wire"],
                   raster_equal=row["raster_sig"] == want["raster_signature"],
                   weights_equal=(row["weights_sig"]
                                  == want["weight_signature"]))
        results[name] = res
        if not (res["raster_equal"] and res["weights_equal"]
                and res["restarts"] >= 1 and res["restored_t"] == CKPT_SAVE_T
                and res["steps_salvaged"] == CKPT_SAVE_T):
            failed.append(name)
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    print(card, flush=True)
    emit({"phase": "cluster_check", "card": card, "grid": "4x4",
          "shards": 4, "ranks": 2, "steps": ref["steps"],
          "ckpt_every": CKPT_SAVE_T, "runs": results,
          "seconds": time.perf_counter() - t_phase})
    if failed:
        raise PhaseFailed(f"supervised recovery failed or differs from the "
                          f"JAX reference: {failed}")

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    try:
        card = phase_card()
        lookup = phase_build()
        phase_attn_sass()
        t0 = time.perf_counter()
        # one connectivity build for both deliveries: the event program's
        # plan and initial state are the dense program's
        sp8e = _program(GridConfig(grid_x=8, grid_y=8),
                        EngineConfig(delivery="event"))
        sp8 = StepProgram.from_parts(
            sp8e.spec._replace(eng=EngineConfig()), sp8e.plan,
            sp8e.init_state().base)
        emit({"phase": "build_8x8", "seconds": time.perf_counter() - t0,
              "synapses": int(sp8.plan.row_ptr[:, -1].sum()),
              "cap_ev": sp8e.cap_ev,
              "fwd_rows": list(sp8e.eplan.fwd_rows.shape),
              "in_rows": list(sp8e.eplan.in_rows.shape)})
        rows = phase_kernels(sp8.plan, sp8.spec, sp8e, lookup)
        phase_check()
        launches = phase_timed(sp8, sp8e)
        phase_profile(sp8, sp8e)
        t0 = time.perf_counter()
        sp8s = _stream_program(GridConfig(grid_x=8, grid_y=8), 1)
        build_s = time.perf_counter() - t0
        rows += phase_stream_kernels(sp8s)
        phase_stream_check()
        launches.update(phase_stream_timed(sp8s, sp8, build_s))
        ckpt8 = _ckpt8_state(sp8)
        del sp8, sp8e, sp8s      # so that the later peaks are their own
        torch.cuda.empty_cache()
        phase_mesh(card)
        torch.cuda.empty_cache()
        phase_ckpt(card, ckpt8)
        del ckpt8
        phase_cluster(card)
        torch.cuda.empty_cache()
        phase_bench()
        torch.cuda.empty_cache()
        lm_rows = phase_lm_kernels()
        attn_rows, attn_launches = phase_attn_kernels()
        phase_lm_check()
        params, lm_launches = phase_lm_serve()
        phase_lm_profile(params)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for r in rows:
        # the timed eager runs launched every other SNN kernel 0 times
        # (phase_timed checks it)
        r["launches"] = launches.get(r["name"], 0)
    rows.append(dict(lm_rows[0], launches=lm_launches))   # prefill shape
    rows.append(dict(attn_rows[0], launches=attn_launches))  # rg_local_prefill
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    # The CPU plain versions are yardsticks, so their bits must not depend
    # on the host: ATen's and MKL's CPU kernels otherwise dispatch on the
    # host's vector instruction set (AVX-512, AVX2, ...), and the plain
    # attention's bits follow it (`tests/test_torch_cuda.py --softcap-isa`).
    # Pin both to the code paths every x86-64 host runs alike, before torch
    # starts.
    os.environ.update(ATEN_CPU_CAPABILITY="default", MKL_CBWR="COMPATIBLE")
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch
    from repro_torch.bench import profile as bench_profile
    from repro_torch.bench import timing
    from repro_torch.bench.suites import event_vs_dense, table1, table2
    from repro_torch.cluster import cli as cluster_cli
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import (EngineConfig, GridConfig, StepProgram,
                                  aer, connectivity, engine, event_engine,
                                  observables, stimulus, stream_engine)
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import arborize as karb
    from repro_torch.kernels import event as kev
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import izhikevich as kizh
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import rg_lru as krg
    from repro_torch.kernels import segment_sum as kseg
    from repro_torch.kernels import stdp as kstdp
    from repro_torch.models import convert, lm
    from repro_torch.serve import engine as serve_engine
    from repro_torch.serve import sampling
    sys.exit(main())
