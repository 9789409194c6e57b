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
  bench    the ported suites (`repro_torch.bench`) on the card, one line
           per report (its env, config, deterministic and wall keys):
           `table1` quick (1x1, 4x4, 150 steps; the 4x4 row's raster
           signature must be the committed JAX reference's), `table1` at
           1x1, 4x4, 8x4, 8x8 and 16x16 (51.2 M synapses), 300 steps, with
           each row's build seconds and peak memory, `table2` (2x2, H=1,
           halo, 200 steps) under `sync` and again under `pipelined`
           (equal raster signatures), `profile` (exchange x placement
           at 2x2, H=4, 150 steps; it raises unless every cell gives the
           same raster and totals), and `event_vs_dense` (2x2, 500
           neurons a column, 200 steps, stim 1 and 0: both deliveries'
           rasters must be equal).

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
the delivery whose path the kernel is on, counted by the wrappers, from the lm_serve run, and from
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
# the profiler's names of the STDP kernels (row_kernel<true> is phase A)
STDP_KERNEL_NAMES = {"stdp_phase_a": "row_kernel<true>",
                     "stdp_arrival_current": "row_kernel<false>",
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
    in place)."""
    from torch.profiler import ProfilerActivity, profile
    restore = restore or (lambda: None)
    restore()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            restore()
            fn()
        torch.cuda.synchronize()
    names = (kernel,) if isinstance(kernel, str) else kernel
    rows = [us for k, us, _ in device_kernel_events(prof)
            if any(n in k for n in names) and skip not in k]
    return sum(rows) * 1e-3 / calls if rows else None


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


def _snn_counted() -> tuple:
    """The SNN kernels whose launches `check` and `timed` read: the dense
    path's, those it replaced (off the path: `izhikevich_update`, the
    pair, `arborize_elements`), the event path's, the split schedule's
    `event_compact` and the LTP kernel the event path's replaced."""
    return (ops.SNN_KERNELS + ops.PHASE_A_KERNELS + ops.PAIR_KERNELS
            + ops.PHASE_B_KERNELS + ops.EVENT_KERNELS
            + ops.EVENT_SPLIT_KERNELS + ops.EVENT_YARDSTICKS)


def _path_kernels(delivery: str) -> tuple:
    """The kernels a step of `delivery` launches once each."""
    return ops.SNN_KERNELS if delivery == "dense" else ops.EVENT_KERNELS


def _main_path_counts(steps: int, delivery: str = "dense") -> dict:
    """Each kernel of the delivery's path once a step, every other SNN
    kernel never."""
    return dict(dict.fromkeys(_snn_counted(), 0),
                **dict.fromkeys(_path_kernels(delivery), steps))


def _program(cfg, eng) -> "StepProgram":
    """The program of (cfg, eng) on the card; under event delivery with
    capacities that drop nothing (`event_engine.no_drop_caps`, a ring of
    E events a slot), as the committed reference's event runs."""
    sp = StepProgram(cfg, eng, device="cuda")
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
    evd = event_vs_dense.run_suite(device="cuda")
    _report_line("event_vs_dense", evd, rows=evd["extra"]["rows"])
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    try:
        phase_card()
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
        del sp8, sp8e            # so that the later peaks are their own
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
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import (EngineConfig, GridConfig, StepProgram,
                                  aer, engine, event_engine, observables,
                                  stimulus)
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
