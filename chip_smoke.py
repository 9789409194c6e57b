"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port only (it imports neither jax nor the JAX package) and
prints one JSON line per phase:

  card     the card's name and power limit (nvidia-smi), torch's name;
  build    nvcc builds the kernels from `src/repro_torch/csrc` (one nvcc
           per source, all at once);
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
           The STDP passes (the main path's fused arrival pass and ordered
           sum `stdp_arrival_current`, LTP, and the arrival pass alone)
           run on the 8x8 plan's own synapse arrays and row pointers, with
           the ring and spikes drawn at the main path's density (2.15%)
           and at 10x it; they update their inputs in place, so every
           timed call starts from restored inputs and only the kernel is
           timed (events around it, profiler device time by its own name),
           and their bound counts the bytes these inputs make them move.
           The fused row is also timed against the pair it replaced
           (`stdp_arrival` then `segment_sum_ordered`, bit-equal to it) on
           the same restored inputs: no PyTorch call gives an ordered sum;
  check    the main path (`StepProgram(..., device="cuda").run`) at 4x4,
           full width, 150 steps, at H=1 block, H=4 block, H=4 scatter:
           raster and weight signatures equal to the committed AVX-pinned
           JAX reference (`src/repro_torch/data/jax_reference.json`),
           every main-path kernel (`ops.SNN_KERNELS`) launched once per
           step and the replaced pair never;
  timed    the main path at 8x8 (12.8 M synapses), H=1, 500 steps after a
           warm-up: ms/step, the phase A / exchange / B split from a
           separate synchronised pass, rate, the paper's normalised metric,
           synaptic events/s, peak memory, raster signature, and a
           torch.profiler breakdown by kernel.
  profile  device time by kernel, device busy and idle share, and device
           operations (kernels and copies) per step of the 8x8 path over
           steps 0-19 (nearly silent) and over the timed run's 500 steps
           (activity comes in bursts).

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

Then the `{"kernels": [...]}` line (launches from the timed SNN run, from
the lm_serve run, and from attn_kernels' one call per shape) and, last,
`{"ok": true, "device": {...}}`.  Any failed phase exits non-zero before
that line.  Without a CUDA device, or without the rest of the repository
beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
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
# kernels phase: the STDP passes' inputs flag this share of the valid
# synapses and spike this share of the neurons (the 8x8 timed run's mean:
# 275,342 arrivals a step among 12.8 M synapses, 21.52 Hz), and 10x it
STDP_DENSITY = 0.0215
STDP_REPLACES = {"stdp_arrival_current": "src/repro/kernels/stdp.py:57",
                 "stdp_arrival": "src/repro/kernels/stdp.py:57",
                 "stdp_ltp": "src/repro/kernels/stdp.py:81"}
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


def device_ms(fn, calls: int = 10, restore=None, kernel="") -> float:
    """The device time per call in ms (torch.profiler) of the CUDA kernels
    whose name holds `kernel` (or one of a tuple of names; all of fn's by
    default); `restore()` runs before every call where fn updates its
    inputs in place."""
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
            if any(n in k for n in names)]
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
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return line


def phase_build():
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(path, HERE)})


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


def _stdp_rows(plan8, spec8):
    """The STDP passes (fused arrival and sum, arrival alone, LTP) on
    plan8's own arrays at the main path's density (2.15% of the valid
    synapses arrive, 2.15% of the neurons spike) and at 10x it: bit-equal
    to the plain version on a CPU copy and on the card, in every output
    and updated state tensor, and timed alone; the fused pass also beside
    the pair it replaced, bit-equal to it."""
    stdp = spec8.stdp
    H, E = plan8.syn_valid.shape
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
    pg = dict(valid=plan8.syn_valid, tgt=plan8.syn_tgt,
              plastic=plan8.syn_plastic, row_ptr=plan8.row_ptr)
    pc = {k: v.cpu() for k, v in pg.items()}
    pg["seg"] = kref.make_segments(plan8.row_ptr, E)
    pc["seg"] = kref.make_segments(pc["row_ptr"], E)
    rng = np.random.default_rng(2015)
    rows, failed = [], []
    for label, density in (("main", STDP_DENSITY), ("10x",
                                                    10 * STDP_DENSITY)):
        st = _stdp_state(rng, pc, D, r, t, density)
        traffic, counts = _stdp_traffic(pc, st, r, half_neg)
        saved = {k: v.cuda() for k, v in st.items()}
        work = {k: v.clone() for k, v in saved.items()}

        def restore(*names):
            for k in names:
                src, dst = saved[k], work[k]
                (dst[:, r] if k == "ring" else dst).copy_(
                    src[:, r] if k == "ring" else src)

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

        for name, fn, state, kname in (
                ("stdp_arrival_current", current, ("ring", "w", "last_arr"),
                 "arrival_current_kernel"),
                ("stdp_arrival", arrival, ("ring", "w", "last_arr"),
                 "arrival_kernel"),
                ("stdp_ltp", ltp, ("w", "last_post"), "ltp_kernel")):
            n_bytes, n_flops = traffic[name]
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
            extra = {}
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
                device_ms=device_ms(launch, restore=again, kernel=kname),
                plain_ms=in_place_ms(lambda: fn(kref, work, pg), again,
                                     calls=3, warmup=1),
                bound_ms=bms, bound_by=by, library_ms=None, equal=equal,
                tolerance="bit-equal (every output and updated state "
                          "tensor, 0 ulp), to the plain version on a CPU "
                          "copy and on the card",
                density=label, bytes=n_bytes, flops=n_flops,
                shape={"H": H, "E": E, "D": D,
                       "N": plan8.gid.shape[1], **counts}, **extra))
        del saved, work
    return rows, failed


def phase_kernels(plan8, spec8):
    """Each kernel against its plain version at the 8x8 shapes; returns the
    rows of the `kernels` line (the STDP passes at the main density)."""
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
    emit({"phase": "kernels", "rows": rows})
    if failed:
        raise PhaseFailed(f"kernels differ from their plain versions: "
                          f"{failed}")
    return [r for r in rows if r.get("density", "main") == "main"]


def _first_divergence(a: np.ndarray, b: np.ndarray):
    diff = np.nonzero((a != b).reshape(a.shape[0], -1).any(axis=1))[0]
    return int(diff[0]) if diff.size else None


def _main_path_counts(steps: int) -> dict:
    """Each main-path kernel once a step, the replaced pair never."""
    return dict(dict.fromkeys(ops.SNN_KERNELS, steps),
                **dict.fromkeys(ops.PAIR_KERNELS, 0))


def phase_check():
    """4x4 full width, 150 steps, three layouts, against the committed
    AVX-pinned JAX reference."""
    with open(os.path.join(HERE, "src", "repro_torch", "data",
                           "jax_reference.json")) as f:
        ref = json.load(f)
    cfg = GridConfig(**ref["grid"],
                     neurons_per_column=ref["neurons_per_column"],
                     synapses_per_neuron=ref["synapses_per_neuron"])
    steps = ref["steps"]
    results, failed = {}, []
    for name, r in ref["runs"].items():
        eng = EngineConfig(n_shards=r["n_shards"], placement=r["placement"])
        sp = StepProgram(cfg, eng, device="cuda")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, raster, _ = sp.run(sp.init_state(), 0, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: ops.launch_counts()[k]
                  for k in ops.SNN_KERNELS + ops.PAIR_KERNELS}
        raster_np = raster.cpu().numpy()
        rsig = observables.raster_signature(raster_np,
                                            sp.plan.gid.cpu().numpy()).hex()
        wsig = sp.weight_signature(state).hex()
        per_step = raster_np.sum(axis=(1, 2)).astype(int)
        ok = (rsig == r["raster_signature"] and wsig == r["weight_signature"]
              and counts == _main_path_counts(steps))
        res = dict(raster_equal=rsig == r["raster_signature"],
                   weights_equal=wsig == r["weight_signature"],
                   spikes=int(per_step.sum()), launches=counts,
                   wall_s=wall)
        if not ok:
            failed.append(name)
            res["first_step_spike_count_differs"] = _first_divergence(
                per_step, np.asarray(r["spikes_per_step"]))
            cpu = StepProgram(cfg, eng, device="cpu")
            _, raster_cpu, _ = cpu.run(cpu.init_state(), 0, steps)
            res["first_step_gpu_differs_from_cpu_port"] = _first_divergence(
                raster_np, raster_cpu.numpy())
        results[name] = res
    emit({"phase": "check", "grid": "4x4", "steps": steps,
          "runs": results})
    if failed:
        raise PhaseFailed(f"main path differs from the JAX reference: "
                          f"{failed}")


def phase_timed(sp8):
    spec, plan = sp8.spec, sp8.plan
    cfg = spec.cfg
    state0 = sp8.init_state()
    sp8.run(state0, 0, 20)                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, raster, tm = sp8.run(state0, 0, MAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    launches = {k: counts[k] for k in ops.SNN_KERNELS + ops.PAIR_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    raster_np = raster.cpu().numpy()
    rate = observables.mean_rate_hz(raster_np, cfg.n_neurons)
    events = int(tm.arrivals.sum())
    norm = wall / (cfg.n_synapses * MAIN_STEPS * 1e-3 * max(rate, 1e-9))

    # separate synchronised pass: the per-phase split (paper Table 2)
    fns = engine.make_step_fn(spec, plan, 0, MAIN_STEPS)
    s = engine.clone_state(state0)
    split = dict(phase_a_s=0.0, exchange_s=0.0, phase_b_s=0.0)
    n_split = 100
    for t_ in range(n_split):
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        s, spiked, _ = fns.phase_a(s, t_)
        torch.cuda.synchronize()
        c1 = time.perf_counter()
        ss = fns.exchange(spiked)
        torch.cuda.synchronize()
        c2 = time.perf_counter()
        s = fns.phase_b(s, ss, t_)
        torch.cuda.synchronize()
        c3 = time.perf_counter()
        split["phase_a_s"] += c1 - c0
        split["exchange_s"] += c2 - c1
        split["phase_b_s"] += c3 - c2
    split_ms = {k.replace("_s", "_ms_per_step"): v / n_split * 1e3
                for k, v in split.items()}

    emit({"phase": "timed", "grid": f"{cfg.grid_x}x{cfg.grid_y}",
          "neurons": cfg.n_neurons, "synapses": cfg.n_synapses,
          "shards": spec.eng.n_shards, "steps": MAIN_STEPS,
          "wall_s": wall, "ms_per_step": wall / MAIN_STEPS * 1e3,
          "split_sync_pass": split_ms, "rate_hz": rate,
          "s_per_synapse_per_sim_s_per_hz": norm,
          "synaptic_events": events, "synaptic_events_per_s": events / wall,
          "max_memory_allocated_bytes": peak, "launches": launches,
          "raster_signature": observables.raster_signature(
              raster_np, plan.gid.cpu().numpy()).hex()})
    if launches != _main_path_counts(MAIN_STEPS):
        raise PhaseFailed(f"kernels not launched once per step on the "
                          f"main path (or the replaced pair launched): "
                          f"{launches}")
    return counts


def phase_profile(sp8, n_steps: int = 20):
    """Device time by kernel over two windows (torch.profiler): the first
    `n_steps` steps from the initial state, where the network is still
    nearly silent, and the timed run's whole range, whose activity comes
    in bursts: the STDP kernels' work follows the arrivals and spikes, so
    only the whole run gives their mean."""
    from torch.profiler import ProfilerActivity, profile
    state0 = sp8.init_state()
    windows = {}
    for label, steps in (("first", n_steps), ("run", MAIN_STEPS)):
        sp8.run(state0, 0, steps)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            c0 = time.perf_counter()
            _, _, tm = sp8.run(state0, 0, steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - c0
        rows = sorted(((us, k, c) for k, us, c in device_kernel_events(prof)),
                      reverse=True)
        busy_us = sum(r[0] for r in rows)
        windows[label] = dict(
            steps=steps, wall_s=wall,
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
        phase_build()
        phase_attn_sass()
        t0 = time.perf_counter()
        sp8 = StepProgram(GridConfig(grid_x=8, grid_y=8), EngineConfig(),
                          device="cuda")
        emit({"phase": "build_8x8", "seconds": time.perf_counter() - t0,
              "synapses": int(sp8.plan.row_ptr[:, -1].sum())})
        rows = phase_kernels(sp8.plan, sp8.spec)
        phase_check()
        launches = phase_timed(sp8)
        phase_profile(sp8)
        del sp8                  # so that the LM's peak memory is its own
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
        r["launches"] = launches[r["name"]]
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
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import (EngineConfig, GridConfig, StepProgram,
                                  engine, observables)
    from repro_torch.kernels import _build, ops
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
