"""The port's CUDA kernels on the card (skipped without one).

Each kernel is held bit for bit against its plain PyTorch version on a CPU
copy of the same inputs (attention within 2e-5 fp32 / one bf16 ulp of its
plain version on the card), and short runs of both deliveries on the card
against the CPU port, the captured graph's run against the eager loop.
Run on a machine with an NVIDIA GPU and nvcc:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

`chip_smoke.py` does the same at the main path's full shapes.  Run as a
script, this file computes `chip_smoke.py`'s `softcap` attention row (the
kernel's output, and the plain version's on the card, on the CPU and on
the CPU on one thread) in N separate processes and prints, as JSON, how
many distinct bit patterns each output took and each process's largest
error against each plain version, all processes under one setting of
`SOFTCAP_ISA_ENVS` (by default the one `chip_smoke.py` pins);
`--softcap-isa` does the same once under each setting:

    python tests/test_torch_cuda.py --softcap-processes N [SETTING]
    python tests/test_torch_cuda.py --softcap-isa
"""
import dataclasses
import os
import hashlib
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))     # run as a script
from repro_torch.core import (DEFAULT_IZH, DEFAULT_STDP,  # noqa: E402
                              EngineConfig, GridConfig, StepProgram, aer,
                              engine, event_engine, observables)
from repro_torch.kernels import arborize as kab  # noqa: E402
from repro_torch.kernels import event as kev  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

sys.path.insert(0, str(ROOT / "tests"))
from test_torch_phase_a import (EDGE_CASES, check_edge,  # noqa: E402
                                edge_inputs, run_op)

pytestmark = pytest.mark.cuda

LTD_KW = dict(a_minus=0.12, tau_minus=20.0, w_min=0.0, w_max=10.0,
              neg_time=-1.0e9)
LTP_KW = dict(a_plus=0.1, tau_plus=20.0, w_min=0.0, w_max=10.0,
              neg_time=-1.0e9)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card)")
    return torch.device("cuda")


def _bits_equal(got, want):
    got, want = got.cpu(), want.cpu()
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return torch.equal(got, want)


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    exc = np.arange(n) % 5 != 4
    return dict(
        v=f(rng.uniform(-80, 31, n)), u=f(rng.uniform(-20, 10, n)),
        cur=f(rng.uniform(-10, 25, n)), a=f(np.where(exc, 0.02, 0.1)),
        b=f(np.full(n, 0.2)), c=f(np.full(n, -65.0)),
        d=f(np.where(exc, 8.0, 2.0)))


def _stdp_inputs(H, E, N, D, density, seed=0):
    """The fused STDP passes' arguments in the engine's layout (valid
    synapses first, sorted by target; pads after), with `density` of the
    ring flags (pads included) and of the neurons spiking."""
    rng = np.random.default_rng(seed)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    times = lambda shape: f(np.where(rng.random(shape) < 0.7,
                                     rng.uniform(-2000.0, 200.0, shape),
                                     -1.0e9))
    tgt = np.zeros((H, E), np.int64)
    valid = np.zeros((H, E), bool)
    row_ptr = np.zeros((H, N + 1), np.int32)
    for h in range(H):
        n_valid = E - 40 - 8 * h
        tgt[h, :n_valid] = np.sort(rng.integers(0, N, n_valid))
        valid[h, :n_valid] = True
        row_ptr[h, 1:] = np.cumsum(np.bincount(tgt[h, :n_valid],
                                               minlength=N))
    t = lambda x: torch.from_numpy(x)
    return dict(
        ring=t(rng.random((H, D, E)) < density), valid=t(valid), tgt=t(tgt),
        plastic=t(rng.random((H, E)) < 0.8), row_ptr=t(row_ptr),
        last_post=times((H, N)), w=f(rng.uniform(0, 10, (H, E))),
        last_arr=times((H, E)), spiked=t(rng.random((H, N)) < density))


@pytest.mark.parametrize("n", [1, 1000, 300_001])
def test_kernels_equal_plain_versions(cuda, n):
    z = _inputs(n, seed=n)
    g = {k: v.to(cuda) for k, v in z.items()}
    izh = ("v", "u", "cur", "a", "b", "c", "d")
    izh_update = lambda d: ops.izhikevich_update(*(d[k] for k in izh),
                                                 v_peak=30.0)
    for got, want in zip(izh_update(g), izh_update(z)):
        assert _bits_equal(got, want)
    counts = np.random.default_rng(n).integers(0, 9, n // 4 + 1)
    row_ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)])
                               .astype(np.int32)).view(1, -1)
    contrib = torch.randn(1, int(counts.sum()) + 5)
    want = ops.segment_sum_ordered(contrib, ref.make_segments(
        row_ptr, contrib.shape[1]))
    got = ops.segment_sum_ordered(contrib.to(cuda), ref.make_segments(
        row_ptr.to(cuda), contrib.shape[1], with_index=False))
    assert _bits_equal(got, want)


@pytest.mark.parametrize("density", [0.0, 0.02, 1.0])
def test_stdp_kernels_equal_plain_versions(cuda, density):
    """Both passes, in place, against their plain versions on a CPU copy:
    every updated state tensor, the contributions and the arrival counts,
    at no arrivals and spikes, the main path's few, and all."""
    z = _stdp_inputs(2, 300_000, 6_000, 3, density, seed=int(density * 100))
    out = {}
    for dev in ("cpu", "cuda"):
        d = {k: v.clone().to(dev) for k, v in z.items()}
        ops.reset_launch_counts()
        contrib, n_arr = ops.stdp_arrival(
            d["ring"], 1, d["valid"], d["tgt"], d["plastic"], d["last_post"],
            d["w"], d["last_arr"], 200.0, **LTD_KW)
        ops.stdp_ltp(d["spiked"], d["row_ptr"], d["plastic"], d["last_arr"],
                     d["w"], d["last_post"], 200.0, **LTP_KW)
        counts = ops.launch_counts()
        out[dev] = dict(d, contrib=contrib, n_arrived=n_arr)
    for k, want in out["cpu"].items():
        assert _bits_equal(out["cuda"][k], want), k
    assert counts["stdp_arrival"] == counts["stdp_ltp"] == 1
    arrived = (z["ring"][:, 1] & z["valid"]).sum(1)
    assert torch.equal(out["cuda"]["n_arrived"].cpu(), arrived)
    assert not out["cuda"]["ring"][:, 1].any()


@pytest.mark.parametrize("density", [0.0, 0.0215, 0.215, 1.0])
def test_stdp_arrival_current_equals_plain_version(cuda, density):
    """The fused arrival pass and ordered sum, in place, against its plain
    version on a CPU copy and against the pair it replaces on the card:
    i_syn, n_arrived, w, last_arr and the popped slot, bit for bit.  Flags
    lie on valid synapses only, as phase B sets them."""
    z = _stdp_inputs(2, 300_000, 6_000, 3, density, seed=int(density * 1e4))
    z["ring"] &= z["valid"][:, None]
    E = z["w"].shape[1]
    out = {}
    for dev, fused in (("cpu", True), ("cuda", True), ("cuda", False)):
        d = {k: v.clone().to(dev) for k, v in z.items()}
        seg = ref.make_segments(d["row_ptr"], E, with_index=dev == "cpu")
        ops.reset_launch_counts()
        if fused:
            i_syn, n_arr = ops.stdp_arrival_current(
                d["ring"], 1, seg, d["valid"], d["tgt"], d["plastic"],
                d["last_post"], d["w"], d["last_arr"], 200.0, **LTD_KW)
        else:
            contrib, n_arr = ops.stdp_arrival(
                d["ring"], 1, d["valid"], d["tgt"], d["plastic"],
                d["last_post"], d["w"], d["last_arr"], 200.0, **LTD_KW)
            i_syn = ops.segment_sum_ordered(contrib, seg)
        torch.cuda.synchronize()
        out[(dev, fused)] = dict(i_syn=i_syn, n_arrived=n_arr, w=d["w"],
                                 last_arr=d["last_arr"], ring=d["ring"])
        if dev == "cuda":
            counts = ops.launch_counts()
            assert counts["stdp_arrival_current"] == int(fused)
            assert counts["stdp_arrival"] == counts[
                "segment_sum_ordered"] == int(not fused)
    for k, want in out[("cpu", True)].items():
        assert _bits_equal(out[("cuda", True)][k], want), k
        assert _bits_equal(out[("cuda", False)][k], want), k
    arrived = (z["ring"][:, 1] & z["valid"]).sum(1)
    assert torch.equal(out[("cuda", True)]["n_arrived"].cpu(), arrived)
    assert not out[("cuda", True)]["ring"][:, 1].any()


def _phase_a_inputs(density, seed):
    """`_stdp_inputs` (flags on valid synapses only, as phase B sets them)
    with the neurons' state: v near and past the threshold, a fifth
    inhibitory, the last 30 neurons of each shard padding, and a stimulus
    list of 64 entries a shard with duplicates and +0.0 (dropped) ones."""
    H, E, N = 2, 300_000, 6_000
    z = _stdp_inputs(H, E, N, 3, density, seed=seed)
    z["ring"] &= z["valid"][:, None]
    rng = np.random.default_rng(seed + 1)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    idx = rng.integers(0, N, (H, 64))
    idx[:, 1::9] = idx[:, ::9][:, :idx[:, 1::9].shape[1]]   # duplicates
    amp = np.where(rng.random((H, 64)) < 0.8, 20.0, 0.0)
    valid = np.ones((H, N), bool)
    valid[:, -30:] = False
    z.update(v=f(rng.uniform(-80.0, 35.0, (H, N))),
             u=f(rng.uniform(-20.0, 10.0, (H, N))),
             exc=torch.from_numpy(np.arange(N)[None].repeat(H, 0) % 5 != 4),
             neuron_valid=torch.from_numpy(valid),
             stim_idx=torch.from_numpy(idx.astype(np.int64)),
             stim_amp=f(amp))
    return z


def _phase_a(d, with_ltp, seg, t=200.0):
    return ops.stdp_phase_a(
        d["ring"], 1, seg, d["valid"], d["tgt"], d["plastic"], d["exc"],
        d["neuron_valid"], d["stim_idx"], d["stim_amp"], d["v"], d["u"],
        d["last_post"], d["w"], d["last_arr"], t, izh=DEFAULT_IZH,
        stdp=DEFAULT_STDP, neg_time=-1.0e9, with_ltp=with_ltp)


@pytest.mark.parametrize("with_ltp", [True, False], ids=["ltp", "no_ltp"])
@pytest.mark.parametrize("density", [0.0, 0.0215, 0.215, 1.0])
def test_stdp_phase_a_equals_plain_version(cuda, density, with_ltp):
    """The phase-A kernel, in place, against its plain version on a CPU
    copy and on the card: spiked, the counts and every updated state
    tensor bit for bit; without LTP, then `ops.stdp_ltp`, it equals the
    kernel with LTP."""
    z = _phase_a_inputs(density, seed=int(density * 1e4) + 3)
    E = z["w"].shape[1]
    out = {}
    for dev, impl in (("cpu", ops), ("cuda", ops), ("cuda", ref)):
        d = {k: v.clone().to(dev) for k, v in z.items()}
        seg = ref.make_segments(d["row_ptr"], E, with_index=impl is ref
                                or dev == "cpu")
        ops.reset_launch_counts()
        if impl is ops:
            spiked, n_arr, n_spk = _phase_a(d, with_ltp, seg)
        else:
            spiked, n_arr, n_spk = ref.stdp_phase_a(
                d["ring"], 1, seg, d["valid"], d["tgt"], d["plastic"],
                d["exc"], d["neuron_valid"], d["stim_idx"], d["stim_amp"],
                d["v"], d["u"], d["last_post"], d["w"], d["last_arr"],
                200.0, izh=DEFAULT_IZH, stdp=DEFAULT_STDP, neg_time=-1.0e9,
                with_ltp=with_ltp)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts == dict(dict.fromkeys(ops.KERNELS, 0), stdp_phase_a=int(
            dev == "cuda" and impl is ops))
        out[(dev, impl)] = dict(d, spiked=spiked, n_arrived=n_arr,
                                n_spikes=n_spk)
    want = out[("cpu", ops)]
    for key in (("cuda", ops), ("cuda", ref)):
        for k in want:
            assert _bits_equal(out[key][k], want[k]), (key, k)
    got = out[("cuda", ops)]
    assert torch.equal(got["n_spikes"].cpu(), want["spiked"].sum(1))
    assert not bool((got["spiked"].cpu() & ~z["neuron_valid"]).any())
    if density > 0:
        assert int(got["n_spikes"].sum()) > 0
    if not with_ltp:
        assert _bits_equal(got["last_post"], z["last_post"])
        d = {k: v.clone().to(cuda) for k, v in z.items()}
        seg = ref.make_segments(d["row_ptr"], E, with_index=False)
        _phase_a(d, True, seg)
        ops.stdp_ltp(got["spiked"], got["row_ptr"], got["plastic"],
                     got["last_arr"], got["w"], got["last_post"], 200.0,
                     **LTP_KW)
        for k in ("w", "last_post"):
            assert _bits_equal(got[k], d[k]), k


@pytest.mark.parametrize("with_ltp", [True, False], ids=["ltp", "no_ltp"])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_stdp_phase_a_edge_rows(cuda, case, with_ltp):
    """The kernel on `test_torch_phase_a`'s hand-made rows (a target that
    spikes in the step its row had arrivals, empty rows, rows past one
    256-synapse round, padded neurons, duplicate stimulus entries, targets
    that never spiked) against its plain version on a CPU copy."""
    z = edge_inputs(case)
    d = {k: v.to(cuda) if torch.is_tensor(v) else v for k, v in z.items()}
    ops.reset_launch_counts()
    got = run_op(d, with_ltp)
    torch.cuda.synchronize()
    assert ops.launch_counts()["stdp_phase_a"] == 1
    want = run_op({k: v.clone() if torch.is_tensor(v) else v
                   for k, v in z.items()}, with_ltp)
    for k in want:
        assert _bits_equal(got[k], want[k]), k
    check_edge(case, z, {k: v.cpu() for k, v in got.items()}, with_ltp)


def test_phase_a_steps_never_synchronise(cuda, monkeypatch):
    """A few steps of phase A on the card under sync-debug "error": no
    pageable copy of a per-step constant, no read of a device value; and
    no `ref.f32` constant is built per step."""
    sp = StepProgram(GridConfig(grid_x=2, grid_y=2, neurons_per_column=100,
                                synapses_per_neuron=40, seed=7),
                     EngineConfig(n_shards=2), device="cuda")
    fns = engine.make_step_fn(sp.spec, sp.plan, 0, 10)
    state = engine.clone_state(sp.init_state())
    state = fns.step(state, 0)[0]                 # builds, allocates scratch
    made = []
    real = ref.f32
    monkeypatch.setattr(ref, "f32", lambda *a: made.append(a) or real(*a))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(1, 4):
            state, _, _ = fns.phase_a(state, t)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert made == []
    assert ops.launch_counts() == dict(dict.fromkeys(ops.KERNELS, 0),
                                       stdp_phase_a=3)


def _misaligned(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """A contiguous copy of x whose first element lies `nbytes` past an
    aligned address (a view at an element offset of a larger buffer)."""
    k = nbytes // x.element_size()
    buf = torch.empty(x.numel() + k, dtype=x.dtype, device=x.device)
    view = buf[k:].view(x.shape)
    view.copy_(x)
    return view


def test_stdp_wrappers_refuse_misaligned_pointers(cuda):
    """A contiguous view at an offset passes the dtype, shape and
    contiguity checks; the wrappers whose kernels read 8 or 16 bytes at a
    time refuse it before any launch, and nothing runs the plain version
    in its place."""
    z = {k: v.to(cuda) for k, v in _stdp_inputs(1, 1008, 50, 2, 0.5).items()}
    seg = ref.make_segments(z["row_ptr"], 1008, with_index=False)
    arrival = lambda d: ops.stdp_arrival(
        d["ring"], 0, d["valid"], d["tgt"], d["plastic"], d["last_post"],
        d["w"], d["last_arr"], 200.0, **LTD_KW)
    current = lambda d: ops.stdp_arrival_current(
        d["ring"], 0, seg, d["valid"], d["tgt"], d["plastic"],
        d["last_post"], d["w"], d["last_arr"], 200.0, **LTD_KW)
    cases = [(arrival, "ring", 1), (arrival, "valid", 4),
             (arrival, "plastic", 1), (arrival, "w", 4),
             (arrival, "last_arr", 8), (current, "ring", 1),
             (current, "ring", 4)]
    ops.reset_launch_counts()
    for fn, name, nbytes in cases:
        d = dict(z, **{name: _misaligned(z[name], nbytes)})
        with pytest.raises(ValueError, match="not a multiple of"):
            fn(d)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    # the same tensors, aligned, run
    arrival({k: v.clone() for k, v in z.items()})
    current({k: v.clone() for k, v in z.items()})
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["stdp_arrival"] == counts["stdp_arrival_current"] == 1


def test_stdp_arrival_refuses_unaligned_rows(cuda):
    """E % 8 != 0 raises on the card: the kernel reads 8 flags at once, and
    nothing runs the plain version in its place."""
    z = {k: v.to(cuda) for k, v in _stdp_inputs(1, 1004, 50, 2, 0.5).items()}
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.stdp_arrival(z["ring"], 0, z["valid"], z["tgt"], z["plastic"],
                         z["last_post"], z["w"], z["last_arr"], 200.0,
                         **LTD_KW)
    assert ops.launch_counts()["stdp_arrival"] == 0


def test_main_path_on_card_equals_cpu_port(cuda):
    cfg = GridConfig(grid_x=2, grid_y=2, neurons_per_column=100,
                     synapses_per_neuron=40, seed=7)
    runs = {}
    for dev in ("cpu", "cuda"):
        sp = StepProgram(cfg, EngineConfig(n_shards=2, placement="scatter"),
                         device=dev)
        ops.reset_launch_counts()
        state, raster, _ = sp.run(sp.init_state(), 0, 60)
        counts = ops.launch_counts()
        runs[dev] = (observables.raster_signature(
            raster.cpu().numpy(), sp.plan.gid.cpu().numpy()),
            sp.weight_signature(state), counts)
    assert runs["cuda"][:2] == runs["cpu"][:2]
    assert runs["cpu"][2] == dict.fromkeys(ops.KERNELS, 0)
    # the main path runs the phase-A and phase-B kernels once a step, never
    # the kernels phase A replaced (PHASE_A_KERNELS) nor the older pair
    assert ops.SNN_KERNELS == ("stdp_phase_a", "arborize")
    assert runs["cuda"][2] == dict(dict.fromkeys(ops.KERNELS, 0),
                                   stdp_phase_a=60, arborize=60)


SMALL = GridConfig(grid_x=2, grid_y=2, neurons_per_column=60,
                   synapses_per_neuron=24, seed=9)


# SMALL with a ring of D = 21 slots (delays 1..20)
SMALL_D21 = GridConfig(grid_x=2, grid_y=2, neurons_per_column=60,
                       synapses_per_neuron=24, delay_max=20, seed=9)
ARBORIZE_TABLES = ("src", "delay", "valid", "fwd_ptr", "fwd_ids",
                   "fwd_delay")


def _arborize_inputs(H, density, seed, cfg=SMALL):
    """A 2x2 plan's own synapse tables and forward CSR at H shards (pads in
    every shard at H=4), an empty ring with a few flags already set, and
    `density` of the sources spiking (CPU tensors)."""
    _, plan, _ = engine.build(cfg, EngineConfig(n_shards=H), device="cpu")
    rng = np.random.default_rng(seed)
    H, E = plan.syn_valid.shape
    S = plan.src_gid.shape[1]
    D = cfg.n_delay_slots
    ring = torch.from_numpy(rng.random((H, D, E)) < 0.01) & plan.syn_valid[
        :, None]
    return dict(zip(ARBORIZE_TABLES, engine.arborize_tables(plan)),
                ring=ring, spiked=torch.from_numpy(rng.random((H, S))
                                                   < density))


def _arborize(op, d, t):
    return op(d["ring"], d["spiked"], *(d[k] for k in ARBORIZE_TABLES), t)


def _arborize_elements(d, t):
    return kab.arborize_elements(d["ring"], d["spiked"], d["src"],
                                 d["delay"], d["valid"], t)


@pytest.mark.parametrize("H", [1, 4])
def test_arborize_equals_plain_version(cuda, H):
    """The path's kernel (source-major over the plan's forward CSR, or
    element-major where its sample shows 18% or more spiking: both walks
    run here) and the element-major one it replaced, each bit-equal to
    the reference's broadcast-compare on a CPU copy and on the card, at
    no, the main path's (2.15%), 5x, 10x its, and all sources spiking, at
    t near the ring's wrap and at t0 - 1 = -1 (an all-False mask there
    sets nothing), on rings of 6 and of 21 slots; each launched once a
    call."""
    plain = lambda d, t: ref.arborize(d["ring"], d["spiked"], d["src"],
                                      d["delay"], d["valid"], t)
    ops.reset_launch_counts()
    n, walks = 0, set()
    for cfg in (SMALL, SMALL_D21):
        for density in (0.0, 0.0215, 0.1075, 0.215, 1.0):
            for t in (-1, 0, 4, 5, 6, 11, 20, 1003):
                z = _arborize_inputs(H, density, seed=t + 7, cfg=cfg)
                g = {k: v.to(cuda) for k, v in z.items()}
                ring0 = g["ring"].clone()
                got = _arborize(ops.arborize, g, t)
                old = _arborize_elements({**g, "ring": ring0.clone()}, t)
                want_gpu = plain({**g, "ring": ring0.clone()}, t)
                want = plain(z, t)
                n += 1
                walks.update(kab.walks_elements(z["spiked"]))
                assert got.data_ptr() == g["ring"].data_ptr()   # in place
                assert torch.equal(got.cpu(), want)
                assert torch.equal(got, want_gpu)
                assert torch.equal(old, want_gpu)
                if density == 0.0:
                    assert torch.equal(want, z["ring"])         # a no-op
    torch.cuda.synchronize()
    assert walks == {True, False}
    assert ops.launch_counts() == dict(dict.fromkeys(ops.KERNELS, 0),
                                       arborize=n, arborize_elements=n)


def test_arborize_runs_on_offset_views(cuda):
    """The kernels read every tensor an element at a time, so they need no
    alignment beyond their dtypes': views one element past an aligned
    address run and give the plain version's bits (both walks)."""
    for cfg, density in ((SMALL, 0.05), (SMALL, 0.3), (SMALL_D21, 0.05)):
        z = _arborize_inputs(1, density, seed=3, cfg=cfg)
        views = {k: _misaligned(v.to(cuda), v.element_size())
                 for k, v in z.items()}
        old = {**views, "ring": _misaligned(z["ring"].to(cuda), 1)}
        got = _arborize(ops.arborize, views, 17)
        got_old = _arborize_elements(old, 17)
        torch.cuda.synchronize()
        want = ref.arborize(z["ring"], z["spiked"], z["src"], z["delay"],
                            z["valid"], 17)
        assert torch.equal(got.cpu(), want)
        assert torch.equal(got_old.cpu(), want)


@pytest.mark.parametrize("exchange", ["allgather", "halo", "hier"])
def test_whole_steps_never_synchronise(cuda, exchange):
    """Whole steps through the phase handles on the card under sync-debug
    "error", in the sync order (A, exchange, B) and in the pipelined one
    (B of the previous step, A's dynamics, exchange, A's plasticity): no
    read of a device value, no pageable copy, and the main path's
    kernels once a phase."""
    sp = StepProgram(SMALL, EngineConfig(n_shards=4, exchange=exchange),
                     device="cuda", hier_groups=2)
    pp = sp.phase_fns()
    state = engine.clone_state(sp.init_state())
    state, spiked, _ = pp.phase_a(state, 0)     # builds, allocates scratch
    state = pp.phase_b(state, pp.exchange(spiked), 0)
    ss = pp.exchange(spiked)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(1, 4):
            state, spiked, _ = pp.phase_a(state, t)
            state = pp.phase_b(state, pp.exchange(spiked), t)
        for t in range(4, 7):
            state = pp.phase_b(state, ss, t - 1)
            state, spiked, _ = pp.phase_a_dynamics(state, t)
            ss = pp.exchange(spiked)
            state = pp.phase_a_plasticity(state, spiked, t)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict(dict.fromkeys(ops.KERNELS, 0),
                                       stdp_phase_a=6, arborize=6,
                                       stdp_ltp=3)


@pytest.mark.parametrize("schedule", ["sync", "pipelined"])
def test_time_phases_on_card_equals_run(cuda, schedule):
    """`time_phases` on the card gives `run`'s raster, weights and counts
    under both schedules, with the halo exchange, and leaves its input
    state untouched."""
    base = StepProgram(SMALL, EngineConfig(n_shards=4), device="cuda")
    s0 = base.init_state()
    s_run, raster, tm = base.run(s0, 0, 40)
    sp = StepProgram.from_parts(
        base.spec._replace(eng=EngineConfig(
            n_shards=4, exchange="halo", exchange_schedule=schedule)),
        base.plan, s0)
    before = [x.clone() for x in s0]
    s, times, rasters, counts = sp.time_phases(s0, 0, 40,
                                               collect_rasters=True)
    assert np.array_equal(np.stack(rasters), raster.cpu().numpy())
    assert sp.weight_signature(s) == base.weight_signature(s_run)
    assert counts == dict(spikes=int(tm.spikes.sum()),
                          arrivals=int(tm.arrivals.sum()))
    assert all(torch.equal(a, b) for a, b in zip(before, s0))
    assert set(times) == {"phase_a_s", "exchange_s", "phase_b_s"}


# -- event delivery and the captured run ----------------------------------


def _event_inputs(H, density, t, seed, cap=None, cfg=SMALL,
                  src_density=None):
    """An event plan of `cfg` (a 2x2 grid by default) at H shards and a
    numpy-seeded event state on the CPU: weights, last spike and arrival
    times, ring slot t mod D listing `density` of each shard's valid
    synapses in random order (the other slots a third of that, at most
    `cap` entries a slot: the plan's cap_ev by default, "E" for E), and
    `density` of the neurons and `src_density` (`density` by default) of
    the sources spiking."""
    sp = StepProgram(cfg, EngineConfig(n_shards=H, delivery="event"),
                     device="cpu")
    st = sp.init_state()
    rng = np.random.default_rng(seed)
    H, E = sp.plan.syn_valid.shape
    N, S = sp.plan.gid.shape[1], sp.plan.src_gid.shape[1]
    D = cfg.n_delay_slots
    cap = E if cap == "E" else cap or st.ev_ring.shape[2]
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    times = lambda shape: f(np.where(rng.random(shape) < 0.7,
                                     rng.uniform(t - 200.0, t, shape),
                                     -1.0e9))
    ring = np.full((H, D, cap), -1, np.int32)
    count = np.zeros((H, D), np.int32)
    for h in range(H):
        nv = int(sp.plan.syn_valid[h].sum())
        for d in range(D):
            k = min(cap, int((density if d == t % D else density / 3) * nv))
            ring[h, d, :k] = rng.permutation(nv)[:k]
            count[h, d] = k
    base = st.base._replace(w=f(rng.uniform(0.0, 10.0, (H, E))),
                            last_post=times((H, N)), last_arr=times((H, E)))
    state = event_engine.EventState(
        base=base, ev_ring=torch.from_numpy(ring),
        ev_count=torch.from_numpy(count),
        sat=torch.from_numpy(rng.integers(0, 3, H).astype(np.int32)))
    src_density = density if src_density is None else src_density
    return sp, state, torch.from_numpy(rng.random((H, N)) < density), \
        torch.from_numpy(rng.random((H, S)) < src_density)


def _event_ops(sp, st, spiked, spiked_src, t, c_post=None, c_src=None,
               plain=False):
    """The event ops of a step in the split schedule's order (the arrivals,
    the spike list and its bookkeeping, LTP, the emission), on `st` in
    place -> the outputs and every state tensor.  `plain` calls the plain
    versions (`kernels.ref`) on whatever device the tensors are on."""
    stdp = sp.spec.stdp
    b = st.base
    N, S = spiked.shape[1], spiked_src.shape[1]
    ltd = dict(a_minus=stdp.a_minus, tau_minus=stdp.tau_minus,
               w_min=stdp.w_min, w_max=stdp.w_max, neg_time=engine.NEG_TIME)
    ltp = dict(a_plus=stdp.a_plus, tau_plus=stdp.tau_plus, w_min=stdp.w_min,
               w_max=stdp.w_max, neg_time=engine.NEG_TIME)
    if plain:
        i_syn, n_arr = ref.event_arrival(
            st.ev_ring, st.ev_count, t % st.ev_ring.shape[1],
            sp.plan.syn_tgt, sp.plan.syn_plastic, b.last_post, b.w,
            b.last_arr, t, **ltd)
    else:
        i_syn, n_arr = ops.event_arrival(
            st.ev_ring, st.ev_count, sp.plan.syn_tgt, sp.plan.row_ptr,
            sp.plan.syn_plastic, b.last_post, b.w, b.last_arr, t, **ltd)
    lib = ref if plain else ops
    listed = lib.event_compact(spiked, b.last_post, st.sat, t,
                               c_post=c_post or N)
    lib.event_ltp(*listed[1:], listed[0], sp.plan.row_ptr,
                  sp.plan.syn_plastic, b.last_arr, b.w, t, **ltp)
    ids, drop = aer.compact_indices(spiked_src, c_src or S, fill=S)
    lib.event_emit(ids.contiguous(), drop, sp.eplan.fwd_rows,
                   sp.plan.syn_delay, st.ev_ring, st.ev_count, st.sat, t)
    return [i_syn, n_arr, *listed] + engine.state_tensors(st)


@pytest.mark.parametrize("H", [1, 4])
@pytest.mark.parametrize("density", [0.0, 0.0215, 0.215, 0.6])
def test_event_kernels_equal_plain_versions(cuda, H, density):
    """event_arrival, event_compact, event_ltp and event_emit, in a step's
    order, bit-equal to their plain versions on a CPU copy and on the
    card: at a wrapping t, at t = -1, with c_post / c_src overflowing and
    with a ring that overflows; each op launched once a call."""
    n = 0
    ops.reset_launch_counts()
    for t, caps, cap in ((1003, {}, None), (-1, {}, None),
                         (17, dict(c_post=5, c_src=7), None),
                         (4, {}, 256)):
        sp, st, spk, src = _event_inputs(H, density, t, seed=t + 11,
                                         cap=cap)
        to = lambda x: x.to(cuda)
        gp = sp.plan._replace(**{k: to(v) for k, v in sp.plan._asdict()
                                 .items()})
        gsp = StepProgram.from_parts(sp.spec, gp, eplan=event_engine
                                     .EventPlan(*map(to, sp.eplan)))
        g, g_plain = engine.map_state(to, st), engine.map_state(to, st)
        got = _event_ops(gsp, g, to(spk), to(src), t, **caps)
        torch.cuda.synchronize()
        n += 1
        want_gpu = _event_ops(gsp, g_plain, to(spk), to(src), t, **caps,
                              plain=True)
        with ref.flush_denormal():
            want = _event_ops(sp, st, spk, src, t, **caps, plain=True)
        for a, b, c in zip(got, want, want_gpu):
            assert _bits_equal(a, b) and _bits_equal(a, c)
    assert ops.launch_counts() == dict(dict.fromkeys(ops.KERNELS, 0),
                                       event_arrival=n, event_compact=n,
                                       event_ltp=n, event_emit=n)


# A plan of more neurons a shard than a tile of the neuron pass's scan
# holds (`kernels.event.NEURON_TILE`, 1,024), and not a multiple of it:
# 4,000 a shard at H=1, 1,000 at H=4.
NEURONS = GridConfig(grid_x=2, grid_y=2, neurons_per_column=1000,
                     synapses_per_neuron=40)
# event_neurons' c_post: none (the split schedule's dynamics half), every
# neuron of the shard, or fewer than the spikes at 21.5% (the cut and sat)
CUTS = {"none": None, "all": "N", "cut": 256}


def _neuron_inputs(H, density, t, seed):
    """The NEURONS event program at H shards (CPU) and numpy-seeded inputs
    of the neuron pass: `density` of the neurons at or past the threshold
    and the others at rest, i_syn, the step's stimulus row, last spike
    times and sat."""
    sp = StepProgram(NEURONS, EngineConfig(n_shards=H, delivery="event"),
                     device="cpu")
    rng = np.random.default_rng(seed)
    H, N = sp.plan.gid.shape
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    index, amp = engine.StimWindow(sp.spec, sp.plan, t, 1).row(t)
    v = np.where(rng.random((H, N)) < density, rng.uniform(30.0, 40.0, (H, N)),
                 rng.uniform(-80.0, -60.0, (H, N)))
    return sp, dict(
        i_syn=f(rng.uniform(-5.0, 20.0, (H, N))), v=f(v),
        u=f(rng.uniform(-20.0, 10.0, (H, N))),
        last_post=f(np.where(rng.random((H, N)) < 0.7,
                             rng.uniform(t - 200.0, t, (H, N)), -1.0e9)),
        sat=torch.from_numpy(rng.integers(0, 3, H).astype(np.int32)),
        stim_idx=index.contiguous(), stim_amp=amp.contiguous())


def _neurons(lib, plan, izh, d, t, c_post, **kw):
    """`lib.event_neurons` on the inputs `d` (updated in place) -> its
    outputs and the state it writes.  With the step counter as t the
    stimulus goes as a window of one row."""
    stim = (d["stim_idx"], d["stim_amp"])
    if isinstance(t, torch.Tensor):
        stim = tuple(x[None] for x in stim)
    out = lib.event_neurons(d["i_syn"], *stim, plan.exc_mask,
                            plan.neuron_valid, d["v"], d["u"],
                            d["last_post"], d["sat"], t, izh=izh,
                            c_post=c_post, **kw)
    return [*out, d["v"], d["u"], d["last_post"], d["sat"]]


@pytest.mark.parametrize("counter", [False, True], ids=["t", "counter"])
@pytest.mark.parametrize("cut", list(CUTS))
@pytest.mark.parametrize("density", [0.0, 0.0215, 0.215, 1.0])
@pytest.mark.parametrize("H", [1, 4])
def test_event_neurons_equal_plain_version(cuda, H, density, cut, counter):
    """The neuron pass and its scan bit-equal to the plain version
    (`ref.event_neurons`: the stimulus, the update, the mask,
    `compact_indices`, last_post, sat, the count) on a CPU copy and on the
    card, with t a launch argument or read from the step counter; called
    twice at one t on fresh copies (the tile state is zero again after a
    call), and once more with one block a shard walking every tile."""
    t = 1003
    sp, d = _neuron_inputs(H, density, t, seed=int(density * 1000) + H)
    N = sp.plan.gid.shape[1]
    c_post = N if CUTS[cut] == "N" else CUTS[cut]
    izh = sp.spec.izh
    to = lambda x: x.to(cuda, copy=True)
    gplan = sp.plan._replace(**{k: to(v) for k, v in sp.plan._asdict()
                                .items()})
    with ref.flush_denormal():
        want = _neurons(ref, sp.plan, izh, {k: v.clone() for k, v in
                                             d.items()}, t, c_post)
    want_gpu = _neurons(ref, gplan, izh, {k: to(v) for k, v in d.items()},
                        t, c_post)
    step = (torch.tensor([t, 0], dtype=torch.int64, device=cuda) if counter
            else t)
    ops.reset_launch_counts()
    for blocks in (0, 0, 1):
        got = _neurons(ops if not blocks else kev, gplan, izh,
                       {k: to(v) for k, v in d.items()}, step, c_post,
                       **({"blocks": blocks} if blocks else {}))
        torch.cuda.synchronize()
        for a, b, c in zip(got, want, want_gpu):
            assert _bits_equal(a, b) and _bits_equal(a, c)
    assert ops.launch_counts() == dict(dict.fromkeys(ops.KERNELS, 0),
                                       event_neurons=3)
    if density == 1.0 and cut == "cut":        # sat, the last tensor
        assert bool((want[-1] > d["sat"]).all())
    if density > 0.2:
        assert int(want[1].sum()) > 0


@pytest.mark.parametrize("rows", ["csr", "empty_rows"])
@pytest.mark.parametrize("c_post", [None, 256])
@pytest.mark.parametrize("density", [0.0215, 0.215])
def test_event_ltp_equals_plain_and_the_kernel_it_replaced(cuda, density,
                                                           c_post, rows):
    """`event_compact` then `event_ltp` (a warp a listed row over a grid
    sized to the card) bit-equal to their plain versions on a CPU copy and
    on the card, and to the kernel they replaced (`event_ltp_rows`) on the
    same inputs: the list, w, last_post, sat; with the card's grid and with
    one block a shard (each warp then takes many rows, one after another).
    `empty_rows` merges each pair of CSR rows into the second, so every
    other listed neuron has an empty row."""
    t = 1003
    sp, st, spk, _ = _event_inputs(1, density, t, seed=int(density * 100),
                                   cfg=NEURONS)
    N = spk.shape[1]
    rp = sp.plan.row_ptr
    if rows == "empty_rows":
        rp = rp[:, (torch.arange(N + 1) // 2) * 2].contiguous()
        rp[:, -1] = sp.plan.row_ptr[:, -1]
    c = c_post or N
    stdp = sp.spec.stdp
    ltp = dict(a_plus=stdp.a_plus, tau_plus=stdp.tau_plus, w_min=stdp.w_min,
               w_max=stdp.w_max, neg_time=engine.NEG_TIME)
    b = st.base

    def run(lib, dev, **kw):
        x = lambda v: v.to(dev, copy=True)
        w, lp, sat = x(b.w), x(b.last_post), x(st.sat)
        listed = lib.event_compact(x(spk), lp, sat, t, c_post=c, **kw)
        lib.event_ltp(*listed[1:], listed[0], x(rp), x(sp.plan.syn_plastic),
                      x(b.last_arr), w, t, **ltp, **kw)
        return [*listed, w, lp, sat]

    with ref.flush_denormal():
        want = run(ref, "cpu")
    want_gpu = run(ref, cuda)
    ops.reset_launch_counts()
    for kw in ({}, dict(blocks=1)):
        got = run(kev if kw else ops, cuda, **kw)
        torch.cuda.synchronize()
        for a, bb, cc in zip(got, want, want_gpu):
            assert _bits_equal(a, bb) and _bits_equal(a, cc)
    # the kernel they replaced, on the same inputs
    x = lambda v: v.to(cuda, copy=True)
    w, lp, sat = x(b.w), x(b.last_post), x(st.sat)
    ids, drop = aer.compact_indices(x(spk), c, fill=N)
    kev.event_ltp_rows(ids.contiguous(), drop, x(spk), x(rp),
                       x(sp.plan.syn_plastic), x(b.last_arr), w, lp, sat, t,
                       **ltp)
    for a, bb in zip((w, lp, sat), want[2:]):
        assert _bits_equal(a, bb)
    assert ops.launch_counts() == dict(dict.fromkeys(ops.KERNELS, 0),
                                       event_compact=2, event_ltp=2,
                                       event_ltp_rows=1)
    if c_post is not None and density > 0.2:
        assert bool((want[-1] > st.sat).all())
    assert not torch.equal(want[2], b.w)


# Plans whose targets' buckets outgrow the arrivals' sum: its registers
# (64 pairs a target), its shared staging (128 weights a target: in-degree
# up to 248 in LONG, 370 in WIDE) and, in WIDE, the emission's registers
# (256 entries of a forward row: its rows have 300).
LONG = GridConfig(grid_x=1, grid_y=1, neurons_per_column=300,
                  synapses_per_neuron=200, seed=5)
WIDE = GridConfig(grid_x=1, grid_y=1, neurons_per_column=400,
                  synapses_per_neuron=300, seed=6)
# (cfg, t, share of the valid synapses listed in slot t mod D, share of
# the sources spiking, ring cap)
LONG_CASES = {"slot_0.6": (LONG, 1003, 0.6, 0.6, "E"),
              "all_listed_t-1": (LONG, -1, 1.0, 0.6, "E"),
              "overflow": (LONG, 17, 0.01, 1.0, 2000),
              "wide_rows": (WIDE, 5, 1.0, 1.0, "E")}


def _first_overflow_tile(sp, st, src_ids, t):
    """The emission tile (`kernels.event.EMIT_ROWS` listed sources) of
    shard 0 whose events first fill a ring slot past cap, or None."""
    D, cap = st.ev_ring.shape[1:]
    fill = st.ev_count[0].clone().to(torch.int64)
    S = sp.eplan.fwd_rows.shape[1]
    for k, s in enumerate(src_ids[0].tolist()):
        if s >= S:
            return None
        ids = sp.eplan.fwd_rows[0, s]
        ids = ids[ids >= 0].to(torch.int64)
        fill += torch.bincount((sp.plan.syn_delay[0, ids] + t) % D,
                               minlength=D)
        if bool((fill > cap).any()):
            return k // kev.EMIT_ROWS
    return None


@pytest.mark.parametrize("case", list(LONG_CASES))
def test_event_kernels_on_long_buckets_and_rows(cuda, case):
    """event_arrival and event_emit (with event_compact and event_ltp
    between them, a step's order) bit-equal to their plain versions on a CPU copy and on the card
    where buckets outgrow the sum's registers and staging (every valid
    synapse listed; up to 248 and 370 events a target), rows outgrow the
    emission's registers, sources span many emission tiles, and the ring
    overflows in a tile before the last; at t = -1 too.  Each case is
    called twice at the same t on restored inputs: the scratch and the
    emission's tile state are zero again after a call."""
    cfg, t, density, src_density, cap = LONG_CASES[case]
    sp, st, spk, src = _event_inputs(1, density, t, seed=len(case),
                                     cap=cap, cfg=cfg,
                                     src_density=src_density)
    S = src.shape[1]
    r = t % cfg.n_delay_slots
    ev = st.ev_ring[0, r]
    tgt = sp.plan.syn_tgt[0, ev[ev >= 0].to(torch.int64)]
    longest = int(torch.bincount(tgt).max()) if tgt.numel() else 0
    src_ids, _ = aer.compact_indices(src, S, fill=S)
    tiles = -(-int((src_ids < S).sum()) // kev.EMIT_ROWS)
    if case == "overflow":
        at = _first_overflow_tile(sp, st, src_ids, t)
        assert at is not None and at < tiles - 1
    else:
        assert longest > 128 and tiles > 16
    if case == "wide_rows":
        assert sp.eplan.fwd_rows.shape[2] > kev.EMIT_ROW_REGS
    to = lambda x: x.to(cuda, copy=True)
    gp = sp.plan._replace(**{k: to(v) for k, v in sp.plan._asdict()
                             .items()})
    gsp = StepProgram.from_parts(sp.spec, gp, eplan=event_engine
                                 .EventPlan(*map(to, sp.eplan)))
    with ref.flush_denormal():
        want = _event_ops(sp, engine.clone_state(st), spk, src, t, c_src=S,
                          plain=True)
    want_gpu = _event_ops(gsp, engine.map_state(to, st), to(spk), to(src),
                          t, c_src=S, plain=True)
    ops.reset_launch_counts()
    for _ in range(2):
        got = _event_ops(gsp, engine.map_state(to, st), to(spk), to(src), t,
                         c_src=S)
        torch.cuda.synchronize()
        for a, b, c in zip(got, want, want_gpu):
            assert _bits_equal(a, b) and _bits_equal(a, c)
    if case == "overflow":                    # sat is the last tensor
        assert int(want[-1][0]) > int(st.sat[0])
    assert ops.launch_counts() == dict(dict.fromkeys(ops.KERNELS, 0),
                                       event_arrival=2, event_compact=2,
                                       event_ltp=2, event_emit=2)


# SMALL with rings of more slots than the emission kernel scans a pass
# (16): D = 21, and D = 40, past a warp's 32 lanes
LONG_RINGS = {"d21": dataclasses.replace(SMALL, delay_max=20),
              "d40": dataclasses.replace(SMALL, delay_max=39)}


@pytest.mark.parametrize("H", [1, 4])
@pytest.mark.parametrize("ring", list(LONG_RINGS))
def test_event_emit_past_16_slots(cuda, ring, H):
    """The three event ops in a step's order, bit-equal to their plain
    versions on a CPU copy and on the card, on rings of 21 and 40 slots:
    at a wrapping t, at t = -1, with c_post / c_src overflowing and with a
    ring that overflows (sat counts the drops)."""
    cfg = LONG_RINGS[ring]
    n = 0
    ops.reset_launch_counts()
    for t, caps, cap in ((1003, {}, None), (-1, {}, None),
                         (17, dict(c_post=5, c_src=7), None), (4, {}, 64)):
        sp, st, spk, src = _event_inputs(H, 0.3, t, seed=t + 13, cap=cap,
                                         cfg=cfg)
        assert int(sp.plan.syn_delay.max()) > 16
        to = lambda x: x.to(cuda)
        gp = sp.plan._replace(**{k: to(v) for k, v in sp.plan._asdict()
                                 .items()})
        gsp = StepProgram.from_parts(sp.spec, gp, eplan=event_engine
                                     .EventPlan(*map(to, sp.eplan)))
        g, g_plain = engine.map_state(to, st), engine.map_state(to, st)
        got = _event_ops(gsp, g, to(spk), to(src), t, **caps)
        torch.cuda.synchronize()
        n += 1
        want_gpu = _event_ops(gsp, g_plain, to(spk), to(src), t, **caps,
                              plain=True)
        with ref.flush_denormal():
            want = _event_ops(sp, st, spk, src, t, **caps, plain=True)
        for a, b, c in zip(got, want, want_gpu):
            assert _bits_equal(a, b) and _bits_equal(a, c)
        if cap is not None or caps:
            assert bool((want[-1] > 0).all())      # sat, the last tensor
    assert ops.launch_counts() == dict(dict.fromkeys(ops.KERNELS, 0),
                                       event_arrival=n, event_compact=n,
                                       event_ltp=n, event_emit=n)


@pytest.mark.parametrize("delivery", ["event", "dense"])
def test_run_at_21_slots_equals_cpu_port(cuda, delivery):
    """A run at delay_max = 20 (D = 21) on the card, the captured graph's
    and the eager loop's, gives the CPU port's raster, weights and (event)
    drops: the emission's slot groups and phase B's kernel at any D."""
    cfg = LONG_RINGS["d21"]
    runs = {}
    for dev in ("cpu", "cuda"):
        sp = StepProgram(cfg, EngineConfig(n_shards=2, delivery=delivery),
                         device=dev)
        for graph in ((True, False) if dev == "cuda" else (True,)):
            state, raster, _ = sp.run(sp.init_state(), 0, 120, graph=graph)
            sat = (state.sat.tolist() if delivery == "event" else None)
            runs[dev, graph] = (observables.raster_signature(
                raster.cpu().numpy(), sp.plan.gid.cpu().numpy()),
                sp.weight_signature(state), sat, int(raster.sum()))
    assert runs["cuda", True] == runs["cpu", True] == runs["cuda", False]
    assert runs["cpu", True][3] > 0


@pytest.mark.parametrize("delivery", ["dense", "event"])
def test_graph_run_equals_eager_run_and_cpu(cuda, delivery):
    """`run` on the card replays a captured graph of `engine.RUN_WINDOW`
    steps: the same raster, weights and state as the eager loop on the card
    and as the CPU port, each kernel of the path launched once a step
    (the wrappers count the eager steps' launches, the capture records
    one a step for its replays), and the input state untouched."""
    W = engine.RUN_WINDOW
    tail = 17
    steps = 2 * W + tail
    eng = EngineConfig(n_shards=2, placement="scatter", delivery=delivery)
    cpu = StepProgram(SMALL, eng, device="cpu")
    s_c, r_c, _ = cpu.run(cpu.init_state(), 0, steps)
    sp = StepProgram(SMALL, eng, device="cuda")
    s0 = sp.init_state()
    before = [x.clone() for x in engine.state_tensors(s0)]
    runs = []
    for graph in (True, True, False):
        ops.reset_launch_counts()
        s, r, tm = sp.run(s0, 0, steps, graph=graph)
        torch.cuda.synchronize()
        runs.append((s, r, tm, ops.launch_counts(),
                     sp.runner.replayed_launches()))
    assert sp.runner.graph is not None
    path = (("stdp_phase_a", "arborize") if delivery == "dense" else
            ops.EVENT_KERNELS)
    assert sp.runner.recorded == dict.fromkeys(path, W)
    # first run: a window eager, one replay, the tail eager; second run:
    # two replays, the tail; the eager loop: every step
    eager_steps = (W + tail, tail, steps)
    for (s, r, tm, counts, replayed), n in zip(runs, eager_steps):
        assert torch.equal(r.cpu(), r_c)
        for a, b in zip(engine.state_tensors(s), engine.state_tensors(s_c)):
            assert _bits_equal(a, b)
        assert counts == dict(dict.fromkeys(ops.KERNELS, 0),
                              **dict.fromkeys(path, n))
        assert replayed == dict.fromkeys(path, steps - n)
    assert all(torch.equal(a, b)
               for a, b in zip(before, engine.state_tensors(s0)))


@pytest.mark.parametrize("delivery", ["dense", "event"])
def test_graph_keeps_its_scratch(cuda, delivery):
    """A replay writes the kernels' scratch at the addresses its capture
    recorded, so each runner owns its scratch: with more runners than
    PyTorch's pool of stream handles (32 a device) made, captured and
    dropped after it, and the shared scratch of eager calls grown by a
    larger plan, its replays still give the eager loop's bits."""
    eng = EngineConfig(n_shards=2, delivery=delivery)
    sp = StepProgram(SMALL, eng, device="cuda")
    s0 = sp.init_state()
    W = engine.RUN_WINDOW
    want = sp.run(s0, 0, 2 * W, graph=False)
    sp.run(s0, 0, W)                          # captures
    for _ in range(40):
        other = StepProgram.from_parts(sp.spec, sp.plan, s0, eplan=sp.eplan)
        other.run(s0, 0, W)
        del other
    wide = StepProgram(GridConfig(grid_x=3, grid_y=2, neurons_per_column=120,
                                  synapses_per_neuron=24), eng, device="cuda")
    pp = wide.phase_fns()
    s, spiked, _ = pp.phase_a(engine.clone_state(wide.init_state()), 0)
    pp.phase_b(s, pp.exchange(spiked), 0)
    ops.reset_launch_counts()
    got = sp.run(s0, 0, 2 * W)
    torch.cuda.synchronize()
    assert sp.runner.replays == 2
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert torch.equal(got[1], want[1])
    assert all(_bits_equal(a, b) for a, b in zip(
        engine.state_tensors(got[0]), engine.state_tensors(want[0])))


@pytest.mark.parametrize("delivery", ["dense", "event"])
def test_graph_replays_never_synchronise(cuda, delivery):
    """Whole runs of replays (state in, windows, outputs, state out) under
    sync-debug "error", once the graph is captured and the stimulus
    drawn."""
    sp = StepProgram(SMALL, EngineConfig(n_shards=4, delivery=delivery),
                     device="cuda")
    s0 = sp.init_state()
    W = engine.RUN_WINDOW
    sp.run(s0, 0, 2 * W)                      # captures
    index, amp = engine.stim_rows(sp.spec, sp.plan, 0, 3 * W + 5)
    want = sp.run(s0, 0, 3 * W + 5, graph=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sp.runner.run(s0, 0, 3 * W + 5, index, amp)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert all(_bits_equal(a, b) for a, b in zip(
        engine.state_tensors(got[0]), engine.state_tensors(want[0])))


@pytest.mark.parametrize("exchange", ["allgather", "halo", "hier"])
def test_event_whole_steps_never_synchronise(cuda, exchange):
    """The event phase handles on the card under sync-debug "error", in
    the sync and the pipelined order: each event op once a phase (the
    pipelined plasticity half lists the spikes with event_compact)."""
    sp = StepProgram(SMALL, EngineConfig(n_shards=4, exchange=exchange,
                                         delivery="event"),
                     device="cuda", hier_groups=2)
    pp = sp.phase_fns()
    state = engine.clone_state(sp.init_state())
    state, spiked, _ = pp.phase_a(state, 0)
    state = pp.phase_b(state, pp.exchange(spiked), 0)
    ss = pp.exchange(spiked)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(1, 4):
            state, spiked, _ = pp.phase_a(state, t)
            state = pp.phase_b(state, pp.exchange(spiked), t)
        for t in range(4, 7):
            state = pp.phase_b(state, ss, t - 1)
            state, spiked, _ = pp.phase_a_dynamics(state, t)
            ss = pp.exchange(spiked)
            state = pp.phase_a_plasticity(state, spiked, t)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert ops.launch_counts() == dict(dict.fromkeys(ops.KERNELS, 0),
                                       event_arrival=6, event_neurons=6,
                                       event_compact=3, event_ltp=6,
                                       event_emit=6)


def _scan_inputs(shape):
    rng = np.random.default_rng(sum(shape))
    B, T, D = shape
    a = torch.from_numpy(rng.uniform(0.5, 0.999, shape).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(
        np.float32))
    h0 = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    return a, b, h0


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "zeros"])
@pytest.mark.parametrize("shape", [(1, 512, 2560), (4, 1, 2560), (3, 100, 96),
                                   (2, 77, 100), (2, 0, 8), (1, 0, 64),
                                   (1, 1, 33), (2, 8, 40), (1, 9, 40)])
def test_rg_lru_scan_equals_plain_version(cuda, shape, with_h0):
    """Bit-equal at prefill, decode, ragged T (chunks of 64 steps) and D
    (warps of 32 channels), T = 0, one step of 33 channels, and either
    side of the kernel's switch from direct loads (T <= 8) to staging."""
    a, b, h0 = _scan_inputs(shape)
    h0 = h0 if with_h0 else None
    ops.reset_launch_counts()
    got = ops.rg_lru_scan(a.to(cuda), b.to(cuda),
                          None if h0 is None else h0.to(cuda))
    torch.cuda.synchronize()
    assert _bits_equal(got, ops.rg_lru_scan(a, b, h0))
    assert ops.launch_counts()["rg_lru_scan"] == (1 if shape[1] else 0)


def test_rg_lru_scan_runs_on_offset_views(cuda):
    """The kernel copies 4 bytes at a time, so a view 4 bytes past an
    aligned address runs, bit-equal (the wrapper refuses no fp32 view for
    its offset)."""
    a, b, h0 = _scan_inputs((2, 77, 100))
    views = [_misaligned(x.to(cuda), 4) for x in (a, b, h0)]
    assert all(v.data_ptr() % 16 == 4 for v in views)
    got = ops.rg_lru_scan(*views)
    torch.cuda.synchronize()
    assert _bits_equal(got, ops.rg_lru_scan(a, b, h0))


def test_lm_serving_on_card_equals_cpu_port(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import convert
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_smoke_config("recurrentgemma-2b").scaled(dtype="float32")
    tree = convert.numpy_params(cfg, 0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (24, 3, 17)]
    out = {}
    for dev in ("cpu", "cuda"):
        params = convert.lm_params_from_jax(tree, cfg, dev)
        eng = ServeEngine(cfg, params, batch=2, s_max=48, device=dev)
        ops.reset_launch_counts()
        done = eng.run([Request(prompt=p, max_new=6) for p in prompts])
        calls = eng.stats["admissions"] + eng.stats["decode_steps"]
        out[dev] = ([r.out.tolist() for r in done],
                    ops.launch_counts()["rg_lru_scan"], calls)
    assert out["cuda"][0] == out["cpu"][0]
    assert out["cpu"][1] == 0
    assert out["cuda"][1] == 4 * out["cuda"][2]


@pytest.mark.parametrize("case", [
    # (BH, T, S, D, dtype, causal, window, softcap, kernel): chip_smoke.py's
    # attn_kernels shapes at reduced BH
    (2, 2048, 2048, 256, torch.bfloat16, True, 2048, None, "wgmma"),
    (2, 1024, 1024, 128, torch.float32, True, None, None, "simt"),
    (3, 100, 300, 80, torch.float32, False, 64, None, "simt"),
    # rows of 40 bytes: the SIMT kernel's element-wise tile loads
    (2, 70, 90, 20, torch.bfloat16, True, 33, 30.0, "simt"),
    (4, 1, 2048, 256, torch.bfloat16, True, 2048, None, "splitkv"),
    # every split of 128 keys but the last sees no key
    (2, 1, 2048, 128, torch.float32, True, 100, None, "splitkv"),
    # ragged q and kv tiles: TMA fills zeros past T and S
    (2, 1000, 1000, 256, torch.bfloat16, True, 2048, None, "wgmma"),
], ids=["rg_local_prefill", "fp32_causal", "bidir_ragged", "odd_rows",
        "rg_local_decode", "decode_window_last_split", "rg_local_ragged"])
def test_flash_attention_equals_plain_version(cuda, case):
    BH, T, S, D, dtype, causal, window, softcap, kind = case
    rng = np.random.default_rng(T + S + D)
    q, k, v = (torch.from_numpy(rng.standard_normal((BH, n, D)).astype(
        np.float32)).to(dtype) for n in (T, S, S))
    kw = dict(causal=causal, window=window, softcap=softcap)
    ops.reset_launch_counts()
    got = ops.attention(q.to(cuda), k.to(cuda), v.to(cuda), **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert kfa.variant_launches[kind] == 1
    want = ref.attention(q.to(cuda), k.to(cuda), v.to(cuda), **kw)
    # both compute in fp32 and round once: bf16 within one ulp of the output
    bf16 = dtype == torch.bfloat16
    rtol, atol = (2.0 ** -7, 1e-4) if bf16 else (2e-5, 2e-5)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               rtol=rtol, atol=atol)


def _softcap_bits(out: str) -> None:
    """`chip_smoke.py`'s `softcap` row on its own inputs (numpy seed 13,
    drawn after the rows before it): the kernel's bf16 output and the plain
    version's fp32 output (before its cast) on the card, on the CPU as
    `chip_smoke.py` calls it, and on the CPU inside `ref.flush_denormal()`
    (one thread), saved to `out`."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.torch = torch
    rng = np.random.default_rng(13)
    for label, c in smoke.ATTN_SHAPES:
        q, k, v = smoke._attn_inputs(rng, c)
        if label == "softcap":
            break
    kw = dict(causal=c["causal"], window=c["window"], softcap=c["softcap"])
    got = ops.attention(q.cuda(), k.cuda(), v.cuda(), **kw)
    f = [x.float() for x in (q, k, v)]
    gpu = ref.attention(*(x.cuda() for x in f), **kw)
    cpu = ref.attention(*f, **kw)
    with ref.flush_denormal():
        cpu1 = ref.attention(*f, **kw)
    np.savez(out, kernel=got.view(torch.int16).cpu().numpy(),
             plain_gpu=gpu.cpu().numpy(), plain_cpu=cpu.numpy(),
             plain_cpu_one_thread=cpu1.numpy(),
             cpu_capability=torch.backends.cpu.get_cpu_capability())


#: Environments of `--softcap-isa`: the host's own vector code, one
#: thread, and the CPU kernels of ATen and MKL pinned to narrower
#: instruction sets.
SOFTCAP_ISA_ENVS = {"host": {}, "one_thread": {"OMP_NUM_THREADS": "1"},
                    "aten_avx2": {"ATEN_CPU_CAPABILITY": "avx2"},
                    "aten_default": {"ATEN_CPU_CAPABILITY": "default"},
                    "mkl_avx2": {"MKL_CBWR": "AVX2"},
                    "mkl_compatible": {"MKL_CBWR": "COMPATIBLE"},
                    "aten_default_mkl_compatible": {
                        "ATEN_CPU_CAPABILITY": "default",
                        "MKL_CBWR": "COMPATIBLE"}}


def softcap_runs(n: int, envs=None) -> list:
    """`_softcap_bits` in n separate processes, one after the other, the
    i-th with `envs[i]` added to its environment."""
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(n):
            out = Path(tmp) / f"softcap_{i}.npz"
            env = dict(os.environ, **(envs[i] if envs else {}))
            subprocess.run([sys.executable, __file__, "--softcap-bits",
                            str(out)], cwd=ROOT, check=True, timeout=600,
                           env=env)
            runs.append(dict(np.load(out)))
    return runs


def softcap_report(runs: list) -> dict:
    """How many distinct bit patterns each output took across the runs, and
    each run's largest error of the kernel against each plain version cast
    to bf16 (and whether it is within one bf16 ulp: rtol 2^-7, atol
    1e-4)."""
    distinct = {k: len({r[k].tobytes() for r in runs}) for k in runs[0]
                if k != "cpu_capability"}
    errors = []
    for r in runs:
        got = torch.from_numpy(r["kernel"]).view(torch.bfloat16).float()
        row = {"cpu_capability": str(r["cpu_capability"]),
               "plain_cpu_sha256": hashlib.sha256(
                   r["plain_cpu"].tobytes()).hexdigest()[:16]}
        for k in ("plain_gpu", "plain_cpu", "plain_cpu_one_thread"):
            want = torch.from_numpy(r[k]).to(torch.bfloat16).float()
            err = (got - want).abs()
            row[k] = float(err.max())
            row[f"{k}_within"] = bool((err <= 1e-4 + 2.0 ** -7
                                       * want.abs()).all())
        errors.append(row)
    return {"processes": len(runs), "distinct": distinct, "errors": errors}


#: The CPU setting `chip_smoke.py` runs its plain versions under (it sets
#: these before torch starts).
SOFTCAP_PINNED = "aten_default_mkl_compatible"


def test_softcap_row_same_bits_in_two_processes(cuda):
    """The `softcap` row's kernel and plain outputs, computed in two
    separate processes under the CPU setting `chip_smoke.py` pins, bit for
    bit the same."""
    pin = SOFTCAP_ISA_ENVS[SOFTCAP_PINNED]
    report = softcap_report(softcap_runs(2, [pin, pin]))
    assert report["distinct"] == dict.fromkeys(report["distinct"], 1), report


if __name__ == "__main__":
    if sys.argv[1] == "--softcap-bits":
        _softcap_bits(sys.argv[2])
    elif sys.argv[1] == "--softcap-isa":
        runs = softcap_runs(len(SOFTCAP_ISA_ENVS),
                            list(SOFTCAP_ISA_ENVS.values()))
        report = softcap_report(runs)
        report["settings"] = list(SOFTCAP_ISA_ENVS)
        report["plain_cpu_as_host"] = [
            bool(np.array_equal(r["plain_cpu"].view(np.uint32),
                                runs[0]["plain_cpu"].view(np.uint32)))
            for r in runs]
        print(json.dumps(report))
    else:
        # --softcap-processes N [SETTING]: N processes under one setting of
        # SOFTCAP_ISA_ENVS (chip_smoke.py's pinned one by default)
        assert sys.argv[1] == "--softcap-processes"
        n = int(sys.argv[2])
        setting = sys.argv[3] if len(sys.argv) > 3 else SOFTCAP_PINNED
        report = softcap_report(softcap_runs(
            n, [SOFTCAP_ISA_ENVS[setting]] * n))
        report["setting"] = setting
        print(json.dumps(report))


# -- streamed connectivity -------------------------------------------------

STREAM_CFG = GridConfig(grid_x=2, grid_y=3, neurons_per_column=60,
                        synapses_per_neuron=24, seed=7)
STREAM_WIDE = GridConfig(grid_x=2, grid_y=2)          # full width


def _streamed(cfg, h, placement, chunk, cuda):
    """(spec, plan, splan, state) of a streamed build on the CPU, and the
    same plan, streamed plan and state on the card."""
    from repro_torch.core import stream_engine as SE
    spec, plan, splan, state = SE.build(cfg, EngineConfig(
        n_shards=h, placement=placement,
        connectivity=f"streamed:chunk={chunk}"), device="cpu")
    to = lambda x: engine.map_state(lambda t: t.to(cuda), x)
    return spec, (plan, splan, state), (to(plan), to(splan), to(state))


@pytest.mark.parametrize("profile", ["ring3", "ring:max_ring=1",
                                     "gaussian:sigma=1.5"])
@pytest.mark.parametrize("cfg,h,placement,chunk", [
    (STREAM_CFG, 1, "block", 1), (STREAM_CFG, 2, "block", 2),
    (STREAM_CFG, 2, "scatter", 3), (STREAM_WIDE, 1, "block", 1),
    (STREAM_WIDE, 4, "scatter", 3)], ids=["h1-k1", "h2-k2", "h2-scatter-k3",
                                          "full-h1-k1", "full-h4-scatter-k3"])
def test_chunk_tables_equal_plain_version(cuda, cfg, h, placement, chunk,
                                          profile):
    """Every chunk regenerated on the card equals the plain version entry
    by entry (row pointers whole, each shard's kept entries), with its
    mismatch flag clear; one launch counted a chunk.  Over the three
    profiles: the kernel's ring prefilter sees one ring, two, and six."""
    from repro_torch.core import stream_engine as SE
    cfg = dataclasses.replace(cfg, connectivity=profile)
    spec, (plan, splan, _), (gplan, gsplan, _) = _streamed(
        cfg, h, placement, chunk, cuda)
    ops.reset_launch_counts()
    _chunks_equal_plain(spec, plan, splan, gplan, gsplan)
    assert ops.launch_counts()["chunk_tables"] == spec.stream.n_chunks


def _chunks_equal_plain(spec, plan, splan, gplan, gsplan) -> int:
    """Every chunk regenerated on the card equals the plain version on
    the CPU (row pointers whole, each shard's kept entries), flag clear
    -> the longest row."""
    from repro_torch.core import stream_engine as SE
    src = SE.chunk_source(spec, plan, splan)
    live = SE.ChunkStream(spec, gplan, gsplan)
    K = SE.live_width(splan)
    longest = 0
    for c in range(spec.stream.n_chunks):
        got = live.regenerate(c)
        want = ref.chunk_tables(src, c, K)
        torch.cuda.synchronize()
        assert torch.equal(got.row_ptr.cpu(), want.row_ptr)
        kept = (want.row_ptr[:, -1] - want.row_ptr[:, 0]).tolist()
        for hh, e in enumerate(kept):
            for a, b in zip(got[1:], want[1:]):
                assert torch.equal(a[hh, :e].cpu(), b[hh, :e])
        longest = max(longest, int(want.row_ptr.diff(dim=1).max()))
    assert int(live.status[0]) == 0
    return longest


@pytest.mark.parametrize("M,lo,hi", [(384, 256, 512), (640, 512, 1 << 20)],
                         ids=["rows-257-512", "rows-past-512"])
def test_chunk_tables_long_rows(cuda, M, lo, hi):
    """Rows longer than the 8-register sort takes (257-512 keys, the
    16-register sort) and longer than any register sort (the rank by
    counting): 2x2 columns of 50 at M = 384 and 640, H = 2 scatter, K = 1,
    every chunk equal to the plain version; the buckets are the plan's
    longest row wide."""
    cfg = GridConfig(grid_x=2, grid_y=2, neurons_per_column=50,
                     synapses_per_neuron=M, seed=7)
    spec, (plan, splan, _), (gplan, gsplan, _) = _streamed(
        cfg, 2, "scatter", 1, cuda)
    longest = _chunks_equal_plain(spec, plan, splan, gplan, gsplan)
    assert lo < longest <= hi and longest == spec.stream.row_cap


def test_chunk_tables_8x8_chunk_h2_scatter(cuda):
    """One chunk of the 8x8 full-width plan at H = 2, scatter placement,
    K = 1 (a shard's chunk spans two columns, every other gid): the card
    equals the plain version run on the card, both shards, flag clear.
    The plan is built on the card (the kernel counts the chunks; the
    plain version raises where a count disagrees)."""
    from repro_torch.core import StepProgram
    from repro_torch.core import stream_engine as SE
    sp = StepProgram(GridConfig(grid_x=8, grid_y=8), EngineConfig(
        n_shards=2, placement="scatter", connectivity="streamed:chunk=1"),
        device=cuda)
    live = SE.ChunkStream(sp.spec, sp.plan, sp.splan)
    c = sp.spec.stream.n_chunks // 2
    got = live.regenerate(c)
    want = ref.chunk_tables(live.source, c, live.tables.src.shape[1])
    torch.cuda.synchronize()
    assert int(live.status[0]) == 0
    assert torch.equal(got.row_ptr, want.row_ptr)
    kept = (want.row_ptr[:, -1] - want.row_ptr[:, 0]).tolist()
    assert min(kept) > 0
    for hh, e in enumerate(kept):
        for a, b in zip(got[1:], want[1:]):
            assert torch.equal(a[hh, :e], b[hh, :e])


@pytest.mark.parametrize("rows", [[2, 3], [1], [0, 3]],
                         ids=["block-2-3", "one-1", "rows-0-3"])
def test_chunk_tables_of_scatter_rows_by_shard_id(cuda, rows):
    """Scatter rows named by the plan's shard ids (a rank's block of two
    of four shards, one shard, two shards apart) regenerate on the card
    as their plain version does, and as those rows of the all-shard call:
    every chunk, flag clear."""
    from repro_torch.core import stream_engine as SE
    spec, (plan, splan, _), (gplan, gsplan, _) = _streamed(
        STREAM_WIDE, 4, "scatter", 2, cuda)
    ss, K = spec.stream, SE.live_width(splan)
    part = lambda p, sp, idx: SE.make_chunk_source(
        spec.cfg, spec.eng, ss.q, p.src_gid[idx], sp.cand[idx],
        sp.e_start[idx], ss.row_cap, shard_id=p.shard_id[idx])
    src = part(plan, splan, rows)
    gidx = torch.tensor(rows, device=cuda)
    gsrc = part(gplan, gsplan, gidx)
    full = SE.chunk_source(spec, plan, splan)
    z = lambda n, dt: torch.zeros((len(rows), n), dtype=dt, device=cuda)
    tables = ref.ChunkTables(row_ptr=z(ss.q + 1, torch.int32),
                             src=z(K, torch.int32), delay=z(K, torch.int32),
                             plastic=z(K, torch.bool))
    status = torch.zeros(1, dtype=torch.int32, device=cuda)
    for c in range(ss.n_chunks):
        got = ops.chunk_tables(gsrc, c, tables, status)
        want = ref.chunk_tables(src, c, K)
        whole = ref.chunk_tables(full, c, K)
        torch.cuda.synchronize()
        assert torch.equal(got.row_ptr.cpu(), want.row_ptr)
        assert torch.equal(want.row_ptr, whole.row_ptr[rows])
        kept = (want.row_ptr[:, -1] - want.row_ptr[:, 0]).tolist()
        for i, e in enumerate(kept):
            for a, b, w in zip(got[1:], want[1:], whole[1:]):
                assert torch.equal(a[i, :e].cpu(), b[i, :e])
                assert torch.equal(b[i, :e], w[rows[i], :e])
    assert int(status[0]) == 0


@pytest.mark.parametrize("h,placement,chunk", [(1, "block", 1),
                                               (2, "scatter", 3)])
def test_streamed_build_on_card_equals_host_build(cuda, h, placement,
                                                  chunk):
    """`stream_engine.build` on the card counts each chunk's synapses and
    sets their initial weights with the chunk kernel; the CPU runs the
    reference's host builder: the same spec, plans and state."""
    from repro_torch.core import stream_engine as SE
    eng = EngineConfig(n_shards=h, placement=placement,
                       connectivity=f"streamed:chunk={chunk}")
    host = SE.build(STREAM_CFG, eng, device="cpu")
    card = SE.build(STREAM_CFG, eng, device=cuda)
    assert card[0] == host[0]
    for a, b in zip(card[1:], host[1:]):
        for x, y in zip(engine.state_tensors(a), engine.state_tensors(b)):
            assert x.is_cuda and _bits_equal(x, y)


def test_chunk_tables_flag_a_wrong_plan(cuda):
    """A plan whose e_start disagrees with what a chunk keeps sets the
    flag (read after the card has finished); the plain version raises."""
    from repro_torch.core import stream_engine as SE
    spec, (plan, splan, _), (gplan, gsplan, _) = _streamed(
        STREAM_CFG, 1, "block", 1, cuda)
    bad = gsplan._replace(e_start=gsplan.e_start + torch.arange(
        gsplan.e_start.shape[1], dtype=torch.int32, device=cuda))
    live = SE.ChunkStream(spec, gplan, bad)
    live.regenerate(1)
    torch.cuda.synchronize()
    assert int(live.status[0]) & 1
    with pytest.raises(RuntimeError, match="flagged"):
        live.check()


def test_chunk_tables_flag_a_short_row_cap(cuda):
    """Buckets one key shorter than the plan's longest row: the chunk
    that holds it sets bit 1 of the flag, and no other chunk does."""
    from repro_torch.core import stream_engine as SE
    spec, (plan, splan, _), (gplan, gsplan, _) = _streamed(
        STREAM_CFG, 1, "block", 1, cuda)
    src = SE.chunk_source(spec, plan, splan)
    K, cap = SE.live_width(splan), spec.stream.row_cap
    short = spec._replace(stream=spec.stream._replace(row_cap=cap - 1))
    live = SE.ChunkStream(short, gplan, gsplan)
    at_cap = []
    for c in range(spec.stream.n_chunks):
        live.status.zero_()
        live.regenerate(c)
        torch.cuda.synchronize()
        over = int(ref.chunk_tables(src, c, K).row_ptr.diff(dim=1).max())
        assert int(live.status[0]) == (2 if over == cap else 0)
        at_cap += [c] if over == cap else []
    live.regenerate(at_cap[0])
    with pytest.raises(RuntimeError, match="flagged"):
        live.check()


@pytest.mark.parametrize("density", [0.0, 0.0215, 0.215, 1.0])
@pytest.mark.parametrize("h,placement,chunk", [(1, "block", 1),
                                               (2, "scatter", 2),
                                               (2, "block", 3)])
def test_chunk_window_kernels_equal_plain_versions(cuda, h, placement, chunk,
                                                   density):
    """The chunk windows of the row kernel (with and without LTP), of the
    LTP kernel and of the element walk, chunk after chunk on the same
    tables, leave the same state, spikes and counts as their plain
    versions on a CPU copy."""
    from repro_torch.core import stream_engine as SE
    spec, (plan, splan, state), _ = _streamed(STREAM_CFG, h, placement,
                                              chunk, cuda)
    src = SE.chunk_source(spec, plan, splan)
    K = SE.live_width(splan)
    rng = np.random.default_rng(chunk)
    H, D, E = state.arr_ring.shape
    N = state.v.shape[1]
    ends = splan.e_start[:, -1].tolist()
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    ring = np.zeros((H, D, E), bool)
    for hh, e in enumerate(ends):
        ring[hh, :, :e] = rng.random((D, e)) < density
    times = lambda shape: f(np.where(rng.random(shape) < 0.7,
                                     rng.uniform(-2000.0, 200.0, shape),
                                     -1.0e9))
    cpu = dict(ring=torch.from_numpy(ring), w=f(rng.uniform(0, 10, (H, E))),
               last_arr=times((H, E)), last_post=times((H, N)),
               v=f(rng.uniform(-80.0, 35.0, (H, N))),
               u=f(rng.uniform(-20.0, 10.0, (H, N))),
               idx=torch.from_numpy(rng.integers(0, N, (H, 64))
                                    .astype(np.int64)),
               amp=f(np.where(rng.random((H, 64)) < 0.8, 20.0, 0.0)),
               spiked=torch.from_numpy(rng.random((H, N)) < density),
               spiked_src=torch.from_numpy(
                   rng.random(tuple(plan.src_gid.shape)) < density),
               exc=plan.exc_mask, nv=plan.neuron_valid,
               out=torch.zeros((H, N), dtype=torch.bool),
               counts=torch.zeros((2, H), dtype=torch.int64))
    gpu = {k: v.clone().to(cuda) for k, v in cpu.items()}
    for d in (cpu, gpu):
        for c in range(spec.stream.n_chunks):
            tb = ref.chunk_tables(src, c, K)
            tb = ref.ChunkTables(*(x.to(d["w"].device) for x in tb))
            lo = c * spec.stream.q
            for with_ltp in (True, False):
                ops.stdp_phase_a_chunk(
                    d["ring"], 7 % D, tb, lo, d["exc"], d["nv"], d["idx"],
                    d["amp"], d["v"], d["u"], d["last_post"], d["w"],
                    d["last_arr"], 207, d["out"], d["counts"],
                    accumulate=c > 0, izh=DEFAULT_IZH, stdp=DEFAULT_STDP,
                    neg_time=-1.0e9, with_ltp=with_ltp)
            ops.stdp_ltp_chunk(d["spiked"], tb, lo, d["last_arr"], d["w"],
                               d["last_post"], 208, **LTP_KW)
            ops.arborize_chunk(d["ring"], d["spiked_src"], tb, 208)
    torch.cuda.synchronize()
    for k in cpu:
        assert _bits_equal(gpu[k], cpu[k]), k


def test_streamed_graph_run_equals_eager_materialized_and_cpu(cuda):
    """A streamed `run` on the card (a captured graph of `RUN_WINDOW`
    steps, K = 2 over 3 owned columns: a ragged last chunk) equals its
    eager loop, the CPU port's streamed run and the card's materialized
    run; each step launches chunk_tables twice a chunk and the phase-A row
    kernel and the element walk once a chunk."""
    from repro_torch.core import stream_engine as SE
    W = engine.RUN_WINDOW
    steps = W + 17
    base = dict(n_shards=2, placement="block")
    eng = EngineConfig(connectivity="streamed:chunk=2", **base)
    cpu = StepProgram(STREAM_CFG, eng, device="cpu")
    s_c, r_c, _ = cpu.run(cpu.init_state(), 0, steps)
    mat = StepProgram(STREAM_CFG, EngineConfig(**base), device="cuda")
    _, r_m, _ = mat.run(mat.init_state(), 0, steps)
    sp = StepProgram(STREAM_CFG, eng, device="cuda")
    n_chunks = sp.spec.stream.n_chunks
    assert n_chunks == 2
    s0 = sp.init_state()
    runs = []
    for graph in (True, True, False):
        ops.reset_launch_counts()
        s, r, _ = sp.run(s0, 0, steps, graph=graph)
        torch.cuda.synchronize()
        runs.append((s, r, ops.launch_counts(),
                     sp.runner.replayed_launches()))
    sp.runner.chunks.check()
    per_step = dict(chunk_tables=2 * n_chunks, stdp_phase_a_chunk=n_chunks,
                    arborize_chunk=n_chunks)
    assert sp.runner.recorded == {k: W * n for k, n in per_step.items()}
    for (s, r, counts, replayed), n in zip(runs, (W + 17, 17, steps)):
        assert torch.equal(r.cpu(), r_c) and torch.equal(r, r_m)
        for a, b in zip(engine.state_tensors(s), engine.state_tensors(s_c)):
            assert _bits_equal(a, b)
        assert counts == dict(dict.fromkeys(ops.KERNELS, 0),
                              **{k: v * n for k, v in per_step.items()})
        assert replayed == {k: v * (steps - n) for k, v in per_step.items()}
    assert sp.weight_signature(runs[0][0]) == mat.weight_signature(
        mat.run(mat.init_state(), 0, steps)[0])
    assert SE.live_width(sp.splan) == sp.runner.chunks.tables.src.shape[1]


@pytest.mark.parametrize("exchange", ["allgather", "halo", "hier"])
def test_streamed_phase_handles_equal_cpu_and_never_synchronise(cuda,
                                                                exchange):
    """The streamed phase handles on the card under sync-debug "error", in
    the sync and the pipelined order (its plasticity half is the LTP
    kernel's chunk window), equal the CPU port's."""
    eng = EngineConfig(n_shards=2, exchange=exchange, placement="scatter",
                       connectivity="streamed:chunk=2")
    out = {}
    for dev in ("cpu", "cuda"):
        sp = StepProgram(STREAM_CFG, eng, device=dev, hier_groups=2)
        pp = sp.phase_fns()
        state = engine.clone_state(sp.init_state())
        state, spiked, _ = pp.phase_a(state, 0)
        state = pp.phase_b(state, pp.exchange(spiked), 0)
        ss = pp.exchange(spiked)
        rasters = []
        if dev == "cuda":
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            torch.cuda.set_sync_debug_mode("error")
        try:
            for t in range(1, 4):
                state, spiked, _ = pp.phase_a(state, t)
                state = pp.phase_b(state, pp.exchange(spiked), t)
                rasters.append(spiked)
            for t in range(4, 7):
                state = pp.phase_b(state, ss, t - 1)
                state, spiked, _ = pp.phase_a_dynamics(state, t)
                ss = pp.exchange(spiked)
                state = pp.phase_a_plasticity(state, spiked, t)
                rasters.append(spiked)
        finally:
            if dev == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        out[dev] = ([r.cpu() for r in rasters],
                    [x.cpu() for x in engine.state_tensors(state)])
    n = sp.spec.stream.n_chunks
    assert ops.launch_counts() == dict(
        dict.fromkeys(ops.KERNELS, 0), chunk_tables=6 * 2 * n + 3 * n,
        stdp_phase_a_chunk=6 * n, arborize_chunk=6 * n,
        stdp_ltp_chunk=3 * n)
    assert all(torch.equal(a, b) for a, b in zip(*(out[d][0] for d in out)))
    assert all(_bits_equal(a, b) for a, b in zip(out["cuda"][1],
                                                  out["cpu"][1]))


# -- the simulation service's per-shard steps (t_base) and its rounds ------


@pytest.mark.parametrize("name", ["stdp_phase_a", "arborize",
                                  "event_arrival", "event_neurons",
                                  "event_ltp", "event_emit"])
def test_t_base_forms_on_card_equal_plain_and_solo(cuda, name):
    """Each op with per-shard steps on the card (t an int, t_base [4, 9]
    on the card): bit-equal to its plain version with the same steps on
    the CPU, and shard h to the solo launch at t + t_base[h]; t_base of
    zeros bit-equal to none."""
    from test_torch_simserve import OPS, _call_op, _op_inputs
    sp_c, st_c = _op_inputs(OPS[name])
    sp_g, st_g = _op_inputs(OPS[name], "cuda")
    tb = torch.tensor([4, 9])
    got = _call_op(name, sp_g, st_g, 20, tb.cuda())
    want = _call_op(name, sp_c, st_c, 20, tb)
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    solo = [_call_op(name, sp_g, st_g, t, None) for t in (24, 29)]
    for a, b0, b1 in zip(got, *solo):
        if a.dim() and a.shape[0] == 2:
            assert _bits_equal(a[0], b0[0]) and _bits_equal(a[1], b1[1])
    zeros = torch.zeros(2, dtype=torch.int64, device="cuda")
    assert all(_bits_equal(a, b) for a, b in zip(
        _call_op(name, sp_g, st_g, 24, zeros), solo[0]))
    with pytest.raises(ValueError, match="t_base"):
        _call_op(name, sp_g, st_g, 24, tb)         # on the CPU


def test_simserve_soak_on_card_equals_cpu_service(cuda):
    """The CPU soak of tests/test_torch_simserve.py on the card: every
    tenant's signature and sat equal the CPU service's, one capture per
    shape key."""
    from test_torch_simserve import (DENSE, EVENT, _soak, _soak_requests,
                                     CFG as SCFG)
    from repro_torch.simserve import SimService, TenantRequest
    out = {}
    for dev in ("cpu", "cuda"):
        svc = SimService(slots=2, round_steps=15, device=dev)
        _, snap = _soak(svc, _soak_requests(TenantRequest, SCFG, DENSE,
                                            EVENT))
        out[dev] = ({n: (s.stream.signature(), s.sat_total)
                     for n, s in svc.sessions.items()},
                    snap["program_cache"])
    assert out["cuda"] == out["cpu"]
    assert all(n == 1 for n in out["cuda"][1]["traces"].values())
