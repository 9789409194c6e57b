"""The port's CUDA kernels on the card (skipped without one).

Each kernel is held bit for bit against its plain PyTorch version on a CPU
copy of the same inputs (attention within 2e-5 fp32 / one bf16 ulp of its
plain version on the card), and a short main-path run on the card against
the CPU port.  Run on a machine with an NVIDIA GPU and nvcc:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

`chip_smoke.py` does the same at the main path's full shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (EngineConfig, GridConfig, StepProgram,
                              observables)
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops, ref

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
    # the main path runs the fused arrival kernel, never the old pair
    assert runs["cuda"][2] == dict(dict.fromkeys(ops.KERNELS, 0),
                                   **dict.fromkeys(ops.SNN_KERNELS, 60))


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
