"""The port's plain kernel versions against the JAX reference.

* Bit for bit against jitted `repro.kernels.ref` (and `jnp.exp`,
  `jax.ops.segment_sum(..., indices_are_sorted=True)`), run in a
  subprocess under `XLA_FLAGS=--xla_cpu_max_isa=AVX` on 1,000,000-element
  numpy inputs that cover the -1e9 "never" sentinels and the clip edges.
* Against the Pallas kernel bodies in interpret mode, in this process,
  with the tolerances of `tests/test_kernels.py`.

The CUDA kernels themselves need the card: `chip_smoke.py` holds each of
them bit for bit against these plain versions.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_reference import run_avx  # noqa: E402

N_ELEM = 1_000_000
STDP_KW = dict(w_min=0.0, w_max=10.0, neg_time=-1.0e9)
LTD_KW = dict(a_minus=0.12, tau_minus=20.0, **STDP_KW)
LTP_KW = dict(a_plus=0.1, tau_plus=20.0, **STDP_KW)
T_STEP = 200.0


def make_inputs(n: int, seed: int = 0) -> dict:
    """numpy inputs for every kernel: neuron states around threshold,
    synapse times mixing recent steps, far-past steps (exp underflow) and
    the -1e9 sentinel, weights at and near the clip edges."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    exc = np.arange(n) % 5 != 4

    def times():
        kind = rng.random(n)
        return f32(np.where(kind < 0.5, rng.uniform(0.0, T_STEP, n),
                   np.where(kind < 0.8, rng.uniform(-3000.0, 0.0, n),
                            -1.0e9)))
    w = rng.uniform(-0.5, 10.5, n)
    w = np.where(rng.random(n) < 0.2, rng.choice([0.0, 10.0, 0.05, 9.95], n),
                 w)
    n_seg = max(n // 200, 9)
    tgt = np.sort(rng.integers(0, n_seg, n))
    tgt[tgt == 7] = 8                                  # an empty segment
    return dict(
        x=f32(rng.uniform(-100.0, 90.0, n)),
        v=f32(rng.uniform(-80.0, 31.0, n)), u=f32(rng.uniform(-20.0, 10.0, n)),
        cur=f32(rng.uniform(-10.0, 25.0, n)),
        a=f32(np.where(exc, 0.02, 0.1)), b=f32(np.full(n, 0.2)),
        c=f32(np.full(n, -65.0)), d=f32(np.where(exc, 8.0, 2.0)),
        arr=rng.random(n) < 0.3, w=f32(w), lp=times(), la=times(),
        plastic=rng.random(n) < 0.8, post=rng.random(n) < 0.5,
        valid=rng.random(n) < 0.95,
        contrib=f32(np.where(rng.random(n) < 0.3, rng.uniform(-5, 10, n), 0)),
        tgt=tgt.astype(np.int32), n_seg=np.int64(n_seg))


def _jax_outputs(path: str) -> None:
    """Inside the AVX subprocess: jitted reference outputs to an npz."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jref

    z = make_inputs(N_ELEM)
    t = np.float32(T_STEP)
    izh = jax.jit(lambda *a: jref.izhikevich_update(*a, v_peak=30.0))(
        z["v"], z["u"], z["cur"], z["a"], z["b"], z["c"], z["d"])
    arr = jax.jit(lambda *a: jref.stdp_arrival(*a, **LTD_KW))(
        z["arr"], z["w"], z["lp"], z["la"], z["plastic"], t)
    ltp = jax.jit(lambda *a: jref.stdp_ltp(*a, **LTP_KW))(
        z["post"], z["w"], z["la"], z["plastic"], z["valid"], t)
    seg = jax.jit(lambda c, i: jax.ops.segment_sum(
        c, i, num_segments=int(z["n_seg"]), indices_are_sorted=True))(
            z["contrib"], z["tgt"])
    out = dict(exp=jax.jit(jnp.exp)(z["x"]), v=izh[0], u=izh[1],
               spiked=izh[2], arr_w=arr[0], arr_la=arr[1], arr_contrib=arr[2],
               ltp_w=ltp, seg=seg)
    np.savez(path, **{k: np.asarray(v) for k, v in out.items()})


@pytest.fixture(scope="module")
def avx(tmp_path_factory):
    path = tmp_path_factory.mktemp("avx") / "kernels.npz"
    run_avx(__file__, [["--out", path]])
    inputs = {k: torch.from_numpy(np.asarray(v))
              for k, v in make_inputs(N_ELEM).items()}
    return inputs, dict(np.load(path))


def assert_bits(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.float32:
        got, want = got.view(np.uint32), want.view(np.uint32)
    n_diff = int((got != want).sum())
    assert n_diff == 0, f"{n_diff} of {got.size} differ"


def test_xla_exp_bit_exact(avx):
    z, want = avx
    with ref.flush_denormal():
        assert_bits(ref.xla_exp(z["x"]), want["exp"])
    # torch.exp is not XLA-CPU's exp: the reason xla_exp exists
    assert not np.array_equal(torch.exp(z["x"]).numpy(), want["exp"])


def test_izhikevich_bit_exact(avx):
    z, want = avx
    v, u, s = ops.izhikevich_update(z["v"], z["u"], z["cur"], z["a"], z["b"],
                                    z["c"], z["d"], v_peak=30.0)
    assert_bits(v, want["v"])
    assert_bits(u, want["u"])
    assert_bits(s, want["spiked"])
    assert 0 < int(s.sum()) < N_ELEM


def test_stdp_arrival_bit_exact(avx):
    z, want = avx
    w, la, c = ops.stdp_arrival(z["arr"], z["w"], z["lp"], z["la"],
                                z["plastic"], T_STEP, **LTD_KW)
    assert_bits(w, want["arr_w"])
    assert_bits(la, want["arr_la"])
    assert_bits(c, want["arr_contrib"])
    assert bool((w != z["w"]).any())


def test_stdp_ltp_bit_exact(avx):
    z, want = avx
    w = ops.stdp_ltp(z["post"], z["w"], z["la"], z["plastic"], z["valid"],
                     T_STEP, **LTP_KW)
    assert_bits(w, want["ltp_w"])
    assert bool((w != z["w"]).any())


def test_segment_sum_ordered_bit_exact(avx):
    z, want = avx
    n_seg = int(z["n_seg"])
    counts = np.bincount(z["tgt"].numpy(), minlength=n_seg)
    row_ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)])
                               .astype(np.int32)).view(1, -1)
    seg = ref.make_segments(row_ptr, N_ELEM)
    got = ops.segment_sum_ordered(z["contrib"].view(1, -1), seg)[0]
    assert_bits(got, want["seg"])
    assert got[7] == 0.0 and seg.max_fan_in == counts.max()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


# -- against the Pallas bodies in interpret mode -----------------------------


def _pallas_ops():
    from repro.kernels import ops as pallas_ops
    return pallas_ops


@pytest.mark.parametrize("n", [7, 1000, 5003])
def test_izhikevich_matches_pallas_interpret(n):
    z = make_inputs(n, seed=n)
    args = [z[k] for k in ("v", "u", "cur", "a", "b", "c", "d")]
    v1, u1, s1 = _pallas_ops().izhikevich_update(*args, v_peak=30.0,
                                                 interpret=True)
    v2, u2, s2 = ops.izhikevich_update(*map(torch.from_numpy, args),
                                       v_peak=30.0)
    np.testing.assert_allclose(v2.numpy(), v1, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(u2.numpy(), u1, rtol=1e-4, atol=1e-3)
    vpre = z["v"]
    for _ in range(2):
        vpre = vpre + 0.5 * (0.04 * vpre * vpre + 5.0 * vpre + 140.0
                             - z["u"] + z["cur"])
    disagree = s2.numpy() != np.asarray(s1)
    assert not (disagree & ~(np.abs(vpre - 30.0) < 1e-2)).any()


@pytest.mark.parametrize("e", [16, 1024, 9999])
def test_stdp_matches_pallas_interpret(e):
    import jax.numpy as jnp
    z = make_inputs(e, seed=e)
    t = jnp.float32(T_STEP)
    got_a = ops.stdp_arrival(*(torch.from_numpy(z[k]) for k in
                               ("arr", "w", "lp", "la", "plastic")),
                             T_STEP, **LTD_KW)
    want_a = _pallas_ops().stdp_arrival(z["arr"], z["w"], z["lp"], z["la"],
                                        z["plastic"], t, interpret=True,
                                        **LTD_KW)
    for g, w in zip(got_a, want_a):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    got_l = ops.stdp_ltp(*(torch.from_numpy(z[k]) for k in
                           ("post", "w", "la", "plastic", "valid")),
                         T_STEP, **LTP_KW)
    want_l = _pallas_ops().stdp_ltp(z["post"], z["w"], z["la"], z["plastic"],
                                    z["valid"], t, interpret=True, **LTP_KW)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-6,
                               atol=1e-6)


if __name__ == "__main__":
    assert sys.argv[1] == "--out"
    _jax_outputs(sys.argv[2])
