"""The port's plain kernel versions against the JAX reference.

* Bit for bit against jitted `repro.kernels.ref` (and `jnp.exp`,
  `jax.ops.segment_sum(..., indices_are_sorted=True)`), run in a
  subprocess under `XLA_FLAGS=--xla_cpu_max_isa=AVX` on 1,000,000-element
  numpy inputs that cover the -1e9 "never" sentinels and the clip edges.
  The port's STDP passes take the engine's own arrays (ring, plan, state)
  and update them in place; the JAX functions take the arrays numpy
  gathers from the same inputs (ring slot & valid, last_post[syn_tgt],
  spiked[syn_tgt]).
* Against the Pallas kernel bodies in interpret mode, in this process,
  with the tolerances of `tests/test_kernels.py`, also on the plans of a
  real 2x2 grid in three layouts.

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


def _times(rng, shape) -> np.ndarray:
    """Spike / arrival times mixing recent steps, far-past steps (exp
    underflow) and the -1e9 "never" sentinel."""
    kind = rng.random(shape)
    return np.asarray(np.where(
        kind < 0.5, rng.uniform(0.0, T_STEP, shape),
        np.where(kind < 0.8, rng.uniform(-3000.0, 0.0, shape), -1.0e9)),
        np.float32)


def _weights(rng, shape) -> np.ndarray:
    """Weights across and at the clip edges [0, 10]."""
    w = rng.uniform(-0.5, 10.5, shape)
    return np.asarray(np.where(rng.random(shape) < 0.2, rng.choice(
        [0.0, 10.0, 0.05, 9.95], shape), w), np.float32)


def make_inputs(n: int, seed: int = 0) -> dict:
    """numpy inputs for the elementwise kernels: neuron states around
    threshold, exp arguments, and sorted segments of contributions."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    exc = np.arange(n) % 5 != 4
    n_seg = max(n // 200, 9)
    tgt = np.sort(rng.integers(0, n_seg, n))
    tgt[tgt == 7] = 8                                  # an empty segment
    return dict(
        x=f32(rng.uniform(-100.0, 90.0, n)),
        v=f32(rng.uniform(-80.0, 31.0, n)), u=f32(rng.uniform(-20.0, 10.0, n)),
        cur=f32(rng.uniform(-10.0, 25.0, n)),
        a=f32(np.where(exc, 0.02, 0.1)), b=f32(np.full(n, 0.2)),
        c=f32(np.full(n, -65.0)), d=f32(np.where(exc, 8.0, 2.0)),
        contrib=f32(np.where(rng.random(n) < 0.3, rng.uniform(-5, 10, n), 0)),
        tgt=tgt.astype(np.int32), n_seg=np.int64(n_seg))


# STDP inputs: H shards of E synapse slots (valid ones first, sorted by
# target, pads after), N neurons a shard, a D-slot ring popped at slot R
STDP_SHAPE = dict(H=2, E=500_000, N=20_000, D=4)
R_SLOT = 2


def make_stdp_inputs(H: int, E: int, N: int, D: int, seed: int = 0) -> dict:
    """numpy arguments of the port's fused STDP passes, in the engine's
    layout: every shard has pads (E > n_valid) and an empty row, the ring
    has flags on 30% of the slots, pads too (`& syn_valid` must drop
    them), and half the neurons spiked."""
    rng = np.random.default_rng(seed)
    n_valid = [E - max(8, E // 50) - 3 * h for h in range(H)]
    tgt = np.zeros((H, E), np.int64)
    valid = np.zeros((H, E), bool)
    row_ptr = np.zeros((H, N + 1), np.int32)
    for h, n in enumerate(n_valid):
        t_h = np.sort(rng.integers(0, N, n))
        t_h[t_h == N // 3] = N // 3 + 1                    # an empty row
        tgt[h, :n], valid[h, :n] = t_h, True
        row_ptr[h, 1:] = np.cumsum(np.bincount(t_h, minlength=N))
    return dict(ring=rng.random((H, D, E)) < 0.3, valid=valid, tgt=tgt,
                plastic=rng.random((H, E)) < 0.8, row_ptr=row_ptr,
                last_post=_times(rng, (H, N)), w=_weights(rng, (H, E)),
                last_arr=_times(rng, (H, E)),
                spiked=rng.random((H, N)) < 0.5)


def gather_stdp(s: dict, r: int = R_SLOT) -> dict:
    """What the JAX functions take: numpy's gathers of `make_stdp_inputs`
    (the JAX engine's `ring[r] & valid`, `last_post[syn_tgt]`,
    `spiked[syn_tgt]`)."""
    take = lambda a: np.take_along_axis(a, s["tgt"], axis=1)
    return dict(arr=s["ring"][:, r] & s["valid"], lp=take(s["last_post"]),
                post=take(s["spiked"]))


def run_port_stdp(s: dict, r: int = R_SLOT) -> dict:
    """The port's two passes (`kernels.ops`) on torch copies of `s`, each
    from the same inputs: the updated state and the returned values."""
    g = {k: torch.from_numpy(np.array(v)) for k, v in s.items()}
    contrib, n_arr = ops.stdp_arrival(
        g["ring"], r, g["valid"], g["tgt"], g["plastic"], g["last_post"],
        g["w"], g["last_arr"], T_STEP, **LTD_KW)
    out = dict(arr_w=g["w"], arr_la=g["last_arr"], ring=g["ring"],
               contrib=contrib, n_arrived=n_arr)
    g = {k: torch.from_numpy(np.array(v)) for k, v in s.items()}
    ops.stdp_ltp(g["spiked"], g["row_ptr"], g["plastic"], g["last_arr"],
                 g["w"], g["last_post"], T_STEP, **LTP_KW)
    out.update(ltp_w=g["w"], ltp_lp=g["last_post"])
    return out


def _jax_outputs(path: str) -> None:
    """Inside the AVX subprocess: jitted reference outputs to an npz."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jref

    z = make_inputs(N_ELEM)
    t = np.float32(T_STEP)
    izh = jax.jit(lambda *a: jref.izhikevich_update(*a, v_peak=30.0))(
        z["v"], z["u"], z["cur"], z["a"], z["b"], z["c"], z["d"])
    s = make_stdp_inputs(**STDP_SHAPE)
    g = gather_stdp(s)
    arr = jax.jit(lambda *a: jref.stdp_arrival(*a, **LTD_KW))(
        g["arr"], s["w"], g["lp"], s["last_arr"], s["plastic"], t)
    ltp = jax.jit(lambda *a: jref.stdp_ltp(*a, **LTP_KW))(
        g["post"], s["w"], s["last_arr"], s["plastic"], s["valid"], t)
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


@pytest.fixture(scope="module")
def stdp_port():
    """The STDP inputs of the AVX run and the port's outputs on them."""
    s = make_stdp_inputs(**STDP_SHAPE)
    return s, run_port_stdp(s)


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


def test_stdp_arrival_bit_exact(avx, stdp_port):
    _, want = avx
    s, got = stdp_port
    arr = gather_stdp(s)["arr"]
    assert_bits(got["arr_w"], want["arr_w"])
    assert_bits(got["arr_la"], want["arr_la"])
    assert_bits(got["contrib"], want["arr_contrib"])
    assert_bits(got["n_arrived"], arr.sum(1))
    assert not got["ring"][:, R_SLOT].any()
    keep = np.arange(STDP_SHAPE["D"]) != R_SLOT
    assert_bits(got["ring"][:, keep], s["ring"][:, keep])
    assert bool((got["arr_w"].numpy() != s["w"]).any())
    assert (s["ring"][:, R_SLOT] & ~s["valid"]).any()


def test_stdp_ltp_bit_exact(avx, stdp_port):
    _, want = avx
    s, got = stdp_port
    assert_bits(got["ltp_w"], want["ltp_w"])
    assert_bits(got["ltp_lp"], np.where(s["spiked"], np.float32(T_STEP),
                                        s["last_post"]))
    assert bool((got["ltp_w"].numpy() != s["w"]).any())
    # the plain version reads syn_tgt and syn_valid off row_ptr
    row = ref.rows_of_synapses(torch.from_numpy(s["row_ptr"]),
                               STDP_SHAPE["E"]).numpy()
    assert np.array_equal(row < STDP_SHAPE["N"], s["valid"])
    assert np.array_equal(np.where(s["valid"], row, 0), s["tgt"])
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


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


def _pallas_stdp(s: dict, r: int = R_SLOT) -> dict:
    """The Pallas kernels in interpret mode on numpy's gathers of `s`,
    flattened as the JAX engine's [E] arrays."""
    import jax.numpy as jnp
    g = gather_stdp(s, r)
    flat = lambda x: np.ascontiguousarray(x).reshape(-1)
    t = jnp.float32(T_STEP)
    shape = s["w"].shape
    w, la, c = _pallas_ops().stdp_arrival(
        flat(g["arr"]), flat(s["w"]), flat(g["lp"]), flat(s["last_arr"]),
        flat(s["plastic"]), t, interpret=True, **LTD_KW)
    ltp = _pallas_ops().stdp_ltp(
        flat(g["post"]), flat(s["w"]), flat(s["last_arr"]),
        flat(s["plastic"]), flat(s["valid"]), t, interpret=True, **LTP_KW)
    return {k: np.asarray(v).reshape(shape) for k, v in
            dict(arr_w=w, arr_la=la, contrib=c, ltp_w=ltp).items()}


def _assert_close(got: dict, want: dict):
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-6, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("e", [16, 1024, 9999])
def test_stdp_matches_pallas_interpret(e):
    s = make_stdp_inputs(H=2, E=e, N=max(e // 20, 4), D=3, seed=e)
    _assert_close(run_port_stdp(s), _pallas_stdp(s))


def _plan_inputs(n_shards: int, placement: str, seed: int) -> dict:
    """`make_stdp_inputs`' dynamic arrays on the plan of a 2x2 grid (100
    neurons a column, 40 synapses each): ring flags only on valid
    synapses, as phase B sets them."""
    from repro_torch.core import EngineConfig, GridConfig, engine
    cfg = GridConfig(grid_x=2, grid_y=2, neurons_per_column=100,
                     synapses_per_neuron=40, seed=7)
    _, plan, _ = engine.build(cfg, EngineConfig(n_shards=n_shards,
                                                placement=placement),
                              device="cpu")
    H, E = plan.syn_valid.shape
    N = plan.gid.shape[1]
    s = make_stdp_inputs(H, E, N, 3, seed=seed)
    valid = plan.syn_valid.numpy()
    s.update(valid=valid, tgt=plan.syn_tgt.numpy(),
             plastic=plan.syn_plastic.numpy(), row_ptr=plan.row_ptr.numpy(),
             ring=s["ring"] & valid[:, None],
             spiked=s["spiked"] & plan.neuron_valid.numpy())
    return s


@pytest.mark.parametrize("kernel", ["arrival", "ltp"])
@pytest.mark.parametrize("layout", [(1, "block"), (4, "block"),
                                    (4, "scatter")],
                         ids=["h1_block", "h4_block", "h4_scatter"])
def test_stdp_on_real_plans(kernel, layout):
    """Against the Pallas kernels on a real plan's arrays; pads (past each
    shard's valid synapses) keep their state, and the popped ring slot is
    cleared while the others keep their flags."""
    s = _plan_inputs(*layout, seed=layout[0])
    got, want = run_port_stdp(s), _pallas_stdp(s)
    pads = ~s["valid"]
    if kernel == "arrival":
        _assert_close(got, {k: want[k] for k in ("arr_w", "arr_la",
                                                 "contrib")})
        arr = gather_stdp(s)["arr"]
        assert np.array_equal(got["n_arrived"].numpy(), arr.sum(1))
        assert not got["ring"][:, R_SLOT].any()
        keep = np.arange(3) != R_SLOT
        assert np.array_equal(got["ring"][:, keep].numpy(),
                              s["ring"][:, keep])
        assert 0 < arr.sum() < s["valid"].sum()
        w, la = got["arr_w"].numpy(), got["arr_la"].numpy()
    else:
        _assert_close(got, {"ltp_w": want["ltp_w"]})
        assert np.array_equal(got["ltp_lp"].numpy(), np.where(
            s["spiked"], np.float32(T_STEP), s["last_post"]))
        w, la = got["ltp_w"].numpy(), s["last_arr"]
    assert np.array_equal(w[pads], s["w"][pads])
    assert np.array_equal(la[pads], s["last_arr"][pads])
    assert (got["contrib"].numpy()[pads] == 0).all()
    assert bool((w != s["w"]).any())


if __name__ == "__main__":
    assert sys.argv[1] == "--out"
    _jax_outputs(sys.argv[2])
