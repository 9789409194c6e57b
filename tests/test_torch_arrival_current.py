"""The fused arrival op `ops.stdp_arrival_current` on the CPU, bit for bit.

The op pops ring slot r, applies LTD and refreshes `last_arr` on the
synapses that arrive, and returns each target's in-order sum of their
pre-LTD weights (`i_syn`) with the arrivals per shard.  Its CUDA kernel
(`csrc/stdp.cu::arrival_current_kernel`) owns target rows and adds only
the weights that arrived; the plain version adds the whole row, +0.0
where nothing arrived.  These tests hold, at 0 ulp in every output
(`i_syn`, `n_arrived`, `w`, `last_arr`, the cleared slot):

* the plain version against the pair it replaces on the main path
  (`ref.stdp_arrival` then `ref.segment_sum_ordered`), on the plans of a
  4x4 grid in three layouts at 0%, 2.15%, 21.5% and 100% density;
* the plain version against the JAX package (its `ops.stdp_arrival`, then
  `jax.ops.segment_sum(..., indices_are_sorted=True)`, as
  `repro.core.engine.phase_a_dynamics` runs them) in a subprocess under
  `XLA_FLAGS=--xla_cpu_max_isa=AVX`;
* a plain-torch model of the kernel's order (per row, only the flagged
  synapses' pre-LTD weights, ascending from +0.0) against the plain
  version: skipping the +0.0 terms keeps the bits;
* the invariant the kernel relies on: phase B never flags a pad;
* `_build.require_aligned`, which the CUDA wrappers call.

The kernel itself needs the card: `tests/test_torch_cuda.py` and
`chip_smoke.py` hold it against the plain version there.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import EngineConfig, GridConfig, engine
from repro_torch.kernels import _build, ops, ref

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_reference import run_avx  # noqa: E402

LTD_KW = dict(a_minus=0.12, tau_minus=20.0, w_min=0.0, w_max=10.0,
              neg_time=-1.0e9)
T_STEP = 300.0
D_SLOTS = 3
R_SLOT = 1
# 4x4 grid at a narrow width (1,600 neurons, 40 synapses each)
GRID = dict(grid_x=4, grid_y=4, neurons_per_column=100,
            synapses_per_neuron=40, seed=11)
LAYOUTS = {"h1_block": (1, "block"), "h4_block": (4, "block"),
           "h4_scatter": (4, "scatter")}
DENSITIES = {"none": 0.0, "main": 0.0215, "10x": 0.215, "all": 1.0}
_plans = {}


def plan_of(layout: str):
    if layout not in _plans:
        n_shards, placement = LAYOUTS[layout]
        _plans[layout] = engine.build(
            GridConfig(**GRID), EngineConfig(n_shards=n_shards,
                                             placement=placement),
            device="cpu")[1]
    return _plans[layout]


def make_state(plan, density: float, seed: int) -> dict:
    """numpy inputs on a plan: ring slot R_SLOT flagged on `density` of the
    valid synapses (as phase B flags them: never a pad) and the other
    slots at random; weights negative (inhibitory), -0.0, at w_min and
    w_max, and between; last spike and arrival times recent, far past or
    never."""
    rng = np.random.default_rng(seed)
    valid = plan.syn_valid.numpy()
    H, E = valid.shape
    N = plan.gid.shape[1]
    ring = (rng.random((H, D_SLOTS, E)) < 0.3) & valid[:, None]
    ring[:, R_SLOT] = (rng.random((H, E)) < density) & valid
    w = rng.uniform(-4.0, 10.0, (H, E))
    w = np.where(rng.random((H, E)) < 0.2, rng.choice(
        [-0.0, 0.0, 10.0, -2.5, 0.05], (H, E)), w).astype(np.float32)

    def times(shape):
        kind = rng.random(shape)
        return np.where(kind < 0.5, rng.uniform(T_STEP - 100, T_STEP, shape),
                        np.where(kind < 0.8, rng.uniform(-3000, 0, shape),
                                 -1.0e9)).astype(np.float32)
    return dict(ring=ring, w=w, last_post=times((H, N)),
                last_arr=times((H, E)))


def torch_state(s: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in s.items()}


def run_op(fn, plan, s: dict, seg) -> dict:
    """`fn` (the op or the plain version) on torch copies of `s`: its
    outputs and the state it updated."""
    g = torch_state(s)
    with ref.flush_denormal():
        i_syn, n_arr = fn(g["ring"], R_SLOT, seg, plan.syn_valid,
                          plan.syn_tgt, plan.syn_plastic, g["last_post"],
                          g["w"], g["last_arr"], T_STEP, **LTD_KW)
    return dict(i_syn=i_syn, n_arrived=n_arr, w=g["w"],
                last_arr=g["last_arr"], ring=g["ring"])


def run_pair(plan, s: dict, seg) -> dict:
    """The pair the op replaces: `ref.stdp_arrival`, then
    `ref.segment_sum_ordered` of its contributions."""
    g = torch_state(s)
    with ref.flush_denormal():
        contrib, n_arr = ref.stdp_arrival(
            g["ring"], R_SLOT, plan.syn_valid, plan.syn_tgt,
            plan.syn_plastic, g["last_post"], g["w"], g["last_arr"], T_STEP,
            **LTD_KW)
        i_syn = ref.segment_sum_ordered(contrib, seg)
    return dict(i_syn=i_syn, n_arrived=n_arr, w=g["w"],
                last_arr=g["last_arr"], ring=g["ring"])


def kernel_order_model(plan, s: dict) -> torch.Tensor:
    """The kernel's sum, in plain torch: for each target row, the
    pre-LTD weights of its flagged synapses only, added in ascending
    synapse order from +0.0, one rounding per add."""
    row_ptr = plan.row_ptr
    H, N = row_ptr.shape[0], row_ptr.shape[1] - 1
    w = torch.from_numpy(s["w"])
    flags = torch.from_numpy(s["ring"][:, R_SLOT])
    row = ref.rows_of_synapses(row_ptr, w.shape[1])
    out = torch.zeros((H, N), dtype=torch.float32)
    with ref.flush_denormal():
        for h in range(H):
            e = torch.nonzero(flags[h] & (row[h] < N)).reshape(-1)
            rows = row[h, e]                       # ascending, like e
            rank = torch.arange(e.numel()) - torch.searchsorted(rows, rows)
            for k in range(int(rank.max()) + 1 if e.numel() else 0):
                at = rank == k                     # one synapse a row
                out[h, rows[at]] = out[h, rows[at]] + w[h, e[at]]
    return out


def assert_bits(got: torch.Tensor, want: torch.Tensor, what: str = ""):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    n_diff = int((got != want).sum())
    assert n_diff == 0, f"{what}: {n_diff} of {got.numel()} differ"


def assert_same(got: dict, want: dict):
    for k in want:
        assert_bits(got[k], want[k], k)


@pytest.mark.parametrize("density", list(DENSITIES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plain_version_equals_the_pair(layout, density):
    plan = plan_of(layout)
    s = make_state(plan, DENSITIES[density], seed=len(layout) + len(density))
    seg = ref.make_segments(plan.row_ptr, plan.syn_valid.shape[1])
    ops.reset_launch_counts()
    got = run_op(ops.stdp_arrival_current, plan, s, seg)
    want = run_pair(plan, s, seg)
    assert_same(got, want)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    # slot R_SLOT popped, the others untouched
    assert not got["ring"][:, R_SLOT].any()
    keep = np.arange(D_SLOTS) != R_SLOT
    assert np.array_equal(got["ring"][:, keep].numpy(), s["ring"][:, keep])
    arrived = s["ring"][:, R_SLOT]
    assert np.array_equal(got["n_arrived"].numpy(), arrived.sum(1))
    row = ref.rows_of_synapses(plan.row_ptr, arrived.shape[1]).numpy()
    N = plan.gid.shape[1]
    hit = np.zeros((row.shape[0], N + 1), bool)
    np.put_along_axis(hit, np.where(arrived, row, N), True, axis=1)
    empty = ~hit[:, :N]
    # a row with no arrival sums to +0.0 (not -0.0)
    assert (got["i_syn"].numpy()[empty].view(np.uint32) == 0).all()
    if density == "main":
        assert empty.any() and (~empty).any()
        assert (got["i_syn"].numpy() < 0).any()      # inhibitory currents
    if density == "all":
        assert not empty[plan.neuron_valid.numpy() & (np.diff(
            plan.row_ptr.numpy(), axis=1) > 0)].any()


@pytest.mark.parametrize("density", list(DENSITIES))
def test_kernel_order_keeps_the_bits(density):
    """Adding only the arrived weights, as the kernel does, gives the plain
    version's sums bit for bit: the +0.0 terms it skips change nothing."""
    plan = plan_of("h4_scatter")
    s = make_state(plan, DENSITIES[density], seed=7 + len(density))
    # -0.0 and +0.0 weights among the arrivals
    arrived = s["ring"][:, R_SLOT]
    s["w"][arrived & (np.arange(arrived.shape[1]) % 7 == 0)] = -0.0
    seg = ref.make_segments(plan.row_ptr, plan.syn_valid.shape[1])
    want = run_op(ref.stdp_arrival_current, plan, s, seg)
    assert_bits(kernel_order_model(plan, s), want["i_syn"], "i_syn")


def test_phase_b_never_flags_a_pad():
    """The kernel reads and clears flags inside rows only, so it relies on
    phase B flagging no pad: every shard here has pads, and after each of
    40 steps of the CPU engine no ring slot holds a pad's flag."""
    sp_plan = plan_of("h4_scatter")
    spec, plan, state = engine.build(
        GridConfig(**GRID), EngineConfig(n_shards=4, placement="scatter"),
        device="cpu")
    assert torch.equal(plan.row_ptr, sp_plan.row_ptr)
    pads = ~plan.syn_valid
    assert bool(pads.any(1).all())
    fns = engine.make_step_fn(spec, plan, 0, 40)
    flagged = 0
    with ref.flush_denormal():
        for t in range(40):
            state, _, _ = fns.step(state, t)
            assert not bool((state.arr_ring & pads[:, None]).any())
            flagged += int(state.arr_ring.sum())
    assert flagged > 0


# -- against the JAX package, AVX-pinned ---------------------------------------


def _jax_outputs(inp: str, out: str) -> None:
    """Inside the AVX subprocess: `repro.core.engine.phase_a_dynamics`'
    arrival and current lines, per shard (vmapped), on the inputs of
    `inp`; the outputs go to `out`."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    z = dict(np.load(inp))
    n_local = z["none_last_post"].shape[1]

    def shard(ring_r, valid, tgt, plastic, last_post, w, last_arr):
        arrivals = ring_r & valid
        lp = last_post[tgt]
        w2, la2, contrib = jops.stdp_arrival(
            arrivals, w, lp, last_arr, plastic, jnp.float32(T_STEP),
            **LTD_KW)
        i_syn = jax.ops.segment_sum(contrib, tgt, num_segments=n_local,
                                    indices_are_sorted=True)
        return i_syn, arrivals.sum(), w2, la2

    res = {}
    for density in DENSITIES:
        got = jax.jit(jax.vmap(shard))(
            z[f"{density}_ring_r"], z["valid"], z["tgt"].astype(np.int32),
            z["plastic"], z[f"{density}_last_post"], z[f"{density}_w"],
            z[f"{density}_last_arr"])
        for k, v in zip(("i_syn", "n_arrived", "w", "last_arr"), got):
            res[f"{density}_{k}"] = np.asarray(v)
    np.savez(out, **res)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The 4x4 H=4 scatter plan's states at every density, and the AVX
    JAX outputs on them."""
    plan = plan_of("h4_scatter")
    states = {d: make_state(plan, p, seed=100 + i)
              for i, (d, p) in enumerate(DENSITIES.items())}
    inp = {"valid": plan.syn_valid.numpy(), "tgt": plan.syn_tgt.numpy(),
           "plastic": plan.syn_plastic.numpy()}
    for d, s in states.items():
        inp.update({f"{d}_ring_r": s["ring"][:, R_SLOT],
                    **{f"{d}_{k}": s[k] for k in ("last_post", "w",
                                                  "last_arr")}})
    tmp = tmp_path_factory.mktemp("avx_arrival")
    np.savez(tmp / "in.npz", **inp)
    run_avx(__file__, [["--in", tmp / "in.npz", "--out", tmp / "out.npz"]])
    return plan, states, dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("density", list(DENSITIES))
def test_plain_version_equals_jax(jax_ref, density):
    plan, states, want = jax_ref
    seg = ref.make_segments(plan.row_ptr, plan.syn_valid.shape[1])
    got = run_op(ops.stdp_arrival_current, plan, states[density], seg)
    for k in ("i_syn", "n_arrived", "w", "last_arr"):
        w_ = torch.from_numpy(want[f"{density}_{k}"])
        assert_bits(got[k], w_.to(got[k].dtype) if k == "n_arrived" else w_,
                    k)
    assert not got["ring"][:, R_SLOT].any()
    if density != "none":
        assert bool((got["w"].numpy() != states[density]["w"]).any())


# -- the alignment helper --------------------------------------------------------


@pytest.mark.parametrize("offset", [0, 1, 4, 8])
def test_require_aligned(offset):
    """Views at an element offset: fp32 on 16 bytes (offsets 0, 4 and 8
    elements are 0, 16 and 32 bytes), bool on 8 bytes (0 and 8)."""
    f = torch.zeros(64, dtype=torch.float32)[offset:offset + 16]
    b = torch.zeros(64, dtype=torch.bool)[offset:offset + 16]
    assert f.is_contiguous() and b.is_contiguous()
    for x, nbytes, ok in ((f, 16, offset % 4 == 0), (b, 8, offset % 8 == 0),
                          (f, 4, True), (b, 1, True)):
        if ok:
            _build.require_aligned("op", nbytes, x=x)
        else:
            with pytest.raises(ValueError, match=f"multiple of {nbytes}"):
                _build.require_aligned("op", nbytes, x=x)
    with pytest.raises(ValueError, match="op: late "):
        _build.require_aligned("op", 8, early=b[8 - offset % 8:],
                               late=b[1:])


if __name__ == "__main__":
    assert sys.argv[1] == "--in" and sys.argv[3] == "--out"
    _jax_outputs(sys.argv[2], sys.argv[4])
