"""Phase A as one op (`ops.stdp_phase_a`) on the CPU, bit for bit.

The op pops ring slot r (LTD, last-arrival refresh, each target's in-order
current), adds the step's stimulus, updates the Izhikevich neurons, masks
the spikes by `neuron_valid` and, with `with_ltp`, applies LTP to the
targets that spiked.  On the card it is one kernel
(`csrc/stdp.cu::row_kernel<true>`); on the CPU its plain version
`ref.stdp_phase_a`.  These tests hold, at 0 ulp in every output and
updated state tensor (v, u, spiked, the counts, w, last_arr, last_post,
the ring):

* the plain version against the sequence of plain ops the engine ran
  before (`stdp_arrival_current`, `stim_current`, the add, a, b, c, d
  picked by `torch.where` from eight constants, `izhikevich_update`,
  `& neuron_valid`, the spike sum, `stdp_ltp`), with and without LTP, on
  the 2x2 and 4x4 plans' own arrays at ring densities 0, 2.15%, 21.5% and
  100% and spike shares from none to all;
* the same on hand-made rows: a target that spikes in the step its row had
  arrivals, empty rows, rows over 256 synapses, padded neurons, duplicate
  stimulus entries, targets that never spiked (`last_post == NEG_TIME`);
* the engine's phase A (and the split `phase_a_dynamics`, then
  `phase_a_plasticity`) against the JAX package's `phase_a_dynamics` then
  `phase_a_plasticity`, in a subprocess under
  `XLA_FLAGS=--xla_cpu_max_isa=AVX`;
* that the CPU path builds its a, b, c and d once per window, not per
  step.

`tests/test_torch_cuda.py` holds the kernel against the plain version on
the card, on the same hand-made rows.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (DEFAULT_IZH, DEFAULT_STDP, EngineConfig,
                              GridConfig, StepProgram, convert, engine,
                              stimulus)
from repro_torch.core.engine import NEG_TIME, ShardState
from repro_torch.kernels import ops, ref

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_reference import run_avx  # noqa: E402

T_STEP = 300
GRIDS = {"2x2": (dict(grid_x=2, grid_y=2, neurons_per_column=100,
                      synapses_per_neuron=40, seed=7),
                 dict(n_shards=2, placement="block")),
         "4x4": (dict(grid_x=4, grid_y=4, neurons_per_column=100,
                      synapses_per_neuron=40, seed=11),
                 dict(n_shards=4, placement="scatter"))}
DENSITIES = {"none": 0.0, "main": 0.0215, "10x": 0.215, "all": 1.0}
SHARES = {"none": 0.0, "main": 0.0215, "10x": 0.215, "all": 1.0}
STATE_KEYS = ("v", "u", "last_post", "w", "last_arr", "ring")
_programs = {}


def program(grid: str) -> StepProgram:
    if grid not in _programs:
        cfg, eng = GRIDS[grid]
        _programs[grid] = StepProgram(GridConfig(**cfg), EngineConfig(**eng),
                                      device="cpu")
    return _programs[grid]


def make_state(valid: np.ndarray, n_local: int, D: int, density: float,
               share: float, seed: int) -> dict:
    """numpy dynamic state on a plan's [H, E] `valid`: ring slot
    T_STEP mod D flagged on `density` of the valid synapses (never a pad,
    as phase B flags them), the other slots at random; about `share` of
    the neurons at or past the threshold (so they spike), the others at
    rest; weights negative, -0.0, at w_min and w_max, and between; last
    spike and arrival times recent, far past, or never."""
    rng = np.random.default_rng(seed)
    H, E = valid.shape
    N = n_local
    ring = (rng.random((H, D, E)) < 0.3) & valid[:, None]
    ring[:, T_STEP % D] = (rng.random((H, E)) < density) & valid
    w = rng.uniform(-4.0, 10.0, (H, E))
    w = np.where(rng.random((H, E)) < 0.2, rng.choice(
        [-0.0, 0.0, 10.0, -2.5, 0.05], (H, E)), w).astype(np.float32)
    v = np.where(rng.random((H, N)) < share, rng.uniform(30.0, 40.0, (H, N)),
                 rng.uniform(-80.0, -60.0, (H, N))).astype(np.float32)

    def times(shape):
        kind = rng.random(shape)
        return np.where(kind < 0.5, rng.uniform(T_STEP - 100, T_STEP, shape),
                        np.where(kind < 0.8, rng.uniform(-3000, 0, shape),
                                 NEG_TIME)).astype(np.float32)
    return dict(v=v, u=rng.uniform(-20.0, 10.0, (H, N)).astype(np.float32),
                last_post=times((H, N)), w=w, last_arr=times((H, E)),
                ring=ring)


def as_state(s: dict) -> ShardState:
    t = {k: torch.from_numpy(np.array(v)) for k, v in s.items()}
    return ShardState(v=t["v"], u=t["u"], last_post=t["last_post"], w=t["w"],
                      last_arr=t["last_arr"], arr_ring=t["ring"])


def stim_row(sp: StepProgram, t: int):
    """The step's (index, amp) row, as `engine.make_step_fn` makes it."""
    spec, plan = sp.spec, sp.plan
    gids = torch.from_numpy(stimulus.stim_table(
        spec.cfg, plan.columns.numpy(), t, 1)).to(torch.int64)
    idx, amp = stimulus.stim_inputs(spec.cfg, plan.columns,
                                    engine.make_gid_to_local(
                                        spec, plan.shard_id), gids,
                                    spec.n_local)
    return idx[0], amp[0]


# -- the op and the sequence it replaced ------------------------------------


def run_op(d: dict, with_ltp: bool, *, coeffs=None) -> dict:
    """`ops.stdp_phase_a` on `d` (torch tensors, updated in place): its
    outputs and the state."""
    seg = ref.make_segments(d["row_ptr"], d["w"].shape[1])
    spiked, n_arr, n_spk = ops.stdp_phase_a(
        d["ring"], d["r"], seg, d["valid"], d["tgt"], d["plastic"], d["exc"],
        d["neuron_valid"], d["stim_idx"], d["stim_amp"], d["v"], d["u"],
        d["last_post"], d["w"], d["last_arr"], d["t"], izh=DEFAULT_IZH,
        stdp=DEFAULT_STDP, neg_time=NEG_TIME, with_ltp=with_ltp,
        coeffs=coeffs)
    return dict(spiked=spiked, n_arrived=n_arr, n_spikes=n_spk,
                **{k: d[k] for k in STATE_KEYS})


def run_sequence(d: dict, with_ltp: bool) -> dict:
    """What the engine ran for phase A before the op: the plain versions
    of the three kernels and the ops between them, in turn."""
    izh, stdp = DEFAULT_IZH, DEFAULT_STDP
    N = d["v"].shape[1]
    seg = ref.make_segments(d["row_ptr"], d["w"].shape[1])
    c = lambda x: ref.f32(x, "cpu")
    with ref.flush_denormal():
        i_syn, n_arr = ref.stdp_arrival_current(
            d["ring"], d["r"], seg, d["valid"], d["tgt"], d["plastic"],
            d["last_post"], d["w"], d["last_arr"], d["t"],
            a_minus=stdp.a_minus, tau_minus=stdp.tau_minus, w_min=stdp.w_min,
            w_max=stdp.w_max, neg_time=NEG_TIME)
        i_ext = torch.zeros(d["stim_idx"].shape[0], N).scatter_add_(
            1, d["stim_idx"], d["stim_amp"])
        i_tot = i_syn + i_ext
        ex = d["exc"]
        a = torch.where(ex, c(izh.a_exc), c(izh.a_inh))
        b = torch.where(ex, c(izh.b_exc), c(izh.b_inh))
        cc = torch.where(ex, c(izh.c_exc), c(izh.c_inh))
        dd = torch.where(ex, c(izh.d_exc), c(izh.d_inh))
        v, u, spiked = ref.izhikevich_update(
            d["v"], d["u"], i_tot, a, b, cc, dd, v_peak=izh.v_peak,
            dt=izh.dt, substeps=izh.v_substeps)
        spiked = spiked & d["neuron_valid"]
        if with_ltp:
            ref.stdp_ltp(spiked, d["row_ptr"], d["plastic"], d["last_arr"],
                         d["w"], d["last_post"], d["t"], a_plus=stdp.a_plus,
                         tau_plus=stdp.tau_plus, w_min=stdp.w_min,
                         w_max=stdp.w_max, neg_time=NEG_TIME)
    d["v"].copy_(v)
    d["u"].copy_(u)
    return dict(spiked=spiked, n_arrived=n_arr, n_spikes=spiked.sum(1),
                **{k: d[k] for k in STATE_KEYS})


def assert_bits(got: torch.Tensor, want: torch.Tensor, what: str = ""):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    n_diff = int((got != want).sum())
    assert n_diff == 0, f"{what}: {n_diff} of {got.numel()} differ"


def assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert_bits(got[k], want[k], k)


def copy(d: dict) -> dict:
    return {k: v.clone() if torch.is_tensor(v) else v for k, v in d.items()}


def plan_inputs(grid: str, density: str, share: str) -> dict:
    sp = program(grid)
    plan, spec = sp.plan, sp.spec
    s = make_state(plan.syn_valid.numpy(), spec.n_local,
                   spec.cfg.n_delay_slots, DENSITIES[density], SHARES[share],
                   seed=len(grid) * 100 + len(density) * 10 + len(share))
    st = as_state(s)
    idx, amp = stim_row(sp, T_STEP)
    return dict(ring=st.arr_ring, r=T_STEP % spec.cfg.n_delay_slots,
                valid=plan.syn_valid, tgt=plan.syn_tgt,
                plastic=plan.syn_plastic, row_ptr=plan.row_ptr,
                exc=plan.exc_mask, neuron_valid=plan.neuron_valid,
                stim_idx=idx, stim_amp=amp, v=st.v, u=st.u,
                last_post=st.last_post, w=st.w, last_arr=st.last_arr,
                t=T_STEP)


@pytest.mark.parametrize("with_ltp", [True, False], ids=["ltp", "no_ltp"])
@pytest.mark.parametrize("share", list(SHARES))
@pytest.mark.parametrize("density", list(DENSITIES))
@pytest.mark.parametrize("grid", list(GRIDS))
def test_plain_version_equals_the_sequence(grid, density, share, with_ltp):
    d = plan_inputs(grid, density, share)
    ops.reset_launch_counts()
    got = run_op(copy(d), with_ltp)
    want = run_sequence(copy(d), with_ltp)
    assert_same(got, want)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    # slot r popped; spikes only of valid neurons; v, u and, with LTP,
    # last_post moved where they should
    assert not got["ring"][:, d["r"]].any()
    assert not bool((got["spiked"] & ~d["neuron_valid"]).any())
    assert torch.equal(got["n_arrived"],
                       (d["ring"][:, d["r"]] & d["valid"]).sum(1))
    spiked = got["spiked"]
    lp_moved = got["last_post"] != d["last_post"]
    assert torch.equal(lp_moved, spiked if with_ltp else
                       torch.zeros_like(spiked))
    if share == "all":
        assert bool(spiked[d["neuron_valid"]].all())
    if share == "none" and density == "none":
        assert not spiked.any()


# -- hand-made rows ---------------------------------------------------------

EDGE_CASES = ("spike_after_arrival", "empty_rows", "long_rows",
              "padded_neurons", "duplicate_stimulus", "never_spiked")


def edge_inputs(case: str, seed: int = 0) -> dict:
    """Two shards of 40 neurons with rows of chosen lengths (valid synapses
    first, sorted by target, pads after; E % 8 == 0), ring slot 1 of 3
    flagged on half the valid synapses, and one feature pushed to its
    edge by `case`:

    * spike_after_arrival: every neuron spikes, and every synapse of its
      row arrived (LTP runs on LTD'd weights with last_arr == t);
    * empty_rows: a third of the rows are empty, some of them spiking;
    * long_rows: rows of 257, 300 and 700 synapses (past one 256-synapse
      round of the kernel), spiking;
    * padded_neurons: the last 10 neurons of each shard are padding, at
      the threshold (their v and u update, they never spike);
    * duplicate_stimulus: 32 stimulus entries a shard on 4 neurons;
    * never_spiked: last_post == NEG_TIME everywhere (no LTD)."""
    rng = np.random.default_rng(seed)
    H, N, D, r, t = 2, 40, 3, 1, 250
    lengths = rng.integers(0, 60, (H, N))
    if case == "empty_rows":
        lengths[:, ::3] = 0
    if case == "long_rows":
        lengths[:, [3, 17, 30]] = [257, 300, 700]
    E = int(lengths.sum(1).max()) + 19
    E += -E % 8
    tgt = np.zeros((H, E), np.int64)
    valid = np.zeros((H, E), bool)
    row_ptr = np.zeros((H, N + 1), np.int32)
    for h in range(H):
        n_valid = int(lengths[h].sum())
        tgt[h, :n_valid] = np.repeat(np.arange(N), lengths[h])
        valid[h, :n_valid] = True
        row_ptr[h, 1:] = np.cumsum(lengths[h])
    ring = (rng.random((H, D, E)) < 0.3) & valid[:, None]
    ring[:, r] = (rng.random((H, E)) < 0.5) & valid
    share = 0.3
    if case == "spike_after_arrival":
        ring[:, r] = valid
        share = 1.0
    if case in ("empty_rows", "long_rows"):
        share = 0.6
    v = np.where(rng.random((H, N)) < share, rng.uniform(30.0, 40.0, (H, N)),
                 rng.uniform(-80.0, -60.0, (H, N)))
    neuron_valid = np.ones((H, N), bool)
    if case == "padded_neurons":
        neuron_valid[:, -10:] = False
        v[:, -10:] = 35.0
    last_post = np.where(rng.random((H, N)) < 0.7,
                         rng.uniform(t - 60, t, (H, N)), NEG_TIME)
    if case == "never_spiked":
        last_post[:] = NEG_TIME
    stim_idx = rng.integers(0, N, (H, 16))
    if case == "duplicate_stimulus":
        stim_idx = rng.choice([2, 5, 11, 39], (H, 32))
    stim_amp = np.where(rng.random(stim_idx.shape) < 0.85, 20.0, 0.0)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    i = lambda x: torch.from_numpy(np.asarray(x))
    return dict(
        ring=i(ring), r=r, valid=i(valid), tgt=i(tgt),
        plastic=i(rng.random((H, E)) < 0.8), row_ptr=i(row_ptr),
        exc=i(np.arange(N)[None].repeat(H, 0) % 5 != 4),
        neuron_valid=i(neuron_valid), stim_idx=i(stim_idx.astype(np.int64)),
        stim_amp=f(stim_amp), v=f(v), u=f(rng.uniform(-20.0, 10.0, (H, N))),
        last_post=f(last_post), w=f(rng.uniform(0.0, 10.0, (H, E))),
        last_arr=f(np.where(rng.random((H, E)) < 0.7,
                            rng.uniform(t - 60, t, (H, E)), NEG_TIME)),
        t=t)


def check_edge(case: str, d: dict, got: dict, with_ltp: bool) -> None:
    """What each hand-made case must show in the op's result."""
    spiked = got["spiked"]
    if case == "spike_after_arrival":
        # every arrived plastic synapse of a spiking target: LTP of exp(0)
        # on the LTD'd weight, last_arr == t
        row = ref.rows_of_synapses(d["row_ptr"], d["w"].shape[1])
        N = d["v"].shape[1]
        post = torch.cat([spiked, spiked.new_zeros(spiked.shape[0], 1)],
                         1).gather(1, row)
        hit = d["valid"] & d["plastic"] & post
        assert bool(hit.any())
        assert bool((got["last_arr"][d["valid"] & (row < N)] == d["t"]).all())
        if with_ltp:
            assert bool((got["w"][hit] >= DEFAULT_STDP.a_plus).all())
    if case == "empty_rows":
        empty = d["row_ptr"][:, 1:] == d["row_ptr"][:, :-1]
        assert bool((spiked & empty).any())
    if case == "long_rows":
        assert bool(spiked[:, [3, 17, 30]].all())
    if case == "padded_neurons":
        assert not spiked[:, -10:].any()
        assert not bool((got["v"][:, -10:] == d["v"][:, -10:]).any())
    if case == "duplicate_stimulus":
        counts = torch.zeros_like(d["v"]).scatter_add_(
            1, d["stim_idx"], (d["stim_amp"] > 0).float())
        assert float(counts.max()) >= 3
    if case == "never_spiked":
        assert bool((got["last_post"][~spiked] == NEG_TIME).all())


@pytest.mark.parametrize("with_ltp", [True, False], ids=["ltp", "no_ltp"])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_edge_rows(case, with_ltp):
    d = edge_inputs(case)
    got = run_op(copy(d), with_ltp)
    assert_same(got, run_sequence(copy(d), with_ltp))
    check_edge(case, d, got, with_ltp)


# -- the engine: once-per-window constants, and JAX -------------------------


def test_cpu_steps_build_no_per_step_constants(monkeypatch):
    """`make_step_fn` picks a, b, c and d once; its steps pass them to the
    op and build none, and the op gives the same bits as when it builds
    them itself."""
    sp = program("2x2")
    built = []
    real = ref.izh_coefficients
    monkeypatch.setattr(ref, "izh_coefficients",
                        lambda *a: built.append(1) or real(*a))
    fns = engine.make_step_fn(sp.spec, sp.plan, 0, 5)
    assert len(built) == 1
    state = engine.clone_state(sp.init_state())
    with ref.flush_denormal():
        for t in range(5):
            state, _, _ = fns.step(state, t)
    assert len(built) == 1
    d = plan_inputs("2x2", "main", "main")
    coeffs = real(d["exc"], DEFAULT_IZH)
    assert_same(run_op(copy(d), True, coeffs=coeffs), run_op(copy(d), True))
    assert len(built) == 2          # the second call built its own


# each a ring density and the same spike share
JAX_CASES = ("none", "main", "10x", "all")


def _jax_phase_a(grid: str, out: str) -> None:
    """Inside the AVX subprocess: the JAX plan of `grid`, states at each
    of JAX_CASES, and `repro.core.engine.phase_a_dynamics` then
    `phase_a_plasticity` on each at step T_STEP (vmapped over shards)."""
    import jax
    import jax.numpy as jnp
    from repro.core import EngineConfig as JE, GridConfig as JG, StepProgram
    from repro.core import engine as jeng, stimulus as jstim
    cfg, eng = GRIDS[grid]
    sp = StepProgram(JG(**cfg), JE(**eng))
    spec, plan = sp.spec, sp.plan
    stim_k = jstim.stim_key(spec.cfg)
    t = jnp.int32(T_STEP)

    def one(p, s):
        s, spiked, tm = jeng.phase_a_dynamics(spec, p, s, t, stim_k)
        s = jeng.phase_a_plasticity(spec, p, s, spiked, t)
        return s, spiked, tm
    step = jax.jit(jax.vmap(one))
    res = {f"plan.{k}": np.asarray(v) for k, v in plan._asdict().items()}
    valid = np.asarray(plan.syn_valid)
    for name in JAX_CASES:
        s = make_state(valid, spec.n_local, spec.cfg.n_delay_slots,
                       DENSITIES[name], SHARES[name],
                       seed=1000 + len(grid) + len(name))
        state = sp.init_state()._replace(
            v=s["v"], u=s["u"], last_post=s["last_post"], w=s["w"],
            last_arr=s["last_arr"], arr_ring=s["ring"])
        new, spiked, tm = step(plan, state)
        res.update({f"{name}.in.{k}": v for k, v in s.items()})
        res.update({f"{name}.out.{k}": np.asarray(getattr(new, k))
                    for k in ("v", "u", "last_post", "w", "last_arr",
                              "arr_ring")})
        res[f"{name}.out.spiked"] = np.asarray(spiked)
        res[f"{name}.out.spikes"] = np.asarray(tm.spikes)
        res[f"{name}.out.arrivals"] = np.asarray(tm.arrivals)
    np.savez(out, **res)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("avx_phase_a")
    outs = {g: tmp / f"{g}.npz" for g in GRIDS}
    run_avx(__file__, [["--grid", g, "--out", p] for g, p in outs.items()])
    return {g: dict(np.load(p)) for g, p in outs.items()}


@pytest.mark.parametrize("split", [False, True], ids=["phase_a", "split"])
@pytest.mark.parametrize("case", JAX_CASES)
@pytest.mark.parametrize("grid", list(GRIDS))
def test_engine_phase_a_equals_jax(jax_ref, grid, case, split):
    z = jax_ref[grid]
    fields = lambda prefix: type("Fields", (), {
        k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)})
    inputs = {k[len(f"{case}.in."):]: v for k, v in z.items()
              if k.startswith(f"{case}.in.")}
    plan, state = convert.from_jax(fields("plan."), as_state(inputs), "cpu")
    sp = StepProgram.from_parts(program(grid).spec, plan)
    fns = engine.make_step_fn(sp.spec, plan, T_STEP, 1)
    with ref.flush_denormal():
        if split:
            seg = ref.make_segments(plan.row_ptr, plan.syn_valid.shape[1])
            stim = stim_row(sp, T_STEP)
            state, spiked, tm = engine.phase_a_dynamics(
                sp.spec, plan, state, T_STEP, stim, seg)
            state = engine.phase_a_plasticity(sp.spec, plan, state, spiked,
                                              T_STEP)
        else:
            state, spiked, tm = fns.phase_a(state, T_STEP)
    want = lambda k: torch.from_numpy(z[f"{case}.out.{k}"])
    for k in ("v", "u", "last_post", "w", "last_arr", "arr_ring"):
        assert_bits(getattr(state, k), want(k), k)
    assert_bits(spiked, want("spiked"), "spiked")
    assert torch.equal(tm.spikes, want("spikes").to(torch.int64))
    assert torch.equal(tm.arrivals, want("arrivals").to(torch.int64))
    if case != "none":
        assert int(tm.spikes.sum()) > 0


if __name__ == "__main__":
    assert sys.argv[1] == "--grid" and sys.argv[3] == "--out"
    _jax_phase_a(sys.argv[2], sys.argv[4])
