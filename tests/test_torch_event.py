"""The port's event delivery (`repro_torch.core.event_engine`) against the
JAX package's event backend, bit for bit.

The JAX side runs jitted under `XLA_FLAGS=--xla_cpu_max_isa=AVX` (no FMA
contraction) in subprocesses started with the module; the port runs its
plain PyTorch versions on the CPU (what the card's kernels are held
against).  At 2x2, 100 neurons a column, M = 40, seed 7 unless a case
says otherwise:

* the event plan (`fwd_rows`, `in_rows`, `cap_ev`) at H=1, H=2 block and
  H=4 scatter, and `in_rows` equal to the plan's CSR rows (`row_ptr`);
* each op's plain version against the JAX lines it ports, on numpy-seeded
  states of the H=1 plan: the arrivals (the whole of phase A's first half,
  and the current alone against XLA-CPU's scatter-add), LTP (with and
  without an overflowing c_post), emission (t = -1, a wrapping t, an
  overflowing ring and c_src);
* `kernels.ref.event_arrival` and `kernels.ref.event_emit` on LONG (1x1,
  300 neurons, M = 200: in-degree up to ~250, the long buckets the card
  kernels are held on): 60% and every valid synapse listed, -1 holes
  inside the list, and rings that fill past cap between listed rows, also
  at t = -1;
* 120-step runs at H=1 block, H=4 block and H=4 scatter: raster, weight
  signature, v, u, ev_ring, ev_count and sat;
* each saturation path of `tests/test_event_engine.py` (cap_ev = 8,
  c_post = 2, c_src = 2 at 1x1, seed 3, 80 steps): the same sat and state;
* a JAX event state at t = 50 carried across by `convert.event_from_jax`
  and run on to t = 100;
* `core.neuron` against `repro.core.neuron`;
* the `event_vs_dense` suite's single-device rows against the JAX suite's.

Within the port: no sort op in an event step, the phase handles (sync and
pipelined, every exchange) give the run's raster, event and dense
deliveries give equal rasters and weights within 1e-4, and the launcher
runs `--delivery event`.
"""
import hashlib
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import (EngineConfig, GridConfig, StepProgram, aer,
                              convert, engine, event_engine, neuron,
                              observables)
from repro_torch.core.params import DEFAULT_IZH
from repro_torch.kernels import ops, ref

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_reference import start_avx, wait_avx  # noqa: E402

SMALL = dict(grid_x=2, grid_y=2, neurons_per_column=100,
             synapses_per_neuron=40, seed=7)
SAT_CFG = dict(grid_x=1, grid_y=1, neurons_per_column=100,
               synapses_per_neuron=40, seed=3)
LONG = dict(grid_x=1, grid_y=1, neurons_per_column=300,
            synapses_per_neuron=200, seed=5)
# arrivals on LONG: (t, share of the valid synapses listed in slot t mod D,
# share of the listed entries then set to -1)
LONG_ARRIVAL = {"slot_0.6": (1003, 0.6, 0.0), "all_listed": (-1, 1.0, 0.0),
                "holes": (1004, 1.0, 0.1)}
# emission on LONG: (t, share of the sources spiking, ring cap), every
# spiking source listed; the ring fills past cap between listed rows
LONG_EMIT = {"overflow": (1005, 1.0, 2000),
             "overflow_prologue": (-1, 0.7, 1500)}
STEPS = 120
SAT_STEPS = 80
CARRY_AT, CARRY_TO = 50, 100
PLAN_LAYOUTS = {"h1_block": (1, "block"), "h2_block": (2, "block"),
                "h4_scatter": (4, "scatter")}
RUN_LAYOUTS = {"h1_block": (1, "block"), "h4_block": (4, "block"),
               "h4_scatter": (4, "scatter")}
SATURATION = {"cap_ev": (dict(cap_ev=8), {}), "c_post": ({}, dict(c_post=2)),
              "c_src": ({}, dict(c_src=2))}
T_ARRIVAL = 1003
EMIT_CASES = {"prologue": dict(t=-1, density=0.1, cap=None, c_src=None),
              "wrap": dict(t=1003, density=0.1, cap=None, c_src=None),
              "overflow": dict(t=1004, density=0.3, cap=256, c_src=None),
              "c_src": dict(t=1005, density=0.3, cap=None, c_src=16)}
NEG_TIME = engine.NEG_TIME


def digest(x) -> str:
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


def summarise(raster, gid, w, valid, v, u, ev_ring, ev_count, sat) -> dict:
    """Signatures of a run's outputs and state (numpy arrays)."""
    h = hashlib.sha256()
    for hh in range(w.shape[0]):
        h.update(np.ascontiguousarray(w[hh][valid[hh]]).tobytes())
    return dict(raster=observables.raster_signature(raster, gid).hex(),
                weights=h.hexdigest(), v=digest(v), u=digest(u),
                ev_ring=digest(ev_ring), ev_count=np.asarray(
                    ev_count).astype(int).tolist(),
                sat=np.asarray(sat).astype(int).tolist(),
                spikes=int(raster.sum()))


# ----------------------------------------------------------------------------
# the JAX side (inside AVX subprocesses)
# ----------------------------------------------------------------------------


def _jax_build(cfg_kw, eng_kw):
    from repro.core import EngineConfig as JE, GridConfig as JG
    from repro.core import event_engine as EV
    return EV.build(JG(**cfg_kw), JE(delivery="event", **eng_kw))


def _jax_summary(spec, plan, state, raster):
    b = state.base
    return summarise(np.asarray(raster), np.asarray(plan.gid),
                     np.asarray(b.w), np.asarray(plan.syn_valid),
                     np.asarray(b.v), np.asarray(b.u),
                     np.asarray(state.ev_ring), np.asarray(state.ev_count),
                     np.asarray(state.sat))


def _jax_run(cfg_kw, eng_kw, steps, cap_ev=None, **caps):
    import jax
    from repro.core import event_engine as EV
    spec, plan, eplan, state = _jax_build(cfg_kw, eng_kw)
    if cap_ev is not None:
        state = EV.init_event_state(spec, state.base, cap_ev)
    st, raster, _ = jax.jit(lambda s: EV.run(spec, plan, eplan, s, 0, steps,
                                             **caps))(state)
    return _jax_summary(spec, plan, st, raster)


def _seeded_event_state(rng, s1, valid, t: int, density: float, D: int,
                        cap: int):
    """numpy-seeded dynamic state of one shard: weights, last spike and
    arrival times (within 200 steps or never), v and u, and ring slot
    t mod D holding `density` of the valid synapses in random order (the
    other slots shorter lists), each synapse at most once a slot."""
    E = valid.shape[0]
    N = np.asarray(s1.base.v).shape[0]
    nv = int(valid.sum())

    def times(n):
        return np.where(rng.random(n) < 0.7, rng.uniform(t - 200.0, t, n),
                        NEG_TIME).astype(np.float32)
    ring = np.full((D, cap), -1, np.int32)
    count = np.zeros(D, np.int32)
    for d in range(D):
        k = min(cap, int((density if d == t % D else density / 3) * nv))
        ring[d, :k] = rng.permutation(nv)[:k]
        count[d] = k
    exc = rng.random(N) < 0.8
    v = np.where(rng.random(N) < density, rng.uniform(30.0, 40.0, N),
                 rng.uniform(-80.0, -60.0, N)).astype(np.float32)
    return dict(w=rng.uniform(0.0, 10.0, E).astype(np.float32),
                last_post=times(N), last_arr=times(E), v=v,
                u=rng.uniform(-20.0, 10.0, N).astype(np.float32),
                ev_ring=ring, ev_count=count, exc=exc)


def _jax_kernel_cases(path: str) -> dict:
    """The event plans of PLAN_LAYOUTS, and each op's JAX lines on seeded
    states of the H=1 plan (inputs and outputs saved to `path`)."""
    import jax
    import jax.numpy as jnp
    from repro.core import event_engine as EV
    from repro.core import neuron as JN
    from repro.core import stimulus as JS
    arrays = {}
    for name, (h, pl) in PLAN_LAYOUTS.items():
        spec, plan, eplan, state = _jax_build(SMALL, dict(
            n_shards=h, placement=pl))
        arrays[f"plan.{name}.fwd_rows"] = np.asarray(eplan.fwd_rows)
        arrays[f"plan.{name}.in_rows"] = np.asarray(eplan.in_rows)
        arrays[f"plan.{name}.cap_ev"] = np.int64(state.ev_ring.shape[-1])
    spec, plan, eplan, state = _jax_build(SMALL, dict(n_shards=1))
    one = lambda tree: jax.tree.map(lambda x: x[0], tree)
    p1, ep1, s1 = one(plan), one(eplan), one(state)
    valid = np.asarray(p1.syn_valid)
    D = spec.cfg.n_delay_slots
    cap = int(s1.ev_ring.shape[-1])
    stim_k = JS.stim_key(spec.cfg)
    rng = np.random.default_rng(19)

    def with_state(d):
        base = s1.base._replace(**{k: jnp.asarray(d[k]) for k in (
            "w", "last_post", "last_arr", "v", "u")})
        return s1._replace(base=base, ev_ring=jnp.asarray(d["ev_ring"]),
                           ev_count=jnp.asarray(d["ev_count"]))

    def save(prefix, d):
        for k, x in d.items():
            arrays[f"{prefix}.{k}"] = np.asarray(x)

    def out_state(prefix, st, spiked=None):
        save(prefix, dict(w=st.base.w, last_arr=st.base.last_arr,
                          last_post=st.base.last_post, v=st.base.v,
                          u=st.base.u, ev_ring=st.ev_ring,
                          ev_count=st.ev_count, sat=st.sat))
        if spiked is not None:
            arrays[f"{prefix}.spiked"] = np.asarray(spiked)

    for label, density in (("main", 0.0215), ("10x", 0.215)):
        d = _seeded_event_state(rng, s1, valid, T_ARRIVAL, density, D, cap)
        d.pop("exc")
        save(f"arrival.{label}.in", d)
        st = with_state(d)
        new, spiked, _ = jax.jit(lambda s, t: EV.phase_a_dynamics(
            spec, p1, ep1, s, t, stim_k))(st, jnp.int32(T_ARRIVAL))
        out_state(f"arrival.{label}.out", new, spiked)

        # the current alone: event_engine.py's lines, XLA-CPU's scatter-add
        def current(s, t):
            ev = s.ev_ring[jnp.mod(t, D)]
            ok = ev >= 0
            eve = jnp.maximum(ev, 0)
            return jnp.zeros((spec.n_local,), jnp.float32).at[
                p1.syn_tgt[eve]].add(jnp.where(ok, s.base.w[eve], 0.0))
        arrays[f"arrival.{label}.i_syn"] = np.asarray(
            jax.jit(current)(st, jnp.int32(T_ARRIVAL)))

        # LTP on the arrivals' output, with and without an overflowing cap
        n = spec.n_local
        spk = rng.random(n) < density * 4
        arrays[f"ltp.{label}.spiked"] = spk
        for c_post in (None, 8):
            tag = f"ltp.{label}.{c_post}"
            out = jax.jit(lambda s, sp, t: EV.phase_a_plasticity(
                spec, p1, ep1, s, sp, t, c_post=c_post))(
                new, jnp.asarray(spk), jnp.int32(T_ARRIVAL))
            out_state(tag, out)

    S = np.asarray(p1.src_gid).shape[0]
    for label, c in EMIT_CASES.items():
        ring_cap = c["cap"] or cap
        d = _seeded_event_state(rng, s1, valid, c["t"] + 1, 0.02, D,
                                ring_cap)
        d.pop("exc")
        save(f"emit.{label}.in", d)
        src = rng.random(S) < c["density"]
        arrays[f"emit.{label}.spiked_src"] = src
        out = jax.jit(lambda s, ss, t: EV.phase_b(
            spec, p1, ep1, s, ss, t, c_src=c["c_src"]))(
            with_state(d), jnp.asarray(src), jnp.int32(c["t"]))
        out_state(f"emit.{label}.out", out)

    # core.neuron
    n = 4096
    v = rng.uniform(-80.0, 35.0, n).astype(np.float32)
    u = rng.uniform(-20.0, 10.0, n).astype(np.float32)
    cur = rng.uniform(-10.0, 25.0, n).astype(np.float32)
    exc = rng.random(n) < 0.8
    ns0 = JN.init_state(jnp.asarray(exc), JN.IzhikevichParams())
    ns, spk = jax.jit(lambda v, u, i, e: JN.step(JN.NeuronState(v, u), i, e,
                                                 JN.IzhikevichParams()))(
        jnp.asarray(v), jnp.asarray(u), jnp.asarray(cur), jnp.asarray(exc))
    save("neuron", dict(v=v, u=u, current=cur, exc=exc, v0=ns0.v, u0=ns0.u,
                        v1=ns.v, u1=ns.u, spiked=spk))
    np.savez(path, **arrays)
    return {}


def _jax_long_cases(path: str) -> dict:
    """The plain arrivals and emission of LONG_ARRIVAL and LONG_EMIT on
    numpy-seeded states of LONG's H=1 plan (the plan's tables, inputs and
    outputs saved to `path`)."""
    import jax
    import jax.numpy as jnp
    from repro.core import event_engine as EV
    from repro.core import stimulus as JS
    spec, plan, eplan, state = _jax_build(LONG, dict(n_shards=1))
    one = lambda tree: jax.tree.map(lambda x: x[0], tree)
    p1, ep1, s1 = one(plan), one(eplan), one(state)
    valid = np.asarray(p1.syn_valid)
    E, D = valid.shape[0], spec.cfg.n_delay_slots
    S = np.asarray(p1.src_gid).shape[0]
    stim_k = JS.stim_key(spec.cfg)
    rng = np.random.default_rng(23)
    arrays = {f"plan.{k}": np.asarray(getattr(p1, k))
              for k in ("syn_tgt", "syn_plastic", "syn_delay")}
    arrays["plan.fwd_rows"] = np.asarray(ep1.fwd_rows)

    def run(prefix, d, fn, t):
        for k, x in d.items():
            arrays[f"{prefix}.in.{k}"] = np.asarray(x)
        base = s1.base._replace(**{k: jnp.asarray(d[k]) for k in (
            "w", "last_post", "last_arr", "v", "u")})
        st = s1._replace(base=base, ev_ring=jnp.asarray(d["ev_ring"]),
                         ev_count=jnp.asarray(d["ev_count"]))
        return jax.jit(fn)(st, jnp.int32(t))

    def out_state(prefix, st):
        for k, x in dict(w=st.base.w, last_arr=st.base.last_arr,
                         ev_ring=st.ev_ring, ev_count=st.ev_count,
                         sat=st.sat).items():
            arrays[f"{prefix}.out.{k}"] = np.asarray(x)

    for label, (t, density, holes) in LONG_ARRIVAL.items():
        d = _seeded_event_state(rng, s1, valid, t, density, D, E)
        d.pop("exc")
        r, k = t % D, d["ev_count"][t % D]
        d["ev_ring"][r, :k][rng.random(k) < holes] = -1
        new, _, tm = run(f"arrival.{label}", d, lambda s, t: (
            EV.phase_a_dynamics(spec, p1, ep1, s, t, stim_k)), t)
        out_state(f"arrival.{label}", new)
        arrays[f"arrival.{label}.arrivals"] = np.asarray(tm.arrivals)

        # the current: event_engine.py's lines, XLA-CPU's scatter-add
        def current(s, t):
            ev = s.ev_ring[jnp.mod(t, D)]
            eve = jnp.maximum(ev, 0)
            return jnp.zeros((spec.n_local,), jnp.float32).at[
                p1.syn_tgt[eve]].add(jnp.where(ev >= 0, s.base.w[eve], 0.0))
        arrays[f"arrival.{label}.i_syn"] = np.asarray(run(
            f"arrival.{label}", d, current, t))

    for label, (t, share, cap) in LONG_EMIT.items():
        d = _seeded_event_state(rng, s1, valid, t + 1, 0.02, D, cap)
        d.pop("exc")
        src = rng.random(S) < share
        arrays[f"emit.{label}.spiked_src"] = src
        out = run(f"emit.{label}", d, lambda s, t: EV.phase_b(
            spec, p1, ep1, s, jnp.asarray(src), t, c_src=S), t)
        out_state(f"emit.{label}", out)
    np.savez(path, **arrays)
    return {}


def _jax_runs(path: str) -> dict:
    """RUN_LAYOUTS' runs and the carried-state case (plan and state at
    CARRY_AT, the uninterrupted run to CARRY_TO, saved to `path`)."""
    import jax
    from repro.core import event_engine as EV
    out = {f"run.{name}": _jax_run(SMALL, dict(n_shards=h, placement=pl),
                                   STEPS)
           for name, (h, pl) in RUN_LAYOUTS.items()}
    spec, plan, eplan, state = _jax_build(SMALL, dict(n_shards=2))
    mid, _, _ = jax.jit(lambda s: EV.run(spec, plan, eplan, s, 0,
                                         CARRY_AT))(state)
    end, raster, _ = jax.jit(lambda s: EV.run(spec, plan, eplan, s, 0,
                                              CARRY_TO))(state)
    out["carry"] = _jax_summary(spec, plan, end, raster)
    arrays = {f"plan.{k}": np.asarray(v) for k, v in plan._asdict().items()}
    arrays.update({f"eplan.{k}": np.asarray(v)
                   for k, v in eplan._asdict().items()})
    arrays.update({f"base.{k}": np.asarray(v)
                   for k, v in mid.base._asdict().items()})
    arrays.update({f"state.{k}": np.asarray(getattr(mid, k))
                   for k in ("ev_ring", "ev_count", "sat")})
    np.savez(path, raster=np.asarray(raster), **arrays)
    return out


def _jax_saturation_and_suite() -> dict:
    """SATURATION's runs and the JAX `event_vs_dense` suite's quick rows."""
    out = {}
    for name, (init, caps) in SATURATION.items():
        out[f"sat.{name}"] = _jax_run(SAT_CFG, dict(n_shards=1), SAT_STEPS,
                                      **init, **caps)
    from repro.bench.suites import event_vs_dense
    out["suite"] = event_vs_dense.bench(quick=True)
    return out


@pytest.fixture(scope="module", autouse=True)
def _avx_jobs(tmp_path_factory):
    """Start the JAX runs with the module, so the port's own runs overlap
    them."""
    tmp = tmp_path_factory.mktemp("event")
    kernels, carry = tmp / "kernels.npz", tmp / "carry.npz"
    long = tmp / "long.npz"
    procs = start_avx(__file__, [["--kernels", kernels], ["--runs", carry],
                                 ["--saturation"], ["--long", long]])
    yield procs, kernels, carry, long
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def jax_ref(_avx_jobs):
    procs, kernels, carry, long = _avx_jobs
    ref_ = {}
    for out in wait_avx(procs, timeout=900):
        ref_.update(json.loads(out.strip().splitlines()[-1]))
    ref_["kernels"] = dict(np.load(kernels))
    ref_["carry_arrays"] = dict(np.load(carry))
    ref_["long"] = dict(np.load(long))
    return ref_


# ----------------------------------------------------------------------------
# the port's side
# ----------------------------------------------------------------------------


def port_summary(sp: StepProgram, state, raster) -> dict:
    b = state.base
    return summarise(raster.numpy(), sp.plan.gid.numpy(), b.w.numpy(),
                     sp.plan.syn_valid.numpy(), b.v.numpy(), b.u.numpy(),
                     state.ev_ring.numpy(), state.ev_count.numpy(),
                     state.sat.numpy())


def port_program(cfg_kw, eng_kw, **caps) -> StepProgram:
    return StepProgram(GridConfig(**cfg_kw),
                       EngineConfig(delivery="event", **eng_kw),
                       device="cpu", caps=caps)


_h1 = {}


def h1_program() -> StepProgram:
    """The port's H=1 event program at SMALL (built once)."""
    if not _h1:
        _h1["sp"] = port_program(SMALL, dict(n_shards=1))
    return _h1["sp"]


def port_state(sp: StepProgram, d: dict, prefix: str):
    """The H=1 event state with the arrays `prefix`.* of the JAX cases."""
    base = sp.init_state().base
    t = lambda k: torch.from_numpy(np.array(d[f"{prefix}.{k}"]))[None]
    base = base._replace(w=t("w"), last_post=t("last_post"),
                         last_arr=t("last_arr"), v=t("v"), u=t("u"))
    return event_engine.EventState(
        base=base, ev_ring=t("ev_ring"), ev_count=t("ev_count"),
        sat=torch.zeros(1, dtype=torch.int32))


def assert_state(st, d: dict, prefix: str, keys=("w", "last_arr",
                                                 "last_post", "v", "u",
                                                 "ev_ring", "ev_count",
                                                 "sat")):
    got = dict(st.base._asdict(), ev_ring=st.ev_ring, ev_count=st.ev_count,
               sat=st.sat)
    for k in keys:
        want = np.asarray(d[f"{prefix}.{k}"])
        g = got[k][0].numpy()
        assert g.dtype.itemsize == want.dtype.itemsize, k
        assert g.tobytes() == want.astype(g.dtype).tobytes(), k


@pytest.mark.parametrize("name", list(PLAN_LAYOUTS))
def test_event_plan_equals_jax(jax_ref, name):
    h, pl = PLAN_LAYOUTS[name]
    sp = port_program(SMALL, dict(n_shards=h, placement=pl))
    z = jax_ref["kernels"]
    assert np.array_equal(sp.eplan.fwd_rows.numpy(),
                          z[f"plan.{name}.fwd_rows"])
    assert np.array_equal(sp.eplan.in_rows.numpy(),
                          z[f"plan.{name}.in_rows"])
    assert sp.cap_ev == int(z[f"plan.{name}.cap_ev"])


@pytest.mark.parametrize("name", list(PLAN_LAYOUTS))
def test_in_rows_are_the_csr_rows(name):
    """Row n of in_rows is [row_ptr[n], row_ptr[n + 1]), then -1: what lets
    the LTP kernel walk row_ptr."""
    h, pl = PLAN_LAYOUTS[name]
    sp = port_program(SMALL, dict(n_shards=h, placement=pl))
    rp = sp.plan.row_ptr.numpy().astype(np.int64)
    rows = sp.eplan.in_rows.numpy()
    k = np.arange(rows.shape[2])
    want = np.where(k[None, None] < (rp[:, 1:] - rp[:, :-1])[..., None],
                    rp[:, :-1, None] + k[None, None], -1)
    assert np.array_equal(rows, want)


@pytest.mark.parametrize("label", ["main", "10x"])
def test_event_arrival_plain_equals_jax(jax_ref, label):
    """Phase A's first half (the arrivals, stimulus, neurons) from a seeded
    state, and the current alone against XLA-CPU's scatter-add."""
    z = jax_ref["kernels"]
    sp = h1_program()
    st = port_state(sp, z, f"arrival.{label}.in")
    st_i = engine.clone_state(st)
    stim = engine.StimWindow(sp.spec, sp.plan, T_ARRIVAL, 1).row(T_ARRIVAL)
    coeffs = ref.izh_coefficients(sp.plan.exc_mask, sp.spec.izh)
    with ref.flush_denormal():
        st, spiked, tm = event_engine.phase_a_dynamics(
            sp.spec, sp.plan, sp.eplan, st, T_ARRIVAL, stim, coeffs)
    assert_state(st, z, f"arrival.{label}.out")
    assert np.array_equal(spiked[0].numpy(), z[f"arrival.{label}.out.spiked"])
    i_syn, n_arrived = ops.event_arrival(
        st_i.ev_ring, st_i.ev_count, sp.plan.syn_tgt, sp.plan.row_ptr,
        sp.plan.syn_plastic,
        st_i.base.last_post, st_i.base.w, st_i.base.last_arr, T_ARRIVAL,
        a_minus=sp.spec.stdp.a_minus, tau_minus=sp.spec.stdp.tau_minus,
        w_min=sp.spec.stdp.w_min, w_max=sp.spec.stdp.w_max,
        neg_time=NEG_TIME)
    assert i_syn[0].numpy().tobytes() == z[f"arrival.{label}.i_syn"].tobytes()
    assert int(n_arrived[0]) == int(tm.arrivals[0]) > 0


@pytest.mark.parametrize("label", ["main", "10x"])
@pytest.mark.parametrize("c_post", [None, 8])
def test_event_ltp_plain_equals_jax(jax_ref, label, c_post):
    z = jax_ref["kernels"]
    sp = h1_program()
    st = port_state(sp, z, f"arrival.{label}.out")
    spiked = torch.from_numpy(z[f"ltp.{label}.spiked"])[None]
    with ref.flush_denormal():
        st = event_engine.phase_a_plasticity(
            sp.spec, sp.plan, sp.eplan, st, spiked, T_ARRIVAL, c_post=c_post)
    assert_state(st, z, f"ltp.{label}.{c_post}")
    if c_post is not None:
        assert int(st.sat[0]) > 0


@pytest.mark.parametrize("label", list(EMIT_CASES))
def test_event_emit_plain_equals_jax(jax_ref, label):
    z = jax_ref["kernels"]
    c = EMIT_CASES[label]
    sp = h1_program()
    st = port_state(sp, z, f"emit.{label}.in")
    src = torch.from_numpy(z[f"emit.{label}.spiked_src"])[None]
    st = event_engine.phase_b(sp.spec, sp.plan, sp.eplan, st, src, c["t"],
                              c_src=c["c_src"])
    assert_state(st, z, f"emit.{label}.out", ("ev_ring", "ev_count", "sat"))
    assert (int(st.sat[0]) > 0) == (label in ("overflow", "c_src"))


_long = {}


def long_program() -> StepProgram:
    """The port's H=1 event program at LONG (built once)."""
    if not _long:
        _long["sp"] = port_program(LONG, dict(n_shards=1))
    return _long["sp"]


def test_long_plan_equals_jax(jax_ref):
    z, sp = jax_ref["long"], long_program()
    for k in ("syn_tgt", "syn_plastic", "syn_delay"):
        assert np.array_equal(getattr(sp.plan, k)[0].numpy(),
                              z[f"plan.{k}"]), k
    assert np.array_equal(sp.eplan.fwd_rows[0].numpy(), z["plan.fwd_rows"])


@pytest.mark.parametrize("label", list(LONG_ARRIVAL))
def test_event_arrival_long_buckets_equal_jax(jax_ref, label):
    """`kernels.ref.event_arrival` on LONG's buckets (over 128 events a
    target) and -1 holes: the current, the arrivals, w, last_arr and the
    cleared slot are the JAX event backend's bits."""
    z, sp = jax_ref["long"], long_program()
    t, _, holes = LONG_ARRIVAL[label]
    st = port_state(sp, z, f"arrival.{label}.in")
    r = t % st.ev_ring.shape[1]
    ev = st.ev_ring[0, r, :int(st.ev_count[0, r])]
    tgt = sp.plan.syn_tgt[0, ev[ev >= 0].to(torch.int64)]
    assert int(torch.bincount(tgt).max()) > 128
    assert bool((ev < 0).any()) == (holes > 0)
    stdp = sp.spec.stdp
    with ref.flush_denormal():
        i_syn, n_arrived = ref.event_arrival(
            st.ev_ring, st.ev_count, r, sp.plan.syn_tgt,
            sp.plan.syn_plastic, st.base.last_post, st.base.w,
            st.base.last_arr, t, a_minus=stdp.a_minus,
            tau_minus=stdp.tau_minus, w_min=stdp.w_min, w_max=stdp.w_max,
            neg_time=NEG_TIME)
    assert i_syn[0].numpy().tobytes() == z[f"arrival.{label}.i_syn"].tobytes()
    assert int(n_arrived[0]) == int(z[f"arrival.{label}.arrivals"])
    assert_state(st, z, f"arrival.{label}.out",
                 ("w", "last_arr", "ev_ring", "ev_count"))


@pytest.mark.parametrize("label", list(LONG_EMIT))
def test_event_emit_long_rows_equal_jax(jax_ref, label):
    """`kernels.ref.event_emit` of LONG's spiking sources, all listed, into
    a ring that fills past cap between listed rows: the ring, the counts
    and sat are the JAX event backend's bits."""
    z, sp = jax_ref["long"], long_program()
    t = LONG_EMIT[label][0]
    st = port_state(sp, z, f"emit.{label}.in")
    src = torch.from_numpy(z[f"emit.{label}.spiked_src"])[None]
    S = src.shape[1]
    ids, drop = aer.compact_indices(src, S, fill=S)
    # the first listed source whose row fills a slot past cap
    D, cap = st.ev_ring.shape[1:]
    fill = st.ev_count[0].to(torch.int64).clone()
    listed = ids[0][ids[0] < S].tolist()
    first = None
    for k, s in enumerate(listed):
        row = sp.eplan.fwd_rows[0, s]
        row = row[row >= 0].to(torch.int64)
        fill += torch.bincount((sp.plan.syn_delay[0, row] + t) % D,
                               minlength=D)
        if first is None and bool((fill > cap).any()):
            first = k
    assert first is not None and 0 < first < len(listed) - 1
    ref.event_emit(ids.contiguous(), drop, sp.eplan.fwd_rows,
                   sp.plan.syn_delay, st.ev_ring, st.ev_count, st.sat, t)
    assert_state(st, z, f"emit.{label}.out", ("ev_ring", "ev_count", "sat"))
    assert int(st.sat[0]) > 0


@pytest.mark.parametrize("name", list(RUN_LAYOUTS))
def test_event_run_equals_jax(jax_ref, name):
    h, pl = RUN_LAYOUTS[name]
    sp = port_program(SMALL, dict(n_shards=h, placement=pl))
    st, raster, tm = sp.run(sp.init_state(), 0, STEPS)
    got = port_summary(sp, st, raster)
    assert got == jax_ref[f"run.{name}"]
    assert int(tm.spikes.sum()) == got["spikes"] > 0
    assert got["sat"] == [0] * h


@pytest.mark.parametrize("name", list(SATURATION))
def test_saturation_equals_jax(jax_ref, name):
    init, caps = SATURATION[name]
    sp = port_program(SAT_CFG, dict(n_shards=1), **caps)
    st0 = sp.init_state()
    if "cap_ev" in init:
        st0 = event_engine.init_event_state(sp.spec, st0.base,
                                            init["cap_ev"])
    st, raster, _ = sp.run(st0, 0, SAT_STEPS)
    got = port_summary(sp, st, raster)
    assert got == jax_ref[f"sat.{name}"]
    assert got["sat"][0] > 0


def test_state_carried_across_from_jax(jax_ref):
    z = jax_ref["carry_arrays"]
    fields = lambda prefix: SimpleNamespace(**{
        k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)})
    state = SimpleNamespace(base=fields("base."), **vars(fields("state.")))
    plan, eplan, state = convert.event_from_jax(fields("plan."),
                                                fields("eplan."), state,
                                                "cpu")
    spec = port_program(SMALL, dict(n_shards=2)).spec
    sp = StepProgram.from_parts(spec, plan, eplan=eplan)
    st, raster, _ = sp.run(state, CARRY_AT, CARRY_TO - CARRY_AT)
    assert np.array_equal(raster.numpy(), z["raster"][CARRY_AT:])
    want = jax_ref["carry"]
    got = port_summary(sp, st, torch.from_numpy(z["raster"]))
    assert got == want


def test_neuron_equals_jax(jax_ref):
    z = jax_ref["kernels"]
    exc = torch.from_numpy(z["neuron.exc"])
    s0 = neuron.init_state(exc, DEFAULT_IZH)
    assert s0.v.numpy().tobytes() == z["neuron.v0"].tobytes()
    assert s0.u.numpy().tobytes() == z["neuron.u0"].tobytes()
    with ref.flush_denormal():
        s1, spiked = neuron.step(
            neuron.NeuronState(torch.from_numpy(z["neuron.v"]),
                               torch.from_numpy(z["neuron.u"])),
            torch.from_numpy(z["neuron.current"]), exc, DEFAULT_IZH)
    assert s1.v.numpy().tobytes() == z["neuron.v1"].tobytes()
    assert s1.u.numpy().tobytes() == z["neuron.u1"].tobytes()
    assert np.array_equal(spiked.numpy(), z["neuron.spiked"])
    assert 0 < int(spiked.sum()) < spiked.numel()


def test_event_vs_dense_rows_equal_jax(jax_ref):
    from repro_torch.bench.suites import event_vs_dense
    rows = event_vs_dense.bench(quick=True, device="cpu")
    keys = ("stim_per_ms", "rate_hz", "identical_rasters", "raster_sig",
            "saturated")
    assert [{k: r[k] for k in keys} for r in rows] == [
        {k: r[k] for k in keys} for r in jax_ref["suite"]]
    assert all(r["identical_rasters"] for r in rows)


# ----------------------------------------------------------------------------
# within the port
# ----------------------------------------------------------------------------


class _OpNames(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def test_no_sort_in_the_event_step():
    """Compaction ranks by cumsum: no sort op anywhere in a step (nor in
    the arrivals' ordered sum)."""
    sp = port_program(SMALL, dict(n_shards=2))
    step_fns = sp.phase_fns()
    state = engine.clone_state(sp.init_state())
    step_fns.phase_a(state, 0)      # draws the stimulus window outside
    with _OpNames() as rec:
        for t in range(1, 30):
            state, spiked, _ = step_fns.phase_a(state, t)
            step_fns.phase_b(state, step_fns.exchange(spiked), t)
    assert rec.names and not any("sort" in n for n in rec.names), \
        sorted(rec.names)
    # the arrivals' ordered sum ran in the recorded steps
    assert any("scatter_reduce" in n for n in rec.names), sorted(rec.names)


@pytest.mark.parametrize("schedule", ["sync", "pipelined"])
@pytest.mark.parametrize("exchange", ["allgather", "halo", "hier"])
def test_event_phases_give_the_run(schedule, exchange):
    sp = StepProgram(GridConfig(**SMALL), EngineConfig(
        n_shards=4, delivery="event", exchange=exchange,
        exchange_schedule=schedule), device="cpu", hier_groups=2)
    st, raster, tm = sp.run(sp.init_state(), 0, 60)
    st2, times, rasters, counts = sp.time_phases(sp.init_state(), 0, 60,
                                                 collect_rasters=True)
    assert np.array_equal(np.stack(rasters), raster.numpy())
    assert sp.weight_signature(st2) == sp.weight_signature(st)
    assert counts == dict(spikes=int(tm.spikes.sum()),
                          arrivals=int(tm.arrivals.sum()))
    assert set(times) == {"phase_a_s", "exchange_s", "phase_b_s"}


def test_event_matches_dense_in_the_port():
    """As tests/test_event_engine.py requires of the JAX package: equal
    rasters, weights within 1e-4 (the sum orders differ)."""
    cfg = GridConfig(**SMALL)
    ev = StepProgram(cfg, EngineConfig(n_shards=2, delivery="event"),
                     device="cpu")
    de = StepProgram(cfg, EngineConfig(n_shards=2), device="cpu")
    s_e, r_e, _ = ev.run(ev.init_state(), 0, 150)
    s_d, r_d, _ = de.run(de.init_state(), 0, 150)
    assert torch.equal(r_e, r_d) and int(r_e.sum()) > 0
    torch.testing.assert_close(s_e.base.w, s_d.w, rtol=1e-4, atol=1e-4)
    assert int(s_e.sat.sum()) == 0


def test_run_leaves_input_state_untouched():
    sp = port_program(SMALL, dict(n_shards=2))
    s0 = sp.init_state()
    before = [x.clone() for x in engine.state_tensors(s0)]
    _, r1, _ = sp.run(s0, 0, 40)
    _, r2, _ = sp.run(s0, 0, 40)
    assert all(torch.equal(a, b)
               for a, b in zip(before, engine.state_tensors(s0)))
    assert torch.equal(r1, r2) and int(r1.sum()) > 0


def test_plain_event_ops_take_an_int_step():
    sp = h1_program()
    st = sp.init_state()
    ctr = torch.zeros(2, dtype=torch.int64)
    ids, dropped = aer.compact_indices(torch.zeros_like(sp.plan.src_gid,
                                                        dtype=torch.bool),
                                       4, fill=sp.plan.src_gid.shape[1])
    with pytest.raises(TypeError, match="step counter"):
        ops.event_emit(ids, dropped, sp.eplan.fwd_rows, sp.plan.syn_delay,
                       st.ev_ring, st.ev_count, st.sat, ctr)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_launcher_runs_event_delivery(capsys):
    from repro_torch.launch import snn
    rate = snn.main(["--grid", "2x1", "--neurons-per-column", "100",
                     "--synapses", "20", "--steps", "40", "--device", "cpu",
                     "--delivery", "event", "--shards", "2",
                     "--exchange", "halo"])
    out = capsys.readouterr().out
    assert "event delivery" in out and "raster equal to" in out
    assert "0 events dropped" in out and rate > 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    if sys.argv[1] == "--kernels":
        print(json.dumps(_jax_kernel_cases(sys.argv[2])))
    elif sys.argv[1] == "--long":
        print(json.dumps(_jax_long_cases(sys.argv[2])))
    elif sys.argv[1] == "--runs":
        print(json.dumps(_jax_runs(sys.argv[2])))
    else:
        assert sys.argv[1] == "--saturation"
        print(json.dumps(_jax_saturation_and_suite()))
