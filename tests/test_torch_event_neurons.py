"""The event backend's phase A after the arrivals, as the port runs it:
`kernels.ops.event_neurons` (the stimulus, the Izhikevich update, the spike
mask and, with c_post, the spike list with last_post and sat), then
`kernels.ops.event_ltp` (LTP on the listed rows), and the split schedule's
`event_compact`.

On the CPU, against the JAX package's event backend jitted under
`XLA_FLAGS=--xla_cpu_max_isa=AVX` in a subprocess started with the module
(SMALL's H=1 plan, numpy-seeded states at 2.15% and 21.5%, the default
c_post and an overflowing c_post = 8): the arrivals, then the new ops' plain
versions give `phase_a_dynamics` then `phase_a_plasticity`'s v, u, spikes,
spike count, w, last_post, last_arr, ring and sat bit for bit.  Within the
port: the fused `phase_a` equals the split (`phase_a_dynamics` then
`phase_a_plasticity`) on the same state, the list is `compact_indices`',
`event_compact` then `event_ltp` give what the LTP op they replaced gave
(`ref.stdp_ltp`: last_post and LTP from the spike mask, and sat), with
empty CSR rows among the listed, and the card wrapper refuses a stimulus
window whose middle axis is not the shards before it reaches the card.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import engine, event_engine
from repro_torch.core.aer import compact_indices
from repro_torch.kernels import event as kev
from repro_torch.kernels import ops, ref

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_event import (SMALL, NEG_TIME, _jax_build,  # noqa: E402
                              _seeded_event_state, assert_state, h1_program,
                              port_state)
from test_torch_reference import start_avx, wait_avx  # noqa: E402

T = 1007
DENSITIES = {"main": 0.0215, "10x": 0.215}
# phase_a_plasticity's c_post: the default (N / 2: nothing dropped here),
# and 8, which the spikes overflow
CAPS = (None, 8)


def _jax_cases(path: str) -> dict:
    """JAX phase_a_dynamics then phase_a_plasticity on numpy-seeded states
    of SMALL's H=1 plan (inputs and outputs saved to `path`)."""
    import jax
    import jax.numpy as jnp
    from repro.core import event_engine as EV
    from repro.core import stimulus as JS
    spec, plan, eplan, state = _jax_build(SMALL, dict(n_shards=1))
    one = lambda tree: jax.tree.map(lambda x: x[0], tree)
    p1, ep1, s1 = one(plan), one(eplan), one(state)
    valid = np.asarray(p1.syn_valid)
    D, cap = spec.cfg.n_delay_slots, int(s1.ev_ring.shape[-1])
    stim_k = JS.stim_key(spec.cfg)
    rng = np.random.default_rng(29)
    arrays = {}
    for label, density in DENSITIES.items():
        d = _seeded_event_state(rng, s1, valid, T, density, D, cap)
        d.pop("exc")
        for k, x in d.items():
            arrays[f"{label}.in.{k}"] = np.asarray(x)
        base = s1.base._replace(**{k: jnp.asarray(d[k]) for k in (
            "w", "last_post", "last_arr", "v", "u")})
        st = s1._replace(base=base, ev_ring=jnp.asarray(d["ev_ring"]),
                         ev_count=jnp.asarray(d["ev_count"]))
        new, spiked, tm = jax.jit(lambda s, t: EV.phase_a_dynamics(
            spec, p1, ep1, s, t, stim_k))(st, jnp.int32(T))
        arrays[f"{label}.spiked"] = np.asarray(spiked)
        arrays[f"{label}.spikes"] = np.asarray(tm.spikes)
        arrays[f"{label}.arrivals"] = np.asarray(tm.arrivals)
        for c_post in CAPS:
            out = jax.jit(lambda s, sp, t: EV.phase_a_plasticity(
                spec, p1, ep1, s, sp, t, c_post=c_post))(
                new, spiked, jnp.int32(T))
            b = out.base
            for k, x in dict(w=b.w, last_arr=b.last_arr,
                             last_post=b.last_post, v=b.v, u=b.u,
                             ev_ring=out.ev_ring, ev_count=out.ev_count,
                             sat=out.sat).items():
                arrays[f"{label}.{c_post}.{k}"] = np.asarray(x)
    np.savez(path, **arrays)
    return {}


@pytest.fixture(scope="module")
def jax_cases(tmp_path_factory):
    path = tmp_path_factory.mktemp("event_neurons") / "cases.npz"
    wait_avx(start_avx(__file__, [["--cases", path]]), timeout=900)
    return dict(np.load(path))


def _ltp_kw(sp) -> dict:
    stdp = sp.spec.stdp
    return dict(a_plus=stdp.a_plus, tau_plus=stdp.tau_plus, w_min=stdp.w_min,
                w_max=stdp.w_max, neg_time=NEG_TIME)


def _fused(sp, st, t, stim, coeffs, c_post):
    """The ops of `event_engine.phase_a` on `st` (in place) -> (spiked,
    count, n_arrived, ids)."""
    b, stdp, plan = st.base, sp.spec.stdp, sp.plan
    i_syn, n_arr = ops.event_arrival(
        st.ev_ring, st.ev_count, plan.syn_tgt, plan.row_ptr,
        plan.syn_plastic, b.last_post, b.w, b.last_arr, t,
        a_minus=stdp.a_minus, tau_minus=stdp.tau_minus, w_min=stdp.w_min,
        w_max=stdp.w_max, neg_time=NEG_TIME)
    spiked, count, ids = ops.event_neurons(
        i_syn, *stim, plan.exc_mask, plan.neuron_valid, b.v, b.u,
        b.last_post, st.sat, t, izh=sp.spec.izh, c_post=c_post,
        coeffs=coeffs)
    ops.event_ltp(ids, count, plan.row_ptr, plan.syn_plastic, b.last_arr,
                  b.w, t, **_ltp_kw(sp))
    return spiked, count, n_arr, ids


@pytest.mark.parametrize("c_post", CAPS, ids=["default", "cut"])
@pytest.mark.parametrize("label", list(DENSITIES))
def test_event_neurons_plain_equals_jax(jax_cases, label, c_post):
    """The arrivals, `event_neurons` and `event_ltp` (plain versions) give
    JAX's phase_a_dynamics then phase_a_plasticity bit for bit."""
    z = jax_cases
    sp = h1_program()
    st = port_state(sp, z, f"{label}.in")
    stim = engine.StimWindow(sp.spec, sp.plan, T, 1).row(T)
    coeffs = ref.izh_coefficients(sp.plan.exc_mask, sp.spec.izh)
    cp = event_engine.default_caps(sp.spec)[0] if c_post is None else c_post
    ops.reset_launch_counts()
    spiked, count, n_arr, ids = _fused(sp, st, T, stim, coeffs, cp)
    assert_state(st, z, f"{label}.{c_post}")
    assert np.array_equal(spiked[0].numpy(), z[f"{label}.spiked"])
    assert int(count[0]) == int(z[f"{label}.spikes"]) > 0
    assert int(n_arr[0]) == int(z[f"{label}.arrivals"]) > 0
    assert int(st.sat[0]) == max(0, int(count[0]) - cp)
    if label == "10x" and c_post is not None:      # the list was cut
        assert int(st.sat[0]) > 0
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


@pytest.mark.parametrize("c_post", [None, 0, 1, 8, 400, "N"])
def test_event_neurons_list_is_compact_indices(c_post):
    """ids are `compact_indices`' (the first c_post spiking neurons, then
    the fill N), count the spikes, sat grows by the spikes past c_post;
    without c_post nothing is listed and last_post and sat stay as they
    were."""
    sp = h1_program()
    st = engine.clone_state(sp.init_state())
    N = sp.plan.gid.shape[1]
    rng = np.random.default_rng(31)
    b = st.base
    b.v.copy_(torch.from_numpy(np.where(
        rng.random((1, N)) < 0.3, 35.0, -70.0).astype(np.float32)))
    i_syn = torch.zeros_like(b.v)
    stim = engine.StimWindow(sp.spec, sp.plan, T, 1).row(T)
    lp0, sat0 = b.last_post.clone(), st.sat.clone()
    if c_post == "N":
        c_post = N
    spiked, count, ids = ops.event_neurons(
        i_syn, *stim, sp.plan.exc_mask, sp.plan.neuron_valid, b.v, b.u,
        b.last_post, st.sat, T, izh=sp.spec.izh, c_post=c_post)
    assert int(count[0]) == int(spiked.sum()) > 8
    if c_post is None:
        assert ids.shape == (1, 0)
        assert torch.equal(b.last_post, lp0) and torch.equal(st.sat, sat0)
        return
    want, dropped = compact_indices(spiked, c_post, fill=N)
    assert torch.equal(ids, want) and ids.dtype == torch.int32
    assert torch.equal(st.sat, sat0 + dropped)
    assert int(dropped[0]) == max(0, int(count[0]) - c_post)
    assert torch.equal(b.last_post, torch.where(
        spiked, torch.tensor(float(T)), lp0))


@pytest.mark.parametrize("c_post", [None, 1, 8])
def test_phase_a_equals_the_split(c_post):
    """`event_engine.phase_a` (the arrivals, `event_neurons` with the list,
    `event_ltp`) and the split schedule's `phase_a_dynamics` then
    `phase_a_plasticity` (`event_neurons` without, then `event_compact`,
    `event_ltp`) give the same spikes, timings and state, bit for bit."""
    sp = h1_program()
    z_rng = np.random.default_rng(37)
    st0, _, _ = sp.run(sp.init_state(), 0, 40)
    st0.base.v.copy_(torch.from_numpy(np.where(
        z_rng.random(st0.base.v.shape) < 0.1, 35.0,
        st0.base.v.numpy()).astype(np.float32)))
    stim = engine.StimWindow(sp.spec, sp.plan, 40, 1).row(40)
    coeffs = ref.izh_coefficients(sp.plan.exc_mask, sp.spec.izh)
    a, b = engine.clone_state(st0), engine.clone_state(st0)
    args = (sp.spec, sp.plan, sp.eplan)
    a, spk_a, tm_a = event_engine.phase_a(*args, a, 40, stim, coeffs,
                                          c_post=c_post)
    b, spk_b, tm_b = event_engine.phase_a_dynamics(*args, b, 40, stim,
                                                   coeffs)
    b = event_engine.phase_a_plasticity(*args, b, spk_b, 40, c_post=c_post)
    assert torch.equal(spk_a, spk_b) and int(spk_a.sum()) > 8
    assert all(torch.equal(x, y) for x, y in zip(tm_a, tm_b))
    for x, y in zip(engine.state_tensors(a), engine.state_tensors(b)):
        assert x.dtype == y.dtype and torch.equal(x.view(torch.uint8),
                                                  y.view(torch.uint8))
    assert (int(a.sat[0]) > int(st0.sat[0])) == (c_post is not None)


@pytest.mark.parametrize("rows", ["csr", "empty_rows"])
@pytest.mark.parametrize("c_post", [None, 8])
@pytest.mark.parametrize("density", [0.05, 0.6])
def test_compact_then_ltp_equals_the_op_it_replaced(density, c_post, rows):
    """`event_compact` then `event_ltp` (plain versions) give the LTP op
    they replaced, `ref.stdp_ltp` on the first c_post spiking neurons
    (LTP on their rows), with last_post = t of every spiking neuron and
    sat += the spikes past c_post, bit for bit: w, last_post, sat.
    `empty_rows` merges each pair of CSR rows into the second, so every
    other listed neuron has an empty row."""
    sp = h1_program()
    N = sp.plan.gid.shape[1]
    rp = sp.plan.row_ptr
    if rows == "empty_rows":
        rp = rp[:, (torch.arange(N + 1) // 2) * 2].contiguous()
        rp[:, -1] = sp.plan.row_ptr[:, -1]
    rng = np.random.default_rng(int(density * 100) + (c_post or 0))
    st = engine.clone_state(sp.init_state())
    b = st.base
    E = b.w.shape[1]
    b.last_arr.copy_(torch.from_numpy(np.where(
        rng.random((1, E)) < 0.5, rng.uniform(T - 60.0, T, (1, E)),
        NEG_TIME).astype(np.float32)))
    spiked = torch.from_numpy(rng.random((1, N)) < density)
    c = N if c_post is None else c_post
    stdp = sp.spec.stdp
    w, lp, sat = b.w.clone(), b.last_post.clone(), st.sat.clone()
    with ref.flush_denormal():
        count, ids = ref.event_compact(spiked, lp, sat, T, c_post=c)
        ref.event_ltp(ids, count, rp, sp.plan.syn_plastic, b.last_arr, w,
                      T, **_ltp_kw(sp))
        want_ids, dropped = compact_indices(spiked, c, fill=N)
        listed = torch.zeros((1, N + 1), dtype=torch.bool).scatter_(
            1, want_ids.long(), True)[:, :N]
        w2, lp2 = b.w.clone(), b.last_post.clone()
        ref.stdp_ltp(listed, rp, sp.plan.syn_plastic, b.last_arr, w2, lp2,
                     T, a_plus=stdp.a_plus, tau_plus=stdp.tau_plus,
                     w_min=stdp.w_min, w_max=stdp.w_max, neg_time=NEG_TIME)
    lp2 = torch.where(spiked, torch.tensor(float(T)), lp2)
    assert torch.equal(ids, want_ids) and int(count[0]) == int(spiked.sum())
    assert torch.equal(w.view(torch.int32), w2.view(torch.int32))
    assert torch.equal(lp, lp2)
    assert torch.equal(sat, st.sat + dropped)
    assert not torch.equal(w, b.w)
    if rows == "empty_rows":
        r = rp[0]
        assert any(int(r[n]) == int(r[n + 1]) for n in ids[0].tolist()
                   if n < N)


@pytest.mark.parametrize("window", [
    "other_shards", "rows_not_windowed", "amp_differs", "shards_of_one"])
def test_event_neurons_refuses_a_window_of_other_shards(window):
    """With the step counter as t, the stimulus must be a window [W, H, K]
    for index and amp alike; a window whose middle axis is not H (even
    where W * H' is a multiple of H, which would read another shard's
    stimulus) is refused before any launch."""
    H, N, K = 2, 16, 4
    idx = torch.zeros((3, H, K), dtype=torch.int64)
    amp = torch.zeros((3, H, K))
    if window == "other_shards":
        idx, amp = (torch.zeros((2, 4, K), dtype=torch.int64),
                    torch.zeros((2, 4, K)))
    elif window == "rows_not_windowed":
        idx, amp = idx[0], amp[0]
    elif window == "amp_differs":
        amp = torch.zeros((3, H, K + 1))
    else:
        idx, amp = (torch.zeros((4, 1, K), dtype=torch.int64),
                    torch.zeros((4, 1, K)))
    f = torch.zeros((H, N))
    m = torch.ones((H, N), dtype=torch.bool)
    ctr = torch.tensor([T, 0], dtype=torch.int64)
    with pytest.raises(ValueError, match="window"):
        kev.event_neurons(f, idx, amp, m, m, f.clone(), f.clone(), f.clone(),
                          torch.zeros(H, dtype=torch.int32), ctr, izh=None,
                          c_post=4)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    assert sys.argv[1] == "--cases"
    print(json.dumps(_jax_cases(sys.argv[2])))
