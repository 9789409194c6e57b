"""The port's multi-tenant simulation service (`repro_torch.simserve`) on
the CPU, against the JAX package's (`repro.simserve`).

* The soak scenario of `tests/test_simserve.py`: 6 tenants over two shape
  keys in 2 slots (queueing and preemption), `round_steps` 15, one tenant
  force-evicted after two rounds and resumed at twice its shard count.
  Each tenant's streamed raster signature and `sat_total` equal the JAX
  `SimService`'s and the JAX solo `StepProgram`'s, and the snapshot's
  counters (rounds, admissions, evictions, resumes, preemptions, queue
  wait, builds and traces per key) equal the JAX snapshot's.  JAX runs in
  an AVX-pinned subprocess (`tests/test_torch_reference.py::start_avx`),
  started with the module.
* The fold itself: a slot at t != 0 beside a slot at t = 0 gives its solo
  run's raster and state (dense and event); the plain versions of the six
  ops that take per-shard steps give, with a t_base of zeros, what they
  give with none, and with per-shard offsets what each shard gives alone;
  a t_base of the wrong shape or device raises.
* The stimulus: two seeds in one group each give their own solo run, and
  drawing a slot's stimulus from the group's spec (seed 0) is caught.
* Zero recapture on refill; evict / resume keeps the raster and `sat`
  (saturated at one layout, and across shard counts); transient and
  permanent group failures; the raster stream's chunked signature and
  CSV; shape keys, negotiation, metrics and the client's errors, as the
  JAX package's tests hold them.
"""
import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (EngineConfig, GridConfig, StepProgram, engine,
                              event_engine, observables)
from repro_torch.kernels import ops
from repro_torch.simserve import (DONE, FAILED, RUNNING, RasterStream,
                                  SimService, TenantRequest, TenantSession,
                                  batcher)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_reference import start_avx, wait_avx  # noqa: E402

CFG = GridConfig(grid_x=2, grid_y=2, neurons_per_column=20,
                 synapses_per_neuron=10)
DENSE = EngineConfig(n_shards=2, delivery="dense")
EVENT = EngineConfig(n_shards=2, delivery="event")
SOAK_SEEDS = (2013, 7, 99, 5, 123456, 42)
SOAK_STEPS, SOAK_ROUND = 60, 15
COUNTERS = ("rounds", "admissions", "evictions", "resumes", "preemptions",
            "queue_wait_rounds", "completed", "submitted", "tenant_steps",
            "group_rounds", "tenant_rounds")


def _soak_requests(TenantRequest, cfg, dense, event):
    return [TenantRequest(f"t{i}", dataclasses.replace(cfg, seed=seed),
                          event if i % 2 else dense, SOAK_STEPS)
            for i, seed in enumerate(SOAK_SEEDS)]


def _soak(svc, reqs):
    """The soak: submit, two rounds, evict the first running tenant, a
    round, resume it at twice its shards, run to the end."""
    for r in reqs:
        svc.submit(r)
    svc.step_round()
    svc.step_round()
    victim = next(s for s in svc.sessions.values() if s.status == RUNNING)
    svc.evict(victim.name)
    svc.step_round()
    svc.resume(victim.name, eng=dataclasses.replace(
        victim.eng, n_shards=victim.eng.n_shards * 2))
    return victim, svc.run()


def _jax_soak() -> dict:
    """Inside the AVX subprocess: the JAX service's soak and every
    tenant's solo run (signature, sat)."""
    import jax  # noqa: F401  (jax starts under the AVX flag)
    from repro.core import distributed as JD, observables as JO
    from repro.core.params import EngineConfig as JE, GridConfig as JG
    from repro.core.step_program import StepProgram as JSP
    from repro.simserve import SimService as JS, TenantRequest as JT
    from repro.simserve import batcher as JB
    cfg = JG(grid_x=2, grid_y=2, neurons_per_column=20,
             synapses_per_neuron=10)
    reqs = _soak_requests(JT, cfg, JE(n_shards=2, delivery="dense"),
                          JE(n_shards=2, delivery="event"))
    svc = JS(slots=2, round_steps=SOAK_ROUND)
    victim, snap = _soak(svc, reqs)
    tenants = {}
    for r in reqs:
        sess = svc.sessions[r.name]
        spec, planT, state = JB.build_parts(r.cfg, sess.eng)
        plan = JD._base_plan(planT)
        eplan = planT[1] if sess.eng.delivery == "event" else None
        prog = JSP.from_parts(spec, plan, eplan, state0=state, mesh=None,
                              caps=None, hier_groups=None)
        st, raster, _ = prog.run(state, 0, r.n_steps)
        tenants[r.name] = dict(
            sig=sess.stream.signature().hex(), sat=sess.sat_total,
            status=sess.status, shards=sess.eng.n_shards,
            solo_sig=JO.raster_signature(np.asarray(raster),
                                         np.asarray(plan.gid)).hex(),
            solo_sat=int(np.asarray(st.sat).sum()) if hasattr(st, "sat")
            else 0)
    return dict(victim=victim.name, tenants=tenants,
                snap={k: snap[k] for k in COUNTERS},
                program_cache=snap["program_cache"])


@pytest.fixture(scope="module", autouse=True)
def _avx_job():
    procs = start_avx(__file__, [["--soak"]])
    yield procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def jax_soak(_avx_job):
    return json.loads(wait_avx(_avx_job)[0].strip().splitlines()[-1])


def _solo(cfg, eng, n_steps, caps=None, cap_ev=None):
    """(signature, sat_total) of the port's solo run."""
    return batcher.solo_run(cfg, eng, n_steps, caps, cap_ev, device="cpu")


def _service(**kw):
    return SimService(device="cpu", **kw)


# -- the soak against the JAX service --------------------------------------


def test_soak_equals_jax_service_and_solo_runs(jax_soak):
    reqs = _soak_requests(TenantRequest, CFG, DENSE, EVENT)
    svc = _service(slots=2, round_steps=SOAK_ROUND)
    victim, snap = _soak(svc, reqs)
    assert victim.name == jax_soak["victim"]
    for r in reqs:
        sess = svc.sessions[r.name]
        want = jax_soak["tenants"][r.name]
        assert sess.status == DONE == want["status"]
        assert sess.eng.n_shards == want["shards"]
        sig = sess.stream.signature().hex()
        assert sig == want["sig"] == want["solo_sig"], r.name
        assert sess.sat_total == want["sat"] == want["solo_sat"], r.name
        solo_sig, solo_sat = _solo(r.cfg, sess.eng, r.n_steps)
        assert (solo_sig.hex(), solo_sat) == (sig, sess.sat_total)
    assert {k: snap[k] for k in COUNTERS} == jax_soak["snap"]
    assert snap["program_cache"] == jax_soak["program_cache"]
    assert snap["program_cache"]["builds"] == 3
    assert all(n == 1 for n in snap["program_cache"]["traces"].values())
    assert snap["preemptions"] > 0 and snap["queue_wait_rounds"] > 0
    assert svc.sessions[victim.name].eng.n_shards == 4


def test_zero_recapture_on_refill():
    """A tenant admitted into an existing group reuses its program: two
    waves into one shape key, one build and one capture."""
    svc = _service(slots=2, round_steps=10)
    svc.submit(TenantRequest("a", dataclasses.replace(CFG, seed=1), DENSE,
                             20))
    svc.submit(TenantRequest("b", dataclasses.replace(CFG, seed=2), DENSE,
                             20))
    svc.step_round()
    prog = next(iter(svc.groups.values())).prog
    svc.submit(TenantRequest("c", dataclasses.replace(CFG, seed=3), DENSE,
                             20))
    snap = svc.run()
    assert all(svc.sessions[n].status == DONE for n in "abc")
    assert snap["program_cache"]["builds"] == 1
    assert snap["program_cache"]["misses"] == 1
    assert sum(snap["program_cache"]["traces"].values()) == 1
    assert next(iter(svc.groups.values())).prog is prog
    for n in "abc":
        sess = svc.sessions[n]
        assert sess.stream.signature() == _solo(sess.request.cfg, DENSE,
                                                20)[0]


def test_regroup_through_the_event_rows_builds_a_fresh_program(monkeypatch):
    """A tenant whose incoming rows outgrow the group's (ki alone grows:
    e_cap and s_cap still fit) regroups; the new program's folded rows are
    as wide as the grown capacities, and both tenants give their solo
    runs.  Negotiation without headroom on the event rows forces it."""
    real = batcher.negotiate

    def tight(realized, cap_ev=None, prior=None):
        g = real(realized, cap_ev=cap_ev, prior=prior)
        kf, ki = realized.kf, realized.ki
        if prior is not None:
            kf, ki = max(kf, prior.kf), max(ki, prior.ki)
        return dataclasses.replace(g, kf=kf, ki=ki)

    monkeypatch.setattr(batcher, "negotiate", tight)
    cfg_a = dataclasses.replace(CFG, seed=2)     # incoming rows of 19
    cfg_b = dataclasses.replace(CFG, seed=12)    # of 21
    svc = _service(slots=2, round_steps=10)
    a = svc.submit(TenantRequest("a", cfg_a, EVENT, 30))
    svc.step_round()
    first = next(iter(svc.groups.values()))
    assert first.caps.ki == 19
    b = svc.submit(TenantRequest("b", cfg_b, EVENT, 30))
    snap = svc.run()
    assert svc.regroups == 1 and a.done and b.done
    group = next(iter(svc.groups.values()))
    assert group.caps == dataclasses.replace(first.caps, ki=21)
    assert group.prog is not first.prog
    assert group.prog.eplan.in_rows.shape[-1] == 21
    assert snap["program_cache"]["misses"] == 2
    assert a.stream.signature() == _solo(cfg_a, EVENT, 30)[0]
    assert b.stream.signature() == _solo(cfg_b, EVENT, 30)[0]


# -- the fold ---------------------------------------------------------------


def _padded(cfg, eng, caps=None):
    """(realized parts, group caps, padded parts) of one tenant."""
    real = batcher.build_parts(cfg, eng, device="cpu")
    gcaps = caps or batcher.negotiate(batcher.measure_caps(*real))
    return real, gcaps, batcher.build_parts(cfg, eng, pad=gcaps,
                                            device="cpu")


@pytest.mark.parametrize("eng", [DENSE, EVENT], ids=["dense", "event"])
def test_folded_slot_at_its_own_t_equals_its_solo_run(eng):
    """Slot 1 resumes tenant B at t = 37 beside tenant A at t = 0 in one
    folded round of 20 steps: B's raster and state are its solo run's
    from 37 (its own plan, padded as the group's, the same bits)."""
    T, R = 37, 20
    cfg_a = dataclasses.replace(CFG, seed=3)
    cfg_b = dataclasses.replace(CFG, seed=8)
    real_a, caps, (spec, plan_a, st_a) = _padded(cfg_a, eng)
    real_b, _, (_, plan_b, st_b) = _padded(cfg_b, eng, caps)
    base = lambda p: batcher.base_plan(p)
    solo = StepProgram.from_parts(
        spec._replace(cfg=cfg_b), base(plan_b), st_b,
        eplan=plan_b[1] if eng.delivery == "event" else None)
    st_t, _, _ = solo.run(st_b, 0, T)
    want_state, want_raster, _ = solo.run(st_t, T, R)

    key = batcher.shape_key(cfg_a, eng)
    prog = batcher.CompiledRound(spec, None, R, 2, plan_a, "cpu")
    group = batcher.BatchGroup(key, prog, 2, caps, plan_a, st_a)
    sessions = []
    for b, (cfg, real, plan, st, t) in enumerate((
            (cfg_a, real_a, plan_a, st_a, 0),
            (cfg_b, real_b, plan_b, st_t, T))):
        sess = TenantSession(TenantRequest(f"s{b}", cfg, eng, T + R), 0)
        sess.t, sess.planT = t, real[1]
        group.install(b, sess, plan, st, 0)
        sessions.append(sess)
    rasters = group.round()
    assert np.array_equal(rasters[1], want_raster.numpy())
    for got, want in zip(engine.state_tensors(group.slot_state(1)),
                         engine.state_tensors(want_state)):
        assert torch.equal(got, want)
    assert prog.traces == 1


def _op_inputs(delivery: str, device="cpu"):
    """A 2x2 plan at H = 2 and its state after 23 steps, for the ops."""
    eng = DENSE if delivery == "dense" else EVENT
    sp = StepProgram(dataclasses.replace(CFG, seed=5), eng, device=device)
    st, _, _ = sp.run(sp.init_state(), 0, 23)
    return sp, st


def _call_op(name: str, sp, st, t, t_base):
    """One op on clones of the program's state at step t (per-shard
    offsets t_base or None) -> its outputs and every state tensor."""
    st = engine.clone_state(st)
    spec, plan = sp.spec, sp.plan
    dev = plan.gid.device
    stdp, izh = spec.stdp, spec.izh
    ltd = dict(a_minus=stdp.a_minus, tau_minus=stdp.tau_minus,
               w_min=stdp.w_min, w_max=stdp.w_max, neg_time=engine.NEG_TIME)
    ltp = dict(a_plus=stdp.a_plus, tau_plus=stdp.tau_plus,
               w_min=stdp.w_min, w_max=stdp.w_max, neg_time=engine.NEG_TIME)
    index, amp = engine.stim_rows(spec, plan, 26, 1)
    stim = (index[0], amp[0])
    gen = torch.Generator().manual_seed(11)
    spiked_src = (torch.rand(plan.src_gid.shape, generator=gen) < 0.2).to(dev)
    if name == "stdp_phase_a":
        seg = engine.kref.make_segments(plan.row_ptr, plan.syn_valid.shape[1])
        out = ops.stdp_phase_a(
            st.arr_ring, t % spec.cfg.n_delay_slots, seg, plan.syn_valid,
            plan.syn_tgt, plan.syn_plastic, plan.exc_mask, plan.neuron_valid,
            *stim, st.v, st.u, st.last_post, st.w, st.last_arr, t, izh=izh,
            stdp=stdp, neg_time=engine.NEG_TIME, with_ltp=True,
            t_base=t_base)
    elif name == "arborize":
        out = (ops.arborize(st.arr_ring, spiked_src,
                            *engine.arborize_tables(plan), t,
                            t_base=t_base),)
    else:
        b = st.base
        c_post, c_src = event_engine.default_caps(spec)
        if name == "event_arrival":
            out = ops.event_arrival(st.ev_ring, st.ev_count, plan.syn_tgt,
                                    plan.row_ptr, plan.syn_plastic,
                                    b.last_post, b.w, b.last_arr, t,
                                    t_base=t_base, **ltd)
        elif name == "event_neurons":
            i_syn = (torch.rand(b.v.shape, generator=gen) * 30.0).to(dev)
            out = ops.event_neurons(i_syn, *stim, plan.exc_mask,
                                    plan.neuron_valid, b.v, b.u, b.last_post,
                                    st.sat, t, izh=izh, c_post=c_post,
                                    t_base=t_base)
        elif name == "event_ltp":
            spiked = (torch.rand(b.v.shape, generator=gen) < 0.3).to(dev)
            ids, _ = event_engine.aer.compact_indices(spiked, c_post,
                                                      fill=b.v.shape[1])
            out = ops.event_ltp(ids.contiguous(), spiked.sum(1),
                                plan.row_ptr, plan.syn_plastic, b.last_arr,
                                b.w, t, t_base=t_base, **ltp)
        else:
            ids, dropped = event_engine.aer.compact_indices(
                spiked_src, c_src, fill=spiked_src.shape[1])
            out = ops.event_emit(ids.contiguous(), dropped, sp.eplan.fwd_rows,
                                 plan.syn_delay, st.ev_ring, st.ev_count,
                                 st.sat, t, t_base=t_base)
    out = () if out is None else out
    return list(out) + engine.state_tensors(st)


OPS = {"stdp_phase_a": "dense", "arborize": "dense",
       "event_arrival": "event", "event_neurons": "event",
       "event_ltp": "event", "event_emit": "event"}


@pytest.mark.parametrize("name", list(OPS))
def test_plain_versions_take_per_shard_steps(name):
    """Each op's plain version: t_base of zeros = none, bit for bit; and
    t = 20 with t_base [4, 9] gives shard 0 what t = 24 gives it and shard
    1 what t = 29 gives it (the rest of each shard's rows untouched by the
    other's step)."""
    sp, st = _op_inputs(OPS[name])
    zeros = torch.zeros(2, dtype=torch.int64)
    plain = _call_op(name, sp, st, 24, None)
    for a, b in zip(plain, _call_op(name, sp, st, 24, zeros)):
        assert torch.equal(a, b)
    mixed = _call_op(name, sp, st, 20, torch.tensor([4, 9]))
    other = _call_op(name, sp, st, 29, None)
    for a, b0, b1 in zip(mixed, plain, other):
        if a.dim() == 0 or a.shape[0] != 2:
            continue
        assert torch.equal(a[0], b0[0]) and torch.equal(a[1], b1[1])


def test_t_base_of_the_wrong_shape_or_device_raises():
    sp, st = _op_inputs("dense")
    with pytest.raises(ValueError, match="per-shard steps"):
        _call_op("arborize", sp, st, 3, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="t_base"):
        _call_op("stdp_phase_a", sp, st, 3, torch.zeros(2))
    with pytest.raises(ValueError, match="int64"):
        engine.kref.arborize(st.arr_ring, torch.zeros(
            sp.plan.src_gid.shape, dtype=torch.bool),
            *engine.arborize_tables(sp.plan)[:3], torch.zeros(3).long())


# -- the stimulus -------------------------------------------------------------


def _two_seed_group(monkeypatch=None):
    svc = _service(slots=2, round_steps=10)
    for name, seed in (("x", 11), ("y", 12)):
        svc.submit(TenantRequest(name, dataclasses.replace(CFG, seed=seed),
                                 DENSE, 30))
    svc.run()
    return svc


def test_each_slot_draws_its_own_stimulus():
    svc = _two_seed_group()
    for name, seed in (("x", 11), ("y", 12)):
        cfg = dataclasses.replace(CFG, seed=seed)
        assert svc.sessions[name].stream.signature() == _solo(cfg, DENSE,
                                                              30)[0]


def test_a_leak_of_the_group_seed_into_a_slot_is_caught(monkeypatch):
    """Drawn from the group's spec (seed 0) instead of the tenant's
    config, the stimulus changes every slot's raster: the contract's
    check sees it."""
    real = engine.stim_rows
    monkeypatch.setattr(engine, "stim_rows",
                        lambda spec, plan, t0, n, cfg=None:
                        real(spec, plan, t0, n))
    svc = _two_seed_group()
    for name, seed in (("x", 11), ("y", 12)):
        cfg = dataclasses.replace(CFG, seed=seed)
        assert svc.sessions[name].stream.signature() != _solo(cfg, DENSE,
                                                              30)[0]


# -- evict / resume -----------------------------------------------------------


@pytest.mark.parametrize("reshard", [False, True], ids=["same_h", "h2_to_4"])
def test_evict_resume_keeps_raster_and_sat(reshard):
    """A tiny event ring saturates (sat > 0): evicted after two rounds and
    resumed at the same layout, the tenant gives its uninterrupted run's
    raster and sat.  Across shard counts (H = 2 -> 4, the default caps,
    sat 0) it keeps the raster and its zero sat."""
    cfg = dataclasses.replace(CFG, seed=11)
    caps, cap_ev = ((None, None) if reshard else ((40, 64), 16))
    n = 60
    want_sig, want_sat = _solo(cfg, EVENT, n, caps=caps, cap_ev=cap_ev)
    assert (want_sat == 0) if reshard else (want_sat > 0)
    svc = _service(slots=2, round_steps=15)
    svc.submit(TenantRequest("sat", cfg, EVENT, n, caps=caps,
                             cap_ev=cap_ev))
    svc.step_round()
    svc.step_round()
    svc.evict("sat")
    svc.step_round()             # a round elapses while parked
    svc.resume("sat", eng=dataclasses.replace(EVENT, n_shards=4)
               if reshard else None)
    svc.run()
    sess = svc.sessions["sat"]
    assert sess.status == DONE and sess.evictions == 1
    assert sess.eng.n_shards == (4 if reshard else 2)
    assert sess.stream.signature() == want_sig
    assert sess.sat_total == want_sat


# -- graceful degradation -------------------------------------------------------


def test_transient_group_failure_recovers_bit_identical():
    svc = _service(slots=2, round_steps=10)
    cfg_b = dataclasses.replace(CFG, seed=11)
    a = svc.submit(TenantRequest("a", CFG, DENSE, n_steps=40))
    b = svc.submit(TenantRequest("b", cfg_b, DENSE, n_steps=40))
    assert svc.step_round()
    group = next(iter(svc.groups.values()))
    real, left = group.prog, {"n": 1}

    def boom(*args, **kw):
        if left["n"]:
            left["n"] -= 1
            raise RuntimeError("injected round failure")
        return real(*args, **kw)

    group.prog = boom
    snap = svc.run()
    assert a.done and b.done
    assert snap["group_failures"] == 1
    assert snap["failure_evictions"] == 2
    assert snap["failed"] == 0
    assert a.failures == 1 and b.failures == 1
    assert a.stream.signature() == _solo(CFG, DENSE, 40)[0]
    assert b.stream.signature() == _solo(cfg_b, DENSE, 40)[0]


def test_permanent_failure_retires_failed_others_unaffected():
    svc = _service(slots=2, round_steps=10, max_tenant_failures=2)
    a = svc.submit(TenantRequest("a", CFG, DENSE, n_steps=40))
    c = svc.submit(TenantRequest("c", CFG, EVENT, n_steps=40))
    assert svc.step_round()
    dense_group = [g for g in svc.groups.values()
                   if svc.sessions["a"] in g.sessions][0]

    class Poison:
        """Delegates everything (snapshots read .traces, installs the
        buffers) but every round raises."""
        def __init__(self, real):
            self._real = real

        def __getattr__(self, k):
            return getattr(self._real, k)

        def __call__(self, *args, **kw):
            raise RuntimeError("permanent failure")

    poisoned = Poison(svc.cache._programs[dense_group.key])
    svc.cache._programs[dense_group.key] = poisoned
    dense_group.prog = poisoned
    snap = svc.run(max_rounds=50)
    assert a.status == FAILED
    assert a.failures == svc.max_tenant_failures + 1
    assert snap["failed"] == 1
    assert snap["group_failures"] == svc.max_tenant_failures + 1
    assert c.done and c.failures == 0
    assert c.stream.signature() == _solo(CFG, EVENT, 40)[0]
    assert a.ckpt_path is not None and os.path.exists(a.ckpt_path)


# -- streaming, keys, metrics, errors -------------------------------------------


def test_raster_stream_chunked_signature_and_csv(tmp_path):
    rng = np.random.default_rng(0)
    raster = rng.random((30, 2, 8)) < 0.2
    gid = np.arange(16).reshape(2, 8)
    full_csv, chunked_csv = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    stream = RasterStream(chunked_csv)
    for t0 in range(0, 30, 7):          # uneven chunks
        stream.push(raster[t0:t0 + 7], gid, t0=t0)
    assert stream.signature() == observables.raster_signature(raster, gid)
    assert stream.n_events == int(raster.sum()) and stream.chunks == 5
    observables.dump_events_csv(full_csv, raster, gid)
    assert open(full_csv).read() == open(chunked_csv).read()


def test_csv_stream_dir(tmp_path):
    svc = SimService(slots=1, round_steps=10, stream_dir=str(tmp_path),
                     device="cpu")
    svc.submit(TenantRequest("x", dataclasses.replace(CFG, seed=4), DENSE,
                             20))
    svc.run()
    lines = open(os.path.join(str(tmp_path), "x.csv")).read().splitlines()
    assert lines[0] == "time_ms,neuron_gid"
    assert len(lines) - 1 == svc.sessions["x"].stream.n_events


def test_shape_keys_and_negotiation():
    a = batcher.shape_key(dataclasses.replace(CFG, seed=1), DENSE)
    assert a == batcher.shape_key(dataclasses.replace(CFG, seed=999), DENSE)
    assert a != batcher.shape_key(CFG, EVENT)
    assert a != batcher.shape_key(CFG, dataclasses.replace(DENSE,
                                                           n_shards=4))
    assert a != batcher.shape_key(CFG, DENSE, caps=(8, 8))
    r = batcher.GroupCaps(e_cap=100, s_cap=50, kf=7, ki=5, cap_ev=64)
    g = batcher.negotiate(r)
    assert g.fits(r) and g.e_cap > r.e_cap and g.kf % 4 == 0
    assert g.e_cap % 16 == 0
    prior = batcher.GroupCaps(e_cap=999, s_cap=1, kf=99, ki=1, cap_ev=0)
    g2 = batcher.negotiate(r, prior=prior)
    assert g2.e_cap >= 999 and g2.kf >= 99 and g2.fits(g)


def test_snapshot_counts():
    svc = _service(slots=1, round_steps=10, preempt=False)
    for name, seed in (("a", 1), ("b", 2)):
        svc.submit(TenantRequest(name, dataclasses.replace(CFG, seed=seed),
                                 DENSE, 20))
    snap = svc.run()
    assert snap["completed"] == 2 and snap["submitted"] == 2
    assert snap["preemptions"] == 0 and snap["tenant_steps"] == 40
    assert svc.sessions["b"].queue_wait_rounds > 0
    assert snap["rounds"] == 4 and snap["tenant_steps_per_s"] > 0
    assert snap["build_s"] > 0


def test_client_errors():
    svc = _service(slots=1, round_steps=10)
    svc.submit(TenantRequest("a", CFG, DENSE, 30))
    with pytest.raises(ValueError):
        svc.submit(TenantRequest("a", CFG, DENSE, 10))
    with pytest.raises(ValueError):
        svc.evict("a")               # still queued, not running
    svc.step_round()
    svc.evict("a")
    with pytest.raises(ValueError):
        svc.resume("a", eng=EVENT)   # the delivery cannot change
    with pytest.raises(ValueError, match="materialized"):
        batcher.build_parts(CFG, dataclasses.replace(
            DENSE, connectivity="streamed:chunk=1"), device="cpu")


def test_the_service_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimService()


if __name__ == "__main__":
    assert sys.argv[1] == "--soak"
    print(json.dumps(_jax_soak()))
