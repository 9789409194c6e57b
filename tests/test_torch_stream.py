"""Streamed connectivity in the port against the JAX package, exactly.

* the streamed half of `core.connectivity` (`parse_mode`,
  `stream_geometry`, `chunk_candidates`, `streamed_shard_keys`) equals
  the reference's;
* the plain chunk regeneration (`kernels.ref.chunk_tables`, what
  `ops.chunk_tables` runs on the CPU and the card's kernel is held
  against) equals the JAX host reference `_chunk_synapses` and the JAX
  in-jit `make_chunk_tables` entry by entry (src gid, target, delay,
  plastic, j) over profiles ring3, `ring:max_ring=1` and a Gaussian, both
  placements, K = 1, 2, 3;
* streamed runs (`StepProgram.run` and `time_phases` over each exchange
  and schedule) give the JAX package's streamed raster and weight
  signatures at H = 1 and 2, both placements and a ragged last chunk, and
  the port's materialized run's;
* a JAX streamed run carried across at t = 20 (`convert.
  streamed_from_jax`) continues bit for bit;
* streamed with event delivery is refused;
* residency: the port's accounting reproduces the reference's (the
  `weak_scaling` grid's ratio 10.4x), and no tensor of a streamed
  program's plan, live tables or regeneration scratch reaches 1/8 of the
  materialized tables.

The chunk tables are integer work, so JAX runs them in this process; the
runs go through the dynamics, so JAX runs them in AVX-pinned subprocesses
(`test_torch_reference.start_avx`), started with the module.
"""
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro_torch.core import (EngineConfig, GridConfig, StepProgram,
                              connectivity, convert, engine, observables)
from repro_torch.core import stream_engine as SE
from repro_torch.core.step_program import check_supported
from repro_torch.dist.mesh import SnnMesh
from repro_torch.kernels import ops, ref

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_reference import start_avx, wait_avx  # noqa: E402

SMALL = dict(grid_x=2, grid_y=3, neurons_per_column=12,
             synapses_per_neuron=8, seed=7)
WIDE = dict(grid_x=2, grid_y=2, neurons_per_column=40,
            synapses_per_neuron=16, seed=7)
STEPS = 40
CARRY_AT = 20
# name -> (grid, shards, placement, chunk): the run cases; SMALL at H=2
# owns 3 columns a shard, so chunk=2 leaves a ragged last chunk
RUNS = {"small-H1-block-K1": (SMALL, 1, "block", 1),
        "small-H2-block-K2": (SMALL, 2, "block", 2),
        "small-H2-scatter-K3": (SMALL, 2, "scatter", 3),
        "wide-H1-block-K1": (WIDE, 1, "block", 1),
        "wide-H2-scatter-K1": (WIDE, 2, "scatter", 1),
        "wide-H2-block-K2": (WIDE, 2, "block", 2)}
# (exchange, shards, placement, chunk) of the time_phases cases, each
# under both schedules
TIMED = [("allgather", 2, "block", 2), ("halo", 2, "scatter", 1),
         ("hier", 2, "block", 1)]
SCHEDULES = ["sync", "pipelined"]
CARRY = ("wide", 2, "block", 2)
PROFILES = ["ring3", "ring:max_ring=1", "gaussian:sigma=1.5"]


def _eng(h, placement, chunk, **kw):
    return dict(n_shards=h, placement=placement,
                connectivity=f"streamed:chunk={chunk}", **kw)


def _summary(sp, raster, state) -> dict:
    raster = np.asarray(raster)
    gid = sp.plan.gid
    gid = gid.cpu().numpy() if isinstance(gid, torch.Tensor) else gid
    return dict(raster_signature=observables.raster_signature(
        raster, np.asarray(gid)).hex(),
        weight_signature=sp.weight_signature(state).hex(),
        spikes_per_step=raster.sum(axis=(1, 2)).astype(int).tolist())


# -- the JAX side, in AVX subprocesses -----------------------------------


def _jax_runs() -> dict:
    """Inside an AVX subprocess: every run case, streamed."""
    import jax  # noqa: F401  (jax starts under the AVX flag)
    from repro.core import EngineConfig as JE, GridConfig as JG
    from repro.core import StepProgram as JSP
    out = {}
    for name, (grid, h, pl, k) in RUNS.items():
        sp = JSP(JG(**grid), JE(**_eng(h, pl, k)))
        state, raster, _ = sp.run(sp.init_state(), 0, STEPS)
        out[name] = _summary(sp, raster, state)
    return out


def _jax_timed() -> dict:
    """Inside an AVX subprocess: JAX's streamed time_phases per case."""
    import jax  # noqa: F401
    from repro.core import EngineConfig as JE, GridConfig as JG
    from repro.core import StepProgram as JSP
    out = {}
    for ex, h, pl, k in TIMED:
        for sched in SCHEDULES:
            sp = JSP(JG(**WIDE), JE(**_eng(h, pl, k, exchange=ex,
                                         exchange_schedule=sched)),
                     hier_groups=2)
            state, _, rasters, _ = sp.time_phases(
                sp.init_state(), 0, STEPS, collect_rasters=True)
            out[f"{ex}-{h}-{pl}-{k}-{sched}"] = _summary(
                sp, np.stack(rasters), state)
    return out


def _jax_carry(path: str) -> dict:
    """Inside an AVX subprocess: a streamed JAX run stopped at CARRY_AT
    (its plan, streamed plan and state saved to `path`) and run whole."""
    import jax  # noqa: F401
    from repro.core import EngineConfig as JE, GridConfig as JG
    from repro.core import StepProgram as JSP
    _, h, pl, k = CARRY
    sp = JSP(JG(**WIDE), JE(**_eng(h, pl, k)))
    state, raster, _ = sp.run(sp.init_state(), 0, STEPS)
    mid, _, _ = sp.run(sp.init_state(), 0, CARRY_AT)
    arrays = {f"plan.{k}": np.asarray(v) for k, v in sp.plan._asdict().items()}
    arrays.update({f"splan.{k}": np.asarray(v)
                   for k, v in sp.splan._asdict().items()})
    arrays.update({f"state.{k}": np.asarray(v)
                   for k, v in mid._asdict().items()})
    np.savez(path, raster=np.asarray(raster), **arrays)
    return _summary(sp, raster, state)


@pytest.fixture(scope="module", autouse=True)
def _avx_jobs(tmp_path_factory):
    carry = tmp_path_factory.mktemp("carry") / "carry.npz"
    procs = start_avx(__file__, [["--runs"], ["--timed"],
                                 ["--carry", carry]])
    yield procs, carry
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def jax_ref(_avx_jobs):
    procs, carry = _avx_jobs
    runs, timed, whole = (json.loads(out.strip().splitlines()[-1])
                          for out in wait_avx(procs))
    return dict(runs=runs, timed=timed, carry=whole,
                carry_arrays=dict(np.load(carry)))


# -- the streamed half of connectivity -----------------------------------


SPECS_OK = ["materialized", "streamed", "streamed:chunk=3",
            " streamed:chunk=2 ", "streamed:chunk=1,"]
SPECS_BAD = ["dense", "streamed:chunk=0", "streamed:rows=2", "streamed:chunk",
             "streamedx:chunk=1"]


@pytest.mark.parametrize("spec", SPECS_OK + SPECS_BAD)
def test_parse_mode_as_reference(spec):
    from repro.core import connectivity as jc

    def outcome(fn):
        try:
            return fn(spec)
        except ValueError:
            return "ValueError"
    assert outcome(connectivity.parse_mode) == outcome(jc.parse_mode)
    assert (outcome(connectivity.parse_mode) == "ValueError") == (
        spec in SPECS_BAD)


@pytest.mark.parametrize("h,placement,chunk", [(1, "block", 1),
                                               (2, "block", 2),
                                               (3, "scatter", 2),
                                               (2, "scatter", 3)])
def test_geometry_candidates_and_keys_as_reference(h, placement, chunk):
    from repro.core import EngineConfig as JE, GridConfig as JG
    from repro.core import connectivity as jc
    cfg, jcfg = GridConfig(**SMALL), JG(**SMALL)
    eng = EngineConfig(n_shards=h, placement=placement)
    jeng = JE(n_shards=h, placement=placement)
    geo = connectivity.stream_geometry(cfg, eng, chunk)
    assert geo == jc.stream_geometry(jcfg, jeng, chunk)
    _, q, n_chunks = geo
    for shard in range(h):
        for c in range(n_chunks):
            np.testing.assert_array_equal(
                connectivity.chunk_candidates(cfg, eng, shard, c * q,
                                              (c + 1) * q),
                jc.chunk_candidates(jcfg, jeng, shard, c * q, (c + 1) * q))
        for a, b in zip(connectivity.streamed_shard_keys(cfg, eng, shard,
                                                         chunk),
                        jc.streamed_shard_keys(jcfg, jeng, shard, chunk)):
            np.testing.assert_array_equal(a, b)


# -- chunk regeneration ---------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 2, 3])
@pytest.mark.parametrize("placement", ["block", "scatter"])
@pytest.mark.parametrize("profile", PROFILES)
def test_plain_chunk_tables_equal_jax(profile, placement, chunk):
    from repro.core import EngineConfig as JE, GridConfig as JG
    from repro.core import connectivity as jc
    from repro.core import stream_engine as JSE
    grid = dict(SMALL, connectivity=profile)
    eng = _eng(2, placement, chunk)
    spec, plan, splan, _ = SE.build(GridConfig(**grid), EngineConfig(**eng),
                                    device="cpu")
    jspec, jplan, jsplan, _ = JSE.build(JG(**grid), JE(**eng))
    # the reference's geometry, then the port's longest row of any chunk
    assert spec.stream[:len(jspec.stream)] == tuple(jspec.stream)
    longest = 0
    np.testing.assert_array_equal(splan.cand.numpy(), np.asarray(jsplan.cand))
    np.testing.assert_array_equal(splan.e_start.numpy(),
                                  np.asarray(jsplan.e_start))
    source = SE.chunk_source(spec, plan, splan)
    ss, K = spec.stream, SE.live_width(splan)
    src_table = plan.src_gid.numpy()
    for h in range(2):
        jgen = jax.jit(JSE.make_chunk_tables(
            jspec, jax.tree_util.tree_map(lambda a: a[h], jplan)),
            static_argnums=2)
        for c in range(ss.n_chunks):
            tb, j = ref.chunk_tables(source, c, K, with_j=True)
            lo = c * ss.q
            rp = tb.row_ptr[h].numpy().astype(np.int64)
            longest = max(longest, int(np.diff(rp).max()))
            e = int(rp[-1] - rp[0])
            assert rp[0] == int(splan.e_start[h, c])
            rows = np.repeat(np.arange(ss.q), np.diff(rp))
            sidx = splan.cand[h, c].numpy()
            host = jc._chunk_synapses(
                GridConfig(**grid), EngineConfig(**eng), h,
                src_table[h][sidx[sidx >= 0]].astype(np.int64), lo,
                lo + ss.q)
            jt = jgen(c, jsplan.cand[h][c], True)
            src = src_table[h][tb.src[h, :e].numpy()]
            for want_src, want_tgt, want_d, want_p, want_j in (
                    (host.src_gid, host.tgt_local, host.delay, host.plastic,
                     host.j),
                    (src_table[h][np.asarray(jt.src)[:e]],
                     np.asarray(jt.tgt_rel)[:e] + lo,
                     np.asarray(jt.delay)[:e], np.asarray(jt.plastic)[:e],
                     np.asarray(jt.j)[:e])):
                np.testing.assert_array_equal(src, want_src)
                np.testing.assert_array_equal(rows + lo, want_tgt)
                np.testing.assert_array_equal(tb.delay[h, :e].numpy(),
                                              want_d)
                np.testing.assert_array_equal(tb.plastic[h, :e].numpy(),
                                              want_p)
                np.testing.assert_array_equal(j[h, :e].numpy(), want_j)
            assert not tb.src[h, e:].any() and not tb.plastic[h, e:].any()
    assert ss.row_cap == longest


@pytest.mark.parametrize("chunk", [1, 2])
def test_plain_chunk_tables_of_a_scatter_block_equal_jax(chunk):
    """A block of scatter rows (shards 2-3 of 4, as a rank of two holds
    them) regenerates its own shards' chunks from the plan's shard ids:
    those rows of the all-shard call, and JAX's `make_chunk_tables` of
    each of the two shards."""
    from repro.core import EngineConfig as JE, GridConfig as JG
    from repro.core import stream_engine as JSE
    eng = _eng(4, "scatter", chunk)
    spec, plan, splan, _ = SE.build(GridConfig(**WIDE), EngineConfig(**eng),
                                    device="cpu")
    jspec, jplan, jsplan, _ = JSE.build(JG(**WIDE), JE(**eng))
    ss, K = spec.stream, SE.live_width(splan)
    rows = [2, 3]
    full = SE.chunk_source(spec, plan, splan)
    block = SE.make_chunk_source(
        spec.cfg, spec.eng, ss.q, plan.src_gid[rows], splan.cand[rows],
        splan.e_start[rows], ss.row_cap, shard_id=plan.shard_id[rows])
    assert block.shard_id.tolist() == rows
    for c in range(ss.n_chunks):
        got = ref.chunk_tables(block, c, K)
        want = ref.chunk_tables(full, c, K)
        for a, b in zip(got, want):
            assert torch.equal(a, b[rows])
    src_table = plan.src_gid.numpy()
    for i, h in enumerate(rows):
        jgen = jax.jit(JSE.make_chunk_tables(
            jspec, jax.tree_util.tree_map(lambda a: a[h], jplan)),
            static_argnums=2)
        for c in range(ss.n_chunks):
            tb = ref.chunk_tables(block, c, K)
            rp = tb.row_ptr[i].numpy().astype(np.int64)
            e = int(rp[-1] - rp[0])
            jt = jgen(c, jsplan.cand[h][c], True)
            np.testing.assert_array_equal(
                src_table[h][tb.src[i, :e].numpy()],
                src_table[h][np.asarray(jt.src)[:e]])
            np.testing.assert_array_equal(
                np.repeat(np.arange(ss.q), np.diff(rp)) + c * ss.q,
                np.asarray(jt.tgt_rel)[:e] + c * ss.q)
            np.testing.assert_array_equal(tb.delay[i, :e].numpy(),
                                          np.asarray(jt.delay)[:e])
            np.testing.assert_array_equal(tb.plastic[i, :e].numpy(),
                                          np.asarray(jt.plastic)[:e])


def test_plain_chunk_tables_refuse_a_wrong_plan():
    spec, plan, splan, _ = SE.build(GridConfig(**SMALL),
                                    EngineConfig(**_eng(1, "block", 1)),
                                    device="cpu")
    source = SE.chunk_source(spec, plan, splan)
    bad = source._replace(e_start=source.e_start + torch.tensor([[0, 1] + [
        1] * (spec.stream.n_chunks - 1)], dtype=torch.int32))
    with pytest.raises(ValueError, match="kept"):
        ref.chunk_tables(bad, 0, SE.live_width(splan))
    with pytest.raises(ValueError, match="at most"):
        ref.chunk_tables(source, 0, 1)


@pytest.mark.parametrize("placement", ["block", "scatter"])
def test_plain_chunk_tables_refuse_a_short_row_cap(placement):
    """The plan's row_cap is the longest target row of any chunk: the
    chunk that holds that row is refused under a row_cap one shorter,
    as the kernel flags it."""
    spec, plan, splan, _ = SE.build(GridConfig(**SMALL),
                                    EngineConfig(**_eng(2, placement, 1)),
                                    device="cpu")
    source = SE.chunk_source(spec, plan, splan)
    K, cap = SE.live_width(splan), spec.stream.row_cap
    longest = [int(ref.chunk_tables(source, c, K).row_ptr.diff(dim=1).max())
               for c in range(spec.stream.n_chunks)]
    assert max(longest) == cap
    short = source._replace(geom=source.geom._replace(row_cap=cap - 1))
    with pytest.raises(ValueError, match="a row of"):
        ref.chunk_tables(short, longest.index(cap), K)


def test_limb_splitmix_equals_numpy():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2 ** 63, 4096, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, 4096, dtype=np.uint64)
    x[:4] = [0, 1, 2 ** 64 - 1, 2 ** 63]
    want = connectivity.splitmix64(x)
    h = torch.from_numpy((x >> np.uint64(32)).astype(np.int64))
    l = torch.from_numpy((x & np.uint64(0xFFFFFFFF)).astype(np.int64))
    gh, gl = ref.splitmix64_limbs(h, l)
    got = (gh.numpy().astype(np.uint64) << np.uint64(32)) | gl.numpy(
    ).astype(np.uint64)
    np.testing.assert_array_equal(got, want)
    m = torch.tensor([1, 2, 7, 1000, 65535])
    for k in range(5):
        np.testing.assert_array_equal(
            ref._mod64(gh, gl, m[k]).numpy().astype(np.uint64),
            want % np.uint64(int(m[k])))


# -- runs ----------------------------------------------------------------


_port_runs = {}


def _port(grid, h, placement, chunk, streamed=True):
    key = json.dumps([grid, h, placement, chunk, streamed])
    if key not in _port_runs:
        eng = _eng(h, placement, chunk) if streamed else dict(
            n_shards=h, placement=placement)
        sp = StepProgram(GridConfig(**grid), EngineConfig(**eng),
                         device="cpu")
        state, raster, tm = sp.run(sp.init_state(), 0, STEPS)
        out = _summary(sp, raster.numpy(), state)
        out["tm_spikes"] = int(tm.spikes.sum())
        _port_runs[key] = out
    return _port_runs[key]


def _same(got, want):
    assert got["spikes_per_step"] == want["spikes_per_step"]
    assert got["raster_signature"] == want["raster_signature"]
    assert got["weight_signature"] == want["weight_signature"]


@pytest.mark.parametrize("name", list(RUNS))
def test_streamed_run_equals_jax_and_materialized(jax_ref, name):
    got = _port(*RUNS[name])
    _same(got, jax_ref["runs"][name])
    assert got["tm_spikes"] == sum(got["spikes_per_step"]) > 0
    _same(got, _port(*RUNS[name], streamed=False))


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("exchange,h,placement,chunk", TIMED)
def test_streamed_time_phases_equal_jax(jax_ref, exchange, h, placement,
                                        chunk, schedule):
    sp = StepProgram(GridConfig(**WIDE), EngineConfig(**_eng(
        h, placement, chunk, exchange=exchange, exchange_schedule=schedule)),
        device="cpu", hier_groups=2)
    s0 = sp.init_state()
    before = [x.clone() for x in s0]
    state, _, rasters, counts = sp.time_phases(s0, 0, STEPS,
                                               collect_rasters=True)
    got = _summary(sp, np.stack(rasters), state)
    _same(got, jax_ref["timed"][f"{exchange}-{h}-{placement}-{chunk}-"
                                f"{schedule}"])
    assert counts["spikes"] == sum(got["spikes_per_step"])
    assert all(torch.equal(a, b) for a, b in zip(before, s0))


def test_streamed_state_carried_across_from_jax(jax_ref):
    z = jax_ref["carry_arrays"]
    fields = lambda prefix: SimpleNamespace(**{
        k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)})
    plan, splan, state = convert.streamed_from_jax(
        fields("plan."), fields("splan."), fields("state."), "cpu")
    _, h, pl, k = CARRY
    spec = StepProgram(GridConfig(**WIDE), EngineConfig(**_eng(h, pl, k)),
                       device="cpu").spec
    sp = StepProgram.from_parts(spec, plan, splan=splan)
    state, raster, _ = sp.run(state, CARRY_AT, STEPS - CARRY_AT)
    assert np.array_equal(raster.numpy(), z["raster"][CARRY_AT:])
    assert (sp.weight_signature(state).hex()
            == jax_ref["carry"]["weight_signature"])


def test_streamed_event_delivery_refused():
    eng = EngineConfig(delivery="event", connectivity="streamed:chunk=1")
    with pytest.raises(ValueError, match="dense"):
        check_supported(eng)
    with pytest.raises(ValueError, match="dense"):
        StepProgram(GridConfig(**SMALL), eng, device="cpu")
    with pytest.raises(ValueError, match="dense"):
        SE.build(GridConfig(**SMALL), eng, device="cpu")
    # over a mesh streamed connectivity runs (its ranks:
    # tests/test_torch_mesh.py), but not with event delivery either
    mesh = SnnMesh(n_shards=1, world=1, rank=0, device=torch.device("cpu"),
                   wire=None, backend="gloo")
    check_supported(EngineConfig(connectivity="streamed:chunk=1"), mesh=mesh)
    with pytest.raises(ValueError, match="dense"):
        check_supported(eng, mesh=mesh)


def test_streamed_program_needs_its_plan():
    sp = StepProgram(GridConfig(**SMALL), EngineConfig(**_eng(1, "block", 1)),
                     device="cpu")
    with pytest.raises(ValueError, match="StreamedPlan"):
        StepProgram.from_parts(sp.spec, sp.plan)


def test_streamed_ops_count_no_launch_on_the_cpu():
    ops.reset_launch_counts()
    _port(SMALL, 1, "block", 1)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


# -- residency -------------------------------------------------------------


def test_residency_accounting_equals_reference():
    from repro.core import EngineConfig as JE, GridConfig as JG
    from repro.core import engine as JENG
    from repro.core import stream_engine as JSE
    grid = dict(grid_x=10, grid_y=10, neurons_per_column=30,
                synapses_per_neuron=100, seed=2013,
                connectivity="ring:max_ring=1")
    eng = dict(n_shards=1, connectivity="streamed:chunk=1")
    spec, _, splan, _ = SE.build(GridConfig(**grid), EngineConfig(**eng),
                                 device="cpu")
    jspec = JSE.build(JG(**grid), JE(**eng))[0]
    e_cap = engine.build(GridConfig(**grid), EngineConfig(n_shards=1),
                         device="cpu")[0].e_cap
    assert e_cap == JENG.build(JG(**grid), JE(n_shards=1))[0].e_cap
    for name in ("chunk_table_bytes", "metadata_bytes",
                 "streamed_table_bytes"):
        assert getattr(SE, name)(spec) == getattr(JSE, name)(jspec)
    assert (SE.materialized_table_bytes(e_cap)
            == JSE.materialized_table_bytes(e_cap))
    ratio = SE.materialized_table_bytes(e_cap) / SE.streamed_table_bytes(spec)
    assert int(ratio * 10) == 104
    assert SE.live_table_bytes(spec, splan) < SE.streamed_table_bytes(spec)


def test_streamed_tensors_are_chunk_sized():
    """No tensor of the plan, the streamed plan, the live chunk tables, the
    regeneration's inputs or its scratch reaches 1/8 of the materialized
    tables (8x8, 20 neurons a column, M = 60, ring:max_ring=1); only the
    synapse state is O(E)."""
    grid = GridConfig(grid_x=8, grid_y=8, neurons_per_column=20,
                      synapses_per_neuron=60, seed=7,
                      connectivity="ring:max_ring=1")
    sp = StepProgram(grid, EngineConfig(n_shards=1,
                                        connectivity="streamed:chunk=1"),
                     device="cpu")
    e_cap = engine.build(grid, EngineConfig(n_shards=1),
                         device="cpu")[0].e_cap
    budget = SE.materialized_table_bytes(e_cap) / 8
    chunks = SE.ChunkStream(sp.spec, sp.plan, sp.splan)
    tensors = (list(sp.plan) + list(sp.splan) + list(chunks.tables)
               + [x for x in chunks.source if isinstance(x, torch.Tensor)])
    for x in tensors:
        assert x.numel() * x.element_size() < budget, (x.shape, x.dtype)
    assert SE.live_table_bytes(sp.spec, sp.splan) < budget


if __name__ == "__main__":
    if sys.argv[1] == "--runs":
        print(json.dumps(_jax_runs()))
    elif sys.argv[1] == "--timed":
        print(json.dumps(_jax_timed()))
    else:
        assert sys.argv[1] == "--carry"
        print(json.dumps(_jax_carry(sys.argv[2])))
