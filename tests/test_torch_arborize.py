"""Phase B's forward CSR, and delay rings longer than the emission kernel's
16-slot group, against the JAX package.

* The plan's forward CSR (`core.engine.make_fwd_csr`: fwd_ptr, fwd_ids,
  fwd_delay, which the card's source-major `arborize` kernel walks), on
  SMALL (2x2, 60 neurons a column, 24 synapses, seed 9: the JAX tests'
  `tests/test_step_program.py` size) and LONG (1x1, 300 neurons, 200
  synapses, seed 5: rows of ~200 synapses), at H = 1, 2 and 4, block and
  scatter: each valid synapse listed once, in the row of its syn_src,
  ascending, its delay beside it; the rows equal the JAX package's
  `EventPlan.fwd_rows` with the pads removed.  A plan whose CSR would
  break this is refused at build.
* A numpy walk of the CSR, and a numpy model of the kernel (the sample
  that picks its walk; source-major: blocks of 32 sources, the spiking
  ones compacted in source order, each entry's row found by the kernel's
  binary search of the block's offsets; element-major; the slot by its
  32-bit arithmetic), set the same ring as the JAX package's `phase_b`,
  at no, 2.15%, 10.75% and 21.5% of the sources spiking (both walks), at
  t = -1 and at wrapping t.  Boolean and integer work: JAX runs in this
  process.
* At delay_max = 20 (D = 21 ring slots; the emission kernel scans 16 a
  pass): the plain `event_emit` against the JAX event backend's emission
  (a wrapping t, t = -1, a ring that overflows, c_src that drops), and
  120-step 1x1 event and dense runs against the JAX runs in raster and
  weight signature.  JAX runs in AVX-pinned subprocesses
  (`test_torch_reference.start_avx`), started with the module.
"""
import functools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (EngineConfig, GridConfig, StepProgram,
                              engine, event_engine, observables)
from repro_torch.kernels import arborize as kab

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_event import _seeded_event_state  # noqa: E402
from test_torch_reference import (jax_event_summary,  # noqa: E402
                                  jax_run_summary, start_avx, wait_avx)

SMALL = dict(grid_x=2, grid_y=2, neurons_per_column=60, synapses_per_neuron=24,
             seed=9)
LONG = dict(grid_x=1, grid_y=1, neurons_per_column=300,
            synapses_per_neuron=200, seed=5)
CONFIGS = {"SMALL": SMALL, "LONG": LONG}
LAYOUTS = {"h1_block": (1, "block"), "h2_block": (2, "block"),
           "h2_scatter": (2, "scatter"), "h4_block": (4, "block"),
           "h4_scatter": (4, "scatter")}
# the walk: (config, shards, placement)
WALKS = {"small_h1": ("SMALL", 1, "block"),
         "small_h4_scatter": ("SMALL", 4, "scatter"),
         "long_h1": ("LONG", 1, "block")}
ROW_SOURCES = 32      # csrc/arborize.cu::kRowSources: sources a block
# D = 21 ring slots
D21 = dict(grid_x=1, grid_y=1, neurons_per_column=100,
           synapses_per_neuron=40, delay_max=20, seed=3)
D21_STEPS = 120
# emission at D = 21: (t, share of the sources spiking, ring cap, c_src)
EMIT21 = {"wrap": (1003, 0.3, None, None), "prologue": (-1, 0.2, None, None),
          "overflow": (1004, 0.6, 64, None), "c_src": (1005, 0.5, None, 16)}


# ----------------------------------------------------------------------------
# the JAX side (inside AVX subprocesses)
# ----------------------------------------------------------------------------


def _jax_emit21(path: str) -> dict:
    """The JAX event backend's emission on numpy-seeded states of D21's
    plan (its tables, inputs and outputs saved to `path`)."""
    import jax
    import jax.numpy as jnp
    from repro.core import EngineConfig as JE, GridConfig as JG
    from repro.core import event_engine as EV
    spec, plan, eplan, state = EV.build(JG(**D21), JE(delivery="event"))
    one = lambda tree: jax.tree.map(lambda x: x[0], tree)
    p1, ep1, s1 = one(plan), one(eplan), one(state)
    valid = np.asarray(p1.syn_valid)
    D, S = spec.cfg.n_delay_slots, np.asarray(p1.src_gid).shape[0]
    rng = np.random.default_rng(29)
    arrays = {"plan.fwd_rows": np.asarray(ep1.fwd_rows),
              "plan.syn_delay": np.asarray(p1.syn_delay)}
    for label, (t, share, cap, c_src) in EMIT21.items():
        d = _seeded_event_state(rng, s1, valid, t + 1, 0.02, D,
                                cap or int(s1.ev_ring.shape[-1]))
        d.pop("exc")
        src = rng.random(S) < share
        arrays[f"{label}.spiked_src"] = src
        for k in ("ev_ring", "ev_count"):
            arrays[f"{label}.in.{k}"] = d[k]
        st = s1._replace(ev_ring=jnp.asarray(d["ev_ring"]),
                         ev_count=jnp.asarray(d["ev_count"]))
        out = jax.jit(lambda s, ss, t: EV.phase_b(
            spec, p1, ep1, s, ss, t, c_src=c_src))(
            st, jnp.asarray(src), jnp.int32(t))
        for k in ("ev_ring", "ev_count", "sat"):
            arrays[f"{label}.out.{k}"] = np.asarray(getattr(out, k))
    np.savez(path, **arrays)
    return {}


def _jax_runs21() -> dict:
    return {"dense": jax_run_summary(D21, dict(n_shards=1), D21_STEPS),
            "event": jax_event_summary(D21, dict(n_shards=1), D21_STEPS)}


@pytest.fixture(scope="module", autouse=True)
def _avx_jobs(tmp_path_factory):
    """Start the JAX side with the module, so the port's own work overlaps
    it."""
    emit = tmp_path_factory.mktemp("d21") / "emit.npz"
    procs = start_avx(__file__, [["--emit21", emit], ["--runs21"]])
    yield procs, emit
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def jax_d21(_avx_jobs):
    procs, emit = _avx_jobs
    outs = wait_avx(procs)
    return dict(emit=dict(np.load(emit)),
                runs=json.loads(outs[1].strip().splitlines()[-1]))


# ----------------------------------------------------------------------------
# the forward CSR
# ----------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _port_plan(cfg: str, h: int, placement: str):
    _, plan, _ = engine.build(GridConfig(**CONFIGS[cfg]), EngineConfig(
        n_shards=h, placement=placement), device="cpu")
    return plan


@functools.lru_cache(maxsize=None)
def _jax_fwd_rows(cfg: str, h: int, placement: str) -> np.ndarray:
    from repro.core import EngineConfig as JE, GridConfig as JG
    from repro.core import event_engine as EV
    _, _, eplan, _ = EV.build(JG(**CONFIGS[cfg]), JE(
        n_shards=h, placement=placement, delivery="event"))
    return np.asarray(eplan.fwd_rows)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_forward_csr_lists_each_valid_synapse_once(cfg, layout):
    h, placement = LAYOUTS[layout]
    plan = _port_plan(cfg, h, placement)
    ptr, ids, delay = (x.numpy() for x in (plan.fwd_ptr, plan.fwd_ids,
                                           plan.fwd_delay))
    src, valid = plan.syn_src.numpy(), plan.syn_valid.numpy()
    syn_delay = plan.syn_delay.numpy()
    H, E = valid.shape
    S = plan.src_gid.shape[1]
    assert ptr.dtype == ids.dtype == delay.dtype == np.int32
    assert ptr.shape == (H, S + 1) and ids.shape == delay.shape == (H, E)
    fwd_rows = _jax_fwd_rows(cfg, h, placement)
    assert fwd_rows.shape[:2] == (H, S)
    for hh in range(H):
        n = int(valid[hh].sum())
        assert ptr[hh, 0] == 0 and ptr[hh, -1] == n
        assert np.all(np.diff(ptr[hh]) >= 0)
        listed = ids[hh, :n].astype(np.int64)
        assert np.all(ids[hh, n:] == -1) and np.all(delay[hh, n:] == 0)
        assert np.array_equal(np.sort(listed), np.flatnonzero(valid[hh]))
        rows = np.repeat(np.arange(S), np.diff(ptr[hh]))
        assert np.array_equal(src[hh, listed], rows)
        assert np.all(np.diff(listed)[np.diff(rows) == 0] > 0)
        assert np.array_equal(delay[hh, :n], syn_delay[hh, listed])
        # the JAX event plan's padded rows, flattened without their pads
        jrows = fwd_rows[hh]
        assert np.array_equal(np.diff(ptr[hh]), (jrows >= 0).sum(1))
        assert np.array_equal(listed, jrows[jrows >= 0])
    if h == 1:      # LONG's rows: about 200 synapses a source
        assert int(np.diff(ptr, axis=1).max()) > (150 if cfg == "LONG"
                                                  else 10)


def test_forward_csr_refuses_a_plan_it_cannot_list():
    plan = _port_plan("SMALL", 1, "block")
    src, valid = plan.syn_src.numpy().copy(), plan.syn_valid.numpy()
    delay, S = plan.syn_delay.numpy(), plan.src_gid.shape[1]
    e = int(np.flatnonzero(valid[0])[5])
    for bad in (S, -1):
        src[0, e] = bad
        with pytest.raises(ValueError, match="source"):
            engine.make_fwd_csr(src, valid, delay, S)


# ----------------------------------------------------------------------------
# the walk against JAX phase_b
# ----------------------------------------------------------------------------


def _ring_slot(delay: np.ndarray, t: int, D: int) -> np.ndarray:
    """The kernels' slot: delay mod D as C's `%` (then made >= 0), plus
    t mod D, less D once: the floor mod of (t + delay)."""
    m = np.fmod(delay.astype(np.int32), np.int32(D))
    m = np.where(m < 0, m + D, m) + t % D
    return np.where(m >= D, m - D, m)


def _csr_walk(ring, spiked, ptr, ids, delay, t):
    """The rows of the sources that spiked, one after another."""
    out = ring.copy()
    D = ring.shape[1]
    for h in range(ring.shape[0]):
        for s in np.flatnonzero(spiked[h]):
            j = np.arange(ptr[h, s], ptr[h, s + 1])
            out[h, np.mod(delay[h, j] + t, D), ids[h, j]] = True
    return out


def _kernel_walk(ring, spiked, tables, t):
    """A numpy model of `csrc/arborize.cu::arborize_rows` -> (ring, walked
    element-major?).  Every block counts the same sample of SAMPLE spike
    flags (sources k * S // SAMPLE); from DENSE_PERCENT of them spiking it
    walks every synapse, else a block of ROW_SOURCES sources lists its
    spiking ones in source order (the ballots), places their rows at the
    exclusive sum of their lengths, and entry f of the block's list finds
    its row by the kernel's binary search (the last listed row whose
    offset is <= f)."""
    src, syn_delay, valid, ptr, ids, delay = tables
    out = ring.copy()
    H, D, _ = ring.shape
    S = spiked.shape[1]
    sample = spiked[:, np.arange(kab.SAMPLE) * S // kab.SAMPLE].sum(1)
    dense = sample * 100 >= kab.DENSE_PERCENT * kab.SAMPLE
    for h in range(H):
        if dense[h]:
            e = np.flatnonzero(valid[h] & spiked[h, src[h]])
            out[h, _ring_slot(syn_delay[h, e], t, D), e] = True
            continue
        for b0 in range(0, S, ROW_SOURCES):
            rows = b0 + np.flatnonzero(spiked[h, b0:b0 + ROW_SOURCES])
            first = ptr[h, rows].astype(np.int64)
            length = ptr[h, rows + 1] - first
            offset = np.cumsum(length) - length
            f = np.arange(int(length.sum()))
            lo, hi = np.zeros_like(f), np.full_like(f, rows.size - 1)
            while np.any(lo < hi):
                mid = (lo + hi + 1) >> 1
                le = offset[np.minimum(mid, rows.size - 1)] <= f
                lo, hi = (np.where((lo < hi) & le, mid, lo),
                          np.where((lo < hi) & ~le, mid - 1, hi))
            j = first[lo] + f - offset[lo]
            out[h, _ring_slot(delay[h, j], t, D), ids[h, j]] = True
    assert list(dense) == kab.walks_elements(torch.from_numpy(spiked))
    return out, bool(dense.any())


@functools.lru_cache(maxsize=None)
def _jax_program(cfg: str, h: int, placement: str):
    from repro.core import EngineConfig as JE, GridConfig as JG
    from repro.core import StepProgram as JSP
    return JSP(JG(**CONFIGS[cfg]), JE(n_shards=h, placement=placement))


@pytest.mark.parametrize("t", [-1, 4, 1003])
@pytest.mark.parametrize("density", [0.0, 0.0215, 0.1075, 0.215])
@pytest.mark.parametrize("case", list(WALKS))
def test_csr_walk_equals_jax_phase_b(case, density, t):
    import jax.numpy as jnp
    cfg, h, placement = WALKS[case]
    jsp, plan = _jax_program(cfg, h, placement), _port_plan(cfg, h,
                                                             placement)
    H, E = plan.syn_valid.shape
    D = CONFIGS[cfg].get("delay_max", 5) + 1
    rng = np.random.default_rng(t + 40 + int(1000 * density))
    ring = (rng.random((H, D, E)) < 0.01) & plan.syn_valid.numpy()[:, None]
    spiked = rng.random(tuple(plan.src_gid.shape)) < density
    jstate = jsp.init_state()._replace(arr_ring=jnp.asarray(ring))
    want = np.asarray(jsp.phase_fns().phase_b(jstate, jnp.asarray(spiked),
                                              t).arr_ring)
    tables = tuple(x.numpy() for x in engine.arborize_tables(plan))
    assert np.array_equal(_csr_walk(ring, spiked, *tables[3:], t), want)
    got, dense = _kernel_walk(ring, spiked, tables, t)
    assert np.array_equal(got, want)
    assert dense == (density > 0.18)      # the sample decides
    if density == 0.0:
        assert np.array_equal(want, ring)            # all-False: a no-op
    else:
        assert want.sum() > ring.sum()


# ----------------------------------------------------------------------------
# D = 21 ring slots
# ----------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _d21_program(delivery: str) -> StepProgram:
    sp = StepProgram(GridConfig(**D21), EngineConfig(delivery=delivery),
                     device="cpu")
    if delivery == "event":
        state0 = event_engine.init_event_state(
            sp.spec, sp.init_state().base, sp.spec.e_cap)
        sp = StepProgram.from_parts(sp.spec, sp.plan, state0, eplan=sp.eplan,
                                    caps=event_engine.no_drop_caps(sp.spec))
    return sp


@pytest.mark.parametrize("case", list(EMIT21))
def test_event_emit_plain_equals_jax_at_21_slots(jax_d21, case):
    """The port's event phase B on the CPU (compaction, then the plain
    `event_emit`) against the JAX event backend's emission at D = 21,
    from the same seeded ring and spikes: ring, counts and sat."""
    z = jax_d21["emit"]
    sp = _d21_program("event")
    assert sp.spec.cfg.n_delay_slots == 21
    assert np.array_equal(sp.eplan.fwd_rows[0].numpy(), z["plan.fwd_rows"])
    assert np.array_equal(sp.plan.syn_delay[0].numpy(), z["plan.syn_delay"])
    assert int(sp.plan.syn_delay.max()) > 16     # past the first group
    t, _, _, c_src = EMIT21[case]
    st = event_engine.EventState(
        base=sp.init_state().base,
        ev_ring=torch.from_numpy(z[f"{case}.in.ev_ring"])[None].clone(),
        ev_count=torch.from_numpy(z[f"{case}.in.ev_count"])[None].clone(),
        sat=torch.zeros(1, dtype=torch.int32))
    spiked_src = torch.from_numpy(z[f"{case}.spiked_src"])[None]
    st = event_engine.phase_b(sp.spec, sp.plan, sp.eplan, st, spiked_src, t,
                              c_src=c_src)
    for k in ("ev_ring", "ev_count", "sat"):
        want = z[f"{case}.out.{k}"]
        got = getattr(st, k)[0].numpy()
        assert got.tobytes() == want.astype(got.dtype).tobytes(), k
    if case in ("overflow", "c_src"):
        assert int(st.sat[0]) > 0


@pytest.mark.parametrize("delivery", ["event", "dense"])
def test_runs_at_21_slots_equal_jax(jax_d21, delivery):
    sp = _d21_program(delivery)
    state, raster, _ = sp.run(sp.init_state(), 0, D21_STEPS)
    raster = raster.numpy()
    want = jax_d21["runs"][delivery]
    assert raster.sum() == want["spikes"] > 0
    assert observables.raster_signature(
        raster, sp.plan.gid.numpy()).hex() == want["raster_signature"]
    assert sp.weight_signature(state).hex() == want["weight_signature"]
    if delivery == "event":
        assert state.sat.tolist() == want["sat"] == [0]


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    if sys.argv[1] == "--emit21":
        print(json.dumps(_jax_emit21(sys.argv[2])))
    else:
        assert sys.argv[1] == "--runs21"
        print(json.dumps(_jax_runs21()))
