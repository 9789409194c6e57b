"""The port's phase split against the JAX package's, exactly.

At the JAX tests' own size (`tests/test_step_program.py`: 2x2, 60
neurons a column, 24 synapses each, seed 9):

* phase B: the plain version `kernels.ref.arborize` (which the engine's
  `phase_b` runs on the CPU) against `repro.core.engine.phase_b` on
  numpy-seeded rings and spike masks, at t near the ring's wrap and at
  t0 - 1 = -1, where an all-False mask (the pipelined schedule's
  prologue) sets nothing;
* the exchange: each of `allgather`, `halo` and `hier` (2 groups) x
  {`block`, `scatter`} at H=4, against `repro`'s
  `StepProgram(mesh=None).phase_fns().exchange` on numpy-seeded spike
  masks; a 'hier' group list gives the group count's exchange, and a
  list that is not contiguous equal blocks of shards is refused;
* `time_phases` under `sync` and `pipelined`: the rasters, weight
  signature and counts of the port's `run` and of JAX's `time_phases`;
  and it leaves its input state untouched.

Phase B and the exchange are boolean and integer work only, so JAX runs
them in this process.  `time_phases` runs the dynamics, so its JAX side
runs in an AVX-pinned subprocess (`test_torch_reference.start_avx`),
started with the module.
"""
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import (EngineConfig, GridConfig, StepProgram, engine,
                              observables)
from repro_torch.kernels import ref

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_reference import start_avx, wait_avx  # noqa: E402

CFG = dict(grid_x=2, grid_y=2, neurons_per_column=60, synapses_per_neuron=24,
           seed=9)
STEPS = 40
EXCHANGES = ["allgather", "halo", "hier"]
PLACEMENTS = ["block", "scatter"]
# (exchange, shards, placement) of the time_phases cases
TIMED = [("halo", 4, "block"), ("hier", 4, "scatter"),
         ("allgather", 2, "block")]
SCHEDULES = ["sync", "pipelined"]


def _summary(sp, raster, state, counts):
    return dict(
        raster_signature=observables.raster_signature(
            np.asarray(raster), np.asarray(sp.plan.gid.cpu()
                                           if hasattr(sp.plan.gid, "cpu")
                                           else sp.plan.gid)).hex(),
        weight_signature=sp.weight_signature(state).hex(),
        spikes_per_step=np.asarray(raster).sum(axis=(1, 2)).astype(
            int).tolist(), **counts)


def _jax_time_phases() -> dict:
    """Inside the AVX subprocess: JAX's time_phases for every case."""
    import jax  # noqa: F401  (jax starts under the AVX flag)
    from repro.core import EngineConfig as JE, GridConfig as JG
    from repro.core import StepProgram as JSP
    out = {}
    for ex, h, pl in TIMED:
        for sched in SCHEDULES:
            sp = JSP(JG(**CFG), JE(n_shards=h, exchange=ex, placement=pl,
                                   exchange_schedule=sched), hier_groups=2)
            state, _, rasters, counts = sp.time_phases(
                sp.init_state(), 0, STEPS, collect_rasters=True)
            out[f"{ex}-{h}-{pl}-{sched}"] = _summary(
                sp, np.stack(rasters), state, counts)
    return out


@pytest.fixture(scope="module", autouse=True)
def _avx_job():
    procs = start_avx(__file__, [["--time-phases"]])
    yield procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def jax_timed(_avx_job):
    return json.loads(wait_avx(_avx_job)[0].strip().splitlines()[-1])


def _jax_program(exchange="allgather", h=4, placement="block"):
    from repro.core import EngineConfig as JE, GridConfig as JG
    from repro.core import StepProgram as JSP
    return JSP(JG(**CFG), JE(n_shards=h, exchange=exchange,
                             placement=placement), hier_groups=2)


def _port_program(exchange="allgather", h=4, placement="block",
                  schedule="sync"):
    return StepProgram(GridConfig(**CFG), EngineConfig(
        n_shards=h, exchange=exchange, placement=placement,
        exchange_schedule=schedule), device="cpu", hier_groups=2)


# -- phase B -------------------------------------------------------------


@pytest.fixture(scope="module")
def programs():
    return _jax_program(), _port_program()


@pytest.mark.parametrize("t", [-1, 0, 4, 5, 6, 11, 1003])
@pytest.mark.parametrize("density", [0.0, 0.02, 0.3, 1.0])
def test_arborize_equals_jax_phase_b(programs, density, t):
    jsp, sp = programs
    plan = sp.plan
    H, E = plan.syn_valid.shape
    D = sp.spec.cfg.n_delay_slots
    rng = np.random.default_rng(t + 10 + int(100 * density))
    ring = (rng.random((H, D, E)) < 0.01) & plan.syn_valid.numpy()[:, None]
    spiked = rng.random(tuple(plan.src_gid.shape)) < density
    jstate = jsp.init_state()._replace(arr_ring=jnp.asarray(ring))
    want = np.asarray(jsp.phase_fns().phase_b(jstate, jnp.asarray(spiked),
                                              t).arr_ring)
    got = ref.arborize(torch.from_numpy(ring.copy()),
                       torch.from_numpy(spiked), plan.syn_src,
                       plan.syn_delay, plan.syn_valid, t)
    assert np.array_equal(got.numpy(), want)
    # the engine's phase B on the CPU is the plain version
    state = sp.init_state()._replace(arr_ring=torch.from_numpy(ring.copy()))
    state = engine.phase_b(sp.spec, plan, state, torch.from_numpy(spiked), t)
    assert np.array_equal(state.arr_ring.numpy(), want)
    if density == 0.0:
        assert np.array_equal(want, ring)            # all-False: a no-op
    else:
        assert want.sum() > ring.sum()


# -- the exchange --------------------------------------------------------


@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("exchange", EXCHANGES)
def test_exchange_equals_jax(exchange, placement):
    jsp = _jax_program(exchange, 4, placement)
    sp = _port_program(exchange, 4, placement)
    assert np.array_equal(sp.plan.src_gid.numpy(),
                          np.asarray(jsp.plan.src_gid))
    jex, ex = jsp.phase_fns().exchange, sp.phase_fns().exchange
    valid = sp.plan.neuron_valid.numpy()
    for i, density in enumerate((0.0, 0.02, 0.3, 1.0)):
        spiked = (np.random.default_rng(i).random(valid.shape) < density) \
            & valid
        want = np.asarray(jex(jnp.asarray(spiked)))
        got = ex(torch.from_numpy(spiked))
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), want)
        assert (want.sum() > 0) == (density > 0)


def test_hier_group_list_equals_group_count():
    count = _port_program("hier", 4, "scatter")
    listed = StepProgram.from_parts(count.spec, count.plan,
                                    count.init_state(),
                                    hier_groups=[[0, 1], [2, 3]])
    valid = count.plan.neuron_valid
    spiked = torch.from_numpy(
        np.random.default_rng(3).random(tuple(valid.shape)) < 0.3) & valid
    assert torch.equal(listed.phase_fns().exchange(spiked),
                       count.phase_fns().exchange(spiked))


@pytest.mark.parametrize("groups", [[[0, 2], [1, 3]], [[2, 3], [0, 1]],
                                    [[0, 1, 2], [3]], [[0, 1]], []])
def test_hier_refuses_groups_it_cannot_route(groups):
    """The stacked exchange moves blocks of consecutive shards: any other
    grouping is refused rather than swapped for the contiguous one."""
    sp = _port_program("hier", 4, "block")
    sp = StepProgram.from_parts(sp.spec, sp.plan, sp.init_state(),
                                hier_groups=groups)
    with pytest.raises(ValueError, match="contiguous blocks"):
        sp.phase_fns()


# -- time_phases ---------------------------------------------------------


_runs = {}


def _port_run(h, placement):
    key = (h, placement)
    if key not in _runs:
        sp = _port_program(h=h, placement=placement)
        state, raster, tm = sp.run(sp.init_state(), 0, STEPS)
        _runs[key] = _summary(sp, raster.numpy(), state, dict(
            spikes=int(tm.spikes.sum()), arrivals=int(tm.arrivals.sum())))
    return _runs[key]


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("case", TIMED, ids=["-".join(map(str, c))
                                             for c in TIMED])
def test_time_phases_equals_run_and_jax(jax_timed, case, schedule):
    ex, h, pl = case
    sp = _port_program(ex, h, pl, schedule)
    s0 = sp.init_state()
    before = [x.clone() for x in s0]
    state, times, rasters, counts = sp.time_phases(s0, 0, STEPS,
                                                   collect_rasters=True)
    got = _summary(sp, np.stack(rasters), state, counts)
    assert got == _port_run(h, pl)
    assert got == jax_timed[f"{ex}-{h}-{pl}-{schedule}"]
    assert got["spikes"] > 0
    assert set(times) == {"phase_a_s", "exchange_s", "phase_b_s"}
    # the input state is untouched: the warm-up and the timed run copy it
    assert all(torch.equal(a, b) for a, b in zip(before, s0))


def test_time_phases_twice_gives_the_same_run():
    sp = _port_program("halo", 2, "scatter", "pipelined")
    s0 = sp.init_state()
    a = sp.time_phases(s0, 0, 20, collect_rasters=True)
    b = sp.time_phases(s0, 0, 20, collect_rasters=True)
    assert np.array_equal(np.stack(a[2]), np.stack(b[2]))
    assert sp.weight_signature(a[0]) == sp.weight_signature(b[0])
    assert a[3] == b[3]


def test_time_phases_without_rasters_keeps_the_counts():
    sp = _port_program("halo", 2, "block")
    s0 = sp.init_state()
    a = sp.time_phases(s0, 0, 20, collect_rasters=True)
    b = sp.time_phases(s0, 0, 20)
    assert b[2] is None
    assert a[3] == b[3]
    assert sp.weight_signature(a[0]) == sp.weight_signature(b[0])


def test_phase_handles_draw_the_stimulus_window_of_any_t():
    """A phase A at any t gives the step of `run` at t: a t outside the
    handles' stimulus window draws the window it falls in."""
    sp = _port_program(h=2)
    pp = sp.phase_fns()
    state, raster, _ = sp.run(sp.init_state(), 0, 260)
    s = engine.clone_state(sp.init_state())
    for t in range(260):
        s, spiked, _ = pp.phase_a(s, t)
        s = pp.phase_b(s, pp.exchange(spiked), t)
        assert torch.equal(spiked, raster[t])
    assert sp.weight_signature(s) == sp.weight_signature(state)


if __name__ == "__main__":
    assert sys.argv[1] == "--time-phases"
    print(json.dumps(_jax_time_phases()))
