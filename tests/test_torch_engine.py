"""The port's dense DPSNN-STDP slice against the JAX reference, bit for bit.

`StepProgram(..., device="cpu").run` (the plain PyTorch path the CUDA
kernels are held against on the card) must give the raster AND weight
signatures of the JAX package jitted under
`XLA_FLAGS=--xla_cpu_max_isa=AVX` (no FMA contraction), run in
subprocesses:

* 2x2, 100 neurons/column, M=40, seed 7, 150 steps, at H in {1,2,4} x
  {block, scatter} and profiles {ring3, ring1, gaussian:sigma=1.5,
  exponential:lambda=1.0};
* 1x1 at full width (1,000 neurons, M=200), 150 steps;
* 4x4 at full width, 150 steps, H=1, against the committed reference file
  (which `test_torch_reference.py` regenerates from JAX);
* a JAX run stopped at t=50, carried across with `convert.from_jax`, and
  continued for 100 steps in the port.

The port's own Table 1 invariance (the same raster at every shard count
and placement) is gated exactly too.
"""
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import (EngineConfig, GridConfig, StepProgram,
                              convert, observables)
from repro_torch.kernels import ops

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_reference import (REF_PATH, jax_run_summary,  # noqa: E402
                                  start_avx, wait_avx)

STEPS = 150
CARRY_AT = 50
SMALL = dict(grid_x=2, grid_y=2, neurons_per_column=100,
             synapses_per_neuron=40, seed=7)
PROFILES = ["ring3", "ring1", "gaussian:sigma=1.5",
            "exponential:lambda=1.0"]
LAYOUTS = [(1, "block"), (1, "scatter"), (2, "block"), (2, "scatter"),
           (4, "block"), (4, "scatter")]
CASES = {f"{p}-H{h}-{pl}": (dict(SMALL, connectivity=p),
                            dict(n_shards=h, placement=pl))
         for p in PROFILES for h, pl in LAYOUTS}
FULL_1X1 = (dict(grid_x=1, grid_y=1), {})
CARRY_CASE = "ring3-H2-block"


def _jax_profile_batch(profile: str) -> dict:
    """Inside an AVX subprocess: every layout of one profile."""
    return {name: jax_run_summary(cfg, eng, STEPS)
            for name, (cfg, eng) in CASES.items()
            if cfg["connectivity"] == profile}


def _jax_full_and_carry(path: str) -> dict:
    """Inside an AVX subprocess: 1x1 at full width, and the JAX side of the
    carried-state case (plan and state at t=50, the 150-step raster)."""
    import jax  # noqa: F401
    from repro.core import EngineConfig as JE, GridConfig as JG, StepProgram
    out = {"full-1x1": jax_run_summary(*FULL_1X1, STEPS)}
    cfg, eng = CASES[CARRY_CASE]
    sp = StepProgram(JG(**cfg), JE(**eng))
    _, raster, _ = sp.run(sp.init_state(), 0, STEPS)
    mid, _, _ = sp.run(sp.init_state(), 0, CARRY_AT)
    arrays = {f"plan.{k}": np.asarray(v) for k, v in sp.plan._asdict().items()}
    arrays.update({f"state.{k}": np.asarray(v)
                   for k, v in mid._asdict().items()})
    np.savez(path, raster=np.asarray(raster), **arrays)
    return out


@pytest.fixture(scope="module", autouse=True)
def _avx_jobs(tmp_path_factory):
    """Start the JAX reference runs with the module, so the port's own runs
    (the 4x4 case first) overlap them."""
    carry = tmp_path_factory.mktemp("carry") / "carry.npz"
    procs = start_avx(__file__, [["--profile", p] for p in PROFILES]
                      + [["--full-and-carry", carry]])
    yield procs, carry
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def jax_ref(_avx_jobs):
    procs, carry = _avx_jobs
    ref = {}
    for out in wait_avx(procs):
        ref.update(json.loads(out.strip().splitlines()[-1]))
    ref["carry"] = dict(np.load(carry))
    return ref


_port_runs = {}


def port_run(cfg_kw: dict, eng_kw: dict, steps: int = STEPS) -> dict:
    """The port's CPU run of a config (cached within this module)."""
    key = json.dumps([cfg_kw, eng_kw, steps], sort_keys=True)
    if key not in _port_runs:
        sp = StepProgram(GridConfig(**cfg_kw), EngineConfig(**eng_kw),
                         device="cpu")
        state, raster, tm = sp.run(sp.init_state(), 0, steps)
        raster = raster.numpy()
        _port_runs[key] = dict(
            raster_signature=observables.raster_signature(
                raster, sp.plan.gid.numpy()).hex(),
            weight_signature=sp.weight_signature(state).hex(),
            spikes=int(raster.sum()),
            spikes_per_step=raster.sum(axis=(1, 2)).astype(int).tolist(),
            tm_spikes=int(tm.spikes.sum()))
    return _port_runs[key]


def assert_same_run(got: dict, want: dict):
    assert got["spikes_per_step"] == want["spikes_per_step"]
    assert got["raster_signature"] == want["raster_signature"]
    assert got["weight_signature"] == want["weight_signature"]


def test_full_width_4x4_matches_committed_reference():
    ref = json.loads(REF_PATH.read_text())
    got = port_run(dict(ref["grid"]), dict(n_shards=1, placement="block"),
                   ref["steps"])
    assert_same_run(got, ref["runs"]["h1_block"])
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


@pytest.mark.parametrize("name", list(CASES))
def test_small_config_bit_exact(jax_ref, name):
    got = port_run(*CASES[name])
    assert_same_run(got, jax_ref[name])
    assert got["tm_spikes"] == got["spikes"] > 0


@pytest.mark.parametrize("profile", PROFILES)
def test_table1_invariance_in_port(profile):
    runs = [port_run(*CASES[f"{profile}-H{h}-{pl}"]) for h, pl in LAYOUTS]
    assert len({r["raster_signature"] for r in runs}) == 1
    # block shards concatenate to the canonical global order
    block = [r["weight_signature"] for (h, pl), r in zip(LAYOUTS, runs)
             if pl == "block" or h == 1]
    assert len(set(block)) == 1


def test_full_width_1x1_bit_exact(jax_ref):
    assert_same_run(port_run(*FULL_1X1), jax_ref["full-1x1"])


def test_state_carried_across_from_jax(jax_ref):
    z = jax_ref["carry"]
    fields = lambda prefix: SimpleNamespace(**{
        k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)})
    plan, state = convert.from_jax(fields("plan."), fields("state."), "cpu")
    cfg, eng = CASES[CARRY_CASE]
    spec = StepProgram(GridConfig(**cfg), EngineConfig(**eng),
                       device="cpu").spec
    sp = StepProgram.from_parts(spec, plan)
    state, raster, _ = sp.run(state, CARRY_AT, STEPS - CARRY_AT)
    assert np.array_equal(raster.numpy(), z["raster"][CARRY_AT:])
    assert (sp.weight_signature(state).hex()
            == jax_ref[CARRY_CASE]["weight_signature"])


def test_run_leaves_input_state_untouched():
    sp = StepProgram(GridConfig(**SMALL), EngineConfig(n_shards=2),
                     device="cpu")
    s0 = sp.init_state()
    before = [x.clone() for x in s0]
    _, r1, _ = sp.run(s0, 0, 40)
    _, r2, _ = sp.run(s0, 0, 40)
    assert all(torch.equal(a, b) for a, b in zip(before, s0))
    assert torch.equal(r1, r2) and int(r1.sum()) > 0


if __name__ == "__main__":
    if sys.argv[1] == "--profile":
        print(json.dumps(_jax_profile_batch(sys.argv[2])))
    else:
        assert sys.argv[1] == "--full-and-carry"
        print(json.dumps(_jax_full_and_carry(sys.argv[2])))
