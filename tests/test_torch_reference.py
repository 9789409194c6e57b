"""The committed JAX reference of the port's main-path check.

The machine with the card has no JAX, so `chip_smoke.py` holds the port's
GPU runs against `src/repro_torch/data/jax_reference.json`: raster and
weight signatures and spike counts of the JAX package at a 4x4 grid, full
width (1,000 neurons per column, M = 200), 150 steps, at H=1 block, H=4
block and H=4 scatter.  The reference is jitted on the CPU with
`XLA_FLAGS=--xla_cpu_max_isa=AVX` (no FMA contraction), which is the
setting under which the port's plain PyTorch path equals it bit for bit.

`event_runs` holds the same three layouts under event delivery
(`repro.core.event_engine`) with capacities that drop nothing (spike
compactions of c_post = the shard's neurons and c_src = its sources, a
ring of cap_ev = E; `caps_note` says why): raster and weight signatures,
spike counts and the saturation counter.

`plan_quick` holds the JAX run (H = 1) of the physics group of the quick
experiment plan (`benchmarks/plans/quick.yaml`: 2x2, 40 neurons a
column, M = 16, seed 7, 40 steps), which `chip_smoke.py`'s plan phase
holds its 15 cells against, and `connectivity_sweep` the JAX runs (H = 1)
of the quick `connectivity_sweep` suite's four profiles (6x6, 40 neurons
a column, M = 30, seed 2013, 40 steps): spikes and raster signature.

The test below regenerates the file in AVX subprocesses and asserts it
equals the committed one, so it cannot go stale.  To rewrite it:

    python tests/test_torch_reference.py --write

This module also holds the AVX-subprocess helpers the other
`test_torch_*` files use: the flag must be set before jax starts, and the
test workers have started jax already.
"""
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
REF_PATH = SRC / "repro_torch" / "data" / "jax_reference.json"
AVX_FLAG = "--xla_cpu_max_isa=AVX"
STEPS = 150
GRID = dict(grid_x=4, grid_y=4)            # full width: the params defaults
LAYOUTS = {"h1_block": (1, "block"), "h4_block": (4, "block"),
           "h4_scatter": (4, "scatter")}
PLAN_QUICK = dict(grid_x=2, grid_y=2, neurons_per_column=40,
                  synapses_per_neuron=16, seed=7)
PLAN_QUICK_STEPS = 40
SWEEP_PROFILES = ("ring3", "ring1", "gaussian:sigma=1.5",
                  "exponential:lambda=1.0")
SWEEP_QUICK = dict(grid_x=6, grid_y=6, neurons_per_column=40,
                   synapses_per_neuron=30, seed=2013)
SWEEP_STEPS = 40


def avx_env(extra_flags: str = "") -> dict:
    """Environment of a subprocess whose jax is pinned to AVX (no FMA),
    with `extra_flags` appended to XLA_FLAGS."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = " ".join(
        f for f in (env.get("XLA_FLAGS", ""), AVX_FLAG, extra_flags) if f)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(SRC), env.get("PYTHONPATH")) if p)
    return env


def start_avx(script: str, arg_lists, extra_flags: str = ""):
    """Start `python script *args` for each args in `arg_lists`, all at
    once, under `avx_env(extra_flags)`."""
    return [subprocess.Popen([sys.executable, script, *map(str, args)],
                             env=avx_env(extra_flags), cwd=ROOT, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for args in arg_lists]


def wait_avx(procs, timeout: float = 600.0):
    """The standard outputs of `start_avx`'s processes, in order; raises if
    one failed, and leaves none running."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"AVX reference subprocess failed:\n"
                                   f"{err[-4000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def run_avx(script: str, arg_lists, timeout: float = 600.0,
            extra_flags: str = ""):
    """`start_avx` then `wait_avx`."""
    return wait_avx(start_avx(script, arg_lists, extra_flags), timeout)


def jax_run_summary(cfg_kw: dict, eng_kw: dict, steps: int) -> dict:
    """Run the JAX package (call inside an AVX subprocess) and summarise
    the run: signatures and spike counts."""
    import jax  # noqa: F401  (jax must start under the AVX flag)
    from repro.core import (EngineConfig, GridConfig, StepProgram,
                            observables)
    sp = StepProgram(GridConfig(**cfg_kw), EngineConfig(**eng_kw))
    state, raster, _ = sp.run(sp.init_state(), 0, steps)
    raster = np.asarray(raster)
    return dict(
        raster_signature=observables.raster_signature(
            raster, np.asarray(sp.plan.gid)).hex(),
        weight_signature=sp.weight_signature(state).hex(),
        spikes=int(raster.sum()),
        spikes_per_step=raster.sum(axis=(1, 2)).astype(int).tolist())


def jax_event_summary(cfg_kw: dict, eng_kw: dict, steps: int) -> dict:
    """The JAX package's event backend (call inside an AVX subprocess) with
    capacities that drop nothing: signatures, spike counts, sat."""
    import jax
    from repro.core import EngineConfig, GridConfig, observables
    from repro.core import event_engine as EV
    spec, plan, eplan, state = EV.build(
        GridConfig(**cfg_kw), EngineConfig(delivery="event", **eng_kw))
    state = EV.init_event_state(spec, state.base, spec.e_cap)
    state, raster, _ = jax.jit(lambda s: EV.run(
        spec, plan, eplan, s, 0, steps, c_post=spec.n_local,
        c_src=spec.s_cap))(state)
    raster = np.asarray(raster)
    w, valid = np.asarray(state.base.w), np.asarray(plan.syn_valid)
    h = hashlib.sha256()
    for hh in range(w.shape[0]):
        h.update(np.ascontiguousarray(w[hh][valid[hh]]).tobytes())
    return dict(
        raster_signature=observables.raster_signature(
            raster, np.asarray(plan.gid)).hex(),
        weight_signature=h.hexdigest(), spikes=int(raster.sum()),
        spikes_per_step=raster.sum(axis=(1, 2)).astype(int).tolist(),
        sat=np.asarray(state.sat).astype(int).tolist())


def build_reference() -> dict:
    """The reference file's content, from fresh AVX subprocesses (one per
    layout and delivery, run in parallel)."""
    outs = run_avx(__file__, [[flag, name] for flag in ("--layout",
                                                        "--event-layout")
                              for name in LAYOUTS]
                   + [["--plan-quick"]]
                   + [["--sweep", p] for p in SWEEP_PROFILES])
    lines = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    n = len(LAYOUTS)
    runs = dict(zip(LAYOUTS, lines[:n]))
    event_runs = dict(zip(LAYOUTS, lines[n:2 * n]))
    sweep = dict(zip(SWEEP_PROFILES, lines[2 * n + 1:]))
    return dict(
        source="JAX package (repro.core.StepProgram), jitted on the CPU "
               f"with XLA_FLAGS={AVX_FLAG}",
        grid=GRID, neurons_per_column=1000, synapses_per_neuron=200,
        steps=STEPS, runs=runs,
        event_source="JAX package (repro.core.event_engine.run with "
                     "c_post = spec.n_local, c_src = spec.s_cap, from "
                     "init_event_state(spec, base, cap_ev=spec.e_cap)), "
                     f"jitted on the CPU with XLA_FLAGS={AVX_FLAG}",
        caps_note="the default capacities drop events of this grid's "
                  "bursts (up to ~6,900 spikes a step: c_src = a shard's "
                  "sources / 8 overflows, and without it a ring of E / 4 "
                  "does), so these runs list every spike and hold E events "
                  "a slot (each synapse is in a slot at most once): sat 0",
        event_runs=event_runs,
        plan_quick=dict(PLAN_QUICK, steps=PLAN_QUICK_STEPS,
                        **lines[2 * n]),
        connectivity_sweep=dict(
            config=dict(SWEEP_QUICK, steps=SWEEP_STEPS, n_shards=1),
            profiles=sweep))


def test_committed_reference_is_current():
    committed = json.loads(REF_PATH.read_text())
    fresh = build_reference()
    assert committed == fresh


def _main(argv):
    if argv[:1] == ["--layout"]:
        h, placement = LAYOUTS[argv[1]]
        summary = jax_run_summary(GRID, dict(n_shards=h, placement=placement),
                                  STEPS)
        print(json.dumps(dict(n_shards=h, placement=placement, **summary)))
    elif argv[:1] == ["--event-layout"]:
        h, placement = LAYOUTS[argv[1]]
        summary = jax_event_summary(GRID, dict(n_shards=h,
                                               placement=placement), STEPS)
        print(json.dumps(dict(n_shards=h, placement=placement, **summary)))
    elif argv[:1] == ["--plan-quick"]:
        s = jax_run_summary(PLAN_QUICK, {}, PLAN_QUICK_STEPS)
        print(json.dumps({k: s[k] for k in ("raster_signature",
                                             "weight_signature", "spikes")}))
    elif argv[:1] == ["--sweep"]:
        s = jax_run_summary(dict(SWEEP_QUICK, connectivity=argv[1]), {},
                            SWEEP_STEPS)
        print(json.dumps({k: s[k] for k in ("raster_signature", "spikes")}))
    elif argv[:1] == ["--write"]:
        REF_PATH.parent.mkdir(parents=True, exist_ok=True)
        REF_PATH.write_text(json.dumps(build_reference(), indent=1) + "\n")
        print(f"wrote {REF_PATH}")
    else:
        raise SystemExit(f"usage: {sys.argv[0]} --write | --layout NAME | "
                         f"--event-layout NAME | --plan-quick | --sweep "
                         f"PROFILE")


if __name__ == "__main__":
    sys.path.insert(0, str(SRC))
    _main(sys.argv[1:])
