"""The port's cluster runtime with real workers: `python -m
repro_torch.cluster run` as gangs of gloo ranks on the CPU (ports of
`tests/test_cluster_smoke.py`, `tests/test_cluster_faults.py` and
`tests/test_cluster_checkpoint.py`).

* Across processes: 2 processes x 2 shards give the raster of the
  port's single-process run (allgather with the phase split, halo, halo
  pipelined, event delivery on halo, a gaussian reach-5 profile on a
  16x1 strip), and a single-process checkpoint restores into the job.
* Supervised recovery on the reference's tiny workload (2x2, 20 neurons
  a column, 10 synapses, 40 steps, 2 ranks, an epoch every 10 steps):
  each fault class of `REPRO_FAULT` recovers within its restart budget
  with the raster and weight signatures of the fault-free single-process
  run (crash, slow, corrupt_ckpt, drop_result, and a hang caught by the
  beacon stall detector); periodic checkpoints alone change no bit; a
  fault re-armed on every attempt exhausts the budget; a combination
  `check_supported` refuses fails its workers with its message.
* The entry points: `python -m repro_torch.cluster run --supervise
  --fault ...` recovers a crash and verifies, and `cluster_scaling`
  quick runs through the bench registry.

Every gang starts with the module (four at a time) and each test waits
for its own.  Nothing here probes and skips: ranks of a gloo job run on
this CPU (`tests/test_torch_mesh.py`), so a gang that cannot run fails.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from repro_torch.bench import registry
from repro_torch.bench import report as bench_report
from repro_torch.bench import subproc
from repro_torch.cluster import cli, local
from repro_torch.cluster.worker import workload_argv
from repro_torch.core import (EngineConfig, GridConfig, StepProgram,
                              checkpoint, observables)

WORKLOAD = dict(grid="2x2", neurons_per_column=20, synapses=10, seed=7,
                steps=40, shards=2, phase_steps=0, device="cpu")
CKPT_EVERY = 10
SMOKE = dict(grid="2x2", neurons_per_column=50, synapses=20, seed=11,
             steps=50, shards=4, phase_steps=0, device="cpu")
T_SAVE = 40
TIMEOUT = 300


def _args(**kw):
    return cli.workload_namespace(**kw)


def _supervised(tmp: Path, fault, stall_timeout=120.0, max_restarts=2):
    args = _args(**WORKLOAD, ckpt_dir=str(tmp / "epochs"),
                 ckpt_every=CKPT_EVERY, supervise=True, fault=fault,
                 max_restarts=max_restarts, stall_timeout=stall_timeout)
    return cli.run_point(args, 2, timeout=TIMEOUT)


def _unsupervised(tmp: Path):
    args = _args(**WORKLOAD, ckpt_dir=str(tmp / "epochs"),
                 ckpt_every=CKPT_EVERY)
    return cli.run_point(args, 2, timeout=TIMEOUT)


def _exhausted(tmp: Path):
    """A crash at step 0 before any epoch exists, with no restart left."""
    cmd = [*cli.WORKER, *workload_argv(_args(**WORKLOAD))]
    try:
        local.supervised_launch(cmd, 2, timeout=TIMEOUT, device="cpu",
                                stall_timeout=120.0, max_restarts=0,
                                backoff_s=0.01, fault="crash@step=0:rank=0")
    except local.LaunchError as e:
        return e
    return None


def _refused(tmp: Path):
    # streamed connectivity with event delivery, which the reference
    # refuses too
    args = _args(**dict(WORKLOAD, delivery="event",
                        connectivity_mode="streamed:chunk=1"))
    try:
        cli.run_point(args, 2, timeout=TIMEOUT)
    except local.LaunchError as e:
        return e
    return None


def _restored_smoke(tmp: Path):
    """A single-process checkpoint at t = 40, restored by the job."""
    sp = StepProgram(GridConfig(**_cfg_kw(SMOKE)),
                     EngineConfig(n_shards=4), device="cpu")
    state, _, _ = sp.run(sp.init_state(), 0, T_SAVE)
    path = checkpoint.save(str(tmp / f"ckpt_{T_SAVE}.npz"), sp.spec,
                           sp.plan, state, T_SAVE)
    _, raster, _ = sp.run(state, T_SAVE, SMOKE["steps"])
    ref = observables.raster_signature(raster.numpy(),
                                       sp.plan.gid.numpy()).hex()
    return ref, cli.run_point(_args(**SMOKE, ckpt=path), 2, timeout=TIMEOUT)


def _cli_run(tmp: Path):
    """`python -m repro_torch.cluster run --supervise` with a crash, as a
    user starts it: (exit code, output)."""
    argv = ["run", "--nprocs", "2", "--shards", "2", "--grid", "2x2",
            "--neurons-per-column", "20", "--synapses", "10", "--seed", "7",
            "--steps", "40", "--ckpt-every", "10", "--ckpt-dir",
            str(tmp / "epochs"), "--supervise", "--fault",
            "crash@step=20:rank=1", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (subproc.SRC, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-m", "repro_torch.cluster",
                          *argv], capture_output=True, text=True, env=env,
                         timeout=TIMEOUT)
    return out.returncode, out.stdout + out.stderr


def _sweep(tmp: Path):
    """`cluster_scaling` at its quick setting through the bench registry,
    on the CPU, written as a report."""
    rep = registry.get("cluster_scaling").fn(True, "cpu")
    return rep, bench_report.save(rep, str(tmp))


def _cfg_kw(w: dict) -> dict:
    gx, gy = (int(v) for v in w["grid"].split("x"))
    return dict(grid_x=gx, grid_y=gy,
                neurons_per_column=w["neurons_per_column"],
                synapses_per_neuron=w["synapses"], seed=w["seed"])


FAULTS = {
    "crash": ("crash@step=20:rank=1", 1, 20),
    "slow": ("slow@step=20:ms=400", 0, None),
    "corrupt_ckpt": ("corrupt_ckpt@step=20", 1, 10),  # epoch 20 bad -> 10
    "drop_result": ("drop_result@rank=0", 1, 40),     # resume at t_end
}
SMOKES = {
    "allgather": dict(SMOKE, phase_steps=8),
    "halo": dict(SMOKE, exchange="halo"),
    "pipelined": dict(SMOKE, exchange="halo", exchange_schedule="pipelined",
                      phase_steps=8),
    "event": dict(SMOKE, delivery="event", exchange="halo"),
    "gaussian": dict(SMOKE, grid="16x1", neurons_per_column=20, synapses=12,
                     exchange="halo", profile="gaussian:sigma=1.5"),
}


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """Every gang of the module, started at once, four at a time: name ->
    future."""
    root = tmp_path_factory.mktemp("gangs")
    jobs = {f"fault_{k}": (lambda d, f=f: _supervised(d, f[0]))
            for k, f in FAULTS.items()}
    jobs.update(
        fault_hang=lambda d: _supervised(d, "hang@step=20:rank=1",
                                         stall_timeout=20.0),
        unsupervised=_unsupervised, exhausted=_exhausted, refused=_refused,
        restored=_restored_smoke, cli=_cli_run, sweep=_sweep,
        **{f"smoke_{k}": (lambda d, w=w: cli.run_point(_args(**w), 2,
                                                       timeout=TIMEOUT))
           for k, w in SMOKES.items()})
    pool = ThreadPoolExecutor(4)
    futures = {}
    for name, fn in jobs.items():
        d = root / name
        d.mkdir()
        futures[name] = pool.submit(fn, d)
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def reference():
    """The fault-free single-process (raster, weights) signatures."""
    return cli.reference_signatures(_args(**WORKLOAD))


@pytest.mark.parametrize("kind", list(FAULTS))
def test_fault_recovers_bit_identical(gangs, reference, kind):
    _, min_restarts, restored_t = FAULTS[kind]
    row = gangs[f"fault_{kind}"].result()
    assert (row["raster_sig"], row["weights_sig"]) == reference
    rec = row["recovery"]
    assert rec["restarts"] >= min_restarts
    if min_restarts == 0:
        assert rec["restarts"] == 0 and not rec["restored"]
    else:
        assert rec["restored"] and rec["restored_t"] == restored_t
        assert rec["recovered_steps"] == restored_t
        assert rec["attempt"] == rec["restarts"]
        assert len(rec["attempts"]) == rec["restarts"]
    if kind == "crash":
        assert "exit code 41" in rec["attempts"][0]["reason"]
    if kind == "corrupt_ckpt":
        assert "exit code 43" in rec["attempts"][0]["reason"]


def test_hang_caught_by_the_stall_detector(gangs, reference):
    """The deadline is long; only beacon-progress stall detection can
    catch the hung worker in time."""
    row = gangs["fault_hang"].result()
    assert (row["raster_sig"], row["weights_sig"]) == reference
    rec = row["recovery"]
    assert rec["restarts"] >= 1 and rec["restored_t"] == 20
    assert any("stalled" in a["reason"] for a in rec["attempts"])


def test_unsupervised_run_unchanged_by_the_checkpoints(gangs, reference):
    row = gangs["unsupervised"].result()
    assert (row["raster_sig"], row["weights_sig"]) == reference
    assert row["n_ckpts"] == WORKLOAD["steps"] // CKPT_EVERY
    assert row["recovery"]["restarts"] == 0
    assert row["device"] == "cpu" and row["wire"] == "gloo"


def test_budget_exhaustion_with_real_workers(gangs):
    err = gangs["exhausted"].result()
    assert err is not None and "restart budget exhausted" in str(err)
    assert len(err.attempts) == 1
    assert 41 in err.attempts[0]["returncodes"]     # EXIT_CRASH


def test_a_refused_combination_fails_its_workers(gangs):
    err = gangs["refused"].result()
    assert err is not None and "cluster worker failed" in str(err)
    assert "requires delivery='dense'" in str(err)


@pytest.mark.parametrize("name", list(SMOKES))
def test_processes_match_the_single_process_run(gangs, name):
    w = SMOKES[name]
    row = gangs[f"smoke_{name}"].result()
    assert row["nprocs"] == 2 and row["shards"] == 4
    assert [pp["proc"] for pp in row["per_proc"]] == [0, 1]
    if w["phase_steps"]:
        for pp in row["per_proc"]:
            for k in ("phase_a_s", "exchange_s", "phase_b_s"):
                assert pp[k] >= 0.0
    if name == "event":
        assert row.get("saturated", 0) == 0
    assert (row["raster_sig"], row["weights_sig"]) == \
        cli.reference_signatures(_args(**w))


def test_a_checkpoint_restores_across_processes(gangs):
    ref, row = gangs["restored"].result()
    assert row["t0"] == T_SAVE, "the workers resume at the saved t"
    assert row["raster_sig"] == ref


def test_report_rows_sum_the_recovery(gangs):
    """The row of a recovered run says what the attempts cost."""
    row = gangs["fault_crash"].result()
    assert row["ckpt_every"] == CKPT_EVERY and row["n_ckpts"] >= 2
    assert row["ckpt_wall_s"] >= 0.0
    assert np.isfinite(row["wall_s"]) and row["rate_hz"] > 0


def test_the_cli_recovers_a_crash(gangs):
    rc, out = gangs["cli"].result()
    assert rc == 0, out[-3000:]
    assert "recovered after 1 restart(s); resumed at t=20 (20 steps " \
        "salvaged)" in out
    assert "exit code 41" in out and "verify OK" in out


def test_cluster_scaling_quick_on_the_cpu(gangs):
    rep, path = gangs["sweep"].result()
    assert bench_report.validate(bench_report.load(path)) == []
    det = rep["deterministic"]
    assert det["identical_across_procs"] and det[
        "identical_weights_across_procs"]
    assert [p["nprocs"] for p in rep["extra"]["points"]] == [1, 2]
    assert rep["config"]["device"] == "cpu" and "p2_exchange_s" in rep["wall"]
