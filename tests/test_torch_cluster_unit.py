"""The port's cluster runtime without a job: `cluster.faults` (the
`REPRO_FAULT` grammar, the injector's gating, the beacons),
`core.integrity` (digest round trip, truncation and bit-flip detection,
newest-valid discovery), `cluster.worker`'s argv and chunk spans,
`cluster.report`'s parsing and aggregation and its BENCH schema,
`_flags`' tuned preset, and `cluster.local`'s reaping, error contract and
supervisor (restart budget, lost result, the fault armed on the first
attempt only) with trivial subprocess commands.  Ports of
`tests/test_cluster_unit.py` and `tests/test_faults_unit.py`; the gangs
of real workers are `tests/test_torch_cluster.py`'s."""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from repro_torch import _flags
from repro_torch.bench import registry
from repro_torch.bench import report as bench_report
from repro_torch.bench import subproc
from repro_torch.cluster import faults, local, report as crep
from repro_torch.cluster.cli import workload_namespace
from repro_torch.cluster.worker import (RESULT_PREFIX, _chunk_spans,
                                        add_workload_args, workload_argv)
from repro_torch.core import integrity


# -- the fault grammar and the injector -------------------------------------


def test_fault_grammar_parses_and_round_trips():
    s = faults.FaultSpec.parse("crash@step=30:rank=1")
    assert (s.kind, s.step, s.rank, s.ms) == ("crash", 30, 1, 0)
    assert faults.FaultSpec.parse(s.spec()) == s
    assert faults.FaultSpec.parse("slow@step=10:ms=500").ms == 500
    assert faults.FaultSpec.parse("drop_result").spec() == "drop_result"
    assert faults.FaultSpec.parse("corrupt_ckpt@step=20").step == 20
    assert faults.KINDS == ("crash", "hang", "slow", "corrupt_ckpt",
                            "drop_result")
    assert (faults.ENV_FAULT, faults.ENV_BEACON_DIR, faults.ENV_ATTEMPT) == (
        "REPRO_FAULT", "REPRO_BEACON_DIR", "REPRO_ATTEMPT")
    assert (faults.EXIT_CRASH, faults.EXIT_CORRUPT) == (41, 43)


@pytest.mark.parametrize("text", [
    "crash@step=7", "hang@step=3:rank=2", "slow@step=5:ms=250:rank=1",
    "corrupt_ckpt", "corrupt_ckpt@step=40:rank=1", "drop_result@rank=1"])
def test_every_kind_round_trips(text):
    spec = faults.FaultSpec.parse(text)
    assert faults.FaultSpec.parse(spec.spec()) == spec
    assert spec.spec() == text


@pytest.mark.parametrize("bad", [
    "explode@step=1",        # unknown kind
    "slow@step=1",           # slow without ms
    "crash@step=x",          # non-integer value
    "crash@foo=1",           # unknown key
    "crash@step",            # missing '='
])
def test_bad_specs_name_the_grammar(bad):
    with pytest.raises(ValueError, match="grammar|integer"):
        faults.FaultSpec.parse(bad)


def test_injector_from_env(monkeypatch):
    monkeypatch.delenv(faults.ENV_FAULT, raising=False)
    assert faults.FaultInjector.from_env(0).spec is None
    monkeypatch.setenv(faults.ENV_FAULT, "crash@step=5")
    assert faults.FaultInjector.from_env(0).spec.step == 5
    monkeypatch.setenv(faults.ENV_FAULT, "")   # the supervisor's disarm
    assert faults.FaultInjector.from_env(0).spec is None


@pytest.fixture
def exits(monkeypatch):
    fired = []
    monkeypatch.setattr(faults, "_hard_exit", fired.append)
    return fired


def test_crash_fires_on_the_covering_chunk_and_matching_rank(exits):
    spec = faults.FaultSpec.parse("crash@step=30:rank=1")
    inj = faults.FaultInjector(spec, rank=1)
    inj.on_chunk(0, 30)                    # 30 not in [0, 30)
    assert exits == []
    inj.on_chunk(30, 40)
    assert exits == [faults.EXIT_CRASH]
    faults.FaultInjector(spec, rank=0).on_chunk(30, 40)   # other rank
    assert exits == [faults.EXIT_CRASH]


def test_disarmed_and_fired_are_noops(exits):
    inj = faults.FaultInjector(None, 0)
    inj.on_chunk(0, 100)
    inj.on_checkpoint_written("/nope", 50)
    assert inj.emit_result() is True and exits == []


def test_slow_sleeps_once(monkeypatch, exits):
    slept = []
    monkeypatch.setattr(faults, "_sleep", slept.append)
    inj = faults.FaultInjector(faults.FaultSpec.parse("slow@step=10:ms=250"),
                               0)
    inj.on_chunk(10, 20)
    inj.on_chunk(20, 30)
    assert slept == [0.25] and exits == []


def test_corrupt_ckpt_truncates_then_exits(tmp_path, exits):
    path = str(tmp_path / "ckpt_20.npz")
    integrity.write_verified(path, {"a": np.arange(4000)})
    inj = faults.FaultInjector(faults.FaultSpec.parse("corrupt_ckpt@step=20"),
                               0)
    inj.on_checkpoint_written(path, 10)    # before the step: no-op
    assert exits == [] and integrity.verify(path)
    inj.on_checkpoint_written(path, 20)
    assert exits == [faults.EXIT_CORRUPT]
    assert not integrity.verify(path)      # the digest catches it


def test_drop_result_swallows_exactly_once(exits):
    inj = faults.FaultInjector(faults.FaultSpec.parse("drop_result"), 0)
    assert inj.emit_result() is False
    assert inj.emit_result() is True       # fired latch


def test_beacons_round_trip_and_tolerate_garbage(tmp_path):
    d = str(tmp_path / "beacons")
    faults.BeaconWriter(d, 1).write(30, "chunk", attempt=2)
    faults.BeaconWriter(d, 0).write(40, "report")
    got = faults.read_beacons(d)
    assert got[1]["step"] == 30 and got[1]["phase"] == "chunk"
    assert got[1]["attempt"] == 2 and got[0]["phase"] == "report"
    with open(os.path.join(d, "beacon_9.json"), "w") as f:
        f.write("{not json")
    assert 9 not in faults.read_beacons(d)
    assert faults.read_beacons(None) == {}
    assert faults.read_beacons(str(tmp_path / "missing")) == {}
    faults.BeaconWriter(None, 0).write(1, "x")      # disabled: no-op


def test_faults_and_integrity_stay_stdlib_and_numpy():
    """The supervisor imports them without torch."""
    code = ("import sys\n"
            "sys.path.insert(0, %r)\n"
            "import importlib.util as u\n"
            "for name in ('faults', 'integrity'):\n"
            "    path = %r if name == 'faults' else %r\n"
            "    spec = u.spec_from_file_location(name, path)\n"
            "    m = sys.modules[name] = u.module_from_spec(spec)\n"
            "    spec.loader.exec_module(m)\n"
            "assert 'torch' not in sys.modules\n"
            "print('ok')\n") % (subproc.SRC, faults.__file__,
                                integrity.__file__)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert out.stdout.strip() == "ok", out.stderr


# -- integrity --------------------------------------------------------------


def test_integrity_write_read_round_trip(tmp_path):
    path = str(tmp_path / "ok.npz")
    arrays = {"w": np.linspace(0, 1, 100).reshape(10, 10), "t": np.int64(7)}
    integrity.write_verified(path, arrays)
    back = integrity.read_verified(path)
    assert np.array_equal(back["w"], arrays["w"]) and int(back["t"]) == 7
    assert integrity.verify(path)
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    # the digest recipe: sorted names, each name, dtype.str, shape, bytes
    assert integrity.payload_digest(arrays) == integrity.payload_digest(
        dict(reversed(list(arrays.items()))))
    assert integrity.payload_digest(arrays) != integrity.payload_digest(
        dict(arrays, t=np.int32(7)))


def test_truncation_raises_checkpoint_corrupt(tmp_path):
    path = str(tmp_path / "trunc.npz")
    integrity.write_verified(path, {"a": np.arange(5000)})
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size * 2 // 3)
    with pytest.raises(integrity.CheckpointCorrupt) as ei:
        integrity.read_verified(path)
    assert ei.value.path == path


def test_bitflip_raises_checkpoint_corrupt(tmp_path):
    path = str(tmp_path / "flip.npz")
    integrity.write_verified(path, {"a": np.arange(5000)})
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(integrity.CheckpointCorrupt):
        integrity.read_verified(path)


def test_latest_valid_falls_back_past_corruption(tmp_path):
    d = str(tmp_path)
    for t in (10, 20, 30):
        integrity.write_verified(os.path.join(d, f"ckpt_{t}.npz"),
                                 {"t": np.int64(t)})
    newest = os.path.join(d, "ckpt_30.npz")
    assert integrity.latest_valid(d) == newest
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    assert integrity.latest_valid(d) == os.path.join(d, "ckpt_20.npz")
    assert integrity.checkpoint_steps(d) == [
        (10, os.path.join(d, "ckpt_10.npz")),
        (20, os.path.join(d, "ckpt_20.npz")), (30, newest)]
    assert integrity.latest_valid(str(tmp_path / "none")) is None


# -- the worker's argv and chunks -------------------------------------------


def test_chunk_spans_align_to_the_run_base():
    assert _chunk_spans(0, 40, 10, 0) == [(0, 10), (10, 20), (20, 30),
                                          (30, 40)]
    # a resume at an epoch re-enters the same boundary sequence
    assert _chunk_spans(20, 40, 10, 0) == [(20, 30), (30, 40)]
    # nonzero base (an explicit --ckpt continuation)
    assert _chunk_spans(15, 35, 10, 15) == [(15, 25), (25, 35)]
    # a ragged tail, k = 0 (one chunk) and an empty window
    assert _chunk_spans(0, 25, 10, 0) == [(0, 10), (10, 20), (20, 25)]
    assert _chunk_spans(5, 40, 0, 0) == [(5, 40)]
    assert _chunk_spans(40, 40, 10, 0) == []
    # a resume off the period's grid rejoins it at the next boundary
    assert _chunk_spans(23, 50, 10, 0) == [(23, 30), (30, 40), (40, 50)]


def test_workload_argv_round_trips_through_the_parser():
    args = workload_namespace(grid="4x2", neurons_per_column=75, steps=33,
                              shards=8, exchange="halo", ckpt="/tmp/c.npz",
                              ckpt_dir="/tmp/e", ckpt_every=11,
                              delivery="event", exchange_schedule="pipelined")
    ap = argparse.ArgumentParser()
    add_workload_args(ap)
    assert vars(ap.parse_args(workload_argv(args))) == vars(args)


# -- results and reports ----------------------------------------------------


def _result(proc, nprocs=2, sig="ab" * 32, wall=1.0, **kw):
    r = dict(proc=proc, nprocs=nprocs, shards=4, t0=0, steps=50,
             exchange="allgather", placement="block", local_devices=2,
             wall_s=wall, spikes=123, rate_hz=10.5, raster_sig=sig,
             weights_sig="cd" * 32, device="cpu", wire="gloo",
             phase_a_s=0.2, exchange_s=0.1, phase_b_s=0.3)
    r.update(kw)
    return r


def _stdout(result):
    return ("some warning\n" + RESULT_PREFIX + json.dumps(result)
            + "\ntrailing noise\n")


def test_parse_worker_outputs_orders_by_proc():
    res = crep.parse_worker_outputs([_stdout(_result(1)),
                                     _stdout(_result(0))])
    assert [r["proc"] for r in res] == [0, 1]
    with pytest.raises(ValueError, match="exactly one"):
        crep.parse_worker_outputs(["no result line here"])


def test_summarize_point_takes_the_slowest_process():
    row = crep.summarize_point([_result(0, wall=1.0, exchange_s=0.1),
                                _result(1, wall=2.5, exchange_s=0.9)])
    assert row["wall_s"] == 2.5 and row["exchange_s"] == 0.9
    assert len(row["per_proc"]) == 2 and row["device"] == "cpu"
    assert row["recovery"] == dict(attempt=0, restarts=0, restored=False,
                                   restored_t=None, recovered_steps=0,
                                   attempts=[])


@pytest.mark.parametrize("results,match", [
    ([_result(0, sig="aa" * 32), _result(1, sig="bb" * 32)], "diverge"),
    ([_result(0), _result(1, weights_sig="ee" * 32)], "diverge"),
    ([_result(0), _result(0)], "expected results from procs"),
], ids=["rasters", "weights", "missing_proc"])
def test_summarize_point_rejects(results, match):
    with pytest.raises(ValueError, match=match):
        crep.summarize_point(results)


def test_summarize_point_keeps_the_recovery_history():
    attempts = [dict(index=0, reason="cluster worker failed", backoff_s=0.5,
                     returncodes=[0, 41], beacons={})]
    row = crep.summarize_point(
        [_result(p, attempt=1, restored_from="e/ckpt_20.npz", restored_t=20,
                 recovered_steps=20, ckpt_every=10, n_ckpts=2,
                 ckpt_wall_s=0.01 * (p + 1)) for p in range(2)],
        attempts=attempts)
    assert row["recovery"] == dict(
        attempt=1, restarts=1, restored=True, restored_t=20,
        recovered_steps=20, attempts=[dict(index=0,
                                           reason="cluster worker failed",
                                           backoff_s=0.5)])
    assert (row["n_ckpts"], row["ckpt_wall_s"]) == (2, 0.02)


def test_scaling_report_is_bench_schema_valid():
    rows = [crep.summarize_point([_result(0, nprocs=1)]),
            crep.summarize_point([_result(0), _result(1, wall=2.0)])]
    rep = crep.scaling_report(rows, dict(quick=True, nprocs=[1, 2]))
    assert bench_report.validate(rep) == []
    assert rep["env"]["backend"] == "cpu"
    assert rep["deterministic"]["identical_across_procs"] is True
    assert rep["deterministic"]["identical_weights_across_procs"] is True
    assert rep["wall"]["p1_wall_s"] == 1.0 and rep["wall"]["p2_wall_s"] == 2.0
    assert rep["wall"]["p2_exchange_s"] == 0.1
    assert rep["extra"]["points"][1]["per_proc"][1]["proc"] == 1


def test_cluster_scaling_is_registered():
    assert "cluster_scaling" in registry.BENCHES
    assert "cluster_scaling" not in registry.NOT_PORTED


# -- the environment ---------------------------------------------------------


def test_cluster_env_and_the_tuned_preset(monkeypatch):
    monkeypatch.setenv("LD_PRELOAD", "")
    env = _flags.cluster_env("src", coordinator="file:///tmp/s",
                             num_processes=4, process_id=3, device="cpu")
    assert (env[_flags.ENV_COORD], env[_flags.ENV_NUM_PROCS],
            env[_flags.ENV_PROC_ID], env[_flags.ENV_DEVICE]) == (
        "file:///tmp/s", "4", "3", "cpu")
    assert _flags.ENV_TUNED not in env
    tuned = _flags.cluster_env("src", coordinator="h:1", num_processes=1,
                               process_id=0, tuned=True)
    assert tuned[_flags.ENV_TUNED] == "1"
    preset = _flags.tuned_host_env()
    assert set(preset) <= {"TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD",
                           _flags.ENV_TUNED, "LD_PRELOAD"}
    assert ("LD_PRELOAD" in preset) == (_flags.find_tcmalloc() is not None)
    monkeypatch.setattr(_flags, "TCMALLOC_CANDIDATES", ("/nonexistent.so",))
    assert _flags.find_tcmalloc() is None
    assert "LD_PRELOAD" not in _flags.tuned_host_env()


# -- the launcher and the supervisor ------------------------------------------


def test_launch_joins_through_a_file_store_and_passes_the_device():
    code = ("import os; print(os.environ['REPRO_CLUSTER_COORD'], "
            "os.environ['REPRO_CLUSTER_DEVICE'], "
            "os.environ['REPRO_CLUSTER_PROC_ID'], os.environ['EXTRA'])")
    outs = local.launch(["-c", code], 2, device="cpu",
                        extra_env=dict(EXTRA="x"), timeout=60)
    fields = [o.split() for o in outs]
    assert [f[1:] for f in fields] == [["cpu", "0", "x"], ["cpu", "1", "x"]]
    assert fields[0][0] == fields[1][0]
    assert fields[0][0].startswith("file://")
    with pytest.raises(ValueError):
        local.launch(["-c", "pass"], 0)


def test_a_failed_worker_fails_the_launch():
    code = ("import os, sys, time\n"
            "print('" + RESULT_PREFIX + "{\"proc\": 0}', flush=True)\n"
            "if os.environ['REPRO_CLUSTER_PROC_ID'] == '1':\n"
            "    sys.exit(3)\n"
            "time.sleep(60)\n")
    t0 = time.monotonic()
    with pytest.raises(local.LaunchError, match="cluster worker failed") as e:
        local.launch(["-c", code], 2, timeout=120)
    assert time.monotonic() - t0 < 40
    assert e.value.returncodes[1] == 3
    assert set(e.value.partial_results) == {0, 1}
    assert "SIGTERM -> procs [0]" in str(e.value)


def test_a_launch_times_out():
    with pytest.raises(local.LaunchError, match="timed out after 2s"):
        local.launch(["-c", "import time; time.sleep(60)"], 1, timeout=2)


def test_reap_bounds_its_time_and_logs_sigkill():
    stubborn = ("import signal, time;"
                "signal.signal(signal.SIGTERM, signal.SIG_IGN);"
                "print('ready', flush=True); time.sleep(60)")
    procs = [subprocess.Popen([sys.executable, "-c", stubborn],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    for p in procs:                       # the handlers are installed
        assert p.stdout.readline().strip() == "ready"
    t0 = time.monotonic()
    info = subproc.reap(procs, total_timeout=1.5)
    assert info == dict(terminated=[0, 1, 2], killed=[0, 1, 2])
    assert time.monotonic() - t0 < 10.0   # one shared grace, not 3x
    assert all(p.poll() is not None for p in procs)
    gentle = [subprocess.Popen([sys.executable, "-c",
                                "import time; time.sleep(60)"])]
    assert subproc.reap(gentle, total_timeout=5.0) == dict(terminated=[0],
                                                          killed=[])


def test_launch_error_carries_partial_results():
    payload = {"proc": 1, "spikes": 3}
    err = local.LaunchError("boom", [0, 41], [
        f"noise\n{RESULT_PREFIX}{json.dumps(payload)}\n", "dead"])
    assert err.partial_results == {0: payload}
    assert "partial CLUSTER_RESULT" in str(err)


def test_budget_exhaustion_raises_with_the_attempt_history():
    with pytest.raises(local.LaunchError) as ei:
        local.supervised_launch(["-c", "import sys; sys.exit(3)"], 1,
                                max_restarts=2, backoff_s=0.01, timeout=120)
    err = ei.value
    assert "restart budget exhausted" in str(err)
    assert [a["index"] for a in err.attempts] == [0, 1, 2]
    assert all(a["returncodes"] == [3] for a in err.attempts)
    assert [a["backoff_s"] for a in err.attempts] == [0.01, 0.02, 0.04]


def test_a_lost_result_line_is_a_failure_when_expected():
    with pytest.raises(local.LaunchError, match="CLUSTER_RESULT"):
        local.supervised_launch(["-c", "print('fine')"], 1, max_restarts=0,
                                backoff_s=0.01, timeout=120)


def test_supervised_success_returns_an_empty_history():
    outs, attempts = local.supervised_launch(
        ["-c", f"print({RESULT_PREFIX!r} + '{{}}')"], 1, max_restarts=1,
        backoff_s=0.01, timeout=120)
    assert attempts == [] and RESULT_PREFIX in outs[0]


def test_supervised_rejects_bad_fault_grammar_fast():
    with pytest.raises(ValueError, match="grammar"):
        local.supervised_launch(["-c", "pass"], 1, fault="explode@step=1")


def test_the_fault_is_armed_on_the_first_attempt_only(monkeypatch):
    seen = []

    def fake_launch(cmd, nprocs, **kw):
        seen.append(kw["extra_env"][faults.ENV_FAULT])
        if len(seen) == 1:
            raise local.LaunchError("worker failed", [41], ["dead"])
        return [RESULT_PREFIX + "{}"]

    monkeypatch.setattr(local, "launch", fake_launch)
    monkeypatch.setattr(local.time, "sleep", lambda s: None)
    outs, attempts = local.supervised_launch(
        ["-c", "x"], 1, fault="crash@step=5", max_restarts=2)
    assert seen == ["crash@step=5", ""]    # recovery runs clean
    assert len(attempts) == 1 and attempts[0]["index"] == 0


def test_a_stall_without_beacons_is_caught(tmp_path):
    """No beacon ever changes: the watch ends the gang after the stall
    budget, long before the deadline."""
    t0 = time.monotonic()
    with pytest.raises(local.LaunchError, match="gang stalled") as e:
        local.launch(["-c", "import time; time.sleep(60)"], 2, timeout=120,
                     stall_timeout=1.0, beacon_dir=str(tmp_path))
    assert time.monotonic() - t0 < 30
    assert "none written" in str(e.value)
