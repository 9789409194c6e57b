"""The port's measuring tools (`repro_torch.bench`) on the CPU.

* `report`: the schema, `save`/`load`/`load_dir` and the comparator,
  case by case as `tests/test_bench_report.py` holds the JAX package's,
  with the toolchain rule keyed on torch;
* `timing`: the median and spread, the warm-up and rep counts of
  `time_fn`, and `norm_seconds` equal to the JAX package's;
* the suites at small sizes on the CPU: `table1.bench(rows=[(1, 1)])`,
  `table2.bench` and `profile_cell` (both schedules) give the JAX
  suites' deterministic keys (spikes, arrivals, raster signature, rate)
  at the same arguments; the JAX suites run in an AVX-pinned subprocess
  (`test_torch_reference.start_avx`), started with the module;
* `weak_scaling` cut to WEAK_STEPS steps a cell (`run_suite(quick=True,
  steps=...)`): the residency cell's ratio (10.4x, the reference's
  accounting) and its streamed = materialized identity, and its and the
  ladder's (H = 1, 2, 4) signatures equal to the JAX package's cells at the
  same depth;
* `simserve_throughput --quick` on the CPU: its signatures, program
  builds and captures (`traces`) at 1, 4 and 8 tenants equal to the JAX
  suite's `run_suite(quick=True)` (a second AVX subprocess);
* `connectivity_sweep` cut to a SWEEP grid and depth (`run_suite(quick=
  True, grid=, steps=, ...)`): each profile's reach statistics equal the
  JAX suite's `_reach_stats`, and its spikes, arrivals, raster signature
  and rate under both exchanges the JAX `profile_cell`'s on the same
  prebuilt plan;
* the registry and the CLI: the ported suites, and NotImplementedError
  naming the ROADMAP item for the JAX package's others.
"""
import copy
import json
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.bench import cli, registry, timing
from repro_torch.bench import profile as BP
from repro_torch.bench import report as R
from repro_torch.bench.suites import (connectivity_sweep,
                                     simserve_throughput, table1, table2,
                                     weak_scaling)
from repro_torch.core import EngineConfig, GridConfig

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_reference import start_avx, wait_avx  # noqa: E402

CFG = dict(grid_x=2, grid_y=2, neurons_per_column=60, synapses_per_neuron=24,
           seed=9)
STEPS = 40
TABLE2 = dict(gx=2, gy=2, npc=100, steps=STEPS)
CELLS = {"halo-2-scatter-pipelined": ("halo", 2, "scatter", "pipelined"),
         "allgather-4-block-sync": ("allgather", 4, "block", "sync")}
DET = ("spikes", "arrivals", "raster_sig", "rate_hz")
WEAK_STEPS = 4
#: connectivity_sweep quick cut for the CPU: a 4x4 grid (H = 4, one column
#: row a shard) and 12 steps, at the quick widths (40 neurons a column,
#: M = 30)
SWEEP = dict(grid=4, steps=12)


def _jax_suites() -> dict:
    """Inside the AVX subprocess: the JAX suites' rows and cells."""
    import jax  # noqa: F401  (jax starts under the AVX flag)
    from repro.bench import profile as JP
    from repro.bench.suites import table1 as J1, table2 as J2
    from repro.core import EngineConfig as JE, GridConfig as JG
    out = dict(table1=J1.bench(rows=[(1, 1)], steps=STEPS)[0],
               table2=J2.bench(**TABLE2), weak_scaling=_jax_weak(),
               connectivity_sweep=_jax_sweep())
    for key, (ex, h, pl, sched) in CELLS.items():
        cell = JP.profile_cell(JG(**CFG), JE(n_shards=h, exchange=ex,
                                             placement=pl,
                                             exchange_schedule=sched), STEPS)
        out[key] = {k: cell[k] for k in DET}
    return out


def _jax_weak() -> dict:
    """Inside the AVX subprocess: the JAX weak_scaling suite's quick cells
    at WEAK_STEPS steps (its `_run_cell` on each cell's configs)."""
    from repro.bench.suites import weak_scaling as JW
    from repro.core import EngineConfig as JE, GridConfig as JG
    grid = dict(neurons_per_column=30, seed=2013,
                connectivity="ring:max_ring=1")
    cfg = JG(grid_x=10, grid_y=10, synapses_per_neuron=100, **grid)
    cells = dict(residency_streamed=(cfg, JE(
        n_shards=1, connectivity="streamed:chunk=1")),
        residency_materialized=(cfg, JE(n_shards=1)))
    for gx, gy, h in JW.LADDER:
        cells[f"ladder_{gx}x{gy}_h{h}"] = (JG(
            grid_x=gx, grid_y=gy, synapses_per_neuron=60, **grid),
            JE(n_shards=h, connectivity="streamed:chunk=2"))
    out = {}
    for name, (c, e) in cells.items():
        r = JW._run_cell(c, e, WEAK_STEPS)
        out[name] = dict(spikes=r["spikes"], raster_sig=r["raster_sig"],
                         weight_sig=r["weight_sig"])
    return out


def _jax_sweep() -> dict:
    """Inside the AVX subprocess: the JAX connectivity_sweep's per-profile
    reach statistics and `profile_cell` keys under both exchanges, at the
    SWEEP cut (the suite's own loop at these sizes)."""
    from repro.bench import profile as JP
    from repro.bench.suites import connectivity_sweep as JC
    from repro.core import EngineConfig as JE, GridConfig as JG
    from repro.core import engine as JEN
    out = {}
    for pspec in JC.PROFILE_SPECS:
        cfg = JG(grid_x=SWEEP["grid"], grid_y=SWEEP["grid"],
                 neurons_per_column=40, synapses_per_neuron=30, seed=2013,
                 connectivity=pspec)
        eng0 = JE(n_shards=4, exchange=JC.EXCHANGES[0], placement="block")
        built = JEN.build(cfg, eng0)
        row = dict(stats=JC._reach_stats(cfg, eng0, built))
        for ex in JC.EXCHANGES:
            cell = JP.profile_cell(cfg, JE(n_shards=4, exchange=ex,
                                           placement="block"),
                                   SWEEP["steps"], built=built)
            row[ex] = {k: cell[k] for k in DET}
        out[pspec] = row
    return out


def _jax_simserve() -> dict:
    """Inside the AVX subprocess: the JAX simserve_throughput suite's
    deterministic keys, quick."""
    import jax  # noqa: F401  (jax starts under the AVX flag)
    from repro.bench.suites import simserve_throughput as JS
    return JS.run_suite(quick=True)["deterministic"]


@pytest.fixture(scope="module", autouse=True)
def _avx_job():
    procs = start_avx(__file__, [["--suites"], ["--simserve"]])
    yield procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def _avx_outputs(_avx_job):
    return [json.loads(out.strip().splitlines()[-1])
            for out in wait_avx(_avx_job)]


@pytest.fixture(scope="module")
def jax_suites(_avx_outputs):
    return _avx_outputs[0]


@pytest.fixture(scope="module")
def jax_simserve(_avx_outputs):
    return _avx_outputs[1]


# -- report --------------------------------------------------------------


def _report(name="unit", **over):
    rep = R.make_report(
        name,
        config=dict(grid="2x2", steps=10, quick=True),
        deterministic=dict(spikes=123, raster_sig="abcd", flag=True,
                           hlo_bytes_x=456789),
        wall=dict(wall_s=1.25, steps_per_s=8.0),
        extra=dict(rows=[{"grid": "2x2"}]), device="cpu")
    rep.update(over)
    return rep


def test_report_env_names_the_device():
    env = _report()["env"]
    assert env["torch"] == torch.__version__
    assert env["backend"] == "cpu" and env["device_name"] == "cpu"
    assert env["power_limit_w"] is None and env["device_count"] == 1


def _drop(rep, sect, key):
    del rep[sect][key]


SCHEMA_ERRORS = {
    "missing_section": (lambda r: r.pop("deterministic"), "deterministic"),
    "float_deterministic": (lambda r: r["deterministic"].update(rate=27.5),
                            "rate"),
    "non_numeric_wall": (lambda r: r["wall"].update(wall_s="fast"),
                         "wall_s"),
    "schema_version": (lambda r: r.update(
        schema_version=R.SCHEMA_VERSION + 1), "schema_version"),
    "env_without_torch": (lambda r: _drop(r, "env", "torch"), "torch"),
}


def test_valid_report_has_no_errors():
    assert R.validate(_report()) == []


@pytest.mark.parametrize("case", list(SCHEMA_ERRORS))
def test_schema_errors_flagged(case):
    rep = _report()
    edit, word = SCHEMA_ERRORS[case]
    edit(rep)
    assert any(word in e for e in R.validate(rep))


def test_save_load_round_trip(tmp_path):
    rep = _report()
    path = R.save(rep, str(tmp_path))
    assert path.endswith("BENCH_unit.json")
    assert R.load(path) == rep
    assert R.load_dir(str(tmp_path)) == {"unit": rep}


def test_save_refuses_invalid(tmp_path):
    rep = _report()
    rep["deterministic"]["bad"] = 1.5
    with pytest.raises(ValueError):
        R.save(rep, str(tmp_path))


def _edit_det(key, value):
    return lambda cur, base: cur["deterministic"].update({key: value})


def _other_torch(edit):
    def f(cur, base):
        base["env"]["torch"] = "0.0.0-baseline"
        edit(cur, base)
    return f


# name -> (edit of (current, baseline), ok, word in a failure or warning)
COMPARE_CASES = {
    "identical": (lambda cur, base: None, True, None),
    "deterministic_drift": (_edit_det("spikes", 124), False, "spikes"),
    "raster_sig_drift": (_edit_det("raster_sig", "beef"), False,
                         "raster_sig"),
    "missing_deterministic": (lambda cur, base: cur["deterministic"].pop(
        "spikes"), False, "spikes"),
    "wall_drift_warns": (lambda cur, base: cur["wall"].update(
        wall_s=base["wall"]["wall_s"] * 3), True, "wall_s"),
    "wall_within_tolerance": (lambda cur, base: cur["wall"].update(
        wall_s=base["wall"]["wall_s"] * 1.2), True, None),
    "config_mismatch": (lambda cur, base: cur["config"].update(steps=999),
                        False, "config"),
    "config_lists": (lambda cur, base: (
        base["config"].update(grids=["1x1", "4x4"]),
        cur["config"].update(grids=["1x1", "4x4", "8x8"])), False, "grids"),
    "hlo_drift_other_torch": (_other_torch(_edit_det("hlo_bytes_x", 1)),
                              True, "hlo_bytes_x"),
    "spike_drift_other_torch": (_other_torch(_edit_det("spikes", 1)), False,
                                "spikes"),
}


@pytest.mark.parametrize("case", list(COMPARE_CASES))
def test_compare(case):
    edit, ok, word = COMPARE_CASES[case]
    base = _report()
    cur = copy.deepcopy(base)
    edit(cur, base)
    res = R.compare(cur, base, wall_tol=0.5)
    assert res.ok == ok
    notes = res.failures if not ok else res.warnings
    if word is None:
        assert not res.warnings and not res.failures
    else:
        assert any(word in n for n in notes), notes


def test_compare_dirs(tmp_path):
    basedir, curdir = tmp_path / "base", tmp_path / "cur"
    R.save(_report("a"), str(basedir))
    R.save(_report("b"), str(basedir))
    R.save(_report("a"), str(curdir))
    res = R.compare_dirs(str(curdir), str(basedir))
    assert not res.ok and any("b" in f for f in res.failures)
    R.save(_report("b"), str(curdir))
    assert R.compare_dirs(str(curdir), str(basedir)).ok
    assert not R.compare_dirs(str(tmp_path), str(tmp_path / "none")).ok


# -- timing --------------------------------------------------------------


def test_time_fn_median_and_spread():
    t = timing.Timing(reps_s=(0.2, 0.1, 0.4))
    assert t.median_s == 0.2
    assert t.min_s == 0.1 and t.max_s == 0.4
    assert abs(t.spread - (0.3 / 0.2)) < 1e-9
    assert abs(timing.Timing(reps_s=(0.1, 0.3)).median_s - 0.2) < 1e-9
    calls = []

    def f(x):
        calls.append(1)
        return {"y": (x * 2, [x])}

    t = timing.time_fn(f, torch.ones(4), reps=3, warmup=2)
    assert len(calls) == 5
    assert len(t.reps_s) == 3 and t.median_s >= 0
    s = timing.summarize([0.2, 0.1, 0.4])
    assert s == dict(median_s=0.2, min_s=0.1, max_s=0.4, spread=1.5, reps=3)


@pytest.mark.parametrize("args", [(1.0, 1000, 100, 10.0),
                                  (0.2309371719999973, 12_800_000, 500,
                                   21.52421875), (3.5, 200_000, 300, 0.0)])
def test_norm_seconds_equals_jax(args):
    from repro.bench import timing as jt
    assert timing.norm_seconds(*args) == jt.norm_seconds(*args)
    assert timing.steps_per_sec(args[0], args[2]) == jt.steps_per_sec(
        args[0], args[2])


# -- the suites against the JAX package's --------------------------------


def test_run_profile_holds_the_invariance(monkeypatch):
    """run_profile's report on the CPU: every cell the same physics, the
    report valid, and the left-out HLO costs said so."""
    rep = BP.run_profile(quick=True, device="cpu")
    assert R.validate(rep) == []
    cells = rep["extra"]["cells"]
    assert len({c["raster_sig"] for c in cells}) == 1
    assert rep["deterministic"]["spikes"] > 0
    assert "hlo" in rep["extra"]["not_recorded"]
    assert rep["env"]["backend"] == "cpu"
    # a layout that changed the physics would raise
    fake = iter(range(len(cells)))
    monkeypatch.setattr(BP, "profile_cell", lambda *a, **k: dict(
        cells[0], raster_sig=str(next(fake))))
    with pytest.raises(RuntimeError, match="invariant"):
        BP.run_profile(quick=True, device="cpu")




def test_table1_equals_jax(jax_suites):
    row = table1.bench(rows=[(1, 1)], steps=STEPS, device="cpu")[0]
    want = jax_suites["table1"]
    for k in ("spikes", "raster_sig", "rate_hz", "synapses", "steps",
              "paper_rate_hz"):
        assert row[k] == want[k], k
    assert row["device"] == "cpu" and row["max_memory_allocated_bytes"] is None
    rate = row["spikes"] / (row["neurons"] * STEPS * 1e-3)
    assert row["norm_s_per_syn_per_s_per_hz"] == pytest.approx(
        timing.norm_seconds(row["wall_s"], row["synapses"], STEPS, rate))


def test_table2_equals_jax(jax_suites):
    row = table2.bench(**TABLE2, device="cpu")
    want = jax_suites["table2"]
    for k in ("spikes", "raster_sig", "grid", "steps"):
        assert row[k] == want[k], k
    assert row["total_s"] == pytest.approx(
        row["compute_s"] + row["exchange_s"] + row["arborize_s"])


@pytest.mark.parametrize("key", list(CELLS))
def test_profile_cell_equals_jax(jax_suites, key):
    ex, h, pl, sched = CELLS[key]
    cell = BP.profile_cell(GridConfig(**CFG), EngineConfig(
        n_shards=h, exchange=ex, placement=pl, exchange_schedule=sched),
        STEPS, device="cpu")
    assert {k: cell[k] for k in DET} == jax_suites[key]
    assert cell["exchange_schedule"] == sched and cell["spikes"] > 0
    assert cell["phases_sum_s"] <= cell["wall_s"]


# -- weak_scaling -----------------------------------------------------------


def test_weak_scaling_equals_jax_cells(jax_suites):
    rep = weak_scaling.run_suite(quick=True, device="cpu", steps=WEAK_STEPS)
    assert R.validate(rep) == []
    d, want = rep["deterministic"], jax_suites["weak_scaling"]
    assert d["residency_ratio_x10"] == 104
    assert d["residency_ratio_x10"] >= 10 * weak_scaling.RATIO_FLOOR
    assert d["residency_identical"] is True
    res = want["residency_streamed"]
    assert (d["residency_spikes"], d["residency_raster_sig"],
            d["residency_weight_sig"]) == (res["spikes"], res["raster_sig"],
                                           res["weight_sig"])
    assert want["residency_materialized"] == res
    assert d["residency_spikes"] > 0
    extra = rep["extra"]["residency"]
    assert extra["live_table_bytes"] < extra["streamed_table_bytes"]
    assert [r["shards"] for r in rep["extra"]["ladder"]] == [1, 2, 4]
    for gx, gy, h in weak_scaling.LADDER:
        tag = f"ladder_{gx}x{gy}_h{h}"
        assert (d[f"{tag}_spikes"], d[f"{tag}_raster_sig"]) == (
            want[tag]["spikes"], want[tag]["raster_sig"])


# -- simserve_throughput ------------------------------------------------


def test_simserve_throughput_quick_equals_jax_suite(jax_simserve):
    rep = simserve_throughput.run_suite(quick=True, device="cpu")
    assert R.validate(rep) == []
    d = rep["deterministic"]
    for n in simserve_throughput.TENANT_COUNTS:
        for key in (f"t{n}_sig", f"t{n}_cache_builds", f"t{n}_traces"):
            assert d[key] == jax_simserve[key], key
        assert d[f"t{n}_cache_builds"] == 1 and d[f"t{n}_traces"] == 1
    assert [r["tenants"] for r in rep["extra"]["rows"]] == [1, 4, 8]


def test_connectivity_sweep_equals_jax(jax_suites, capsys):
    rep = connectivity_sweep.run_suite(quick=True, device="cpu", **SWEEP)
    assert R.validate(rep) == []
    want = jax_suites["connectivity_sweep"]
    rows = {r["profile"]: r for r in rep["extra"]["rows"]}
    assert list(rows) == list(connectivity_sweep.PROFILE_SPECS)
    det = rep["deterministic"]
    for pspec, w in want.items():
        row, key = rows[pspec], connectivity_sweep._key(pspec)
        assert {k: row[k] for k in w["stats"]} == w["stats"]
        assert w["halo"]["raster_sig"] == w["allgather"]["raster_sig"]
        assert det[f"{key}_raster_sig"] == w["halo"]["raster_sig"]
        assert det[f"{key}_spikes"] == w["halo"]["spikes"] > 0
        assert row["rate_hz"] == w["halo"]["rate_hz"]
    assert "halo exchange/phaseA" in capsys.readouterr().out


def test_connectivity_sweep_profile_cell_reuses_a_build():
    from repro_torch.core import engine
    cfg = GridConfig(grid_x=2, grid_y=2, neurons_per_column=30,
                     synapses_per_neuron=12, seed=2013,
                     connectivity="exponential:lambda=1.0")
    eng = EngineConfig(n_shards=2, exchange="halo")
    built = engine.build(cfg, eng, device="cpu")
    w0 = built[2].w.clone()
    a = BP.profile_cell(cfg, EngineConfig(n_shards=2, exchange="allgather"),
                        8, device="cpu", built=built)
    b = BP.profile_cell(cfg, eng, 8, device="cpu")
    assert torch.equal(built[2].w, w0)
    assert {k: a[k] for k in DET} == {k: b[k] for k in DET}
    with pytest.raises(ValueError, match="layout"):
        BP.profile_cell(cfg, EngineConfig(n_shards=2, placement="scatter"),
                        8, device="cpu", built=built)


# -- registry and CLI ----------------------------------------------------


def test_registry_ports_three_suites():
    # (since event delivery: a fourth, event_vs_dense's single-device rows;
    # since streamed connectivity: weak_scaling; since the mesh:
    # comm_overlap, scaling and event_vs_dense's distributed cells)
    # (since the cluster runtime: cluster_scaling; since the simulation
    # service: simserve_throughput; since the experiment plans:
    # connectivity_sweep)
    # (since the training slice: lm_throughput)
    assert sorted(registry.BENCHES) == ["cluster_scaling", "comm_overlap",
                                        "connectivity_sweep",
                                        "event_vs_dense", "lm_throughput",
                                        "profile", "scaling",
                                        "simserve_throughput", "table1",
                                        "table2", "weak_scaling"]
    for name in ("weak_scaling", "comm_overlap", "scaling",
                 "cluster_scaling", "simserve_throughput",
                 "connectivity_sweep", "lm_throughput"):
        assert name not in registry.NOT_PORTED
    assert sorted(registry.NOT_PORTED) == ["roofline"]
    assert "13.6" in registry.NOT_PORTED["roofline"]
    for name in registry.NOT_PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
            registry.get(name)
    with pytest.raises(KeyError):
        registry.get("nope")


def test_cli_runs_table2_on_the_cpu(tmp_path, monkeypatch, capsys):
    real = table2.bench
    monkeypatch.setattr(table2, "bench", lambda quick, device: real(
        **TABLE2, device=device))
    assert cli.main(["run", "table2", "--device", "cpu", "--out",
                     str(tmp_path)]) == 0
    rep = R.load(str(tmp_path / "BENCH_table2.json"))
    assert rep["env"]["backend"] == "cpu" and R.validate(rep) == []
    assert cli.main(["compare", "table2", "--current", str(tmp_path),
                     "--baseline", str(tmp_path)]) == 0
    assert cli.main(["list"]) == 0
    out = capsys.readouterr().out
    assert "table1" in out and "not ported yet" in out
    assert cli.main(["run", "roofline", "--device", "cpu", "--out",
                     str(tmp_path)]) == 1


if __name__ == "__main__":
    assert sys.argv[1] in ("--suites", "--simserve")
    print(json.dumps(_jax_suites() if sys.argv[1] == "--suites"
                     else _jax_simserve()))
