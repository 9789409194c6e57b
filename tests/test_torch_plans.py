"""The port's experiment plans (`repro_torch.bench.plans`) against the JAX
package's (`repro.bench.plans`), on the CPU.

* `validate`: the same `PlanError` lists on every bad document of the
  JAX schema tests, and the same `Plan` on good ones;
* `expand` with one pinned env dict: equal cells (every knob, key, hash
  and physics group) and exclusion reasons, on the committed quick and
  paper_scaling plans' contents (written inline here) and on a document
  with streamed connectivity x scatter placement x 2 processes;
* the runner's resume cases with a fake executor, as
  `tests/test_plan_runner.py` holds the JAX runner; the merged report
  validates under the port's `report.validate` and flags a group whose
  signatures differ;
* `dashboard.render` byte-equal to the JAX dashboard for the same records;
* a real tiny plan through the CLI (`plan expand|run|report --device
  cpu`): five cells in fresh interpreters and over the cluster launcher
  (1 process halo block, event, streamed scatter; 2 processes halo, and
  streamed hier scatter) give one raster, the JAX package's `StepProgram`
  run of the same config in an AVX-pinned subprocess
  (`test_torch_reference.start_avx`, started with the module), and a
  second run executes no cell.
"""
import copy
import json
import os
import sys
from pathlib import Path

import pytest
import torch

from repro.bench import plans as jplans
from repro.bench import report as JR
from repro.bench.plans import dashboard as jdash
from repro.bench.plans import runner as JRU
from repro_torch.bench import cli
from repro_torch.bench import plans
from repro_torch.bench import report as R
from repro_torch.bench.plans import dashboard as dash
from repro_torch.bench.plans import runner as RU
from repro_torch.bench.plans import schema as S

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_reference import start_avx, wait_avx  # noqa: E402

ENV = {"jax": "0.4.37", "backend": "cpu"}
SIG = "ab" * 32
BASELINES = Path(__file__).resolve().parents[1] / "benchmarks" / "baselines"


def _doc(**over):
    doc = dict(name="unit",
               workload=dict(neurons_per_column=30, synapses_per_neuron=12,
                             steps=20, seed=7),
               axes=dict(delivery=["dense", "event"], shards=[2]))
    doc.update(over)
    return doc


# the committed plans' contents (benchmarks/plans/*.yaml), inline
QUICK = dict(
    name="quick",
    workload=dict(neurons_per_column=40, synapses_per_neuron=16, steps=40,
                  phase_steps=10, seed=7),
    axes=dict(grid=["2x2"], connectivity=["materialized",
                                          "streamed:chunk=1"],
              delivery=["dense", "event"], exchange=["halo", "allgather"],
              exchange_schedule=["sync", "pipelined"], shards=[2],
              nprocs=[1, 2]),
    exclude=[{"nprocs": 2, "exchange": "allgather"},
             {"nprocs": 2, "exchange_schedule": "pipelined"}],
    budgets=dict(timeout_s=600, reps=2))
PAPER_SCALING = dict(
    name="paper_scaling",
    workload=dict(neurons_per_column=100, synapses_per_neuron=40, steps=100,
                  phase_steps=25, seed=2013),
    axes=dict(grid=["2x2", "4x2", "4x4"], delivery=["dense", "event"],
              exchange=["halo", "hier"],
              exchange_schedule=["sync", "pipelined"], shards=[8],
              nprocs=[1, 2]),
    budgets=dict(timeout_s=1800, reps=2))
STREAMED_SCATTER = _doc(axes=dict(
    connectivity=["materialized", "streamed:chunk=1"],
    placement=["block", "scatter"], exchange=["halo", "hier"], shards=[4],
    nprocs=[1, 2]))
EXPAND_DOCS = {
    "quick": (QUICK, 15), "paper_scaling": (PAPER_SCALING, 36),
    "streamed_scatter_nprocs2": (STREAMED_SCATTER, 12),
    "unit": (_doc(), 2),
    "divisibility": (_doc(axes=dict(shards=[2], nprocs=[1, 3])), 1),
    "hier_needs_processes": (_doc(axes=dict(
        exchange=["halo", "hier"], shards=[2], nprocs=[1, 2])), 3),
    "event_refuses_streamed": (_doc(axes=dict(
        delivery=["dense", "event"], shards=[2],
        connectivity=["materialized", "streamed:chunk=2"])), 3),
    "user_exclude": (_doc(exclude=[{"delivery": "event"}]), 1),
    "layouts": (_doc(axes=dict(delivery=["dense", "event"],
                               exchange=["halo", "allgather"],
                               shards=[1, 2])), 8),
    "timeout_budget": (_doc(budgets=dict(timeout_s=123)), 2),
    "stim_and_profiles": (_doc(axes=dict(
        stim=["default", "quiet", "strong"],
        profile=["ring3", "gaussian:sigma=1.5", "exponential:lambda=1.0"],
        grid=["2x2", "4x1"])), 18),
}

# bad documents: the JAX schema tests' cases
BAD_DOCS = {
    "all_errors_at_once": _doc(bogus=1, axes=dict(delivery=["dens"],
                                                  warp=[1]),
                               workload=dict(steps=-1, nope=2)),
    "duplicate_axis_value": _doc(axes=dict(delivery=["dense", "dense"])),
    "bad_name": _doc(name="no spaces allowed"),
    "exclude_unknown_axis": _doc(exclude=[{"warp": 2}]),
    "exclude_bad_value": _doc(exclude=[{"delivery": "sparse"}]),
    "not_a_mapping": ["a", "list"],
    "sections_not_mappings": dict(name="x", workload=[1], axes=[2],
                                  exclude={"a": 1}, budgets=[3]),
    "empty_axis": _doc(axes=dict(delivery=[])),
    "bad_exclude_entry": _doc(exclude=[{}, 3]),
}
for _i, _axes in enumerate([
        dict(delivery=["dense", "sparse"]), dict(exchange=["ring"]),
        dict(exchange_schedule=["eager"]), dict(stim=["loud"]),
        dict(grid=["2x"]), dict(grid=["0x2"]), dict(shards=[0]),
        dict(shards=[True]), dict(nprocs=["2"]),
        dict(profile=["definitely-not-a-profile"]),
        dict(connectivity=["paged"]),
        dict(connectivity=["streamed:chunk=0"]),
        dict(placement=["diagonal"])]):
    BAD_DOCS[f"axis_{_i}_{next(iter(_axes))}"] = _doc(axes=_axes)
for _i, _b in enumerate([dict(reps=0), dict(timeout_s=-5),
                         dict(gpu_hours=1)]):
    BAD_DOCS[f"budgets_{_i}_{next(iter(_b))}"] = _doc(budgets=_b)


# -- the real tiny plan's JAX reference, started with the module ----------

TINY = dict(
    name="tiny",
    workload=dict(neurons_per_column=20, synapses_per_neuron=8, steps=10,
                  phase_steps=4, seed=7),
    axes=dict(connectivity=["materialized", "streamed:chunk=1"],
              delivery=["dense", "event"], exchange=["halo", "hier"],
              placement=["block", "scatter"], shards=[2], nprocs=[1, 2]),
    # five cells: 1 process halo block dense and event, 1 process streamed
    # scatter halo; 2 processes halo block, 2 processes streamed hier scatter
    exclude=[{"placement": "scatter", "connectivity": "materialized"},
             {"placement": "block", "connectivity": "streamed:chunk=1"},
             {"delivery": "event", "nprocs": 2},
             {"exchange": "hier", "connectivity": "materialized"},
             {"exchange": "halo", "connectivity": "streamed:chunk=1",
              "nprocs": 2}],
    budgets=dict(timeout_s=300, reps=2))


def _jax_tiny() -> dict:
    """Inside the AVX subprocess: the JAX package's StepProgram run of the
    tiny plan's physics (one shard)."""
    import jax  # noqa: F401  (jax starts under the AVX flag)
    import numpy as np
    from repro.core import EngineConfig, GridConfig, StepProgram, observables
    w = TINY["workload"]
    sp = StepProgram(GridConfig(grid_x=2, grid_y=2,
                                neurons_per_column=w["neurons_per_column"],
                                synapses_per_neuron=w["synapses_per_neuron"],
                                seed=w["seed"]), EngineConfig())
    _, raster, _ = sp.run(sp.init_state(), 0, w["steps"])
    raster = np.asarray(raster)
    return dict(raster_sig=observables.raster_signature(
        raster, np.asarray(sp.plan.gid)).hex(), spikes=int(raster.sum()))


@pytest.fixture(scope="module")
def jax_tiny():
    procs = start_avx(__file__, [["--tiny"]])
    try:
        yield json.loads(wait_avx(procs)[0].strip().splitlines()[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


# -- schema ---------------------------------------------------------------


@pytest.mark.parametrize("case", list(BAD_DOCS))
def test_validate_gives_the_jax_errors(case):
    doc = BAD_DOCS[case]
    with pytest.raises(jplans.PlanError) as want:
        jplans.validate(copy.deepcopy(doc))
    with pytest.raises(plans.PlanError) as got:
        plans.validate(copy.deepcopy(doc))
    assert got.value.errors == want.value.errors
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", list(EXPAND_DOCS))
def test_validate_and_expand_equal_jax(case):
    doc, n_cells = EXPAND_DOCS[case]
    got, want = plans.validate(doc), jplans.validate(doc)
    assert got.to_config() == want.to_config()
    assert got.description == want.description
    cells, excluded = plans.expand(got, env=ENV)
    jcells, jexcluded = jplans.expand(want, env=ENV)
    assert len(cells) == n_cells
    assert cells == jcells
    assert excluded == jexcluded
    assert all(e["reason"] for e in excluded)


def test_expand_errors_equal_jax():
    doc = _doc(exclude=[{"delivery": ["dense", "event"]}])
    for pk in (plans, jplans):
        with pytest.raises(pk.PlanError, match="zero cells"):
            pk.expand(pk.validate(doc), env=ENV)
    p = plans.validate(_doc())
    axes = {a: list(v) for a, v in p.axes.items()}
    axes["delivery"] = ["dense", "dense"]
    dup = S.Plan(name=p.name, workload=p.workload, axes=axes, exclude=(),
                 budgets=p.budgets)
    with pytest.raises(plans.PlanError, match="duplicate"):
        plans.expand(dup, env=ENV)


def test_runtime_env_names_torch_and_the_device():
    from repro_torch.bench.plans.expand import runtime_env
    assert runtime_env("cpu") == {"torch": torch.__version__,
                                  "device": "cpu"}
    assert runtime_env()["device"] == "cuda"
    cell = plans.expand(plans.validate(_doc()), env=runtime_env("cpu"))[0][0]
    assert plans.cell_hash(cell, runtime_env("cpu")) != plans.cell_hash(
        cell, runtime_env("cuda"))


def test_load_reads_json_and_yaml(tmp_path):
    path = tmp_path / "p.json"
    path.write_text(json.dumps(_doc()))
    assert plans.load(str(path)).to_config() == jplans.load(
        str(path)).to_config()
    with pytest.raises(plans.PlanError):
        plans.load(str(tmp_path / "missing.json"))
    yaml = pytest.importorskip("yaml")
    ypath = tmp_path / "hinted.yaml"
    ypath.write_text(yaml.safe_dump(dict(workload=dict(steps=10))))
    p = plans.load(str(ypath))
    assert p.name == "hinted" and p.workload["steps"] == 10


# -- runner, store, report ------------------------------------------------


def _plan_doc(**over):
    doc = dict(name="unit",
               workload=dict(neurons_per_column=30, synapses_per_neuron=12,
                             steps=20, phase_steps=5, seed=7),
               axes=dict(delivery=["dense", "event"], exchange=["halo"],
                         shards=[2]))
    doc.update(over)
    return doc


def _plan(**over):
    return plans.validate(_plan_doc(**over))


def _executor(calls=None, sig=SIG, fail_keys=()):
    def run(cell):
        if calls is not None:
            calls.append(cell["key"])
        if cell["key"] in fail_keys:
            raise RuntimeError("injected cell failure")
        res = dict(wall_s=0.5, wall_reps_s=[0.5, 0.6], spikes=10,
                   rate_hz=1.0, raster_sig=sig, phase_a_s=0.2,
                   exchange_s=0.1, phase_b_s=0.2,
                   phase_steps=cell["phase_steps"])
        if cell["delivery"] == "event":
            res["saturated"] = 0
        return RU._finalize(cell, res)
    return run


def _run(plan, out, **kw):
    kw.setdefault("env", ENV)
    kw.setdefault("log", lambda m: None)
    return plans.run_plan(plan, str(out), **kw)


def _fail_first(p):
    return {plans.expand(p, env=ENV)[0][0]["key"]}


def _drop_one(tmp_path, s0):
    assert plans.ResultStore(str(tmp_path), "unit").drop_cell(
        s0["executed_keys"][0])
    return [s0["executed_keys"][0]]


# name -> (first run's kwargs, between (tmp_path, summary) -> keys that
# must rerun or None, second run's kwargs, (executed, skipped, failed, ok)
# of the second run)
RESUME_CASES = {
    "second_run_executes_nothing": (
        {}, None, dict(assert_complete=True), (0, 2, 0, True)),
    "deleted_cell_is_the_only_rerun": (
        {}, _drop_one, {}, (1, 1, 0, True)),
    "stale_hash_reruns_every_cell": (
        {}, None, dict(env={"jax": "9.9.9", "backend": "cpu"}),
        (2, 0, 0, True)),
    "other_device_reruns_every_cell": (
        dict(env={"torch": "2", "device": "cpu"}), None,
        dict(env={"torch": "2", "device": "cuda"}), (2, 0, 0, True)),
    "failed_cell_retries": (
        dict(fail=True), None, {}, (1, 1, 0, True)),
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resume(case, tmp_path):
    first, between, second, want = RESUME_CASES[case]
    p = _plan()
    first = dict(first)
    fail = _fail_first(p) if first.pop("fail", False) else ()
    s0 = _run(p, tmp_path, executor=_executor(fail_keys=fail), **first)
    assert (s0["executed"], s0["failed"]) == (2 - len(fail), len(fail))
    assert s0["ok"] == (not fail)
    store = plans.ResultStore(str(tmp_path), "unit")
    for k in fail:
        assert store.load_cell(k) is None
    rerun = between(tmp_path, s0) if between else None
    calls = []
    s = _run(p, tmp_path, executor=_executor(calls), **second)
    assert (s["executed"], s["skipped"], s["failed"], s["ok"]) == want
    assert calls == s["executed_keys"]
    if rerun is not None:
        assert calls == rerun
    if fail:
        assert calls == list(fail)
    assert store.load_summary()["executed"] == s["executed"]


def test_assert_complete_fails_when_work_remained(tmp_path):
    s = _run(_plan(), tmp_path, executor=_executor(), assert_complete=True)
    assert s["executed"] == 2 and not s["ok"]


def test_store_layout_equals_jax(tmp_path):
    """The same records under the same names: the JAX store reads the
    port's cells."""
    _run(_plan(), tmp_path, executor=_executor())
    got = plans.ResultStore(str(tmp_path), "unit").load_results()
    want = jplans.ResultStore(str(tmp_path), "unit").load_results()
    assert got == want and len(got) == 2
    assert os.path.isfile(tmp_path / "unit" / "last_run_summary.json")


def test_merged_report_validates_and_gates_identity(tmp_path):
    _run(_plan(), tmp_path, executor=_executor())
    path, rep = plans.write_report(_plan(), str(tmp_path), env=ENV)
    assert R.validate(rep) == [] and rep["name"] == "plan_unit"
    assert path.endswith("BENCH_plan_unit.json")
    det = rep["deterministic"]
    idents = [k for k in det if k.startswith("identical_")]
    assert len([k for k in det if k.endswith("_spikes")]) == 2
    assert len(idents) == 1 and det[idents[0]] is True
    assert any(k.endswith("_exchange_s") for k in rep["wall"])
    assert not any("reps" in k for k in rep["wall"])
    # the deterministic and wall sections equal the JAX reporter's
    jrep = jplans.merged_report(jplans.validate(_plan_doc()),
                                plans.ResultStore(str(tmp_path), "unit")
                                .load_results())
    assert rep["deterministic"] == jrep["deterministic"]
    assert rep["wall"] == jrep["wall"] and rep["config"] == jrep["config"]
    for r in plans.ResultStore(str(tmp_path), "unit").load_results():
        res = r["result"]
        assert res["time_per_syn_event_s"] == pytest.approx(
            res["wall_s"] / (res["spikes"] *
                             r["cell"]["synapses_per_neuron"]), rel=1e-2)


def test_merged_report_flags_a_divergent_group(tmp_path):
    p = _plan()
    flip = plans.expand(p, env=ENV)[0][1]["key"]

    def run(cell):
        sig = "ff" * 32 if cell["key"] == flip else SIG
        return _executor(sig=sig)(cell)

    _run(p, tmp_path, executor=run)
    _, rep = plans.write_report(p, str(tmp_path), env=ENV)
    ident = [k for k in rep["deterministic"] if k.startswith("identical_")]
    assert rep["deterministic"][ident[0]] is False
    assert any(not g["identical"] for g in rep["extra"]["groups"].values())


def test_partial_store_is_refused_without_flag(tmp_path):
    p = _plan()
    _run(p, tmp_path, executor=_executor())
    store = plans.ResultStore(str(tmp_path), "unit")
    store.drop_cell(store.load_results()[0]["key"])
    with pytest.raises(plans.PlanError):
        plans.write_report(p, str(tmp_path), env=ENV)
    _, rep = plans.write_report(p, str(tmp_path), allow_partial=True,
                                env=ENV)
    assert len(rep["extra"]["cells"]) == 1


def test_finalize_equals_jax():
    cell = plans.expand(_plan(), env=ENV)[0][0]
    for res in (dict(wall_s=0.123456, spikes=77), dict(spikes=0),
                dict(wall_s=0.5)):
        assert RU._finalize(cell, dict(res)) == JRU._finalize(cell,
                                                              dict(res))


# -- dashboard ------------------------------------------------------------


def _records(sig_for=None):
    doc = dict(name="unit",
               workload=dict(neurons_per_column=30, synapses_per_neuron=12,
                             steps=20, phase_steps=5, seed=7),
               axes=dict(delivery=["dense"], exchange=["halo"],
                         exchange_schedule=["sync", "pipelined"],
                         shards=[2], nprocs=[1, 2]))
    plan = plans.validate(doc)
    recs = []
    for c in plans.expand(plan, env=ENV)[0]:
        exch = 0.1 if c["exchange_schedule"] == "sync" else 0.04
        recs.append(dict(
            key=c["key"], hash=c["hash"], cell=c, elapsed_s=1.0,
            result=dict(wall_s=0.5 * c["nprocs"], spikes=10, rate_hz=1.0,
                        raster_sig=(sig_for or {}).get(c["key"], SIG),
                        phase_a_s=0.2, exchange_s=exch, phase_b_s=0.2,
                        phase_steps=5, time_per_syn_event_s=4.2e-3)))
    return plan.to_config(), recs


def _prior(cfg, recs, label):
    wall = {f"{r['key']}_wall_s": r["result"]["wall_s"] + 0.1 for r in recs}
    return label, R.make_report(f"plan_{cfg['name']}", dict(quick=True),
                                dict(), wall, device="cpu")


DASH_CASES = {
    "plain": lambda cfg, recs: {},
    "summary": lambda cfg, recs: dict(summary=dict(executed=4, skipped=0,
                                                   failed=0)),
    "prior_runs": lambda cfg, recs: dict(prior_reports=[
        _prior(cfg, recs, "plan_unit_0601"),
        _prior(cfg, recs, "plan_unit_0701")]),
    "jax_history": lambda cfg, recs: dict(history=JR.load_dir(
        str(BASELINES))),
}


@pytest.mark.parametrize("diverged", [False, True])
@pytest.mark.parametrize("case", list(DASH_CASES))
def test_dashboard_bytes_equal_jax(case, diverged):
    cfg, recs = _records()
    if diverged:
        cfg, recs = _records(sig_for={recs[0]["key"]: "ff" * 32})
    kw = DASH_CASES[case](cfg, recs)
    html = dash.render(cfg, recs, **kw)
    assert html == jdash.render(cfg, recs, **kw)
    assert html.startswith("<!DOCTYPE html>") and "<script" not in html
    assert "http://" not in html and "https://" not in html
    assert ("DIVERGED" in html) == diverged


def test_dashboard_history_names_torch():
    rep = R.make_report("table1", dict(quick=True), dict(sig="ab"),
                        dict(a_wall_s=1.0), device="cpu")
    html = dash.history_section({"table1": rep})
    assert f"torch {rep['env']['torch']}" in html


# -- the CLI and a real tiny plan on the CPU ------------------------------


def test_cli_plan_expand_and_errors(tmp_path, capsys):
    path = tmp_path / "quick.json"
    path.write_text(json.dumps(QUICK))
    assert cli.main(["plan", "expand", str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "15 cell(s), 1" in out and "EXCLUDED" in out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(_doc(axes=dict(delivery=["sparse"]))))
    assert cli.main(["plan", "expand", str(bad)]) == 2
    assert cli.main(["plan", "resume", str(path), "--device", "cpu",
                     "--out", str(tmp_path / "none")]) == 2
    assert cli.main(["plan", "report", str(path), "--device", "cpu",
                     "--out", str(tmp_path / "none")]) == 1


def test_tiny_plan_runs_on_the_cpu_equal_to_jax(tmp_path, jax_tiny, capsys):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(TINY))
    out = str(tmp_path / "store")
    args = ["--device", "cpu", "--out", out]
    assert cli.main(["plan", "run", str(path), *args]) == 0
    store = plans.ResultStore(out, "tiny")
    recs = store.load_results()
    assert sorted((r["cell"]["nprocs"], r["cell"]["connectivity"],
                   r["cell"]["delivery"], r["cell"]["exchange"],
                   r["cell"]["placement"]) for r in recs) == [
        (1, "materialized", "dense", "halo", "block"),
        (1, "materialized", "event", "halo", "block"),
        (1, "streamed:chunk=1", "dense", "halo", "scatter"),
        (2, "materialized", "dense", "halo", "block"),
        (2, "streamed:chunk=1", "dense", "hier", "scatter")]
    for r in recs:
        res = r["result"]
        assert r["env"] == {"torch": torch.__version__, "device": "cpu"}
        assert (res["raster_sig"], res["spikes"]) == (
            jax_tiny["raster_sig"], jax_tiny["spikes"]), r["key"]
        assert res["spikes"] > 0 and res["phase_steps"] == 4
        assert res["wall_s"] > 0 and "exchange_s" in res
        assert res["time_per_syn_event_s"] > 0
        if r["cell"]["nprocs"] == 1:
            assert len(res["wall_reps_s"]) == 2
            assert res["wall_s"] == min(res["wall_reps_s"])
            assert res["arrivals"] >= 0
        if r["cell"]["delivery"] == "event":
            assert res["saturated"] == 0
    capsys.readouterr()
    assert cli.main(["plan", "resume", str(path), *args,
                     "--assert-complete"]) == 0
    assert '"executed": 0' in capsys.readouterr().out
    assert store.load_summary()["skipped"] == 5
    assert cli.main(["plan", "report", str(path), *args]) == 0
    rep = R.load(os.path.join(store.root, "BENCH_plan_tiny.json"))
    assert R.validate(rep) == [] and rep["env"]["backend"] == "cpu"
    idents = [k for k in rep["deterministic"] if k.startswith("identical_")]
    assert len(idents) == 1 and rep["deterministic"][idents[0]] is True
    assert os.path.getsize(os.path.join(store.root, "dashboard.html")) > 1000


if __name__ == "__main__":
    assert sys.argv[1:] == ["--tiny"]
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    print(json.dumps(_jax_tiny()))
