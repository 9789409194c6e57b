"""The bench suites over `torch.distributed` ranks on the CPU (gloo):
`comm_overlap`, `scaling` and `event_vs_dense`'s distributed cells, at
small sizes, the three run at once by the module's fixture.

* `comm_overlap`: both schedules give the same raster in every cell (the
  suite raises otherwise), and each profile's raster is the port's
  stacked single-process run's; on the CPU the hidden < exposed gate is
  recorded, not enforced, and the report says so; the gate itself raises
  where it holds (a GPU a rank), and the schedule gate everywhere (fed
  cells, no processes).
* `scaling`: every H of the strong ladder gives the stacked run's raster.
* `event_vs_dense.bench_distributed`: one raster a stimulus level across
  every H, exchange and delivery, equal to the stacked run's; `sat` 0
  with the default capacities.
* The CLI and the registry: the three run from `python -m
  repro_torch.bench` (`cli.main`), and the registry no longer lists them
  as not ported.
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest

from repro_torch.bench import cli, registry
from repro_torch.bench import report as R
from repro_torch.bench.suites import comm_overlap, event_vs_dense, scaling
from repro_torch.core import (EngineConfig, GridConfig, StepProgram,
                              observables)

NPC, STEPS = 40, 20


def _run_all():
    kw = dict(device="cpu", npc=NPC, steps=STEPS, timeout=240)
    jobs = dict(
        comm_overlap=lambda: comm_overlap.run_suite(quick=True, **kw),
        scaling=lambda: scaling.run_suite(quick=True, **kw),
        event_vs_dense=lambda: event_vs_dense.bench_distributed(
            quick=True, **kw))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futures = {k: ex.submit(f) for k, f in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


@pytest.fixture(scope="module")
def suites():
    return _run_all()


def _stacked_sig(cfg: GridConfig, steps: int = STEPS) -> str:
    sp = StepProgram(cfg, EngineConfig(n_shards=2), device="cpu")
    _, raster, _ = sp.run(sp.init_state(), 0, steps)
    return observables.raster_signature(raster.numpy(),
                                        sp.plan.gid.numpy()).hex()


def test_comm_overlap_schedules_agree_with_the_stacked_run(suites):
    rep = suites["comm_overlap"]
    assert R.validate(rep) == []
    assert rep["config"]["hidden_gate"] == {
        "h2": "recorded only: the ranks share a device",
        "h4": "recorded only: the ranks share a device"}
    assert rep["config"]["wire"] == {"h2": "gloo", "h4": "gloo"}
    cells = {c["cell"]: c for c in rep["extra"]["cells"]}
    assert len(cells) == 12
    for pkey, pspec in comm_overlap.PROFILES:
        want = _stacked_sig(GridConfig(
            grid_x=4, grid_y=2, neurons_per_column=NPC,
            synapses_per_neuron=50, seed=5, connectivity=pspec))
        for H in comm_overlap.H_LIST:
            for sched in comm_overlap.SCHEDULES:
                assert cells[f"{pkey}_h{H}_{sched}"]["raster_sig"] == want
    for p in rep["extra"]["overlap"]:
        assert isinstance(p["hidden"], bool)


def _fed_cells(pipelined_exchange_s: float, pipelined_sig: str = "a"):
    """comm_overlap's result lines of one H, made up: sync exposes 1 s."""
    out = []
    for pkey, pspec in comm_overlap.PROFILES:
        for sched in comm_overlap.SCHEDULES:
            ex = 1.0 if sched == "sync" else pipelined_exchange_s
            out.append(dict(
                key=f"{pkey}_h{{H}}_{sched}", profile=pspec, reach=3, h=0,
                schedule=sched, steps=1, wire="nccl", phase_a_s=1.0,
                exchange_s=ex, phase_b_s=1.0, phases_sum_s=2.0 + ex,
                exposed_fraction=ex / (2.0 + ex), spikes=1,
                raster_sig="a" if sched == "sync" else pipelined_sig))
    return out


@pytest.mark.parametrize("separate,pipelined_s,sig,error", [
    (True, 2.0, "a", "not hidden"), (False, 2.0, "a", None),
    (True, 0.5, "a", None), (False, 0.5, "b", "changed the physics")])
def test_comm_overlap_gates(monkeypatch, separate, pipelined_s, sig, error):
    """The hidden < exposed gate holds only where the ranks have a GPU
    each; the schedules' rasters must agree everywhere."""
    def fake(fn, args, H, **kw):
        return [dict(c, key=c["key"].format(H=H))
                for c in _fed_cells(pipelined_s, sig)]
    monkeypatch.setattr(comm_overlap, "call_ranks", fake)
    monkeypatch.setattr(comm_overlap, "separate_devices",
                        lambda device, n: separate)
    if error is None:
        rep = comm_overlap.run_suite(device="cpu")
        gate = rep["config"]["hidden_gate"]["h2"]
        assert gate.startswith("enforced" if separate else "recorded")
    else:
        with pytest.raises(RuntimeError, match=error):
            comm_overlap.run_suite(device="cpu")


def test_scaling_strong_ladder_equals_the_stacked_run(suites):
    rep = suites["scaling"]
    assert R.validate(rep) == []
    assert rep["config"]["strong_shards"] == [1, 2, 4]
    assert rep["config"]["wire"] == "gloo"
    assert rep["deterministic"]["strong_identical_across_h"] is True
    cfg = GridConfig(grid_x=2, grid_y=2, neurons_per_column=NPC)
    assert rep["deterministic"]["strong_raster_sig"] == _stacked_sig(cfg)
    for r in rep["extra"]["weak"]:
        gx, gy = {1: (1, 1), 2: (2, 1), 4: (2, 2)}[r["shards"]]
        assert r["raster_sig"] == _stacked_sig(GridConfig(
            grid_x=gx, grid_y=gy, neurons_per_column=NPC))


def test_event_vs_dense_distributed_cells(suites):
    h_list, cells = suites["event_vs_dense"]
    assert h_list == [1, 2, 4]
    assert len(cells) == 18
    cfg = GridConfig(grid_x=2, grid_y=2, neurons_per_column=NPC,
                     synapses_per_neuron=50, seed=5)
    for stim in (1, 0):
        want = _stacked_sig(dataclasses.replace(
            cfg, stim_events_per_ms_per_column=stim))
        sigs = {c["raster_sig"] for c in cells.values()
                if c["stim_per_ms"] == stim}
        assert sigs == {want}
    for key, c in cells.items():
        if c["delivery"] == "event" and "rated" not in key:
            assert c["saturated"] == 0
        assert c["wire"] == "gloo" and np.isfinite(c["exchange_s"])


def test_the_cli_runs_the_distributed_suites(suites, tmp_path, monkeypatch,
                                             capsys):
    """`python -m repro_torch.bench run NAME` reaches each suite through
    the registry (the runs themselves are the fixture's)."""
    monkeypatch.setattr(comm_overlap, "run_suite",
                        lambda quick, device: suites["comm_overlap"])
    monkeypatch.setattr(scaling, "run_suite",
                        lambda quick, device: suites["scaling"])
    for name in ("comm_overlap", "scaling"):
        assert name not in registry.NOT_PORTED
        assert cli.main(["run", name, "--quick", "--device", "cpu",
                         "--out", str(tmp_path)]) == 0
        assert R.validate(R.load(str(tmp_path / f"BENCH_{name}.json"))) \
            == []
    assert "event_vs_dense" in registry.BENCHES
    assert cli.main(["list"]) == 0
    listed = capsys.readouterr().out
    assert "comm_overlap" in listed and "scaling" in listed
