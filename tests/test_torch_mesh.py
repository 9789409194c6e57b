"""The port's mesh path on the CPU: `StepProgram(cfg, eng, mesh=...)` over
`torch.distributed` ranks (gloo), against the port's stacked
single-process run and the JAX package's `shard_map` run on 4 host
devices, bit for bit.

* Ranks: each (R, cells) job starts once (`bench.subproc.Ranks`,
  a `file://` store under the test's temporary directory) and runs all
  of its cells: R = 4 (one shard a rank) dense {allgather, halo, hier} x
  {sync, pipelined}, scatter placement with allgather, event delivery
  with allgather and halo, streamed connectivity (chunk = 1) with halo
  sync, halo pipelined and allgather sync, and a 16x1 ring1 strip whose
  halo does not reach every rank; R = 2 (two shards a rank, H = 4: hier's
  groups are the ranks' blocks, halo messages straddle ranks); R = 1
  (the four shards on one rank: streamed connectivity with scatter
  placement, halo sync and allgather pipelined).  Each cell
  gives the raster and weight signatures (gathered on the primary), the
  spikes, the event cells' `sat` and every rank's messages by
  destination; a few cells also run `time_phases`.
* The JAX package's runs: one AVX-pinned subprocess with 4 forced host
  devices (`XLA_FLAGS=--xla_cpu_max_isa=AVX
  --xla_force_host_platform_device_count=4`), `StepProgram(..., mesh=
  make_mesh(4))` a cell, hier's groups the ranks' blocks (`hier_groups`
  = R).  It starts with the module, beside the ranks.
* Units without processes: block slicing of the plan, the states, the
  EventPlan and the StreamedPlan, the stimulus of a block plan, the chunk
  source's bounds of a block, `mesh_shard_groups`, the halo routes, the
  cluster variables and the backend choice.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.bench import subproc
from repro_torch.cluster import runtime
from repro_torch.core import EngineConfig, GridConfig, StepProgram
from repro_torch.core import distributed as D
from repro_torch.core import engine, stream_engine
from repro_torch.core.step_program import check_supported
from repro_torch.dist import mesh as dmesh
from repro_torch.dist import sharding

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_reference import ROOT, avx_env  # noqa: E402

SMALL = dict(grid_x=2, grid_y=2, neurons_per_column=80,
             synapses_per_neuron=30, seed=7)
STRIP = dict(grid_x=16, grid_y=1, neurons_per_column=40,
             synapses_per_neuron=20, seed=3, connectivity="ring1")
STEPS = 60
EXCHANGES = ("allgather", "halo", "hier")
SCHEDULES = ("sync", "pipelined")


def _cell(cfg, **eng):
    return dict(cfg=cfg, eng=dict(n_shards=4, **eng))


CELLS = {4: {f"dense_{ex}_{sc}": _cell(SMALL, exchange=ex,
                                       exchange_schedule=sc)
             for ex in EXCHANGES for sc in SCHEDULES}, 2: {}, 1: {}}
CELLS[4].update(
    scatter_allgather_sync=_cell(SMALL, exchange="allgather",
                                 placement="scatter"),
    event_allgather_sync=_cell(SMALL, exchange="allgather",
                               delivery="event"),
    event_halo_pipelined=_cell(SMALL, exchange="halo", delivery="event",
                               exchange_schedule="pipelined"),
    streamed_halo_sync=_cell(SMALL, exchange="halo",
                             connectivity="streamed:chunk=1"),
    streamed_halo_pipelined=_cell(SMALL, exchange="halo",
                                  exchange_schedule="pipelined",
                                  connectivity="streamed:chunk=1"),
    streamed_allgather_sync=_cell(SMALL, exchange="allgather",
                                  connectivity="streamed:chunk=1"),
    strip_halo_sync=_cell(STRIP, exchange="halo"),
    strip_hier_sync=_cell(STRIP, exchange="hier"),
    event_hier_sync=_cell(SMALL, exchange="hier", delivery="event"),
    scatter_halo_sync=_cell(SMALL, exchange="halo", placement="scatter"),
    scatter_hier_pipelined=_cell(SMALL, exchange="hier",
                                 placement="scatter",
                                 exchange_schedule="pipelined"))
CELLS[2].update(
    {f"dense_{ex}_{sc}": _cell(SMALL, exchange=ex, exchange_schedule=sc)
     for ex in ("halo", "hier") for sc in SCHEDULES},
    dense_allgather_sync=_cell(SMALL, exchange="allgather"),
    event_halo_sync=_cell(SMALL, exchange="halo", delivery="event"),
    event_hier_pipelined=_cell(SMALL, exchange="hier", delivery="event",
                               exchange_schedule="pipelined"),
    scatter_halo_pipelined=_cell(SMALL, exchange="halo",
                                 placement="scatter",
                                 exchange_schedule="pipelined"),
    scatter_hier_sync=_cell(SMALL, exchange="hier", placement="scatter"),
    streamed_halo_sync=_cell(SMALL, exchange="halo",
                             connectivity="streamed:chunk=1"))
# one rank holding all four shards: streamed connectivity with scatter
# placement, which more ranks refuse (`check_supported`)
CELLS[1].update(
    streamed_scatter_halo_sync=_cell(SMALL, exchange="halo",
                                     placement="scatter",
                                     connectivity="streamed:chunk=1"),
    streamed_scatter_allgather_pipelined=_cell(
        SMALL, exchange="allgather", placement="scatter",
        exchange_schedule="pipelined", connectivity="streamed:chunk=1"))
#: cells that also run `time_phases` on the ranks
TIMED = ("dense_halo_pipelined", "dense_hier_sync", "event_halo_pipelined")

_RANK_CODE = """
import sys
sys.path.insert(0, {tests!r})
from repro_torch.cluster import runtime
runtime.ensure_initialized()
from test_torch_mesh import rank_cells
rank_cells({cells!r}, {timed!r})
"""


LAUNCH_ARGS = ["--grid", "2x2", "--neurons-per-column", "80",
               "--synapses", "30", "--steps", "40", "--shards", "4"]
LAUNCHES = {"event": ["--delivery", "event", "--exchange", "halo",
                      "--exchange-schedule", "pipelined"],
            "streamed": ["--connectivity-mode", "streamed:chunk=1",
                         "--exchange", "hier", "--hier-groups", "2"]}
_LAUNCH_CODE = f"""
from repro_torch.launch import snn
for extra in {list(LAUNCHES.values())!r}:
    snn.main({LAUNCH_ARGS!r} + extra)
"""


def rank_cells(cells: dict, timed) -> None:
    """Inside each rank: every cell, one result line a cell from the
    primary (signatures, spikes, sat, the job's messages by source and
    destination rank, and the time_phases raster where asked for)."""
    from repro_torch.core import observables
    R = runtime.process_count()
    for name, c in cells.items():
        mesh = dmesh.make_snn_mesh(4)
        sp = StepProgram(GridConfig(**c["cfg"]), EngineConfig(**c["eng"]),
                         mesh=mesh)
        state, raster, tm = sp.run(sp.place(sp.init_state()), 0, STEPS)
        sent = torch.tensor([[mesh.wire.sent[q] for q in range(R)]])
        raster, full, sent = (sp.gather_raster(raster), sp.gather(state),
                              runtime.gather(sent))
        tp = None
        if name in timed:
            _, _, rasters, counts = sp.time_phases(
                sp.init_state(), 0, STEPS, collect_rasters=True)
            if runtime.is_primary():
                tp = dict(equal=bool(np.array_equal(np.stack(rasters),
                                                    raster.numpy())),
                          spikes=counts["spikes"])
        if runtime.is_primary():
            subproc.emit(dict(
                name=name, raster_signature=observables.raster_signature(
                    raster.numpy(), sp.plan.gid.numpy()).hex(),
                weight_signature=sp.weight_signature(full).hex(),
                spikes=int(raster.sum()),
                sat=(int(full.sat.sum()) if hasattr(full, "sat") else None),
                sent=(sent // STEPS).tolist(), time_phases=tp,
                wire=mesh.backend))


def _jax_cells(cells: dict) -> dict:
    """Inside the AVX subprocess with 4 host devices: each cell's
    shard_map run (hier's groups: `groups`)."""
    import jax  # noqa: F401  (jax starts under the AVX flag)
    from repro.core import EngineConfig as JE, GridConfig as JG
    from repro.core import StepProgram as JSP, observables
    from repro.core import distributed as JD
    out = {}
    for key, c in cells.items():
        sp = JSP(JG(**c["cfg"]), JE(**c["eng"]), mesh=JD.make_mesh(4),
                 hier_groups=c.get("groups"))
        state, raster, _ = sp.run(sp.place(sp.init_state()), 0, STEPS)
        raster = np.asarray(raster)
        out[key] = dict(
            raster_signature=observables.raster_signature(
                raster, np.asarray(sp.plan.gid)).hex(),
            weight_signature=sp.weight_signature(state).hex(),
            spikes=int(raster.sum()),
            sat=(int(np.asarray(state.sat).sum()) if hasattr(state, "sat")
                 else None))
    return out


def _jax_key(R: int, c: dict) -> str:
    """One JAX run a distinct (cfg, eng, hier groups)."""
    groups = R if c["eng"].get("exchange") == "hier" else None
    return json.dumps([c["cfg"], c["eng"], groups], sort_keys=True)


def _jax_requests() -> dict:
    req = {}
    for R, cells in CELLS.items():
        for c in cells.values():
            req[_jax_key(R, c)] = dict(c, groups=(
                R if c["eng"].get("exchange") == "hier" else None))
    return req


# -- the jobs, started with the module and waited for by the fixtures ------


_started = {}


def _start(tmp_root: Path):
    if _started:
        return _started
    env = avx_env()
    env["XLA_FLAGS"] += " --xla_force_host_platform_device_count=4"
    _started["jax"] = subprocess.Popen(
        [sys.executable, __file__, "--jax"], env=env, cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    tests = str(Path(__file__).resolve().parent)
    _started["launch"] = subproc.Ranks(
        _LAUNCH_CODE, 2, device="cpu", timeout=420,
        store=str(tmp_root / "store_launch"))
    for R, cells in CELLS.items():
        _started[R] = subproc.Ranks(
            _RANK_CODE.format(tests=tests, cells=cells, timed=TIMED), R,
            device="cpu", timeout=420, store=str(tmp_root / f"store{R}"))
    return _started


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    started = _start(tmp_path_factory.mktemp("mesh"))
    # the stacked runs, in this process while the jobs run
    for R, name in CASES:
        _stacked_run(R, CELLS[R][name])
    return started


@pytest.fixture(scope="module")
def ranks4(jobs):
    return {c["name"]: c for c in subproc.results(jobs[4].wait())}


@pytest.fixture(scope="module")
def ranks2(jobs):
    return {c["name"]: c for c in subproc.results(jobs[2].wait())}


@pytest.fixture(scope="module")
def ranks1(jobs):
    return {c["name"]: c for c in subproc.results(jobs[1].wait())}


@pytest.fixture(scope="module")
def jax_cells(jobs):
    p = jobs["jax"]
    try:
        out, err = p.communicate(timeout=420)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


_stacked = {}


def _stacked_run(R: int, c: dict) -> dict:
    """The port's single-process run of the cell (the shards stacked on
    the CPU; hier in R groups)."""
    key = _jax_key(R, c)
    if key not in _stacked:
        from repro_torch.core import observables
        groups = R if c["eng"].get("exchange") == "hier" else None
        sp = StepProgram(GridConfig(**c["cfg"]), EngineConfig(**c["eng"]),
                         device="cpu", hier_groups=groups)
        state, raster, _ = sp.run(sp.init_state(), 0, STEPS)
        raster = raster.numpy()
        if groups:      # the stacked hier wire, through its phase handles
            _, _, rasters, _ = sp.time_phases(sp.init_state(), 0, STEPS,
                                              collect_rasters=True)
            assert np.array_equal(np.stack(rasters), raster)
        _stacked[key] = dict(
            raster_signature=observables.raster_signature(
                raster, sp.plan.gid.numpy()).hex(),
            weight_signature=sp.weight_signature(state).hex(),
            spikes=int(raster.sum()),
            sat=int(state.sat.sum()) if hasattr(state, "sat") else None)
    return _stacked[key]


KEYS = ("raster_signature", "weight_signature", "spikes", "sat")
CASES = [(R, name) for R in CELLS for name in CELLS[R]]


@pytest.mark.parametrize("R,name", CASES, ids=[f"R{R}-{n}"
                                               for R, n in CASES])
def test_ranks_equal_stacked_and_jax_shard_map(R, name, request,
                                               jax_cells):
    got = request.getfixturevalue(f"ranks{R}")[name]
    c = CELLS[R][name]
    want_jax = jax_cells[_jax_key(R, c)]
    want_port = _stacked_run(R, c)
    assert {k: got[k] for k in KEYS} == want_port
    assert {k: got[k] for k in KEYS} == want_jax
    assert got["spikes"] > 0 and got["wire"] == "gloo"
    if got["time_phases"] is not None:
        assert got["time_phases"] == dict(equal=True, spikes=got["spikes"])


def test_the_launcher_runs_over_a_job(jobs, capsys):
    """`python -m repro_torch.launch.snn` as two ranks of a job (what
    torchrun or run_ranks start): the primary prints the `[snn]` lines
    with the process count and the wire, and the rate and the streamed
    weights of the single-process launcher."""
    from repro_torch.launch import snn
    out = jobs["launch"].wait()
    lines = out.splitlines()
    assert sum("2 processes over gloo" in ln for ln in lines) == 2
    assert any("raster equal to the fused run's" in ln for ln in lines)
    assert any("0 events dropped (sat)" in ln for ln in lines)
    capsys.readouterr()
    for extra in LAUNCHES.values():
        snn.main(LAUNCH_ARGS + extra + ["--device", "cpu"])
    alone = capsys.readouterr().out.splitlines()
    keep = ("final-window rate", "[snn] streamed:", "[snn] event delivery:")
    assert [ln for ln in lines if ln.startswith("[snn]") and any(
        k in ln for k in keep)] == [ln for ln in alone if any(
            k in ln for k in keep)]


def test_halo_and_hier_send_only_where_the_offsets_reach(ranks4, ranks2):
    """16x1 ring1, H = 4, a shard a rank: shard h hears h - 1, h and h + 1,
    so each rank sends one message a step to each of its two neighbours
    and none to the rank opposite; at H = 4 over 2 ranks every rank sends
    to the other.  The allgather wire sends no point-to-point message."""
    ring = [[0, 1, 0, 1], [1, 0, 1, 0], [0, 1, 0, 1], [1, 0, 1, 0]]
    assert ranks4["strip_halo_sync"]["sent"] == ring
    assert ranks4["strip_hier_sync"]["sent"] == ring
    assert ranks4["dense_allgather_sync"]["sent"] == [[0] * 4] * 4
    for name in ("dense_halo_sync", "dense_hier_sync"):
        assert ranks2[name]["sent"] == [[0, 1], [1, 0]]


# -- units, no processes -----------------------------------------------------


def _stub_mesh(world: int, rank: int, H: int = 4) -> dmesh.SnnMesh:
    return dmesh.SnnMesh(n_shards=H, world=world, rank=rank,
                         device=torch.device("cpu"), wire=None,
                         backend="gloo")


def _leaves(tree):
    return engine.state_tensors(tree)


@pytest.mark.parametrize("kind", ["dense", "event", "streamed"])
def test_shard_put_slices_every_tree_by_block(kind):
    kw = dict(dense={}, event=dict(delivery="event"),
              streamed=dict(connectivity="streamed:chunk=1"))[kind]
    sp = StepProgram(GridConfig(**SMALL), EngineConfig(n_shards=4, **kw),
                     device="cpu")
    trees = [sp.plan, sp.init_state()] + [t for t in (sp.eplan, sp.splan)
                                          if t is not None]
    for rank in range(2):
        mesh = _stub_mesh(2, rank)
        for tree in trees:
            block = sharding.shard_put(mesh, tree)
            assert type(block) is type(tree)
            for a, b in zip(_leaves(block), _leaves(tree)):
                assert torch.equal(a, b[2 * rank:2 * rank + 2])
    with pytest.raises(ValueError, match="leading axis"):
        sharding.shard_put(_stub_mesh(2, 0, H=2), sp.plan)


@pytest.mark.parametrize("placement", ["block", "scatter"])
def test_a_block_plan_keeps_its_stimulus(placement):
    """The stimulus keys on the plan's shard ids and columns, so a rank's
    block draws its rows of the full table."""
    sp = StepProgram(GridConfig(**SMALL), EngineConfig(
        n_shards=4, placement=placement), device="cpu")
    full = engine.StimWindow(sp.spec, sp.plan, 10, 20)
    block = engine.StimWindow(sp.spec, sharding.shard_put(
        _stub_mesh(2, 1), sp.plan), 10, 20)
    assert torch.equal(block.index, full.index[:, 2:4])
    assert torch.equal(block.amp, full.amp[:, 2:4])
    assert block.amp.abs().sum() > 0


def test_a_block_chunk_source_has_the_blocks_bounds():
    sp = StepProgram(GridConfig(**SMALL), EngineConfig(
        n_shards=4, connectivity="streamed:chunk=1"), device="cpu")
    full = stream_engine.chunk_source(sp.spec, sp.plan, sp.splan)
    mesh = _stub_mesh(2, 1)
    src = stream_engine.chunk_source(sp.spec, sharding.shard_put(
        mesh, sp.plan), sharding.shard_put(mesh, sp.splan))
    assert torch.equal(src.bounds, full.bounds[2:5])
    from repro_torch.kernels import ref as kref
    k = stream_engine.live_width(sp.splan)
    for c in range(sp.spec.stream.n_chunks):
        want = kref.chunk_tables(full, c, k)
        got = kref.chunk_tables(src, c, k)
        for a, b in zip(got, want):
            assert torch.equal(a, b[2:4])


def test_mesh_shard_groups_and_hier_groups():
    spec = StepProgram(GridConfig(**SMALL), EngineConfig(n_shards=4),
                       device="cpu").spec
    mesh = _stub_mesh(2, 0)
    assert D.mesh_shard_groups(mesh, 4) == [[0, 1], [2, 3]]
    assert D._resolve_groups(spec, mesh, None) == [[0, 1], [2, 3]]
    assert D._resolve_groups(spec, mesh, 2) == [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="ranks' blocks"):
        D._resolve_groups(spec, mesh, 4)
    with pytest.raises(ValueError, match="shards"):
        D.mesh_shard_groups(mesh, 8)


def test_halo_routes_reach_only_the_neighbours():
    sp = StepProgram(GridConfig(**STRIP), EngineConfig(n_shards=4),
                     device="cpu")
    assert D.halo_offsets(sp.spec, sp.plan) == [0, 1, 3]
    offsets = D.halo_offsets(sp.spec, sp.plan)
    routes = [D.aer_routes(_stub_mesh(4, r), 1, offsets) for r in range(4)]
    for r, rt in enumerate(routes):
        assert sorted(rt["send"]) == sorted({(r + 1) % 4, (r - 1) % 4})
        for q, rows in rt["send"].items():
            # what r sends q is what q expects from r, in the same order
            assert [r + i for i in rows] == routes[q]["recv"][r]
    # two shards a rank: each message carries the block's shards that the
    # other rank hears
    routes = [D.aer_routes(_stub_mesh(2, r), 1, offsets) for r in range(2)]
    assert routes[0]["send"] == {1: [0, 1]}
    assert routes[1]["recv"] == {0: [0, 1]}


def test_check_supported_takes_a_mesh():
    eng = EngineConfig(n_shards=4, connectivity="streamed:chunk=1")
    check_supported(eng, _stub_mesh(2, 0))
    check_supported(EngineConfig(n_shards=4, placement="scatter",
                                 connectivity="streamed:chunk=1"),
                    _stub_mesh(1, 0))
    with pytest.raises(NotImplementedError, match="scatter"):
        check_supported(EngineConfig(n_shards=4, placement="scatter",
                                     connectivity="streamed:chunk=1"),
                        _stub_mesh(2, 0))
    with pytest.raises(ValueError, match="shards"):
        check_supported(EngineConfig(n_shards=2), _stub_mesh(2, 0))


def test_cluster_variables(monkeypatch):
    from repro_torch import _flags
    for v in (_flags.ENV_COORD, _flags.ENV_NUM_PROCS, _flags.ENV_PROC_ID,
              _flags.ENV_DEVICE) + runtime.TORCHRUN_ENV:
        monkeypatch.delenv(v, raising=False)
    assert runtime.from_env() is None
    assert runtime.ensure_initialized() is False
    monkeypatch.setenv(_flags.ENV_COORD, "localhost:1234")
    with pytest.raises(RuntimeError, match="partial cluster environment"):
        runtime.from_env()
    env = _flags.cluster_env("src", coordinator="localhost:1234",
                             num_processes=2, process_id=1, device="cpu")
    for k in (_flags.ENV_COORD, _flags.ENV_NUM_PROCS, _flags.ENV_PROC_ID,
              _flags.ENV_DEVICE):
        monkeypatch.setenv(k, env[k])
    cfg = runtime.from_env()
    assert cfg == runtime.ClusterConfig("localhost:1234", 2, 1, "cpu")
    assert cfg.init_method == "tcp://localhost:1234"
    assert env["PYTHONPATH"].split(os.pathsep)[0] == "src"


def test_backend_choice_never_falls_back():
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert runtime.choose_backend(cpu, 4, 0) == ("gloo", False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        runtime.choose_backend(cpu, 1, 0, "nccl")
    assert runtime.choose_backend(card, 1, 1) == ("nccl", False)
    assert runtime.choose_backend(card, 2, 2) == ("nccl", False)
    assert runtime.choose_backend(card, 4, 1) == ("gloo", True)
    assert runtime.choose_backend(card, 2, 2, "gloo") == ("gloo", True)
    with pytest.raises(ValueError, match="share a GPU"):
        runtime.choose_backend(card, 4, 1, "nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        runtime.choose_backend(cpu, 1, 0, "mpi")


def test_a_mesh_needs_a_job():
    assert runtime.job() is None
    with pytest.raises(RuntimeError, match="no torch.distributed job"):
        dmesh.make_snn_mesh(4)


def test_a_failed_rank_fails_the_job(tmp_path):
    code = ("from repro_torch.cluster import runtime\n"
            "runtime.ensure_initialized()\n"
            "import sys, time\n"
            "if runtime.process_index() == 1:\n"
            "    sys.exit(3)\n"
            "time.sleep(60)\n")
    with pytest.raises(subproc.RanksError, match="rank 1 failed") as e:
        subproc.run_ranks(code, 2, device="cpu", timeout=50,
                          store=str(tmp_path / "store"))
    assert e.value.returncodes[1] == 3


def test_a_rank_leaves_the_job(tmp_path):
    """`runtime.shutdown` (run at exit) destroys the process group: one
    left to the interpreter's exit aborted ranks now and then after their
    work was done."""
    code = ("from repro_torch.cluster import runtime\n"
            "import torch.distributed as dist\n"
            "runtime.ensure_initialized()\n"
            "assert dist.is_initialized() and runtime.job().world == 2\n"
            "runtime.shutdown()\n"
            "assert not dist.is_initialized() and runtime.job() is None\n"
            "runtime.shutdown()\n"
            "print('left')\n")
    assert subproc.run_ranks(code, 2, device="cpu", timeout=60,
                             store=str(tmp_path / "store")).split() == [
        "left"]


if __name__ == "__main__":
    assert sys.argv[1] == "--jax"
    print(json.dumps(_jax_cells(_jax_requests())))
