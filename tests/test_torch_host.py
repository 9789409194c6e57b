"""The PyTorch port's host layer, stimulus, isolation and device handling.

Connectivity, topology, profiles and observables are numpy-only copies in
the port, and the stimulus is threefry rewritten in numpy: all of them are
held here against the JAX package in this process, with no tolerance.
"""
import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import connectivity as jconn
from repro.core import engine as jengine
from repro.core import observables as jobs
from repro.core import stimulus as jstim
from repro.core.params import EngineConfig as JEngineConfig
from repro.core.params import GridConfig as JGridConfig
from repro_torch.core import connectivity as tconn
from repro_torch.core import engine as tengine
from repro_torch.core import observables as tobs
from repro_torch.core import stimulus as tstim
from repro_torch.core.params import EngineConfig, GridConfig
from repro_torch.core.step_program import StepProgram, check_supported
from repro_torch.dist.mesh import SnnMesh
from repro_torch.kernels import izhikevich as kizh
from repro_torch.kernels import ops, segment_sum as kseg, stdp as kstdp
from repro_torch.kernels import ref as kref

ROOT = Path(__file__).resolve().parents[1]
PROFILES = ["ring3", "ring1", "gaussian:sigma=1.5"]
GRIDS = [(1, 1), (2, 2), (4, 4)]
LAYOUTS = [(1, "block"), (1, "scatter"), (2, "block"), (2, "scatter"),
           (4, "block"), (4, "scatter")]
SMALL = dict(neurons_per_column=100, synapses_per_neuron=40, seed=7)


def _configs(grid, profile, layout):
    kw = dict(grid_x=grid[0], grid_y=grid[1], connectivity=profile, **SMALL)
    eng = dict(n_shards=layout[0], placement=layout[1])
    return (JGridConfig(**kw), JEngineConfig(**eng), GridConfig(**kw),
            EngineConfig(**eng))


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"H{x[0]}-{x[1]}")
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_shard_tables_and_plan_equal_reference(grid, profile, layout):
    jcfg, jeng, tcfg, teng = _configs(grid, profile, layout)
    ref_tables = jconn.build_all_shards(jcfg, jeng)
    port_tables = tconn.build_all_shards(tcfg, teng)
    assert len(ref_tables) == len(port_tables) == layout[0]
    for r, p in zip(ref_tables, port_tables):
        for f in dataclasses.fields(r):
            a, b = getattr(r, f.name), getattr(p, f.name)
            assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
            assert np.asarray(a).dtype == np.asarray(b).dtype, f.name

    if grid != (2, 2):
        return
    # the stacked plan and initial state the engines build from them
    _, jplan, jstate = jengine.build(jcfg, jeng)
    _, tplan, tstate = tengine.build(tcfg, teng, device="cpu")
    for name in jengine.ShardPlan._fields:
        assert np.array_equal(np.asarray(getattr(jplan, name)),
                              getattr(tplan, name).numpy()), name
    for name in jengine.ShardState._fields:
        assert np.array_equal(np.asarray(getattr(jstate, name)),
                              getattr(tstate, name).numpy()), name


def test_signatures_equal_on_same_events():
    rng = np.random.default_rng(3)
    raster = rng.random((40, 3, 50)) < 0.1
    gid = np.arange(150).reshape(3, 50)
    assert (tobs.raster_signature(raster, gid)
            == jobs.raster_signature(raster, gid))
    t, g = jobs.raster_events(raster, gid, t0=7)
    assert tobs.events_signature(t, g) == jobs.events_signature(t, g)
    assert tobs.mean_rate_hz(raster, 150) == jobs.mean_rate_hz(raster, 150)


@pytest.mark.parametrize("seed", [2013, 7, 123456789])
def test_column_events_equal_reference(seed):
    cfg = GridConfig(grid_x=4, grid_y=4, seed=seed)
    jcfg = JGridConfig(grid_x=4, grid_y=4, seed=seed)
    cols = np.arange(-1, 16, dtype=np.int32)      # -1: a column pad
    ts = np.arange(2000, dtype=np.int32)
    f = jax.jit(jax.vmap(lambda t: jstim.column_events(
        jcfg, jstim.stim_key(jcfg), jnp.asarray(cols), t)))
    want = np.asarray(f(jnp.asarray(ts)))
    got = tstim.column_events(cfg, tstim.stim_key(cfg), cols, ts)
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    assert np.array_equal(
        tstim.column_events(cfg, tstim.stim_key(cfg), cols, 11), want[11])


@pytest.mark.parametrize("layout", [(4, "scatter"), (3, "block")],
                         ids=lambda x: f"H{x[0]}-{x[1]}")
def test_stim_current_equals_reference(layout):
    """The port's masked scatter of stim_amplitude equals the reference's
    `mode="drop"` scatter, shard by shard (H=3 block splits columns)."""
    kw = dict(grid_x=2, grid_y=2, stim_events_per_ms_per_column=3, **SMALL)
    jcfg, tcfg = JGridConfig(**kw), GridConfig(**kw)
    eng = dict(n_shards=layout[0], placement=layout[1])
    jspec, jplan, _ = jengine.build(jcfg, JEngineConfig(**eng))
    tspec, tplan, _ = tengine.build(tcfg, EngineConfig(**eng), device="cpu")
    t0, n = 5, 40
    gids = torch.from_numpy(tstim.stim_table(
        tcfg, tplan.columns.numpy(), t0, n)).to(torch.int64)
    g2l = tengine.make_gid_to_local(tspec, tplan.shard_id)
    idx, amp = tstim.stim_inputs(tcfg, tplan.columns, g2l, gids,
                                 tspec.n_local)
    key = jstim.stim_key(jcfg)
    for h in range(layout[0]):
        p = jax.tree.map(lambda x: x[h], jplan)
        jg2l = jengine.make_gid_to_local(jspec, p.shard_id)
        want = np.asarray(jax.jit(jax.vmap(lambda t: jstim.stim_current(
            jcfg, key, p.columns, t, jg2l, jspec.n_local)))(
                jnp.arange(t0, t0 + n, dtype=jnp.int32)))
        for i in range(n):
            got = tstim.stim_current(idx[i], amp[i], tspec.n_local)[h]
            assert np.array_equal(got.numpy(), want[i]), (h, i)


def _import_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        for name in _import_names(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, name)


def test_isolation_in_fresh_interpreter():
    code = r"""
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
from repro_torch.core import EngineConfig, GridConfig, StepProgram
sp = StepProgram(GridConfig(neurons_per_column=50, synapses_per_neuron=10),
                 EngineConfig(), device="cpu")
state, raster, tm = sp.run(sp.init_state(), 0, 1)
assert raster.shape == (1, 1, 50)
import numpy as np
import repro_torch.launch.serve, repro_torch.models, repro_torch.serve
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm
from repro_torch.serve.engine import Request, ServeEngine
cfg = get_smoke_config("recurrentgemma-2b")
eng = ServeEngine(cfg, lm.init_params(cfg, device="cpu"), batch=1, s_max=16,
                  device="cpu")
done = eng.run([Request(prompt=np.arange(5), max_new=2)])
assert done[0].out.shape == (2,)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("isolated", len([m for m in sys.modules if m.startswith("repro_torch")]))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("isolated")


def test_no_hidden_fallback_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal is not testable")
    cfg = GridConfig(neurons_per_column=50, synapses_per_neuron=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StepProgram(cfg, EngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StepProgram(cfg, EngineConfig(), device="cuda")


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never run a plain version: a CPU tensor is an
    error there, and ops routes any device but cpu/cuda to an error."""
    x = torch.zeros(8)
    b = torch.zeros(8, dtype=torch.bool)
    kw = dict(w_min=0.0, w_max=10.0, neg_time=-1e9)
    with pytest.raises(ValueError, match="not CUDA"):
        kizh.izhikevich_update(x, x, x, x, x, x, x, v_peak=30.0)
    x2, b2 = x.view(1, 8), b.view(1, 8)
    i2 = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="not CUDA"):
        kstdp.stdp_arrival(b.view(1, 1, 8), 0, b2, i2, b2, x2, x2, x2, 1.0,
                           a_minus=0.1, tau_minus=20.0, **kw)
    row_ptr = torch.zeros((1, 9), dtype=torch.int32)
    with pytest.raises(ValueError, match="not CUDA"):
        kstdp.stdp_ltp(b2, row_ptr, b2, x2, x2, x2, 1.0, a_plus=0.1,
                       tau_plus=20.0, **kw)
    seg = kref.make_segments(torch.zeros((1, 3), dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="not CUDA"):
        kseg.segment_sum_ordered(x.view(1, 8), seg)
    m = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.izhikevich_update(m, m, m, m, m, m, m, v_peak=30.0)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_build_without_nvcc_raises():
    """A kernel build that cannot run raises; nothing falls back."""
    from repro_torch.kernels import _build
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is present: the missing-toolkit error is not "
                    "testable")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()


def test_unported_options_are_refused():
    from repro_torch.launch import snn
    cfg = GridConfig(neurons_per_column=50, synapses_per_neuron=10)
    # (event delivery and streamed connectivity run; a delivery that does
    # not exist, and streamed with event delivery, which the reference
    # refuses too, are refused as bad values)
    with pytest.raises(ValueError, match="dense"):
        StepProgram(cfg, EngineConfig(delivery="event",
                                      connectivity="streamed:chunk=1"),
                    device="cpu")
    with pytest.raises(ValueError, match="delivery"):
        StepProgram(cfg, EngineConfig(delivery="nope"), device="cpu")
    # a mesh runs (its ranks: tests/test_torch_mesh.py); one of another
    # shard count, or streamed scatter shards over several ranks, is
    # refused
    mesh = SnnMesh(n_shards=2, world=2, rank=0, device=torch.device("cpu"),
                   wire=None, backend="gloo")
    check_supported(EngineConfig(n_shards=2), mesh)
    with pytest.raises(ValueError, match="the mesh has 2 shards"):
        StepProgram(cfg, EngineConfig(), device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="scatter"):
        StepProgram(cfg, EngineConfig(n_shards=2, placement="scatter",
                                      connectivity="streamed:chunk=1"),
                    mesh=mesh)
    # (--ckpt-dir runs since the checkpoints: tests/test_torch_checkpoint.py;
    # --ckpt-every without it is refused)
    for argv in (["--delivery", "nope"], ["--ckpt-every", "10"],
                 ["--connectivity-mode", "streamed:chunk=2", "--delivery",
                  "event"], ["--connectivity-mode", "streamed:chunk=0"]):
        with pytest.raises(SystemExit):
            snn.main(argv + ["--device", "cpu"])


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import snn
    rate = snn.main(["--grid", "2x1", "--neurons-per-column", "100",
                     "--synapses", "20", "--steps", "30", "--shards", "2",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[snn] 200 neurons / 4000 synapses on 2 shards" in out
    assert "done at t=30 ms" in out
    assert rate > 0
