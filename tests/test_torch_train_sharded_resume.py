"""Sharded train states across meshes, and the meshes' refusals, on the
CPU (gloo ranks, `tests/_train_sharded_ranks.py`; the jobs' helpers are
`test_torch_train_sharded.py`'s).

* A state saved by a `Trainer` at 2x2 (`granite-moe-3b-a800m` at SMOKE,
  two steps of `train_reference.json`'s plain trajectory; the primary
  gathers the blocks and writes the JAX package's file format) resumes
  in one process and at 1x4 (`Trainer.maybe_resume` into a template
  placed on the meta device, each rank keeping its blocks) and takes the
  next step within 1e-4 of the one-process trajectory's.
* The launcher's `--production-mesh` under a 4-rank job raises, naming
  the job's size; `make_lm_mesh` raises without a job; a batch whose rows
  do not divide over the 'batch' axes is refused.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import pipeline
from repro_torch.dist import lm_blocks
from repro_torch.dist.mesh import LmMesh, make_lm_mesh
from repro_torch.optim import schedules
from repro_torch.train import step as step_mod
from repro_torch.train import train_state as ts

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _train_sharded_ranks as R  # noqa: E402
from test_torch_train_sharded import TOL, run_job  # noqa: E402

RESUME_ARCH = "granite-moe-3b-a800m"


@pytest.fixture(scope="module")
def reference():
    return R.reference()


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A Trainer's checkpoint after two steps at 2x2."""
    tmp = tmp_path_factory.mktemp("ckpt")
    res = run_job("save_rank", dict(shape=(2, 2), arch=RESUME_ARCH,
                                    dir=str(tmp / "ckpt")), 4, tmp)
    return tmp / "ckpt", res[0]["losses"]


def _one_process_losses(reference):
    cfg = get_smoke_config(RESUME_ARCH).scaled(dtype="float32")
    return R.trajectory(cfg, reference)[0]["loss"]


def test_saved_at_2x2_resumes_in_one_process(saved, reference):
    ckpt, losses = saved
    want = _one_process_losses(reference)
    np.testing.assert_allclose(losses, want[:2], rtol=0,
                               atol=TOL["trajectory"])
    cfg = get_smoke_config(RESUME_ARCH).scaled(dtype="float32")
    tr = reference["trajectory"]
    state = ts.load(ts.latest(str(ckpt)), ts.create(R.params_of(cfg,
                                                                reference)))
    assert int(state.step) == 2
    step = step_mod.make_train_step(cfg, lr_schedule=schedules.wsd(
        *tr["wsd"]))
    batch = next(iter(pipeline.Batcher(cfg, tr["B"], tr["T"],
                                       seed=tr["batcher_seed"],
                                       start_index=2, device="cpu")))
    _, m = step(state, batch)
    assert abs(float(m["loss"]) - want[2]) <= TOL["trajectory"]


def test_saved_at_2x2_resumes_at_1x4(saved, reference, tmp_path):
    ckpt, _ = saved
    want = _one_process_losses(reference)
    r = run_job("resume_rank", dict(shape=(1, 4), arch=RESUME_ARCH,
                                    dir=str(ckpt)), 4, tmp_path)[0]
    assert r["start"] == 2 and r["step"] == 3
    assert abs(r["losses"][0] - want[2]) <= TOL["trajectory"]
    cfg = get_smoke_config(RESUME_ARCH)
    n_moe = sum(k == "moe" for _, k in cfg.layers)
    assert [x[0] for x in r["slots"]] == [2 * n_moe * 8 // 4] * 4


def test_production_mesh_refuses_a_four_rank_job(tmp_path):
    r = run_job("production_rank", {}, 4, tmp_path)[0]
    assert r["raised"] == "ValueError"
    assert "256 ranks" in r["message"] and "world size 4" in r["message"]


def test_lm_mesh_needs_a_job_of_its_size():
    with pytest.raises(RuntimeError, match="needs a torch.distributed job"):
        make_lm_mesh((2, 2), ("data", "model"))


def test_rows_refuse_a_batch_the_ranks_do_not_divide():
    class _Mesh(LmMesh):
        def group(self, name):
            return type("G", (), {"size": 2})()
    mesh = _Mesh(("data", "model"), (2, 1), rank=0)
    x = torch.arange(6).view(3, 2)
    with pytest.raises(ValueError, match="do not divide"):
        lm_blocks.rows(x, "tokens", mesh)
    assert torch.equal(lm_blocks.rows(torch.arange(8).view(4, 2), "tokens",
                                      mesh), torch.arange(4).view(2, 2))


@pytest.mark.parametrize("rank", range(4))
def test_place_cuts_a_whole_state_into_the_ranks_blocks(reference, rank):
    """`lm_blocks.place` of a one-process state after a step, as rank
    `rank` of a 2x2 mesh sees it (placing needs no collective): each
    parameter, m and v is its `LeafPlace` block of the whole, the rank
    holds `expected_bytes`, and a layer outside its units is empty (four
    layers, so that the stacked vectors shard their unit axis)."""
    cfg = get_smoke_config(RESUME_ARCH).scaled(dtype="float32", n_layers=4)
    tr = reference["trajectory"]
    state = ts.create(R.params_of(cfg, reference))
    step = step_mod.make_train_step(cfg, lr_schedule=schedules.wsd(
        *tr["wsd"]))
    state, _ = step(state, next(iter(pipeline.Batcher(
        cfg, tr["B"], tr["T"], seed=tr["batcher_seed"], device="cpu"))))
    whole = {n: w.detach().clone() for n, w in
             state.params.named_parameters()}
    m, v = dict(state.opt.m), dict(state.opt.v)
    mesh = LmMesh(("data", "model"), (2, 2), rank=rank,
                  device=torch.device("cpu"))
    placed = lm_blocks.place(state, mesh)
    empty = 0
    for n, w in placed.params.named_parameters():
        b = w.place.block(mesh, mesh.coords)
        if b is None:
            empty += 1
            assert w.numel() == 0 and placed.opt.m[n].numel() == 0
            continue
        cut = tuple(slice(r.start, r.stop) for r in b)
        assert torch.equal(w.detach(), whole[n][cut])
        assert torch.equal(placed.opt.m[n], m[n][cut])
        assert torch.equal(placed.opt.v[n], v[n][cut])
    assert empty > 0
    assert lm_blocks.resident_bytes(placed) == lm_blocks.expected_bytes(
        cfg, mesh, mesh.coords)
    assert int(placed.step) == 1
