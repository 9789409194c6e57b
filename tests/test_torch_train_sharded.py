"""The sharded train step on the CPU: gloo ranks over an `LmMesh`, the
state in blocks by the JAX package's sharding rules (`dist.lm_blocks`),
against the one-process port step and the JAX package's trajectories.

Meshes 2x2, 1x2 ('model' only: expert parallelism alone) and 2x1 ('data'
only), each one job of fresh interpreters (`bench.subproc.Ranks`,
`device="cpu"`, `tests/_train_sharded_ranks.py`) running
`granite-moe-3b-a800m`, `qwen3-0.6b` and `recurrentgemma-2b` at SMOKE in
fp32 on `convert.numpy_params(cfg, 0)`:
* `train_reference.json`'s loss batch (B = 2, four labels masked): the
  loss within 2e-5 of the one-process port's, each gradient leaf
  (gathered whole on the primary) within 1e-3 of its largest magnitude;
* its three-step plain trajectories (B = 4, T = 16, WSD): losses and
  gradient norms within 1e-4 of the JAX package's and of the one-process
  port's, learning rates equal;
* each rank's resident bytes (parameters, m, v) equal the sum of its
  blocks under the JAX specs (`lm_blocks.expected_bytes`);
* the experts' slot products each rank ran: E/M of them under expert
  parallelism (granite's 8 experts over 'model'), E without.
* at 2x2 also the reference's microbatch and compress trajectories of
  `recurrentgemma-2b`, within 1e-4, and each arch's bf16 loss and
  gradients within 0.05 and 0.1 (of the leaf's largest magnitude) of the
  one-process port's.

Saving and resuming across meshes, and the meshes' refusals:
`test_torch_train_sharded_resume.py`.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.bench import subproc
from repro_torch.configs import get_smoke_config
from repro_torch.dist import lm_blocks
from repro_torch.dist.mesh import LmMesh

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
import _train_sharded_ranks as R  # noqa: E402

ARCHS = ("granite-moe-3b-a800m", "qwen3-0.6b", "recurrentgemma-2b")
MESHES = {"2x2": (2, 2), "1x2": (1, 2), "2x1": (2, 1)}
TOL = dict(loss=2e-5, leaf=1e-3, trajectory=1e-4)
#: bf16: the one-process training gates (a bf16 rounding that lands elsewhere
#: moves a whole bf16 ulp)
TOL_BF16 = dict(loss=0.05, leaf=0.1)
#: the reference's other trajectories, run at 2x2: micro-batches of 2 rows
#: (one a rank a micro-batch), and bf16 compression with error feedback
CONFIGS = (("recurrentgemma-2b", "microbatch"),
           ("recurrentgemma-2b", "compress"))

_CODE = """
import sys
sys.path[:0] = [{tests!r}, {src!r}]
from repro_torch.cluster import runtime
runtime.ensure_initialized()
import _train_sharded_ranks as R
R.{fn}({args!r})
"""


def run_job(fn: str, args: dict, n: int, tmp: Path) -> list:
    tmp.mkdir(parents=True, exist_ok=True)
    code = _CODE.format(tests=str(TESTS), src=subproc.SRC, fn=fn, args=args)
    out = subproc.run_ranks(code, n, device="cpu", timeout=300,
                            store=str(tmp / f"store_{fn}"))
    return subproc.results(out)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Each mesh's job, run once when a test first needs it."""
    done = {}

    def get(key):
        if key not in done:
            shape = MESHES[key]
            res = run_job("mesh_rank", dict(
                shape=shape, archs=ARCHS,
                configs=CONFIGS if key == "2x2" else (),
                bf16=ARCHS if key == "2x2" else ()),
                int(np.prod(shape)), tmp_path_factory.mktemp(f"mesh{key}"))
            done[key] = {(f"{r['arch']}:{r['config']}" if "config" in r
                          else r["arch"]): r for r in res}
        return done[key]
    return get


@pytest.fixture(scope="module")
def reference():
    return R.reference()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("key", MESHES)
def test_loss_and_gradients_match_one_process(jobs, key, arch):
    r = jobs(key)[arch]
    assert abs(r["loss"] - r["loss_one"]) <= TOL["loss"]
    worst = max(r["leaf_err"].items(), key=lambda kv: kv[1])
    assert worst[1] <= TOL["leaf"], worst
    assert len(r["leaf_err"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("key", MESHES)
def test_three_steps_match_jax_and_one_process(jobs, reference, key, arch):
    r = jobs(key)[arch]
    want = reference["trajectories"][f"{arch}:plain"]
    for other in (want, r["traj_one"]):
        np.testing.assert_allclose(r["traj"]["loss"], other["loss"], rtol=0,
                                   atol=TOL["trajectory"])
        np.testing.assert_allclose(r["traj"]["grad_norm"],
                                   other["grad_norm"],
                                   rtol=TOL["trajectory"], atol=0)
        assert r["traj"]["lr"] == other["lr"]


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_gradients_match_one_process_at_2x2(jobs, arch):
    r = jobs("2x2")[f"{arch}:bfloat16"]
    assert abs(r["loss"] - r["loss_one"]) <= TOL_BF16["loss"]
    worst = max(r["leaf_err"].items(), key=lambda kv: kv[1])
    assert worst[1] <= TOL_BF16["leaf"], worst


@pytest.mark.parametrize("arch,config", CONFIGS)
def test_microbatch_and_compression_match_jax_at_2x2(jobs, reference, arch,
                                                     config):
    """The rows of a micro-batch are split over the 'data' ranks (every
    rank's i-th part is micro-batch i); the synthetic batches mask no
    label, so each micro-batch's mean weighs alike and the step is the
    reference's.  The error-feedback residual is a block of the
    parameters' layout."""
    r = jobs("2x2")[f"{arch}:{config}"]
    want = reference["trajectories"][f"{arch}:{config}"]
    np.testing.assert_allclose(r["traj"]["loss"], want["loss"], rtol=0,
                               atol=TOL["trajectory"])
    np.testing.assert_allclose(r["traj"]["grad_norm"], want["grad_norm"],
                               rtol=TOL["trajectory"], atol=0)
    assert r["traj"]["lr"] == want["lr"]
    for resident, expected in r["ranks"]:
        assert resident == expected > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("key", MESHES)
def test_resident_bytes_are_the_blocks(jobs, key, arch):
    r = jobs(key)[arch]
    ranks = r["ranks"]
    assert len(ranks) == int(np.prod(MESHES[key]))
    for resident, expected, _ in ranks:
        assert resident == expected > 0
    if int(np.prod(MESHES[key])) > 1:
        cfg = get_smoke_config(arch).scaled(dtype="float32")
        one = lm_blocks.expected_bytes(cfg, LmMesh(("data", "model"),
                                                   (1, 1)), dict(data=0,
                                                                 model=0))
        assert max(x[0] for x in ranks) < one


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("key", MESHES)
def test_expert_slot_products_per_rank(jobs, reference, key, arch):
    r = jobs(key)[arch]
    cfg = get_smoke_config(arch)
    steps = reference["trajectory"]["steps"]
    if cfg.moe is None:
        assert all(x[2] == 0 for x in r["ranks"]) and r["slots_one"] == 0
        return
    E, M = cfg.moe.n_experts, MESHES[key][1]
    n_moe = sum(k == "moe" for _, k in cfg.layers)
    # every layer runs twice a step (its forward and its recompute)
    assert r["slots_one"] == steps * 2 * n_moe * E
    assert all(x[2] == steps * 2 * n_moe * E // M for x in r["ranks"])
