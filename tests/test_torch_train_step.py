"""The port's training loop on the CPU: `train.step`, `train.trainer`,
`train.train_state` files, `data.pipeline`, the `launch.train` CLI and
the `lm_throughput` suite, against the JAX package where it has numbers.

* Three `make_train_step` steps (plain, microbatch 2, compress_grads with
  error feedback) against the JAX package's trajectories in
  `data/train_reference.json` (which `test_torch_train_loss.py` keeps
  current): losses within 1e-4, gradient norms within 1e-4 of theirs,
  learning rates equal.
* A `Trainer` resumed after a simulated preemption continues bit for bit.
* Train-state files written by each package are read by the other (the
  JAX side in an AVX subprocess: this file is its script).
* Serving under `no_grad` builds no autograd graph and keeps its bits
  after `train_state.create` made the parameters trainable.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_reference import SRC, run_avx  # noqa: E402
from test_torch_lm_serve import EXACT_FLAG  # noqa: E402
import test_torch_train_loss as TL  # noqa: E402

sys.path.insert(0, str(SRC))         # also when run as a script

from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402
from repro_torch.train import train_state as ts  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

TRAJ_TOL = 1e-4
#: the train-state files' model: bf16 weights (a uint16 view in the
#: file), pattern units stacked, the error-feedback residual present
STATE_ARCH, STATE_DTYPE = "recurrentgemma-2b", "bfloat16"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_state(arch, dtype="float32", ef=False):
    cfg = TL.smoke(arch, dtype)
    params = convert.lm_params_from_jax(
        convert.numpy_params(cfg, TL.WEIGHTS_SEED), cfg, "cpu")
    return cfg, ts.create(params, use_error_feedback=ef)


def batches(cfg, start=0, B=TL.TRAJ_B, T=TL.TRAJ_T):
    return iter(pipeline.Batcher(cfg, B, T, seed=1, start_index=start,
                                 device="cpu"))


@pytest.mark.parametrize("arch,config", TL.TRAJECTORIES)
def test_three_train_steps_against_jax(arch, config):
    want = json.loads(TL.REF_PATH.read_text())["trajectories"][
        f"{arch}:{config}"]
    kw = TL.TRAJ_CONFIGS[config]
    cfg, state = port_state(arch, ef=kw.get("compress_grads", False))
    step = step_mod.make_train_step(
        cfg, lr_schedule=schedules.wsd(*TL.TRAJ_LR), **kw)
    data = batches(cfg)
    got = {k: [] for k in want}
    for _ in range(TL.TRAJ_STEPS):
        state, m = step(state, next(data))
        for k in got:
            got[k].append(float(m[k]))
    assert int(state.step) == int(state.opt.step) == TL.TRAJ_STEPS
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                               atol=TRAJ_TOL)
    np.testing.assert_allclose(got["xent"], want["xent"], rtol=0,
                               atol=TRAJ_TOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=TRAJ_TOL, atol=0)
    assert got["lr"] == want["lr"]
    if kw.get("compress_grads"):
        assert all(r.abs().max() > 0 for r in state.ef_residual.values())


def _run_trainer(cfg, state, ckpt_dir, n, start=0):
    step = step_mod.make_train_step(cfg,
                                    lr_schedule=schedules.constant(1e-3))
    tr = Trainer(step, state, ckpt_dir=ckpt_dir, ckpt_every=2,
                 log_every=100, log_fn=lambda *a: None)
    start = tr.maybe_resume()
    tr.run(batches(cfg, start, 2, 16), n - start)
    return tr


def test_trainer_resumes_bit_for_bit_after_preemption(tmp_path):
    cfg, state = port_state("recurrentgemma-2b", ef=False)
    whole = _run_trainer(cfg, state, None, 5)
    cfg, state = port_state("recurrentgemma-2b")
    _run_trainer(cfg, state, str(tmp_path), 3)     # preempted after step 3
    assert ts.latest(str(tmp_path)).endswith("lm_3.npz")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["lm_2.npz",
                                                           "lm_3.npz"]
    cfg, state = port_state("recurrentgemma-2b")   # a fresh process's state
    resumed = _run_trainer(cfg, state, str(tmp_path), 5)
    assert int(resumed.state.step) == 5
    assert resumed.history == whole.history[3:]
    for (n, a), b in zip(whole.state.params.named_parameters(),
                         resumed.state.params.parameters()):
        assert torch.equal(a, b), n
    for k in whole.state.opt.m:
        assert torch.equal(whole.state.opt.m[k], resumed.state.opt.m[k])
        assert torch.equal(whole.state.opt.v[k], resumed.state.opt.v[k])


def test_trainer_restores_the_last_checkpoint_on_a_non_finite_loss(tmp_path):
    cfg, state = port_state("qwen3-0.6b")
    real = step_mod.make_train_step(cfg,
                                    lr_schedule=schedules.constant(1e-3))
    calls = []

    def step(st, b):
        st, m = real(st, b)
        calls.append(int(st.step))
        if len(calls) == 3:
            m = dict(m, loss=torch.tensor(float("nan")))
        return st, m

    logs = []
    tr = Trainer(step, state, ckpt_dir=str(tmp_path), ckpt_every=2,
                 log_every=100, log_fn=logs.append)
    tr.run(batches(cfg, 0, 2, 16), 4)
    assert any("non-finite loss at step 3" in s for s in logs)
    assert any("resumed from" in s and "lm_2.npz" in s for s in logs)
    assert len(tr.history) == 3 and int(tr.state.step) == 3


def test_trainer_refuses_a_non_finite_loss_without_a_checkpoint():
    cfg, state = port_state("qwen3-0.6b")
    tr = Trainer(lambda st, b: (st, {"loss": torch.tensor(float("inf"))}),
                 state, log_fn=lambda *a: None)
    with pytest.raises(FloatingPointError):
        tr.run(batches(cfg, 0, 2, 16), 1)


# ---------------------------------------------------------------------------
# train-state files across the packages
# ---------------------------------------------------------------------------


def _jax_state(ckpt_dir: str):
    """In an AVX subprocess: the JAX state after one step, saved to
    jax.npz with its leaves as fp32 in jax_leaves.npz; and port.npz (the
    port's file) loaded into a JAX template, its leaves in
    port_in_jax.npz."""
    import jax
    from repro.data import pipeline as jpipe
    from repro.optim import schedules as jsched
    from repro.train import step as jstep
    from repro.train import train_state as jts
    cfg = TL.smoke(STATE_ARCH, STATE_DTYPE)
    jc, params = TL._jax_params(cfg)
    state = jts.create(params, use_error_feedback=True)
    step = jax.jit(jstep.make_train_step(jc, lr_schedule=jsched.constant(
        1e-2), compress_grads=True))
    state, _ = step(state, next(iter(jpipe.Batcher(jc, 2, 16, seed=1))))
    d = Path(ckpt_dir)
    jts.save(str(d / "jax.npz"), state, extra={"from": "jax"})
    dump = lambda s: {f"leaf_{i}": np.asarray(x).astype(np.float32)
                      for i, x in enumerate(jax.tree.leaves(s))}
    np.savez(d / "jax_leaves.npz", **dump(state))
    if (d / "port.npz").exists():
        np.savez(d / "port_in_jax.npz",
                 **dump(jts.load(str(d / "port.npz"), state)))


def _leaf_values(state) -> list:
    return [t.detach().float() for *_, tensors in ts._leaves(state)
            for t in tensors]


def _leaf_arrays(z) -> list:
    """The per-parameter fp32 arrays of a leaf dump, in the port's leaf
    order (stacked leaves split)."""
    cfg = TL.smoke(STATE_ARCH, STATE_DTYPE)
    groups = convert.jax_leaf_groups(cfg)
    out, i = [], 0
    for part in range(6):                   # params, step, m, v, step, ef
        if part in (1, 4):
            out.append(z[f"leaf_{i}"])
            i += 1
            continue
        for g in groups:
            a = z[f"leaf_{i}"]
            out.extend(list(a) if g.stacked else [a])
            i += 1
    return out


def test_train_state_files_move_both_ways(tmp_path):
    cfg, state = port_state(STATE_ARCH, STATE_DTYPE, ef=True)
    step = step_mod.make_train_step(
        cfg, lr_schedule=schedules.constant(1e-2), compress_grads=True)
    state, _ = step(state, next(batches(cfg, 0, 2, 16)))
    ts.save(str(tmp_path / "port.npz"), state)
    run_avx(__file__, [["--state", str(tmp_path)]], extra_flags=EXACT_FLAG)

    # the port's file in JAX: every leaf the port's value, bit for bit
    with np.load(tmp_path / "port_in_jax.npz") as z:
        got = _leaf_arrays(z)
    want = _leaf_values(state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a, b.numpy())

    # JAX's file in the port: every leaf JAX's value, bit for bit, the
    # parameters loaded in place, the same leaf count and meta
    _, template = port_state(STATE_ARCH, STATE_DTYPE, ef=True)
    loaded = ts.load(str(tmp_path / "jax.npz"), template)
    assert loaded.params is template.params
    assert int(loaded.step) == 1 and loaded.step.dtype == torch.int32
    with np.load(tmp_path / "jax_leaves.npz") as z:
        want = _leaf_arrays(z)
    got = _leaf_values(loaded)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b)
    p = next(loaded.params.parameters())
    assert p.dtype == torch.bfloat16 and p.requires_grad
    # a file saved again from the loaded state equals JAX's leaf for leaf
    ts.save(str(tmp_path / "again.npz"), loaded)
    with np.load(tmp_path / "jax.npz") as a, \
            np.load(tmp_path / "again.npz") as b:
        ma, mb = json.loads(str(a["meta"])), json.loads(str(b["meta"]))
        assert ma["dtypes"] == mb["dtypes"] and ma["step"] == mb["step"]
        for i in range(ma["n_leaves"]):
            assert a[f"leaf_{i}"].dtype == b[f"leaf_{i}"].dtype
            assert np.array_equal(a[f"leaf_{i}"], b[f"leaf_{i}"])


def test_load_refuses_another_layout(tmp_path):
    _, state = port_state("qwen3-0.6b")
    ts.save(str(tmp_path / "lm_0.npz"), state)
    _, other = port_state("qwen3-0.6b", ef=True)
    with pytest.raises(ValueError, match="leaves"):
        ts.load(str(tmp_path / "lm_0.npz"), other)
    _, bf = port_state("qwen3-0.6b", "bfloat16")
    with pytest.raises(ValueError, match="bfloat16"):
        ts.load(str(tmp_path / "lm_0.npz"), bf)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_leaf_groups_follow_jax_tree_leaves(arch):
    """`convert.jax_leaf_groups` lists the JAX tree's leaves in
    `jax.tree.leaves` order, a unit leaf the stack of its layers'
    parameters (structure only: JAX in-process)."""
    import jax
    cfg = get_smoke_config(arch)
    tree = convert.numpy_params(cfg, 0)
    named = dict(lm.LM(cfg, torch.device("meta")).named_parameters())
    leaves = jax.tree.leaves(tree)
    groups = convert.jax_leaf_groups(cfg)
    assert len(leaves) == len(groups)
    flat = {}
    for name, w in named.items():
        flat[name] = np.asarray(convert._jax_leaf(tree, cfg, name))
    for leaf, g in zip(leaves, groups):
        got = np.stack([flat[n] for n in g.names]) if g.stacked \
            else flat[g.names[0]]
        assert np.array_equal(got, leaf)
    assert sorted(n for g in groups for n in g.names) == sorted(named)


# ---------------------------------------------------------------------------
# data, the launcher, the suite, serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "seamless-m4t-medium",
                                  "llava-next-34b"])
def test_batcher_yields_the_jax_stream(arch):
    from repro.configs import get_smoke_config as jax_smoke
    from repro.data import pipeline as jpipe
    cfg = get_smoke_config(arch)
    want = jpipe.Batcher(jax_smoke(arch), 2, 12, seed=1).make(4)
    it = pipeline.Batcher(cfg, 2, 12, seed=1, start_index=4, device="cpu")
    got = next(iter(pipeline.prefetch(iter(it))))
    assert sorted(got) == sorted(want) and it.index >= 5
    for k in want:
        assert got[k].device.type == "cpu"
        assert np.array_equal(got[k].numpy(), want[k])


def test_launcher_trains_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch import train as launch_train
    tr = launch_train.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                            "cpu", "--steps", "3", "--batch", "2", "--seq",
                            "16", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train] qwen3-0.6b" in out and "[train] losses" in out
    assert len(tr.history) == 3 and all(np.isfinite(tr.history))
    assert (tmp_path / "lm_3.npz").exists()
    with pytest.raises(NotImplementedError, match="13.7"):
        launch_train.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                           "cpu", "--production-mesh"])


def test_lm_throughput_quick_report_on_the_cpu():
    from repro_torch.bench import report as R
    from repro_torch.bench.suites import lm_throughput
    rep = lm_throughput.run_suite(quick=True, device="cpu")
    assert R.validate(rep) == []
    assert rep["env"]["backend"] == "cpu"
    train, decode = rep["extra"]["rows"]
    assert train["kind"] == "train" and train["steps"] == 5
    assert np.isfinite(train["final_loss"])
    assert rep["wall"]["train_tokens_per_s"] > 0
    assert rep["wall"]["decode_tokens_per_s"] > 0


def test_serving_builds_no_graph_and_keeps_its_bits():
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = TL.smoke("recurrentgemma-2b")
    tree = convert.numpy_params(cfg, 0)
    batch = {"tokens": torch.arange(10)[None] % cfg.vocab_size}
    rng = np.random.default_rng(2)
    reqs = lambda: [Request(prompt=rng.integers(0, cfg.vocab_size, n),
                            max_new=4) for n in (5, 9)]
    out = {}
    for trainable in (False, True):
        params = convert.lm_params_from_jax(tree, cfg, "cpu")
        if trainable:
            ts.create(params)
            assert all(w.requires_grad for w in params.parameters())
        with torch.no_grad():
            logits, _ = lm.forward(cfg, params, batch)
        assert logits.grad_fn is None and not logits.requires_grad
        eng = ServeEngine(cfg, params, batch=2, s_max=32, device="cpu")
        rng = np.random.default_rng(2)
        done = eng.run(reqs())
        out[trainable] = (logits, [r.out.tolist() for r in done])
    assert torch.equal(out[False][0], out[True][0])
    assert out[False][1] == out[True][1]
    frozen = convert.lm_params_from_jax(tree, cfg, "cpu")
    assert not any(w.requires_grad for w in frozen.parameters())
    logits, _ = lm.forward(cfg, frozen, batch)      # grad mode on
    assert logits.grad_fn is None


if __name__ == "__main__":
    if sys.argv[1:2] != ["--state"]:
        raise SystemExit(f"usage: {sys.argv[0]} --state DIR")
    _jax_state(sys.argv[2])
