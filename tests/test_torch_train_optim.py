"""The port's optimizer (`repro_torch.optim`) against the JAX package's, on
the same numpy inputs.

The JAX side runs jitted, as its train step runs them, in an AVX
subprocess with `--xla_allow_excess_precision=false` (this file is its
script).  XLA folds constants there (a division by a constant becomes a
multiplication by its fp32 reciprocal; AdamW's two divisions of m
become one), and the port computes those folded forms.

Tolerances, in fp32 ulps (the distance between the bit patterns):
* schedules: 0 for `constant` and WSD's warm-up and flat steps; 1 for
  WSD's decay (`pow`, though none differed); `cosine` within 2^-23 of its
  peak (the device's `cos` and XLA-CPU's differ by an ulp on a few
  arguments, and by up to 164 ulps of the result where cos(pi t) nears -1
  and 1 + cos cancels);
* AdamW: 1 (the bias corrections' `b ** step`: `torch.pow` and XLA-CPU's
  `power` differ by an ulp on some steps, and the ulp carries into the
  parameters it scales);
* the global norm and clipping: 1 (ATen and XLA sum a leaf's squares in
  other orders); compression with error feedback: 0.
The counts of differing values are printed by `--measure`:

    python tests/test_torch_train_optim.py --measure
"""
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_reference import SRC, run_avx  # noqa: E402
from test_torch_lm_serve import EXACT_FLAG  # noqa: E402

sys.path.insert(0, str(SRC))         # also when run as a script

from repro_torch.optim import adamw, grad_utils, schedules  # noqa: E402

#: name -> (function, arguments): the schedules compared
SCHEDULES = {"wsd": ("wsd", (3e-4, 7, 100, 333)),
             "wsd_launcher": ("wsd", (3e-4, 2, 10, 1)),
             "wsd_frac": ("wsd", (1e-3, 10, 50, 30, 0.25)),
             "cosine": ("cosine", (3e-4, 7, 1000)),
             "cosine_short": ("cosine", (1e-2, 0, 40, 0.0)),
             "constant": ("constant", (2.5e-4,))}
STEPS = 1200
SCHEDULE_ULPS = {"wsd": 1, "wsd_launcher": 0, "wsd_frac": 1,
                 "constant": 0}
#: cosine: the largest difference, over the peak learning rate
COSINE_ATOL = 2.0 ** -23
#: the optimizer's tree: name -> (shape, dtype); sorted keys differ from
#: this order, as JAX's leaves follow sorted keys
TREE = {"w_out": ((7, 5), "float32"), "embed": ((11, 5), "bfloat16"),
        "norm": ((5,), "float32"), "b": ((3, 4, 2), "bfloat16")}
ADAM_STEPS = 4
ADAM_ULPS = 1
NORM_ULPS = 1


def tree_inputs(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k, (shape, _) in TREE.items()}


def _ml_dtype(name):
    import ml_dtypes
    return np.float32 if name == "float32" else ml_dtypes.bfloat16


def _jax_main(path):
    import jax
    import jax.numpy as jnp
    from repro.optim import adamw as jadamw
    from repro.optim import grad_utils as jgu
    from repro.optim import schedules as jsched
    out = {}
    for name, (fn, args) in SCHEDULES.items():
        f = jax.jit(getattr(jsched, fn)(*args))
        out[f"sched_{name}"] = np.array(
            [np.asarray(f(jnp.int32(s))) for s in range(STEPS)], np.float32)

    dt = {k: _ml_dtype(d) for k, (_, d) in TREE.items()}
    params = {k: jnp.asarray(v.astype(dt[k]))
              for k, v in tree_inputs(1).items()}
    st = jadamw.init(params)
    upd = jax.jit(lambda g, s, p: jadamw.update(
        g, s, p, lr=jsched.wsd(1e-2, 2, 10, 1)))
    for i in range(ADAM_STEPS):
        g = {k: jnp.asarray(v.astype(dt[k]))
             for k, v in tree_inputs(10 + i).items()}
        params, st = upd(g, st, params)
        for k in TREE:
            out[f"adam_{i}_{k}"] = np.asarray(params[k].astype(jnp.float32))
            out[f"adam_{i}_m_{k}"] = np.asarray(st.m[k])
            out[f"adam_{i}_v_{k}"] = np.asarray(st.v[k])

    for scale in (1.0, 1e-3):
        g = {k: jnp.asarray((v * scale).astype(dt[k]))
             for k, v in tree_inputs(20).items()}
        clipped, norm = jax.jit(lambda g: jgu.clip_by_global_norm(g, 1.0))(g)
        out[f"norm_{scale}"] = np.asarray(norm)
        for k in TREE:
            out[f"clip_{scale}_{k}"] = np.asarray(
                clipped[k].astype(jnp.float32))
    g = {k: jnp.asarray(v) for k, v in tree_inputs(30).items()}
    res = jgu.init_error_feedback(g)
    comp = jax.jit(jgu.compress_with_feedback)
    for i in range(2):
        q, res = comp(g, res)
        for k in TREE:
            out[f"comp_{i}_{k}"] = np.asarray(q[k].astype(jnp.float32))
            out[f"res_{i}_{k}"] = np.asarray(res[k])
    np.savez(path, **out)


@pytest.fixture(scope="module")
def ref():
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "optim.npz")
        run_avx(__file__, [["--jax", path]], extra_flags=EXACT_FLAG)
        with np.load(path) as z:
            return {k: z[k] for k in z.files}


def ulps(got, want) -> np.ndarray:
    """The distance in fp32 ulps between the bit patterns."""
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    a = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _torch_tree(seed, scale=1.0):
    return {k: torch.from_numpy(v * np.float32(scale)).to(getattr(torch, d))
            for (k, v), (_, d) in zip(tree_inputs(seed).items(),
                                      TREE.values())}


GROUPS = [[k] for k in sorted(TREE)]       # jax.tree.leaves: sorted keys


def schedule_values(name):
    fn, args = SCHEDULES[name]
    f = getattr(schedules, fn)(*args)
    return np.array([f(torch.tensor(s, dtype=torch.int32)).item()
                     for s in range(STEPS)], np.float32)


def adam_run():
    params = _torch_tree(1)
    st = adamw.init(params)
    out = []
    for i in range(ADAM_STEPS):
        params, st = adamw.update(_torch_tree(10 + i), st, params,
                                  lr=schedules.wsd(1e-2, 2, 10, 1))
        # (the update works in place: keep copies of this step's values)
        out.append(({k: p.clone() for k, p in params.items()},
                    adamw.AdamWState(st.step.clone(),
                                     {k: x.clone() for k, x in st.m.items()},
                                     {k: x.clone() for k, x in st.v.items()})))
    return out


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_against_jax(ref, name):
    got, want = schedule_values(name), ref[f"sched_{name}"]
    if SCHEDULES[name][0] == "cosine":
        # XLA-CPU's cos is not the device's: a few ulps apart, more where
        # cos(pi t) nears -1 and 1 + cos cancels
        peak = SCHEDULES[name][1][0]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=COSINE_ATOL * peak)
    else:
        assert ulps(got, want).max() <= SCHEDULE_ULPS[name]
    assert got.dtype == np.float32


def test_schedule_takes_the_step_as_a_tensor_and_keeps_its_device():
    lr = schedules.wsd(3e-4, 2, 10, 1)(torch.tensor(3))
    assert lr.dtype == torch.float32 and lr.dim() == 0
    assert lr.device.type == "cpu" and float(lr) == np.float32(3e-4)


@pytest.mark.parametrize("i", range(ADAM_STEPS))
def test_adamw_update_against_jax(ref, i):
    params, st = adam_run()[i]
    assert int(st.step) == i + 1 and st.step.dtype == torch.int32
    for k, (_, dtype) in TREE.items():
        assert params[k].dtype == getattr(torch, dtype)
        assert st.m[k].dtype == torch.float32
        assert ulps(params[k], ref[f"adam_{i}_{k}"]).max() <= ADAM_ULPS
        assert ulps(st.m[k], ref[f"adam_{i}_m_{k}"]).max() == 0
        assert ulps(st.v[k], ref[f"adam_{i}_v_{k}"]).max() == 0


def test_adamw_updates_parameters_in_place():
    p = torch.nn.Parameter(torch.ones(3), requires_grad=True)
    params = {"p": p}
    got, st = adamw.update({"p": torch.ones(3)}, adamw.init(params), params,
                           lr=1e-3)
    assert got["p"] is p and not torch.equal(p.detach(), torch.ones(3))
    assert p.requires_grad and p.grad_fn is None


@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_clip_by_global_norm_against_jax(ref, scale):
    g = _torch_tree(20, scale)
    clipped, norm = grad_utils.clip_by_global_norm(g, 1.0, GROUPS)
    assert ulps(norm, ref[f"norm_{scale}"]).max() <= NORM_ULPS
    for k, (_, dtype) in TREE.items():
        assert clipped[k].dtype == getattr(torch, dtype)
        assert ulps(clipped[k], ref[f"clip_{scale}_{k}"]).max() <= NORM_ULPS


def test_compress_with_feedback_against_jax(ref):
    g = {k: torch.from_numpy(v) for k, v in tree_inputs(30).items()}
    res = grad_utils.init_error_feedback(g)
    for i in range(2):
        q, res = grad_utils.compress_with_feedback(g, res)
        for k in TREE:
            assert q[k].dtype == torch.bfloat16
            assert ulps(q[k], ref[f"comp_{i}_{k}"]).max() == 0
            assert ulps(res[k], ref[f"res_{i}_{k}"]).max() == 0


def measure(ref) -> dict:
    """How many values differ from JAX's, and by how many ulps at most."""
    out = {}
    for name in SCHEDULES:
        u = ulps(schedule_values(name), ref[f"sched_{name}"])
        out[f"schedule {name}"] = [int((u > 0).sum()), int(u.max()), STEPS]
    for i, (params, _) in enumerate(adam_run()):
        u = np.concatenate([ulps(params[k], ref[f"adam_{i}_{k}"]).ravel()
                            for k in TREE])
        out[f"adamw step {i + 1}"] = [int((u > 0).sum()), int(u.max()),
                                      int(u.size)]
    for scale in (1.0, 1e-3):
        _, norm = grad_utils.clip_by_global_norm(_torch_tree(20, scale), 1.0,
                                                 GROUPS)
        out[f"global norm x{scale}"] = int(ulps(norm, ref[f"norm_{scale}"]))
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax"]:
        _jax_main(sys.argv[2])
    elif sys.argv[1:2] == ["--measure"]:
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "optim.npz")
            run_avx(__file__, [["--jax", path]], extra_flags=EXACT_FLAG)
            with np.load(path) as z:
                print(json.dumps(measure({k: z[k] for k in z.files}),
                                 indent=1))
    else:
        raise SystemExit(f"usage: {sys.argv[0]} --jax OUT.npz | --measure")
