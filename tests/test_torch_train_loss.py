"""The port's training loss and gradients against the JAX package, at SMOKE
size, and the committed reference the card checks them against.

`lm.loss_fn` and its gradients for `qwen3-0.6b`, `recurrentgemma-2b`,
`rwkv6-1.6b` and `granite-moe-3b-a800m` (its MoE auxiliary loss) in fp32
and bf16, and for `seamless-m4t-medium` (`enc_embeds`) and
`llava-next-34b` (`embeds`) in fp32.  Weights: `convert.numpy_params(cfg,
0)`, cast to the model dtype on both sides.  Batch: B = 2, T = 16 from
the synthetic stream (`data.synthetic`, seed 3), four labels set to -100,
`xent_chunk` = 6, which the loss lowers to 4 (four chunks).  The JAX side
runs jitted `jax.value_and_grad` in subprocesses pinned to AVX with
`--xla_allow_excess_precision=false` (this file is their script).

Tolerances: fp32, the loss within 2e-5 and each gradient leaf within
1e-3 of that leaf's largest magnitude in JAX; bf16, the loss within 0.05
and each leaf within 0.1 of its largest magnitude (the serving gates'
0.1; the sums run in other orders, and a bf16 rounding that lands
elsewhere moves a whole bf16 ulp).

`src/repro_torch/data/train_reference.json` holds, per arch and dtype,
the JAX loss, xent, aux, global gradient norm and per-leaf gradient sum,
largest magnitude and a seeded sample of entries, and three-step
`train.step` trajectories (losses, gradient norms, learning rates) of
`recurrentgemma-2b` (plain, microbatch 2, compress_grads), `qwen3-0.6b`
and `granite-moe-3b-a800m` in fp32 at B = 4, T = 16 from
`data.pipeline.Batcher(seed=1)`.  `chip_smoke.py`'s `train_check` reads
it; the first test below regenerates it and compares, so it cannot go
stale.  To rewrite it:

    python tests/test_torch_train_loss.py --write
"""
import json
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_reference import AVX_FLAG, SRC, run_avx  # noqa: E402
from test_torch_lm_serve import EXACT_FLAG  # noqa: E402

sys.path.insert(0, str(SRC))         # also when run as a script

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402

REF_PATH = SRC / "repro_torch" / "data" / "train_reference.json"
BF16_ARCHS = ("qwen3-0.6b", "recurrentgemma-2b", "rwkv6-1.6b",
              "granite-moe-3b-a800m")
FP32_ARCHS = BF16_ARCHS + ("seamless-m4t-medium", "llava-next-34b")
VARIANTS = tuple(f"{a}:float32" for a in FP32_ARCHS) + tuple(
    f"{a}:bfloat16" for a in BF16_ARCHS)
WEIGHTS_SEED = 0
BATCH_SEED, B, T, ENC_T, XENT_CHUNK = 3, 2, 16, 8, 6
MASKED = ((0, 0), (0, 1), (0, 2), (1, T - 1))        # labels set to -100
SAMPLES = 4                                           # entries kept a leaf
#: three-step train.step runs: arch -> configs (fp32, B = 4, T = 16)
TRAJ_CONFIGS = {"plain": {}, "microbatch": dict(microbatch=2),
                "compress": dict(compress_grads=True)}
TRAJECTORIES = (("recurrentgemma-2b", "plain"),
                ("recurrentgemma-2b", "microbatch"),
                ("recurrentgemma-2b", "compress"), ("qwen3-0.6b", "plain"),
                ("granite-moe-3b-a800m", "plain"))
TRAJ_B, TRAJ_T, TRAJ_STEPS = 4, 16, 3
TRAJ_LR = (1e-3, 2, 10, 1)          # wsd(peak, warmup, stable, decay)
N_PROCS = 4
TOL = {"float32": dict(loss=2e-5, leaf=1e-3),
       "bfloat16": dict(loss=0.05, leaf=0.1)}


def smoke(arch, dtype="float32"):
    return get_smoke_config(arch).scaled(dtype=dtype)


def loss_batch(cfg) -> dict:
    """The loss tests' batch, numpy: tokens, labels (four masked), and the
    arch's embeddings input."""
    toks = synthetic.batch_tokens(BATCH_SEED, 0, B, T, cfg.vocab_size)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    for i, t in MASKED:
        b["labels"][i, t] = -100
    if cfg.modality == "vlm":
        b["embeds"] = synthetic.batch_embeds(BATCH_SEED, 0, B, T,
                                             cfg.d_model)
    if cfg.family == "encdec":
        b["enc_embeds"] = synthetic.batch_embeds(BATCH_SEED, 0, B, ENC_T,
                                                 cfg.d_model)
    return b


def leaf_sample(name: str, numel: int) -> np.ndarray:
    rng = np.random.default_rng([BATCH_SEED, zlib.crc32(name.encode())])
    return np.sort(rng.choice(numel, min(SAMPLES, numel), replace=False))


# ---------------------------------------------------------------------------
# the JAX side (inside an AVX subprocess)
# ---------------------------------------------------------------------------


def _jax_params(cfg):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import lm as jlm
    jc = jax_smoke(cfg.name).scaled(dtype=cfg.dtype)
    tree = convert.numpy_params(cfg, WEIGHTS_SEED)
    shapes = jax.eval_shape(lambda k: jlm.init_params(jc, k),
                            jax.random.key(0))
    return jc, jax.tree.map(lambda x, s: jnp.asarray(x).astype(s.dtype),
                            tree, shapes)


def _by_name(cfg, tree) -> dict:
    """A JAX parameter-shaped tree as {port name: fp32 numpy}."""
    import jax
    out = {}
    for leaf, x in zip(convert.jax_leaf_groups(cfg), jax.tree.leaves(tree)):
        x = np.asarray(x.astype(np.float32))
        out.update(zip(leaf.names, list(x) if leaf.stacked else [x]))
    return out


def jax_loss(variant: str) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.models import lm as jlm
    from repro.optim import grad_utils as jgu
    cfg = smoke(*variant.split(":"))
    jc, params = _jax_params(cfg)
    batch = {k: jnp.asarray(v) for k, v in loss_batch(cfg).items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(jc, p, batch, xent_chunk=XENT_CHUNK),
        has_aux=True))(params)
    out = {f"{variant}|{k}": np.asarray(v) for k, v in _by_name(
        cfg, grads).items()}
    out.update({f"{variant}|=loss": np.asarray(loss),
                f"{variant}|=xent": np.asarray(metrics["xent"]),
                f"{variant}|=aux": np.asarray(metrics["aux"]),
                f"{variant}|=grad_norm": np.asarray(jgu.global_norm(grads))})
    return out


def jax_trajectory(arch: str, config: str) -> dict:
    import jax
    from repro.data import pipeline as jpipe
    from repro.optim import schedules as jsched
    from repro.train import step as jstep
    from repro.train.train_state import create as jcreate
    cfg = smoke(arch)
    jc, params = _jax_params(cfg)
    kw = TRAJ_CONFIGS[config]
    state = jcreate(params, use_error_feedback=kw.get("compress_grads",
                                                      False))
    step = jax.jit(jstep.make_train_step(jc, lr_schedule=jsched.wsd(
        *TRAJ_LR), **kw))
    data = iter(jpipe.Batcher(jc, TRAJ_B, TRAJ_T, seed=1))
    rows = {"loss": [], "grad_norm": [], "lr": [], "xent": []}
    for _ in range(TRAJ_STEPS):
        state, m = step(state, next(data))
        for k in rows:
            rows[k].append(float(m[k]))
    key = f"{arch}:{config}"
    return {f"{key}|={k}": np.asarray(v, np.float32) for k, v in rows.items()}


def _jax_main(jobs: str, path: str):
    out = {}
    for job in jobs.split(","):
        parts = job.split(":")
        out.update(jax_trajectory(parts[1], parts[2])
                   if parts[0] == "traj" else jax_loss(job))
    np.savez(path, **out)


def run_jax(tmp) -> dict:
    """Every variant's loss and gradients and every trajectory, from
    N_PROCS AVX subprocesses."""
    jobs = list(VARIANTS) + [f"traj:{a}:{c}" for a, c in TRAJECTORIES]
    paths = [str(Path(tmp) / f"train_{i}.npz") for i in range(N_PROCS)]
    run_avx(__file__, [["--jax", ",".join(jobs[i::N_PROCS]), p]
                       for i, p in enumerate(paths)], timeout=900,
            extra_flags=EXACT_FLAG)
    out = {}
    for p in paths:
        with np.load(p) as z:
            out.update({k: z[k] for k in z.files})
    return out


def build_reference(jax_out: dict) -> dict:
    """train_reference.json's content from `run_jax`'s arrays."""
    variants = {}
    for v in VARIANTS:
        arch, dtype = v.split(":")
        leaves = {}
        for name, w in lm.LM(smoke(arch, dtype),
                             torch.device("meta")).named_parameters():
            g = jax_out[f"{v}|{name}"].ravel()
            idx = leaf_sample(name, g.size)
            leaves[name] = dict(
                shape=list(w.shape), sum=float(g.astype(np.float64).sum()),
                max_abs=float(np.abs(g).max()), idx=idx.tolist(),
                val=[float(x) for x in g[idx]])
        variants[v] = dict({k: float(jax_out[f"{v}|={k}"]) for k in (
            "loss", "xent", "aux", "grad_norm")}, leaves=leaves)
    trajectories = {
        f"{a}:{c}": {k: [float(x) for x in jax_out[f"{a}:{c}|={k}"]]
                     for k in ("loss", "grad_norm", "lr", "xent")}
        for a, c in TRAJECTORIES}
    return dict(
        source="JAX package (jax.value_and_grad of repro.models.lm.loss_fn; "
               "repro.train.step.make_train_step), jitted on the CPU with "
               f"XLA_FLAGS='{AVX_FLAG} {EXACT_FLAG}'",
        weights_seed=WEIGHTS_SEED,
        weights="repro_torch.models.convert.numpy_params(cfg, weights_seed),"
                " cast to the model dtype",
        batch=dict(source="repro_torch.data.synthetic (batch_tokens, "
                          "batch_embeds)", seed=BATCH_SEED, index=0, B=B,
                   T=T, enc_T=ENC_T, masked=[list(m) for m in MASKED]),
        xent_chunk=XENT_CHUNK,
        sample="per leaf, SAMPLES flat indices from default_rng([seed, "
               "crc32(name)]).choice, sorted",
        variants=variants,
        trajectory=dict(batcher_seed=1, B=TRAJ_B, T=TRAJ_T,
                        steps=TRAJ_STEPS, wsd=list(TRAJ_LR),
                        configs={c: TRAJ_CONFIGS[c] for _, c in
                                 TRAJECTORIES}),
        trajectories=trajectories)


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    return run_jax(tmp_path_factory.mktemp("train_jax"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """SMOKE shapes are tiny: one intra-op thread, so that parallel test
    workers do not contend for the cores (the count is restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the port against it
# ---------------------------------------------------------------------------


def port_loss(variant: str, device="cpu"):
    """(loss, metrics, {name: gradient}) of the port on the variant's
    weights and batch."""
    cfg = smoke(*variant.split(":"))
    params = convert.lm_params_from_jax(
        convert.numpy_params(cfg, WEIGHTS_SEED), cfg, device)
    params.requires_grad_(True)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in loss_batch(cfg).items()}
    loss, metrics = lm.loss_fn(cfg, params, batch, xent_chunk=XENT_CHUNK)
    names, ws = zip(*params.named_parameters())
    gs = torch.autograd.grad(loss, ws, allow_unused=True,
                             materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(names, gs)))


def test_committed_train_reference_is_current(jax_out):
    committed = json.loads(REF_PATH.read_text())
    fresh = build_reference(jax_out)
    for v in VARIANTS:
        for k in ("loss", "xent", "aux", "grad_norm"):
            assert abs(committed["variants"][v][k]
                       - fresh["variants"][v][k]) <= 1e-6, (v, k)
    assert committed == fresh


@pytest.mark.parametrize("variant", VARIANTS)
def test_loss_and_gradients_against_jax(jax_out, variant):
    dtype = variant.split(":")[1]
    tol = TOL[dtype]
    loss, metrics, grads = port_loss(variant)
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(jax_out[f"{variant}|=loss"])) <= tol[
        "loss"]
    assert abs(float(metrics["aux"]) - float(jax_out[f"{variant}|=aux"])) \
        <= tol["loss"]
    for name, g in grads.items():
        want = jax_out[f"{variant}|{name}"]
        assert g.dtype == getattr(torch, dtype) or g.dtype == torch.float32
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(g.float().numpy() - want).max())
        assert err <= tol["leaf"] * scale, (name, err, scale)


def test_moe_aux_term_is_in_the_loss(jax_out):
    v = "granite-moe-3b-a800m:float32"
    loss, metrics, _ = port_loss(v)
    assert float(metrics["aux"]) > 0.5
    assert float(loss) == pytest.approx(
        float(metrics["xent"]) + 0.01 * float(metrics["aux"]), abs=1e-6)


@pytest.mark.parametrize("chunk", [512, 16, 5, 1])
def test_chunking_changes_no_loss(chunk):
    """c = min(chunk, T) lowered until it divides T: 16, 16, 4, 1 chunks of
    the 16 positions give the same loss within fp32 rounding."""
    cfg = smoke("qwen3-0.6b")
    params = convert.lm_params_from_jax(
        convert.numpy_params(cfg, WEIGHTS_SEED), cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in loss_batch(cfg).items()}
    with torch.no_grad():
        want, _ = lm.loss_fn(cfg, params, batch, xent_chunk=T)
        got, _ = lm.loss_fn(cfg, params, batch, xent_chunk=chunk)
    assert abs(float(got) - float(want)) <= 1e-5


def test_loss_masks_labels_of_minus_100():
    cfg = smoke("recurrentgemma-2b")
    params = convert.lm_params_from_jax(
        convert.numpy_params(cfg, WEIGHTS_SEED), cfg, "cpu")
    b = {k: torch.from_numpy(v) for k, v in loss_batch(cfg).items()}
    with torch.no_grad():
        logits, _ = lm.forward(cfg, params, b)
        lp = torch.log_softmax(logits.float(), -1)
        y = b["labels"].long()
        keep = y != -100
        want = -(lp.gather(-1, y.clamp_min(0)[..., None])[..., 0][keep]
                 ).mean()
        got, _ = lm.loss_fn(cfg, params, b, xent_chunk=XENT_CHUNK)
    assert int(keep.sum()) == B * T - len(MASKED)
    assert abs(float(got) - float(want)) <= 1e-5


def test_recompute_runs_each_layer_forward_twice():
    """With gradients on, every layer runs under `torch.utils.checkpoint`:
    the RG-LRU scan runs twice a layer (forward and recompute) and its
    backward once; the same gradients as without recompute."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    cfg = smoke("recurrentgemma-2b")
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = ops.RGLRUScan.forward, ops.RGLRUScan.backward

    def fwd(ctx, *a):
        calls["fwd"] += 1
        return real_fwd(ctx, *a)

    def bwd(ctx, *a):
        calls["bwd"] += 1
        return real_bwd(ctx, *a)

    ops.RGLRUScan.forward, ops.RGLRUScan.backward = (staticmethod(fwd),
                                                     staticmethod(bwd))
    try:
        _, _, grads = port_loss("recurrentgemma-2b:float32")
    finally:
        ops.RGLRUScan.forward, ops.RGLRUScan.backward = (
            staticmethod(real_fwd), staticmethod(real_bwd))
    n_rg = sum(k[0] == "rg" for k in cfg.layers)
    assert (calls["fwd"], calls["bwd"]) == (2 * n_rg, n_rg)

    real = transformer._recomputed
    transformer._recomputed = lambda cfg, kinds, layer, x, pos, enc: \
        transformer._apply_layer(cfg, kinds, layer, x, pos, None, None, enc)
    try:
        _, _, plain = port_loss("recurrentgemma-2b:float32")
    finally:
        transformer._recomputed = real
    for name in grads:
        assert torch.equal(grads[name], plain[name]), name


def _main(argv):
    if argv[:1] == ["--jax"]:
        _jax_main(argv[1], argv[2])
    elif argv[:1] == ["--write"]:
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            REF_PATH.write_text(json.dumps(build_reference(run_jax(tmp)))
                                + "\n")
        print(f"wrote {REF_PATH}")
    else:
        raise SystemExit(f"usage: {sys.argv[0]} --write | --jax JOBS OUT")


if __name__ == "__main__":
    _main(sys.argv[1:])
