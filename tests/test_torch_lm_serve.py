"""The port's serving path as a whole, for every ported architecture, at
SMOKE size.

The machine with the card has no JAX, so `chip_smoke.py` holds the port's
serving runs against `src/repro_torch/data/lm_reference.json`: one entry
per architecture, each for SMOKE in fp32 and in bf16, with the numpy seed
of the weights (`convert.numpy_params`, cast to the model dtype on both
sides by round-to-nearest-even), four requests, the JAX package's greedy
tokens from `ServeEngine(batch=2, s_max=48)`, and the teacher-forced
logits of request 0 (the slot prefill, then one decode step per reference
token).  Request 0 has the longest prompt (24 tokens) and 12 new tokens,
so its positions reach 35 and `recurrentgemma-2b`'s 32-slot local
attention ring wraps; the others are short, so their slot is refilled
while request 0 decodes.  Their prompts are left-padded to 24 with token
0, and the pads pass through every layer: RWKV's recurrence, and the MoE
dispatch, where they take capacity before the real tokens.  The reference
is run on the CPU with `XLA_FLAGS=--xla_cpu_max_isa=AVX`, in
subprocesses.  They also run with `--xla_allow_excess_precision=false`:
by default XLA on the CPU drops the bf16 roundings between fused
elementwise operations (a chain bf16 -> f32 -> bf16 -> f32 keeps f32), so
its bf16 model is not the one its source writes, and the port, which
rounds where the source does, reads 0.03-0.10 from it on every logit row
(`granite-moe-3b-a800m` up to 0.1016, its top-8 routing amplifying the
gap); the pin is to bf16 what the AVX pin is to FMA contraction.  The
first test below regenerates every entry and compares
(tokens equal, logits within 1e-6), so none can go stale.  To rewrite
them all:

    python tests/test_torch_lm_serve.py --write

The archs whose input is more than tokens (`FRONTENDS`) also have a
`frontend` entry: a lockstep run from their frontend's input, which the
serving engine does not take.  `seamless-m4t-medium` prefills a prompt
of tokens after encoding frame embeddings (`enc_embeds`), and
`llava-next-34b` prefills patch embeddings (`embeds`); both then decode
greedily in lockstep (`lm.prefill`, `lm.decode_step`), and the entry keeps
the greedy tokens and the logits of every step.  The inputs are drawn
from `np.random.default_rng(inputs_seed)` as the entry's `inputs` says.

Tolerances: fp32 logits within 2e-4 of JAX and greedy tokens equal; bf16
teacher-forced logits within 0.1 (about twice the gap between the bf16 and
the fp32 `recurrentgemma-2b` on the same weights).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_reference import ROOT, SRC, AVX_FLAG, run_avx  # noqa: E402

sys.path.insert(0, str(SRC))         # also when run as a script

from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

REF_PATH = SRC / "repro_torch" / "data" / "lm_reference.json"
#: XLA flags beyond the AVX pin: round bf16 where the source does.
EXACT_FLAG = "--xla_allow_excess_precision=false"
ARCH = "recurrentgemma-2b"
#: The reference's subprocesses: each runs a share of the (arch, dtype)
#: variants in turn.
N_PROCS = 4
WEIGHTS_SEED = 0
REQUESTS_SEED = 1
PROMPT_LENS = (24, 3, 17, 9)
MAX_NEW = (12, 4, 5, 6)
BATCH, S_MAX = 2, 48
VARIANTS = ("float32", "bfloat16")
TOL = {"float32": 2e-4, "bfloat16": 0.1}
#: the frontend runs: the input, its rows, and its length (frames before a
#: prompt of tokens for the enc-dec model, positions for `embeds`)
FRONTENDS = {
    "seamless-m4t-medium": dict(input="enc_embeds", batch=2, length=16,
                                prompt_len=6),
    "llava-next-34b": dict(input="embeds", batch=2, length=12),
}
FRONTEND_SEED, FRONTEND_NEW, FRONTEND_S_MAX = 2, 6, 24
FRONTEND_INPUTS = ("standard_normal((batch, length, d_model)) as float32, "
                   "then for enc_embeds integers(0, vocab_size, (batch, "
                   "prompt_len)), the prompt's tokens")


def frontend_inputs(arch: str) -> dict:
    """The frontend run's batch, numpy arrays (FRONTEND_INPUTS)."""
    f, cfg = FRONTENDS[arch], get_smoke_config(arch)
    rng = np.random.default_rng(FRONTEND_SEED)
    x = rng.standard_normal((f["batch"], f["length"], cfg.d_model)).astype(
        np.float32)
    if f["input"] == "embeds":
        return {"embeds": x}
    return {"enc_embeds": x, "tokens": rng.integers(
        0, cfg.vocab_size, (f["batch"], f["prompt_len"]))}


def make_requests(vocab: int):
    rng = np.random.default_rng(REQUESTS_SEED)
    return [dict(prompt=rng.integers(0, vocab, n).tolist(), max_new=m)
            for n, m in zip(PROMPT_LENS, MAX_NEW)]


def jax_variant(arch: str, dtype: str) -> dict:
    """The reference of one arch and dtype (call inside an AVX
    subprocess)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import lm as jlm
    from repro.serve.engine import Request, ServeEngine

    jc = jax_smoke(arch).scaled(dtype=dtype)
    tree = convert.numpy_params(get_smoke_config(arch).scaled(dtype=dtype),
                                WEIGHTS_SEED)
    shapes = jax.eval_shape(lambda k: jlm.init_params(jc, k),
                            jax.random.key(0))
    params = jax.tree.map(lambda x, s: jnp.asarray(x).astype(s.dtype), tree,
                          shapes)
    reqs = make_requests(jc.vocab_size)
    done = ServeEngine(jc, params, batch=BATCH, s_max=S_MAX).run(
        [Request(prompt=np.asarray(r["prompt"], np.int32),
                 max_new=r["max_new"]) for r in reqs])
    tokens = [r.out.tolist() for r in done]

    step = jax.jit(lambda p, c, t: jlm.decode_step(jc, p, c, t))
    t_pad = max(PROMPT_LENS)
    toks = np.zeros((1, t_pad), np.int32)
    toks[0, t_pad - PROMPT_LENS[0]:] = reqs[0]["prompt"]
    logits, cache = step(params, jlm.init_cache(jc, 1, S_MAX),
                         jnp.asarray(toks))
    rows = [logits[0, -1]]
    for tok in tokens[0]:
        logits, cache = step(params, cache, jnp.asarray([[tok]], jnp.int32))
        rows.append(logits[0, 0])
    tf = np.asarray(jnp.stack(rows).astype(jnp.float32))
    return dict(dtype=dtype, tokens=tokens,
                teacher_forced_logits=[[float(x) for x in row]
                                       for row in tf])


def jax_frontend(arch: str, dtype: str) -> dict:
    """The frontend run of one arch and dtype (inside an AVX subprocess):
    prefill, then FRONTEND_NEW greedy lockstep steps."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import lm as jlm

    jc = jax_smoke(arch).scaled(dtype=dtype)
    tree = convert.numpy_params(get_smoke_config(arch).scaled(dtype=dtype),
                                WEIGHTS_SEED)
    shapes = jax.eval_shape(lambda k: jlm.init_params(jc, k),
                            jax.random.key(0))
    params = jax.tree.map(lambda x, s: jnp.asarray(x).astype(s.dtype), tree,
                          shapes)
    batch = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
             for k, v in frontend_inputs(arch).items()}
    prefill = jax.jit(lambda p, c, b: jlm.prefill(jc, p, c, b))
    step = jax.jit(lambda p, c, t: jlm.decode_step(jc, p, c, t))
    cache = jlm.init_cache(jc, FRONTENDS[arch]["batch"], FRONTEND_S_MAX)
    logits, cache = prefill(params, cache, batch)
    rows, toks = [logits], []
    for _ in range(FRONTEND_NEW):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(tok)
        logits, cache = step(params, cache, tok[:, None])
        logits = logits[:, 0]
        rows.append(logits)
    tf = np.asarray(jnp.stack(rows).astype(jnp.float32))
    return dict(dtype=dtype,
                tokens=np.asarray(jnp.stack(toks, axis=1)).tolist(),
                teacher_forced_logits=tf.tolist())


def build_reference() -> dict:
    """Every ported arch's entry, keyed by arch."""
    jobs = [f"{a}:{v}" for a in ARCH_IDS for v in VARIANTS] + [
        f"{a}:{v}:frontend" for a in FRONTENDS for v in VARIANTS]
    outs = run_avx(__file__, [["--variants", ",".join(jobs[i::N_PROCS])]
                              for i in range(N_PROCS)], timeout=900,
                   extra_flags=EXACT_FLAG)
    got = {}
    for o in outs:
        got.update(json.loads(o.strip().splitlines()[-1]))
    refs = {arch: dict(
        source="JAX package (repro.serve.engine.ServeEngine and "
               "repro.models.lm.decode_step), on the CPU with "
               f"XLA_FLAGS='{AVX_FLAG} {EXACT_FLAG}'",
        arch=arch, config="SMOKE", weights_seed=WEIGHTS_SEED,
        weights="repro_torch.models.convert.numpy_params(cfg, "
                "weights_seed), cast to the model dtype",
        batch=BATCH, s_max=S_MAX, t_pad=max(PROMPT_LENS),
        requests=make_requests(get_smoke_config(arch).vocab_size),
        variants={v: got[f"{arch}:{v}"] for v in VARIANTS})
        for arch in ARCH_IDS}
    for arch, f in FRONTENDS.items():
        refs[arch]["frontend"] = dict(
            f, source="JAX package (repro.models.lm.prefill, then "
                      "decode_step fed the argmax in lockstep)",
            inputs_seed=FRONTEND_SEED,
            inputs=f"np.random.default_rng(inputs_seed): {FRONTEND_INPUTS}",
            new_tokens=FRONTEND_NEW, s_max=FRONTEND_S_MAX,
            variants={v: got[f"{arch}:{v}:frontend"] for v in VARIANTS})
    return refs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """SMOKE shapes are tiny: one intra-op thread, so that parallel test
    workers do not contend for the cores (the count is restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def references():
    return json.loads(REF_PATH.read_text())


def _port(arch: str, dtype: str, ref):
    cfg = get_smoke_config(arch).scaled(dtype=dtype)
    params = convert.lm_params_from_jax(
        convert.numpy_params(cfg, ref["weights_seed"]), cfg, "cpu")
    return cfg, params


def _serve(cfg, params, reqs):
    eng = tengine.ServeEngine(cfg, params, batch=BATCH, s_max=S_MAX,
                              device="cpu")
    done = eng.run([tengine.Request(prompt=np.asarray(r["prompt"]),
                                    max_new=r["max_new"]) for r in reqs])
    return [r.out.tolist() for r in done], eng.stats


def test_committed_lm_reference_is_current():
    committed = json.loads(REF_PATH.read_text())
    fresh = build_reference()
    assert sorted(committed) == sorted(fresh) == sorted(ARCH_IDS)
    runs = [(arch, v, ()) for arch in ARCH_IDS for v in VARIANTS] + [
        (arch, v, ("frontend",)) for arch in FRONTENDS for v in VARIANTS]
    for arch, v, where in runs:
        c = _get(committed[arch], where)["variants"].pop(v)
        f = _get(fresh[arch], where)["variants"].pop(v)
        assert c["tokens"] == f["tokens"], (arch, v, where)
        np.testing.assert_allclose(f["teacher_forced_logits"],
                                   c["teacher_forced_logits"], rtol=0,
                                   atol=1e-6, err_msg=f"{arch} {v} {where}")
    assert committed == fresh


def _get(entry, where):
    for key in where:
        entry = entry[key]
    return entry


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_fp32_greedy_tokens_equal_jax(references, arch):
    reference = references[arch]
    cfg, params = _port(arch, "float32", reference)
    ops.reset_launch_counts()
    tokens, stats = _serve(cfg, params, reference["requests"])
    assert tokens == reference["variants"]["float32"]["tokens"]
    assert stats["admissions"] == 4 and stats["decode_steps"] > 0
    assert ops.launch_counts()["rg_lru_scan"] == 0   # the CPU: no kernel


@pytest.mark.parametrize("dtype", VARIANTS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_teacher_forced_logits_equal_jax(references, arch, dtype):
    reference = references[arch]
    cfg, params = _port(arch, dtype, reference)
    ref = reference["variants"][dtype]
    req = reference["requests"][0]
    got = tengine.teacher_forced_logits(cfg, params, req["prompt"],
                                        ref["tokens"][0],
                                        reference["t_pad"], S_MAX)
    want = np.asarray(ref["teacher_forced_logits"], np.float32)
    assert got.shape == want.shape == (req["max_new"] + 1, cfg.vocab_size)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[dtype])
    if dtype == "float32":
        assert got[:-1].argmax(-1).tolist() == ref["tokens"][0]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_refill_does_not_change_a_live_slot(references, arch):
    """Request 0 decodes while its companion's slot is refilled twice; its
    tokens equal its solo run's."""
    reference = references[arch]
    cfg, params = _port(arch, "float32", reference)
    reqs = reference["requests"]
    together, stats = _serve(cfg, params, reqs)
    solo, _ = _serve(cfg, params, reqs[:1])
    assert together[0] == solo[0]
    assert stats["admissions"] == len(reqs)


def test_temperature_sampling_draws_from_the_top_k(references):
    reference = references[ARCH]
    from repro_torch.serve import sampling
    logits = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 512)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    top = torch.topk(logits, 5, dim=-1).indices
    for _ in range(20):
        tok = sampling.temperature(gen, logits, temp=0.7, top_k=5)
        assert tok.shape == (3,)
        assert all(int(t) in top[i].tolist() for i, t in enumerate(tok))
    cold = sampling.temperature(gen, logits, temp=1e-9)
    assert torch.equal(cold, sampling.greedy(logits))
    cfg, params = _port(ARCH, "float32", reference)
    eng = tengine.ServeEngine(cfg, params, batch=2, s_max=S_MAX,
                              greedy=False, seed=3, device="cpu")
    reqs = reference["requests"][:3]
    outs = [r.out for r in eng.run(
        [tengine.Request(prompt=np.asarray(r["prompt"]),
                         max_new=r["max_new"]) for r in reqs])]
    assert [o.shape[0] for o in outs] == [r["max_new"] for r in reqs]
    assert all(((o >= 0) & (o < cfg.vocab_size)).all() for o in outs)


def test_no_hidden_fallback_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal is not testable")
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg = get_smoke_config(ARCH)
    params = lm.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.ServeEngine(cfg, params, batch=1, s_max=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", ARCH, "--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(cfg)
    # a CUDA tensor reaches the kernel, which cannot build here: it raises
    # rather than run the plain version
    with FakeTensorMode():
        a = torch.empty(1, 4, 8, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            ops.rg_lru_scan(a, a)
    assert ops.launch_counts()["rg_lru_scan"] == 0


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)


def test_cli_serves_smoke_on_cpu():
    out = _cli("--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
               "3", "--max-new", "4")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[serve] 3 requests, 12 tokens" in out.stdout
    assert "3 slot prefills" in out.stdout


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "granite-moe-3b-a800m"])
def test_cli_serves_a_new_family_on_cpu(arch):
    out = _cli("--arch", arch, "--smoke", "--device", "cpu", "--requests",
               "3", "--max-new", "4")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[serve] 3 requests, 12 tokens" in out.stdout
    assert "3 slot prefills" in out.stdout


@pytest.mark.parametrize("arch", sorted(FRONTENDS))
def test_cli_serves_a_frontend_arch_on_cpu(arch):
    """The engine serves token prompts: llava's text path, and seamless
    with its cross-attention over the decoder's own states (no encoder
    input, as in the JAX package's engine)."""
    out = _cli("--arch", arch, "--smoke", "--device", "cpu", "--requests",
               "3", "--max-new", "4")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[serve] 3 requests, 12 tokens" in out.stdout
    assert "3 slot prefills" in out.stdout


@pytest.mark.parametrize("dtype", VARIANTS)
@pytest.mark.parametrize("arch", sorted(FRONTENDS))
def test_frontend_lockstep_equals_jax(references, arch, dtype):
    """The `frontend` entry: the port's prefill from the frontend's input
    and its decode steps, fed the reference's greedy tokens: logits
    within the tolerance, and in fp32 the same greedy tokens."""
    fe = references[arch]["frontend"]
    cfg, params = _port(arch, dtype, references[arch])
    ref = fe["variants"][dtype]
    batch = {k: torch.from_numpy(v) for k, v in frontend_inputs(arch).items()}
    got = tengine.lockstep_teacher_forced_logits(cfg, params, batch,
                                                 ref["tokens"], fe["s_max"])
    want = np.asarray(ref["teacher_forced_logits"], np.float32)
    assert got.shape == want.shape == (fe["new_tokens"] + 1, fe["batch"],
                                       cfg.vocab_size)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[dtype])
    if dtype == "float32":
        assert got[:-1].argmax(-1).T.tolist() == ref["tokens"]


def _main(argv):
    if argv[:1] == ["--variants"]:
        print(json.dumps({job: (jax_frontend(*job.split(":")[:2])
                                if job.endswith(":frontend")
                                else jax_variant(*job.split(":")))
                          for job in argv[1].split(",")}))
    elif argv[:1] == ["--write"]:
        REF_PATH.write_text(json.dumps(build_reference()) + "\n")
        print(f"wrote {REF_PATH}")
    else:
        raise SystemExit(f"usage: {sys.argv[0]} --write | --variants "
                         f"ARCH:DTYPE[,ARCH:DTYPE...]")


if __name__ == "__main__":
    _main(sys.argv[1:])
