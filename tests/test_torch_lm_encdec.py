"""The port's encoder-decoder model (`seamless-m4t-medium`) and `embeds`
input (`llava-next-34b`) against the JAX package, on the CPU, at SMOKE
size: cross-attention (a (k, v) pair and the lazy `_EncOut`, fp32 and
bf16, qk-norm with grouped heads), the encoder's bidirectional attention
(the direct path and the chunked path, whose non-causal form is the JAX
package's dense variant), one 'xa' layer with and without a cache and
with no encoder input, and the models whole: `encode`, `forward`,
`prefill` from `enc_embeds` and from a cache's `enc_out`, lockstep greedy
decode, and the `embeds` input.

Weights come from `convert.numpy_params` (numpy seed 0, fp32, cast to the
model dtype on both sides by round-to-nearest-even), inputs from numpy
seeds.  The JAX side runs in subprocesses with the pins of
`test_torch_lm_serve.py` (`XLA_FLAGS=--xla_cpu_max_isa=AVX
--xla_allow_excess_precision=false`); this file is their script
(`--cases GROUP OUT.npz`).  Tolerances: modules rtol = atol = 2e-4 in
fp32 (as `test_torch_lm_families.py`) and BF16_MODULE in bf16; whole
models within 2e-4 in fp32 with equal greedy tokens, and within 0.1 in
bf16 (`test_torch_lm_serve.py`'s limits).  Structure-only checks
(parameter counts by `jax.eval_shape`, the `convert` round trip) run JAX
in-process.
"""
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

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import attention, convert, lm  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

SEAMLESS, LLAVA = "seamless-m4t-medium", "llava-next-34b"
TOL = dict(rtol=2e-4, atol=2e-4)
#: bf16 modules: both sides round to bf16 where the source does, so they
#: differ by the products' summation order, a bf16 ulp of the output
#: (outputs here are under 2 in magnitude: an ulp is at most 2^-7)
BF16_MODULE = dict(rtol=2.0 ** -7, atol=2.0 ** -7)
MODEL_TOL = {"float32": TOL, "bfloat16": dict(rtol=0, atol=0.1)}
WEIGHTS_SEED = 0
#: Full-width parameter counts (the JAX package's `init_params` under
#: `jax.eval_shape`).
FULL_PARAMS = {SEAMLESS: 614_739_968, LLAVA: 34_388_917_248}
#: cross-attention cases: (source, dtype, config overrides); qk-norm with
#: 2 kv heads for 4 query heads also covers the grouped layout
CROSS_CASES = {
    "tuple_fp32": ("tuple", "float32", {}),
    "encout_fp32": ("encout", "float32", {}),
    "tuple_bf16": ("tuple", "bfloat16", {}),
    "encout_bf16": ("encout", "bfloat16", {}),
    "encout_qk_gqa": ("encout", "float32",
                      dict(qk_norm=True, n_kv_heads=2)),
}
#: the queries' positions in the cross cases: a rotation would move them
CROSS_POS = np.arange(5) + 7
#: bidirectional attention: (batch, frames); 1,536^2 > 2^21 takes the
#: chunked path (q chunks of 512, kv chunks of 768)
BI_CASES = {"direct": (2, 12), "chunked": (1, 1536)}
XA_CASES = ("encout", "encout_cache", "none", "none_cache")
S_MAX, PROMPT, NEW = 16, 5, 6
DTYPES = ("float32", "bfloat16")
GROUPS = {"modules": None, "models_float32": "float32",
          "models_bfloat16": "bfloat16"}


def rand(seed, *shape, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return x.astype(np.float32)


def smoke(arch, dtype="float32", **kw):
    return get_smoke_config(arch).scaled(dtype=dtype, **kw)


def tokens(arch, seed=31, T=8):
    return np.random.default_rng(seed).integers(
        0, smoke(arch).vocab_size, (2, T))


def cross_inputs(case):
    _, _, kw = CROSS_CASES[case]
    c = smoke(SEAMLESS, **kw)
    return dict(x=rand(1, 2, 5, c.d_model), enc=rand(2, 2, 9, c.d_model),
                k=rand(3, 2, 9, c.n_kv_heads, c.head_dim),
                v=rand(4, 2, 9, c.n_kv_heads, c.head_dim))


def xa_inputs():
    d = smoke(SEAMLESS).d_model
    return rand(20, 2, 6, d), rand(21, 2, 9, d), rand(22, 2, 1, d)


def seamless_inputs():
    return rand(30, 2, 10, smoke(SEAMLESS).d_model), tokens(SEAMLESS)


def llava_embeds():
    return rand(40, 2, 10, smoke(LLAVA).d_model)


# ---------------------------------------------------------------------------
# the JAX side (inside an AVX subprocess)
# ---------------------------------------------------------------------------


def _jax_params(arch, dtype="float32", **kw):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import lm as jlm
    jc = jax_smoke(arch).scaled(dtype=dtype, **kw)
    tree = convert.numpy_params(smoke(arch, dtype, **kw), WEIGHTS_SEED)
    shapes = jax.eval_shape(lambda k: jlm.init_params(jc, k),
                            jax.random.key(0))
    return jc, jax.tree.map(lambda x, s: jnp.asarray(x).astype(s.dtype),
                            tree, shapes)


def _jax_layer(stack, k, cfg):
    import jax
    where = convert._layer_key(cfg, k)
    if where[0] == "units":
        return jax.tree.map(lambda a: a[where[2]], stack["units"][where[1]])
    return stack["rem"][where[1]]


def jax_modules() -> dict:
    import jax.numpy as jnp
    from repro.models import attention as jattn
    from repro.models import lm as jlm
    from repro.models import transformer as jtr
    out = {}
    for case, (src, dtype, kw) in CROSS_CASES.items():
        jc, jp = _jax_params(SEAMLESS, dtype, **kw)
        p = _jax_layer(jp["stack"], 0, jc)["cross"]
        dt = jnp.dtype(dtype)
        a = {k: jnp.asarray(v).astype(dt) for k, v in
             cross_inputs(case).items()}
        kv = (a["k"], a["v"]) if src == "tuple" else jlm._EncOut(a["enc"])
        y, cache = jattn.attention(jc, p, a["x"], jnp.asarray(CROSS_POS),
                                   causal=False, kv_override=kv)
        assert cache is None
        out[f"cross_{case}"] = y.astype(jnp.float32)

    jc, jp = _jax_params(SEAMLESS)
    enc_cfg = jlm.encoder_view(jc)
    p = _jax_layer(jp["enc_stack"], 0, enc_cfg)["mixer"]
    for case, (B, S) in BI_CASES.items():
        x = jnp.asarray(rand(10 + S, B, S, jc.d_model))
        y, _ = jattn.attention(enc_cfg, p, x, jnp.arange(S), causal=False)
        out[f"bi_{case}"] = y

    lp = _jax_layer(jp["stack"], 0, jc)
    kinds = jc.layers[0]
    x, enc, xt = (jnp.asarray(a) for a in xa_inputs())
    for case in XA_CASES:
        enc_kv = jlm._EncOut(enc) if case.startswith("encout") else None
        if not case.endswith("cache"):
            y, _, _ = jtr._apply_layer(jc, kinds, lp, x, jnp.arange(6), None,
                                       None, enc_kv)
            out[f"xa_{case}"] = y
            continue
        shape = (2, S_MAX, jc.n_kv_heads, jc.head_dim)
        cache = {"kv": (jnp.zeros(shape), jnp.zeros(shape))}
        y, cache, _ = jtr._apply_layer(jc, kinds, lp, x, jnp.arange(6),
                                       cache, jnp.int32(0), enc_kv)
        # the decode step: lockstep with an encoder, per slot without one
        # (as the serving engine runs it)
        cp = jnp.int32(6) if enc_kv is not None else jnp.array([6, 6])
        yd, cache, _ = jtr._apply_layer(jc, kinds, lp, xt,
                                        cp[..., None] + jnp.arange(1),
                                        cache, cp, enc_kv)
        out.update({f"xa_{case}_prefill": y, f"xa_{case}_decode": yd,
                    f"xa_{case}_k": cache["kv"][0],
                    f"xa_{case}_v": cache["kv"][1]})
    return out


def _greedy(jc, jp, batch):
    """prefill then NEW lockstep greedy steps: (tokens [B, NEW], logits
    [NEW + 1, B, V])."""
    import jax
    import jax.numpy as jnp
    from repro.models import lm as jlm
    B = next(iter(batch.values())).shape[0]
    prefill = jax.jit(lambda p, c, b: jlm.prefill(jc, p, c, b))
    step = jax.jit(lambda p, c, t: jlm.decode_step(jc, p, c, t))
    logits, cache = prefill(jp, jlm.init_cache(jc, B, S_MAX), batch)
    rows, toks = [logits], []
    for _ in range(NEW):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(tok)
        logits, cache = step(jp, cache, tok[:, None])
        logits = logits[:, 0]
        rows.append(logits)
    return (jnp.stack(toks, axis=1),
            jnp.stack(rows).astype(jnp.float32))


def jax_models(dtype) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.models import lm as jlm
    f32 = lambda a: jnp.asarray(a).astype(jnp.float32)
    out = {}
    jc, jp = _jax_params(SEAMLESS, dtype)
    enc_np, toks_np = seamless_inputs()
    enc, toks = jnp.asarray(enc_np), jnp.asarray(toks_np, jnp.int32)
    enc_out = jax.jit(lambda p, e: jlm.encode(jc, p, e))(jp, enc)
    out["enc_out"] = f32(enc_out)
    logits, _ = jax.jit(lambda p, b: jlm.forward(jc, p, b))(
        jp, {"tokens": toks, "enc_embeds": enc})
    out["seamless_fwd"] = f32(logits)
    out["seamless_tokens"], out["seamless_logits"] = _greedy(
        jc, jp, {"tokens": toks[:, :PROMPT], "enc_embeds": enc})
    logits, cache = jax.jit(lambda p, c, b: jlm.prefill(jc, p, c, b))(
        jp, jlm.init_cache(jc, 2, S_MAX, enc_out=enc_out),
        {"tokens": toks[:, :PROMPT]})
    out["seamless_prefill_cached"] = f32(logits)
    if dtype == "float32":
        long = jnp.asarray(rand(50, 1, 1536, jc.d_model))
        out["enc_out_long"] = jax.jit(lambda p, e: jlm.encode(jc, p, e))(
            jp, long)

    jc, jp = _jax_params(LLAVA, dtype)
    emb = jnp.asarray(llava_embeds())
    logits, _ = jax.jit(lambda p, b: jlm.forward(jc, p, b))(
        jp, {"embeds": emb})
    out["llava_fwd"] = f32(logits)
    out["llava_tokens"], out["llava_logits"] = _greedy(
        jc, jp, {"embeds": emb})
    return out


def _main(argv):
    if argv[:1] != ["--cases"]:
        raise SystemExit(f"usage: {sys.argv[0]} --cases GROUP OUT.npz")
    group, path = argv[1], argv[2]
    outs = jax_modules() if GROUPS[group] is None else jax_models(
        GROUPS[group])
    np.savez(path, **{k: np.asarray(v) for k, v in outs.items()})
    print(path)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """SMOKE shapes are tiny: one intra-op thread, so that parallel test
    workers do not contend for the cores (the count is restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    with tempfile.TemporaryDirectory() as tmp:
        paths = [str(Path(tmp) / f"{g}.npz") for g in GROUPS]
        run_avx(__file__, [["--cases", g, p] for g, p in zip(GROUPS, paths)],
                extra_flags=EXACT_FLAG)
        out = {}
        for p in paths:
            group = Path(p).stem
            with np.load(p) as z:
                pre = "" if group == "modules" else GROUPS[group] + "_"
                out.update({pre + k: z[k] for k in z.files})
    return out


# ---------------------------------------------------------------------------
# the port against it
# ---------------------------------------------------------------------------


_PORT = {}


def port(arch, dtype="float32", **kw):
    key = (arch, dtype, tuple(sorted(kw.items())))
    if key not in _PORT:
        cfg = smoke(arch, dtype, **kw)
        _PORT[key] = (cfg, convert.lm_params_from_jax(
            convert.numpy_params(cfg, WEIGHTS_SEED), cfg, "cpu"))
    return _PORT[key]


def close(got, want, **tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **(tol or TOL))


T_ = torch.from_numpy


def _cross(case, rotate_q=False):
    src, dtype, kw = CROSS_CASES[case]
    cfg, p = port(SEAMLESS, dtype, **kw)
    dt = getattr(torch, dtype)
    a = {k: T_(v).to(dt) for k, v in cross_inputs(case).items()}
    kv = (a["k"], a["v"]) if src == "tuple" else lm._EncOut(a["enc"])
    cross = p.stack.layers[0].cross
    pos = T_(CROSS_POS)
    if not rotate_q:
        return attention.attention(cfg, cross, a["x"], pos, causal=False,
                                   kv_override=kv)
    # the same call with q rotated to its positions (what the port must
    # not do): shows that the case tells the two apart
    q = (a["x"] @ cross.wq).view(2, 5, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = attention.common.rms_norm(q, cross.q_gamma, cfg.norm_eps)
    q = attention.common.rope(q, pos, cfg.rope_theta)
    if src == "tuple":
        k, v = a["k"], a["v"]
    else:
        k = (a["enc"] @ cross.wk).view(2, 9, cfg.n_kv_heads, cfg.head_dim)
        v = (a["enc"] @ cross.wv).view(2, 9, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        k = attention.common.rms_norm(k, cross.k_gamma, cfg.norm_eps)
    G = cfg.n_heads // cfg.n_kv_heads
    qg = q.view(2, 5, cfg.n_kv_heads, G, cfg.head_dim).permute(0, 2, 3, 1, 4)
    out = attention._direct_gqa(qg, k, v, causal=False, window=None,
                                softcap=None, scale=cfg.head_dim ** -0.5,
                                q_offset=0)
    y = out.permute(0, 3, 1, 2, 4).reshape(2, 5, -1)
    return y @ cross.wo


@pytest.mark.parametrize("case", CROSS_CASES)
def test_cross_attention(ref, case):
    y, cache = _cross(case)
    assert cache is None
    assert y.dtype == getattr(torch, CROSS_CASES[case][1])
    tol = BF16_MODULE if y.dtype == torch.bfloat16 else TOL
    close(y, ref[f"cross_{case}"], **tol)


@pytest.mark.parametrize("case", ["tuple_fp32", "encout_fp32",
                                  "encout_qk_gqa"])
def test_cross_attention_rotates_neither_q_nor_k(ref, case):
    """The cross cases' queries sit at positions 7..11: rotating q there
    moves the output far past the tolerance, and the JAX package does not
    rotate; nor do positions change the port's output."""
    rotated = _cross(case, rotate_q=True)
    err = np.abs(rotated.numpy() - ref[f"cross_{case}"]).max()
    assert err > 100 * TOL["atol"]
    cfg, p = port(SEAMLESS, *CROSS_CASES[case][1:2],
                  **CROSS_CASES[case][2])
    a = cross_inputs(case)
    kv = lm._EncOut(T_(a["enc"])) if CROSS_CASES[case][0] == "encout" \
        else (T_(a["k"]), T_(a["v"]))
    y0, _ = attention.attention(cfg, p.stack.layers[0].cross, T_(a["x"]),
                                torch.zeros(5, dtype=torch.int64),
                                causal=False, kv_override=kv)
    assert torch.equal(y0, _cross(case)[0])


@pytest.mark.parametrize("case", BI_CASES)
def test_bidirectional_attention(ref, case, monkeypatch):
    cfg, p = port(SEAMLESS)
    B, S = BI_CASES[case]
    chunked = []
    real = attention._chunked_gqa
    monkeypatch.setattr(attention, "_chunked_gqa",
                        lambda *a, **kw: chunked.append(kw) or real(*a, **kw))
    y, cache = attention.attention(
        lm.encoder_view(cfg), p.enc_stack.layers[0].mixer,
        T_(rand(10 + S, B, S, cfg.d_model)), torch.arange(S), causal=False)
    assert cache is None
    assert len(chunked) == (case == "chunked")
    if chunked:
        assert chunked[0]["causal"] is False
        assert chunked[0]["window"] is None
    close(y, ref[f"bi_{case}"])


def test_chunked_noncausal_visits_every_kv_chunk_in_order():
    """Neither causal nor windowed: every q chunk runs its online softmax
    over every kv chunk, in ascending order, as the JAX package's dense
    variant scans them; a causal call prunes (its pruned variant)."""
    assert attention.kv_chunks(1536, 1536, 512, 768, 0, False, None) == \
        [[0, 1]] * 3
    assert attention.kv_chunks(2048, 4096, 512, 1024, 0, False, None) == \
        [[0, 1, 2, 3]] * 4
    assert attention.kv_chunks(1536, 1536, 512, 768, 0, True, None) == \
        [[0], [0, 1], [0, 1]]


def _xa_layer():
    cfg, p = port(SEAMLESS)
    return cfg, p.stack.layers[0]


@pytest.mark.parametrize("case", XA_CASES)
def test_xa_layer(ref, case):
    cfg, layer = _xa_layer()
    assert layer.kinds == ("xa", "dense")
    x, enc, xt = (T_(a) for a in xa_inputs())
    enc_kv = lm._EncOut(enc) if case.startswith("encout") else None
    if not case.endswith("cache"):
        y, nc, aux = transformer._apply_layer(cfg, layer.kinds, layer, x,
                                              torch.arange(6), None, None,
                                              enc_kv)
        assert nc is None and aux is None
        close(y, ref[f"xa_{case}"])
        return
    cache = transformer.init_caches(cfg, 2, S_MAX, torch.float32, "cpu")[0]
    assert set(cache) == {"kv"}
    y, cache, _ = transformer._apply_layer(cfg, layer.kinds, layer, x,
                                           torch.arange(6), cache,
                                           torch.tensor(0), enc_kv)
    cp = torch.tensor(6) if enc_kv is not None else torch.tensor([6, 6])
    yd, cache, _ = transformer._apply_layer(
        cfg, layer.kinds, layer, xt, cp[..., None] + torch.arange(1), cache,
        cp, enc_kv)
    assert set(cache) == {"kv"}
    close(y, ref[f"xa_{case}_prefill"])
    close(yd, ref[f"xa_{case}_decode"])
    close(cache["kv"][0], ref[f"xa_{case}_k"])
    close(cache["kv"][1], ref[f"xa_{case}_v"])


def test_caches_of_the_encdec_kinds():
    """'xa' layers get a kv ring of s_max slots, 'bi' layers none; the
    model's cache keeps 'enc_out'."""
    cfg = smoke(SEAMLESS)
    caches = transformer.init_caches(cfg, 2, S_MAX, torch.float32, "cpu")
    assert [tuple(c["kv"][0].shape) for c in caches] == \
        [(2, S_MAX, cfg.n_kv_heads, cfg.head_dim)] * cfg.n_layers
    enc = lm.encoder_view(cfg)
    assert enc.layers == (("bi", "dense"),) * cfg.n_encoder_layers
    assert transformer.init_caches(enc, 2, S_MAX, torch.float32, "cpu") == \
        [{}] * cfg.n_encoder_layers
    out = torch.zeros(2, 3, cfg.d_model)
    cache = lm.init_cache(cfg, 2, S_MAX, enc_out=out, device="cpu")
    assert cache["enc_out"] is out
    assert lm.init_cache(cfg, 2, S_MAX, device="cpu")["enc_out"] is None


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode(ref, dtype):
    cfg, p = port(SEAMLESS, dtype)
    enc, _ = seamless_inputs()
    out = lm.encode(cfg, p, T_(enc))
    assert out.dtype == getattr(torch, dtype)
    assert out.shape == (2, 10, cfg.d_model)
    close(out, ref[f"{dtype}_enc_out"], **MODEL_TOL[dtype])


def test_encode_chunked(ref):
    """1,536 frames: every encoder layer takes the chunked path."""
    cfg, p = port(SEAMLESS)
    out = lm.encode(cfg, p, T_(rand(50, 1, 1536, cfg.d_model)))
    close(out, ref["float32_enc_out_long"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_with_enc_embeds(ref, dtype):
    cfg, p = port(SEAMLESS, dtype)
    enc, toks = seamless_inputs()
    logits, aux = lm.forward(cfg, p, {"tokens": T_(toks),
                                      "enc_embeds": T_(enc)})
    assert logits.shape == (2, 8, cfg.vocab_size)
    assert float(aux) == 0.0
    close(logits, ref[f"{dtype}_seamless_fwd"], **MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_with_embeds(ref, dtype):
    cfg, p = port(LLAVA, dtype)
    logits, _ = lm.forward(cfg, p, {"embeds": T_(llava_embeds())})
    assert logits.shape == (2, 10, cfg.vocab_size)
    close(logits, ref[f"{dtype}_llava_fwd"], **MODEL_TOL[dtype])


def _lockstep(arch, dtype, batch, ref_tokens, ref_logits):
    """Teacher-forced through the port's prefill and decode steps: the
    logits against the reference's, and in fp32 the greedy tokens
    equal."""
    cfg, p = port(arch, dtype)
    got = tengine.lockstep_teacher_forced_logits(cfg, p, batch, ref_tokens,
                                                 S_MAX)
    assert got.shape == (NEW + 1, 2, cfg.vocab_size)
    assert torch.isfinite(got).all()
    close(got, ref_logits, **MODEL_TOL[dtype])
    if dtype == "float32":
        assert np.array_equal(got[:-1].argmax(-1).T.numpy(), ref_tokens)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_from_enc_embeds_and_greedy_decode(ref, dtype):
    enc, toks = seamless_inputs()
    _lockstep(SEAMLESS, dtype, {"tokens": T_(toks[:, :PROMPT]),
                                "enc_embeds": T_(enc)},
              ref[f"{dtype}_seamless_tokens"],
              ref[f"{dtype}_seamless_logits"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_from_cached_enc_out(ref, dtype):
    cfg, p = port(SEAMLESS, dtype)
    enc, toks = seamless_inputs()
    enc_out = lm.encode(cfg, p, T_(enc))
    cache = lm.init_cache(cfg, 2, S_MAX, enc_out=enc_out, device="cpu")
    logits, cache = lm.prefill(cfg, p, cache, {"tokens": T_(toks[:, :PROMPT])})
    assert cache["enc_out"] is enc_out and int(cache["pos"]) == PROMPT
    close(logits, ref[f"{dtype}_seamless_prefill_cached"],
          **MODEL_TOL[dtype])
    # and the same logits as the prefill that encodes
    cache2 = lm.init_cache(cfg, 2, S_MAX, device="cpu")
    logits2, cache2 = lm.prefill(cfg, p, cache2, {
        "tokens": T_(toks[:, :PROMPT]), "enc_embeds": T_(enc)})
    assert torch.equal(logits, logits2)
    assert torch.equal(cache2["enc_out"], enc_out)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embeds_prefill_and_greedy_decode(ref, dtype):
    _lockstep(LLAVA, dtype, {"embeds": T_(llava_embeds())},
              ref[f"{dtype}_llava_tokens"], ref[f"{dtype}_llava_logits"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", [SEAMLESS, LLAVA])
def test_decode_matches_forward(arch, dtype):
    """The JAX package's check (`tests/test_arch_smoke.py`) in the port: 8
    decode steps equal the forward's logits; bf16 at its tolerance (rtol
    2e-2, atol 0.25), fp32 at 2e-4.  seamless decodes against its encoded
    frames in the cache; llava prefills 4 `embeds` positions, then decodes
    8 tokens, against a forward of the same embeddings followed by the
    tokens' (its emb_scale is 1)."""
    cfg = smoke(arch, dtype)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = T_(tokens(arch, seed=7))
    with torch.no_grad():
        if arch == SEAMLESS:
            enc = T_(rand(5, 2, 24, cfg.d_model))
            full, _ = lm.forward(cfg, params, {"tokens": toks,
                                               "enc_embeds": enc})
            cache = lm.init_cache(cfg, 2, 8, enc_out=lm.encode(cfg, params,
                                                                 enc),
                                  device="cpu")
            lead = 0
        else:
            emb = T_(rand(6, 2, 4, cfg.d_model))
            cat = torch.cat([emb.to(params.embed.dtype),
                             lm.embed_tokens(cfg, params, toks)], dim=1)
            full, _ = lm.forward(cfg, params, {"embeds": cat})
            full = full[:, 4:]
            cache = lm.init_cache(cfg, 2, 12, device="cpu")
            _, cache = lm.prefill(cfg, params, cache, {"embeds": emb})
            lead = 4
        outs = []
        for i in range(8):
            lg, cache = lm.decode_step(cfg, params, cache, toks[:, i:i + 1])
            outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    # the logits of step i predict token i + 1: the forward's row i
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=0.25)
    close(dec, full.float(), **tol)
    assert int(cache["pos"]) == lead + 8


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", [SEAMLESS, LLAVA])
def test_params_round_trip_bit_for_bit(arch, dtype):
    import jax
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import lm as jlm
    cfg = smoke(arch, dtype)
    jp = jax.tree.map(np.asarray, jax.jit(
        lambda k: jlm.init_params(jax_smoke(arch).scaled(dtype=dtype), k))(
            jax.random.key(3)))
    tree = convert.lm_params_to_tree(
        convert.lm_params_from_jax(jp, cfg, "cpu"), cfg)
    assert jax.tree.structure(tree) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    if arch == SEAMLESS:
        assert set(tree) == {"embed", "final_norm", "stack", "enc_stack",
                             "enc_norm"}
        assert tree["enc_stack"]["rem"] == []
        assert tree["enc_stack"]["units"]["layer0"]["mixer"]["wq"].shape[
            0] == cfg.n_encoder_layers
        assert set(tree["stack"]["units"]["layer0"]) == {
            "norm1", "norm2", "norm3", "mixer", "cross", "mlp"}


@pytest.mark.parametrize("arch", [SEAMLESS, LLAVA])
def test_numpy_params_fit_the_jax_tree(arch):
    """`numpy_params` draws every leaf of the JAX package's tree, at its
    shape; the norm gains near 1 (the encoder's and `norm3` too)."""
    import jax
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import lm as jlm
    tree = convert.numpy_params(smoke(arch), 1)
    shapes = jax.eval_shape(lambda k: jlm.init_params(jax_smoke(arch), k),
                            jax.random.key(0))
    assert jax.tree.structure(tree) == jax.tree.structure(shapes)
    for a, s in zip(jax.tree.leaves(tree), jax.tree.leaves(shapes)):
        assert a.shape == s.shape and a.dtype == np.float32
    if arch == SEAMLESS:
        for g in (tree["enc_norm"],
                  tree["stack"]["units"]["layer0"]["norm3"]):
            assert 0.5 < g.mean() < 1.5 and g.std() > 0.05


@pytest.mark.parametrize("arch", [SEAMLESS, LLAVA])
def test_full_width_parameter_count(arch):
    import jax
    from repro.configs import get_config as jax_config
    from repro.models import lm as jlm
    shapes = jax.eval_shape(lambda k: jlm.init_params(jax_config(arch), k),
                            jax.random.key(0))
    n = sum(x.size for x in jax.tree.leaves(shapes))
    meta = lm.init_params(get_config(arch), device="meta")
    assert lm.param_count(meta) == n == FULL_PARAMS[arch]
    assert [layer.kinds for layer in meta.stack.layers] == list(
        get_config(arch).layers)
    if arch == SEAMLESS:
        assert len(meta.enc_stack.layers) == get_config(arch).n_encoder_layers


def test_init_params_draws_the_encdec_constants():
    """The port's own init: norm gains 1 (`norm3`, `enc_norm` fp32 too),
    the cross weights fan-in, the encoder drawn from the same generator."""
    gen = torch.Generator().manual_seed(0)
    cfg = smoke(SEAMLESS, "bfloat16")
    p = lm.init_params(cfg, gen, "cpu")
    layer = p.stack.layers[1]
    assert layer.norm3.dtype == p.enc_norm.dtype == torch.float32
    assert bool((layer.norm3 == 1).all()) and bool((p.enc_norm == 1).all())
    w = layer.cross.wq.float()
    assert layer.cross.wq.dtype == torch.bfloat16
    assert w.abs().max() <= 3.0 / cfg.d_model ** 0.5 + 1e-2
    assert not torch.equal(layer.cross.wq, layer.mixer.wq)
    assert not torch.equal(p.enc_stack.layers[0].mixer.wq, layer.mixer.wq)


if __name__ == "__main__":
    _main(sys.argv[1:])
