"""The port's LM modules against the JAX package, one by one, on the CPU.

Weights are the JAX package's own (`repro.models.lm.init_params(SMOKE,
key(0))` of `recurrentgemma-2b`, fp32 variant), carried across with
`repro_torch.models.convert.lm_params_from_jax`; inputs are numpy-seeded.
Tolerance: rtol = atol = 2e-4 in fp32 (different summation orders in the
matrix products, and `exp`/`sin`/`cos` of two libraries a few ulps apart).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as jattn
from repro.models import common as jcom
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro.models import recurrent as jrec
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import attention, common, convert, lm, mlp, recurrent
from repro_torch.models import transformer

ARCH = "recurrentgemma-2b"
TOL = dict(rtol=2e-4, atol=2e-4)
RG, LA = 0, 2              # SMOKE layers: rg, rg, la, rg, rg


@pytest.fixture(scope="module")
def models():
    jc = jax_smoke(ARCH).scaled(dtype="float32")
    cfg = get_smoke_config(ARCH).scaled(dtype="float32")
    jp = jlm.init_params(jc, jax.random.key(0))
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jc, jp, cfg, tp


def jax_layer(cfg, jp, k):
    where = convert._layer_key(cfg, k)
    if where[0] == "units":
        return jax.tree.map(lambda a: a[where[2]],
                            jp["stack"]["units"][where[1]])
    return jp["stack"]["rem"][where[1]]


def rand(seed, *shape, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return x.astype(np.float32)


def close(got, want, **tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **(tol or TOL))


@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm(plus_one):
    x, g = rand(0, 2, 5, 128, scale=3.0), rand(1, 128)
    close(common.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-6,
                          plus_one),
          jcom.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-6, plus_one))


@pytest.mark.parametrize("per_slot", [False, True])
def test_rope(per_slot):
    x = rand(2, 2, 7, 3, 64)
    if per_slot:
        pos = np.array([[0, 1, 2, 3, 4, 5, 6], [40, 41, 42, 43, 44, 45, 46]])
    else:
        pos = np.arange(7) + 1530
    close(common.rope(torch.from_numpy(x), torch.from_numpy(pos)),
          jcom.rope(jnp.asarray(x), jnp.asarray(pos)))


@pytest.mark.parametrize("kind,gated", [("swiglu", True), ("gelu", False),
                                        ("gelu", True), ("relu2", False)])
def test_activate(kind, gated):
    x, g = rand(3, 4, 256, scale=3.0), rand(4, 4, 256, scale=3.0)
    tg = torch.from_numpy(g) if gated else None
    jg = jnp.asarray(g) if gated else None
    close(common.activate(torch.from_numpy(x), tg, kind),
          jcom.activate(jnp.asarray(x), jg, kind))


def test_mlp(models):
    jc, jp, cfg, tp = models
    x = rand(5, 2, 6, cfg.d_model)
    close(mlp.mlp(tp.stack.layers[RG].mlp, torch.from_numpy(x), cfg.act),
          jmlp.mlp(jax_layer(cfg, jp, RG)["mlp"], jnp.asarray(x), jc.act))


@pytest.mark.parametrize("T,with_state", [(9, False), (9, True), (1, True),
                                          (2, True)])
def test_causal_conv1d(models, T, with_state):
    jc, jp, cfg, tp = models
    p = tp.stack.layers[RG].mixer
    jpm = jax_layer(cfg, jp, RG)["mixer"]
    x = rand(6, 2, T, cfg.rg_lru_width)
    st = rand(7, 2, cfg.conv1d_width - 1, cfg.rg_lru_width) \
        if with_state else None
    y, s = recurrent._causal_conv1d(
        torch.from_numpy(x), p.conv_w, p.conv_b,
        None if st is None else torch.from_numpy(st))
    jy, js = jrec._causal_conv1d(jnp.asarray(x), jpm["conv_w"],
                                 jpm["conv_b"],
                                 None if st is None else jnp.asarray(st))
    close(y, jy)
    close(s, js)


@pytest.mark.parametrize("layer", [RG, 4])
def test_rglru_prefill_then_decode(models, layer):
    jc, jp, cfg, tp = models
    p, jpm = tp.stack.layers[layer].mixer, jax_layer(cfg, jp, layer)["mixer"]
    x = rand(8, 2, 12, cfg.d_model)
    y, st = recurrent.rglru(cfg, p, torch.from_numpy(x))
    jy, jst = jrec.rglru(jc, jpm, jnp.asarray(x))
    close(y, jy)
    for k in ("h", "conv"):
        close(st[k], jst[k])
    for t in range(3):           # decode with the carried state
        xt = rand(9 + t, 2, 1, cfg.d_model)
        y, st = recurrent.rglru(cfg, p, torch.from_numpy(xt), st)
        jy, jst = jrec.rglru(jc, jpm, jnp.asarray(xt), jst)
        close(y, jy)
        for k in ("h", "conv"):
            close(st[k], jst[k])


def _attn(models, layer):
    jc, jp, cfg, tp = models
    return (jc, jax_layer(cfg, jp, layer)["mixer"], cfg,
            tp.stack.layers[layer].mixer)


@pytest.mark.parametrize("T,window", [(24, 32), (40, 32), (24, None)])
def test_attention_direct(models, T, window):
    jc, jpm, cfg, p = _attn(models, LA)
    x, pos = rand(10, 2, T, cfg.d_model), np.arange(T)
    y, _ = attention.attention(cfg, p, torch.from_numpy(x),
                               torch.from_numpy(pos), window=window)
    jy, _ = jattn.attention(jc, jpm, jnp.asarray(x), jnp.asarray(pos),
                            window=window)
    close(y, jy)


@pytest.mark.parametrize("window", [32, None])
def test_attention_chunked(models, window):
    """T = S = 1536: T * S exceeds 1024 * 2048, the chunked path."""
    jc, jpm, cfg, p = _attn(models, LA)
    T = 1536
    x, pos = rand(11, 1, T, cfg.d_model), np.arange(T)
    y, _ = attention.attention(cfg, p, torch.from_numpy(x),
                               torch.from_numpy(pos), window=window)
    jy, _ = jax.jit(lambda x, pos: jattn.attention(
        jc, jpm, x, pos, window=window))(jnp.asarray(x), jnp.asarray(pos))
    close(y, jy)


def _cache(seed, B, S_r, cfg):
    shape = (B, S_r, cfg.n_kv_heads, cfg.head_dim)
    return rand(seed, *shape), rand(seed + 1, *shape)


@pytest.mark.parametrize("T", [20, 40])
def test_attention_prefill_writes_the_ring(models, T):
    """A prefill with a cache (scalar position 0); T = 40 > S_r = 32
    writes only the last 32 tokens, at slot p mod 32."""
    jc, jpm, cfg, p = _attn(models, LA)
    kc, vc = _cache(12, 2, cfg.window, cfg)
    x, pos = rand(14, 2, T, cfg.d_model), np.arange(T)
    y, (k2, v2) = attention.attention(
        cfg, p, torch.from_numpy(x), torch.from_numpy(pos),
        window=cfg.window, cache=(torch.tensor(kc), torch.tensor(vc)),
        cache_pos=torch.tensor(0))
    jy, (jk, jv) = jattn.attention(
        jc, jpm, jnp.asarray(x), jnp.asarray(pos), window=jc.window,
        cache=(jnp.asarray(kc), jnp.asarray(vc)), cache_pos=jnp.int32(0))
    close(y, jy)
    close(k2, jk)
    close(v2, jv)


def test_attention_decode_per_slot_with_ring_wrap(models):
    """Per-slot positions [5, 40] in a 32-slot ring: slot 1 has wrapped,
    and its oldest entries must be masked out by the window."""
    jc, jpm, cfg, p = _attn(models, LA)
    kc, vc = _cache(15, 2, cfg.window, cfg)
    cache_pos = np.array([5, 40])
    for step in range(3):
        x = rand(20 + step, 2, 1, cfg.d_model)
        pos = cache_pos[:, None]
        y, (kc_t, vc_t) = attention.attention(
            cfg, p, torch.from_numpy(x), torch.from_numpy(pos),
            window=cfg.window, cache=(torch.tensor(kc), torch.tensor(vc)),
            cache_pos=torch.from_numpy(cache_pos))
        jy, (jk, jv) = jattn.attention(
            jc, jpm, jnp.asarray(x), jnp.asarray(pos), window=jc.window,
            cache=(jnp.asarray(kc), jnp.asarray(vc)),
            cache_pos=jnp.asarray(cache_pos, jnp.int32))
        close(y, jy)
        close(kc_t, jk)
        close(vc_t, jv)
        kc, vc, cache_pos = np.asarray(jk), np.asarray(jv), cache_pos + 1


def test_forward_logits(models):
    jc, jp, cfg, tp = models
    toks = np.random.default_rng(16).integers(0, cfg.vocab_size, (2, 24))
    logits, aux = lm.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    jl, _ = jax.jit(lambda p, t: jlm.forward(jc, p, {"tokens": t}))(
        jp, jnp.asarray(toks, jnp.int32))
    assert logits.shape == (2, 24, cfg.vocab_size)
    close(logits, jl)
    assert float(aux) == 0.0


def test_prefill_and_decode_step(models):
    """lm.prefill (last logits only) and lm.decode_step with a per-slot
    cache, against the JAX package's."""
    jc, jp, cfg, tp = models
    toks = np.random.default_rng(17).integers(0, cfg.vocab_size, (2, 10))
    cache = lm.init_cache(cfg, 2, 48, device="cpu")
    logits, cache = lm.prefill(cfg, tp, cache,
                               {"tokens": torch.from_numpy(toks)})
    jcache = jlm.init_cache(jc, 2, 48)
    jlog, jcache = jlm.prefill(jc, jp, jcache,
                               {"tokens": jnp.asarray(toks, jnp.int32)})
    close(logits, jlog)
    assert int(cache["pos"]) == int(jcache["pos"]) == 10
    nxt = np.array([[3], [7]])
    logits, cache = lm.decode_step(cfg, tp, cache, torch.from_numpy(nxt))
    jlog, jcache = jlm.decode_step(jc, jp, jcache,
                                   jnp.asarray(nxt, jnp.int32))
    close(logits, jlog)


def test_full_width_parameter_count():
    cfg = get_config(ARCH)
    meta = lm.init_params(cfg, device="meta")
    shapes = jax.eval_shape(lambda k: jlm.init_params(jax_config(ARCH), k),
                            jax.random.key(0))
    n = sum(x.size for x in jax.tree.leaves(shapes))
    assert lm.param_count(meta) == n == 2_894_574_080
    assert len(meta.stack.layers) == 26
    kinds = [layer.kinds[0] for layer in meta.stack.layers]
    assert kinds.count("rg") == 18 and kinds.count("la") == 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_bit_for_bit(dtype):
    jc = jax_smoke(ARCH).scaled(dtype=dtype)
    cfg = get_smoke_config(ARCH).scaled(dtype=dtype)
    jp = jax.tree.map(np.asarray, jlm.init_params(jc, jax.random.key(3)))
    tree = convert.lm_params_to_tree(
        convert.lm_params_from_jax(jp, cfg, "cpu"), cfg)
    assert jax.tree.structure(tree) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    if dtype == "bfloat16":
        assert any(x.dtype.name == "bfloat16" for x in jax.tree.leaves(tree))


def test_numpy_params_have_the_jax_layout():
    cfg = get_smoke_config(ARCH)
    tree = convert.numpy_params(cfg, 0)
    shapes = jax.eval_shape(lambda k: jlm.init_params(jax_smoke(ARCH), k),
                            jax.random.key(0))
    assert jax.tree.structure(tree) == jax.tree.structure(shapes)
    for a, s in zip(jax.tree.leaves(tree), jax.tree.leaves(shapes)):
        assert a.shape == s.shape and a.dtype == np.float32


def test_init_params_draws_the_jax_distributions():
    cfg = get_smoke_config(ARCH)
    gen = torch.Generator().manual_seed(0)
    p = lm.init_params(cfg, gen, "cpu")
    assert p.embed.dtype == torch.bfloat16
    assert p.final_norm.dtype == torch.float32
    assert abs(p.embed.float().std().item() * cfg.d_model ** 0.5 - 1) < 0.05
    w = p.stack.layers[0].mixer.w_x.float()
    assert w.abs().max() <= 3.0 / cfg.d_model ** 0.5 + 1e-3
    assert torch.equal(p.stack.layers[2].norm1, torch.ones(cfg.d_model))
    jl = jrec.init_rglru(jax.random.key(0), "x", jax_smoke(ARCH),
                         jnp.float32)["log_lambda"]
    close(p.stack.layers[0].mixer.log_lambda, jl, rtol=1e-5, atol=1e-5)
    again = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again.stack.layers[4].mlp.w_in,
                       p.stack.layers[4].mlp.w_in)


def test_every_arch_and_kind_is_ported():
    """The port takes all of the JAX package's architectures, enc-dec
    (the 'xa' and 'bi' mixers, `seamless-m4t-medium`) and the `embeds`
    frontend (`llava-next-34b`) included, and builds every layer kind."""
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro_torch.configs import ARCH_IDS
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        for mine, theirs in [(get_config, jax_config),
                             (get_smoke_config, jax_smoke)]:
            assert dataclasses.asdict(mine(arch)) == dataclasses.asdict(
                theirs(arch))
    cfg = get_smoke_config(ARCH)
    xa = transformer.Layer(cfg, ("xa", "dense"), torch.float32, "meta")
    assert isinstance(xa.cross, attention.Attention)
    assert xa.norm3.dtype == torch.float32
    bi = transformer.Layer(cfg, ("bi", "dense"), torch.float32, "meta")
    assert isinstance(bi.mixer, attention.Attention)
    assert not hasattr(bi, "cross") and not hasattr(bi, "norm3")
    encdec = lm.LM(get_smoke_config("seamless-m4t-medium"), "meta")
    assert [layer.kinds for layer in encdec.enc_stack.layers] == [
        ("bi", "dense")] * 2
    with pytest.raises(ValueError, match="unknown layer kind"):
        transformer.Layer(cfg, ("xx", "dense"), torch.float32, "meta")
