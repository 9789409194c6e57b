"""The port's decoder-only families against the JAX package, on the CPU:
RWKV-6 (time and channel mix), MoE (dispatch, drops, combine, the shared
expert, the auxiliary loss), qk-norm attention, untied embeddings, and
each new architecture whole at SMOKE size.

Weights come from `convert.numpy_params` (numpy seeds, fp32), inputs from
numpy seeds.  The JAX side runs in subprocesses pinned to
`XLA_FLAGS=--xla_cpu_max_isa=AVX` (`test_torch_reference.run_avx`): this
file is their script (`--cases GROUP OUT.npz`).  Tolerance: rtol = atol =
2e-4 in fp32, as in `test_torch_lm_model.py`; dispatch (which
assignments keep a slot, and the tokens in each slot) and the bf16
combine are compared bit for bit.  Structure-only checks (parameter
counts by `jax.eval_shape`, the `convert` round trip, top-k ties) run
JAX in-process.
"""
import dataclasses
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_reference import SRC, run_avx  # noqa: E402

sys.path.insert(0, str(SRC))         # also when run as a script

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import (attention, convert, lm, moe,  # noqa: E402
                                recurrent)
from repro_torch.models import transformer  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
WEIGHTS_SEED = 0
NEW_ARCHS = ("rwkv6-1.6b", "granite-moe-3b-a800m", "qwen3-0.6b",
             "minicpm-2b", "internlm2-20b", "gemma3-27b",
             "llama4-maverick-400b-a17b")
#: Full-width parameter counts (the JAX package's `init_params` under
#: `jax.eval_shape`).
FULL_PARAMS = {
    "rwkv6-1.6b": 1_583_941_632,
    "granite-moe-3b-a800m": 3_298_793_472,
    "qwen3-0.6b": 596_049_920,
    "minicpm-2b": 2_724_880_896,
    "internlm2-20b": 19_861_149_696,
    "gemma3-27b": 27_008_335_616,
    "llama4-maverick-400b-a17b": 397_691_950_080,
}
RWKV, GRANITE, LLAMA4 = NEW_ARCHS[0], NEW_ARCHS[1], NEW_ARCHS[6]
#: MoE cases: (arch, layer, T, capacity factor or None for the config's,
#: pads at the front of row 0).  Factor 0.25 drops: C = 8 slots for an
#: average of 10 (granite) or 5 (llama4) assignments an expert.
MOE_CASES = {
    "granite_nodrop": (GRANITE, 0, 12, None, 0),
    "granite_drop": (GRANITE, 0, 40, 0.25, 0),
    "granite_leftpad_drop": (GRANITE, 0, 40, 0.25, 12),
    "llama4_shared": (LLAMA4, 1, 12, None, 0),
    "llama4_shared_drop": (LLAMA4, 1, 40, 0.25, 12),
}
RWKV_CASES = [(T, st) for T in (1, 7) for st in (False, True)]
QK_ARCHS = ("qwen3-0.6b", "gemma3-27b")
UNEMBED_ARCHS = ("internlm2-20b", "rwkv6-1.6b", "minicpm-2b")
GROUPS = {"modules": None, "archs_a": NEW_ARCHS[:4],
          "archs_b": NEW_ARCHS[4:]}


def rand(seed, *shape, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return x.astype(np.float32)


def smoke(arch, dtype="float32"):
    return get_smoke_config(arch).scaled(dtype=dtype)


def tokens(arch, seed=11, T=12):
    return np.random.default_rng(seed).integers(
        0, smoke(arch).vocab_size, (2, T))


def moe_input(case):
    arch, _, T, _, pads = MOE_CASES[case]
    x = rand(100 + list(MOE_CASES).index(case), 2, T, smoke(arch).d_model)
    x[0, :pads] = rand(5, smoke(arch).d_model)      # a left pad's rows
    return x


def moe_cfg(case):
    arch, _, _, cf, _ = MOE_CASES[case]
    m = smoke(arch).moe
    return m if cf is None else dataclasses.replace(m, capacity_factor=cf)


def rwkv_inputs(T, with_state):
    c = smoke(RWKV)
    H, dh = c.d_model // c.rwkv_head_dim, c.rwkv_head_dim
    x = rand(20 + T, 2, T, c.d_model)
    st = None
    if with_state:
        st = dict(S=rand(30, 2, H, dh, dh, scale=0.5),
                  xa=rand(31, 2, c.d_model), xf=rand(32, 2, c.d_model))
    return x, st


def combine_inputs():
    """Routing, expert outputs and gates for the bf16 combine: granite
    SMOKE widths, T = 40, capacity 8 (drops)."""
    rng = np.random.default_rng(40)
    B, T, E, K, C, d = 2, 40, 8, 2, 8, smoke(GRANITE).d_model
    idx = np.stack([np.stack([rng.choice(E, K, replace=False)
                              for _ in range(T)]) for _ in range(B)])
    return (idx, rand(41, B, E, C, d), rand(42, B, T, K, scale=0.5), C)


# ---------------------------------------------------------------------------
# the JAX side (inside an AVX subprocess)
# ---------------------------------------------------------------------------


def _jax_params(arch, dtype="float32"):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import lm as jlm
    jc = jax_smoke(arch).scaled(dtype=dtype)
    tree = convert.numpy_params(smoke(arch, dtype), WEIGHTS_SEED)
    shapes = jax.eval_shape(lambda k: jlm.init_params(jc, k),
                            jax.random.key(0))
    return jc, jax.tree.map(lambda x, s: jnp.asarray(x).astype(s.dtype),
                            tree, shapes)


def _jax_layer(arch, jp, k):
    import jax
    where = convert._layer_key(smoke(arch), k)
    if where[0] == "units":
        return jax.tree.map(lambda a: a[where[2]],
                            jp["stack"]["units"][where[1]])
    return jp["stack"]["rem"][where[1]]


def jax_modules() -> dict:
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jattn
    from repro.models import lm as jlm
    from repro.models import moe as jmoe
    from repro.models import recurrent as jrec
    out = {}

    jc, jp = _jax_params(RWKV)
    for T, with_state in RWKV_CASES:
        x, st = rwkv_inputs(T, with_state)
        lp = _jax_layer(RWKV, jp, 0)
        jst = None if st is None else {k: jnp.asarray(v)
                                       for k, v in st.items()}
        y, s = jrec.rwkv_time_mix(jc, lp["mixer"], jnp.asarray(x), jst)
        key = f"tmix_{T}_{with_state}"
        out.update({f"{key}_y": y, f"{key}_S": s["S"], f"{key}_xa": s["xa"]})
        y, xf = jrec.rwkv_channel_mix(jc, lp["mlp"], jnp.asarray(x), jst)
        out.update({f"cmix_{T}_{with_state}_y": y,
                    f"cmix_{T}_{with_state}_xf": xf})

    for case, (arch, layer, T, _, _) in MOE_CASES.items():
        jc, jp = _jax_params(arch)
        p = _jax_layer(arch, jp, layer)["mlp"]
        m = moe_cfg(case)
        x = jnp.asarray(moe_input(case))
        y, aux = jmoe.moe(p, x, m, jc.act)
        # the routing and dispatch, as `moe` computes them
        B, E, K = x.shape[0], m.n_experts, m.top_k
        probs = jax.nn.softmax(x.reshape(B * T, -1) @ p["router"], axis=-1)
        _, idx = jax.lax.top_k(probs, K)
        C = min(-(-(int(m.capacity_factor * T * K / E) or 1) // 8) * 8,
                T * K)
        x_e, (order, _, _, keep, token_of) = jax.vmap(
            lambda xr, ir: jmoe._row_dispatch(xr, ir, E, C, K))(
                x, idx.reshape(B, T, K))
        out.update({f"{case}_y": y, f"{case}_aux": aux,
                    f"{case}_idx": idx.reshape(B, T, K), f"{case}_x_e": x_e,
                    f"{case}_order": order, f"{case}_keep": keep,
                    f"{case}_C": np.int64(C)})

    idx, y_e, gates, C = combine_inputs()
    B, T, K = idx.shape
    E = y_e.shape[1]
    bf = jnp.bfloat16
    dummy = jnp.zeros((B, T, 1), bf)
    _, disp = jax.vmap(lambda xr, ir: jmoe._row_dispatch(xr, ir, E, C, K))(
        dummy, jnp.asarray(idx, jnp.int32))
    y = jax.vmap(lambda ye, gr, dp: jmoe._row_combine(ye, gr, dp, T, C, bf))(
        jnp.asarray(y_e, bf), jnp.asarray(gates, bf), disp)
    out["combine_bf16"] = np.asarray(y).view(np.uint16)

    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4]], np.float32)
    out["topk_ties"] = jax.lax.top_k(jnp.asarray(probs), 3)[1]

    for arch in QK_ARCHS:
        jc, jp = _jax_params(arch)
        p = _jax_layer(arch, jp, 0)["mixer"]
        x, pos = rand(50, 2, 10, jc.d_model), np.arange(10)
        window = jc.window if jc.pattern[0][0] == "la" else None
        y, _ = jattn.attention(jc, p, jnp.asarray(x), jnp.asarray(pos),
                               window=window)
        shape = (2, 16, jc.n_kv_heads, jc.head_dim)
        cache = (jnp.zeros(shape), jnp.zeros(shape))
        _, cache = jattn.attention(jc, p, jnp.asarray(x), jnp.asarray(pos),
                                   window=window, cache=cache,
                                   cache_pos=jnp.int32(0))
        xt, cp = rand(51, 2, 1, jc.d_model), np.array([10, 10])
        yd, _ = jattn.attention(jc, p, jnp.asarray(xt),
                                jnp.asarray(cp[:, None]), window=window,
                                cache=cache, cache_pos=jnp.asarray(cp))
        out.update({f"qk_{arch}_y": y, f"qk_{arch}_decode": yd})

    for arch in UNEMBED_ARCHS:
        jc, jp = _jax_params(arch)
        out[f"unembed_{arch}"] = jlm.unembed(
            jc, jp, jnp.asarray(rand(60, 2, 5, jc.d_model)))
    return out


def jax_archs(archs) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.models import lm as jlm
    out = {}
    for arch in archs:
        jc, jp = _jax_params(arch)
        logits, aux = jax.jit(lambda p, t: jlm.forward(jc, p, {"tokens": t}))(
            jp, jnp.asarray(tokens(arch), jnp.int32))
        out.update({f"fwd_{arch}": logits, f"aux_{arch}": aux})
    return out


def _main(argv):
    if argv[:1] != ["--cases"]:
        raise SystemExit(f"usage: {sys.argv[0]} --cases GROUP OUT.npz")
    group, path = argv[1], argv[2]
    outs = jax_modules() if GROUPS[group] is None else jax_archs(
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
        run_avx(__file__, [["--cases", g, p] for g, p in zip(GROUPS, paths)])
        out = {}
        for p in paths:
            with np.load(p) as z:
                out.update({k: z[k] for k in z.files})
    return out


# ---------------------------------------------------------------------------
# the port against it
# ---------------------------------------------------------------------------


_PORT = {}


def port(arch, dtype="float32"):
    if (arch, dtype) not in _PORT:
        cfg = smoke(arch, dtype)
        _PORT[arch, dtype] = (cfg, convert.lm_params_from_jax(
            convert.numpy_params(cfg, WEIGHTS_SEED), cfg, "cpu"))
    return _PORT[arch, dtype]


def close(got, want, **tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **(tol or TOL))


T_ = torch.from_numpy


@pytest.mark.parametrize("T,with_state", RWKV_CASES)
def test_rwkv_time_mix(ref, T, with_state):
    cfg, p = port(RWKV)
    x, st = rwkv_inputs(T, with_state)
    tst = None if st is None else {k: T_(v) for k, v in st.items()}
    y, s = recurrent.rwkv_time_mix(cfg, p.stack.layers[0].mixer, T_(x), tst)
    key = f"tmix_{T}_{with_state}"
    close(y, ref[f"{key}_y"])
    close(s["S"], ref[f"{key}_S"])
    close(s["xa"], ref[f"{key}_xa"])
    assert s["S"].dtype == torch.float32


@pytest.mark.parametrize("T,with_state", RWKV_CASES)
def test_rwkv_channel_mix(ref, T, with_state):
    cfg, p = port(RWKV)
    x, st = rwkv_inputs(T, with_state)
    tst = None if st is None else {k: T_(v) for k, v in st.items()}
    y, xf = recurrent.rwkv_channel_mix(cfg, p.stack.layers[0].mlp, T_(x),
                                       tst)
    close(y, ref[f"cmix_{T}_{with_state}_y"])
    close(xf, ref[f"cmix_{T}_{with_state}_xf"])


def test_rwkv_state_dtypes():
    """S stays fp32; the token-shift carries are in the model dtype."""
    cfg, p = port(RWKV, "bfloat16")
    x = T_(rand(70, 2, 3, cfg.d_model)).to(torch.bfloat16)
    cache = transformer.init_caches(cfg, 2, 8, torch.bfloat16, "cpu")[0]
    _, nc, aux = transformer._apply_layer(cfg, cfg.layers[0],
                                          p.stack.layers[0], x,
                                          torch.arange(3), cache,
                                          torch.tensor(0))
    assert aux is None
    assert set(nc["rwkv"]) == {"S", "xa", "xf"}
    assert nc["rwkv"]["S"].dtype == torch.float32
    assert nc["rwkv"]["xa"].dtype == nc["rwkv"]["xf"].dtype == torch.bfloat16


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe(ref, case):
    arch, layer, T, _, _ = MOE_CASES[case]
    cfg, p = port(arch)
    m = moe_cfg(case)
    y, aux = moe.moe(p.stack.layers[layer].mlp, T_(moe_input(case)), m,
                     cfg.act)
    close(y, ref[f"{case}_y"])
    close(aux, ref[f"{case}_aux"])


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_dispatch_keeps_the_same_assignments(ref, case):
    """The same experts, the same kept assignments, the same tokens in
    each slot: with drops and a left pad, the pads' rows take their
    expert's first slots, as in JAX."""
    arch, layer, T, cf, pads = MOE_CASES[case]
    m = moe_cfg(case)
    C = moe.capacity(m, T)
    assert C == int(ref[f"{case}_C"])
    x = T_(moe_input(case))
    router = port(arch)[1].stack.layers[layer].mlp.router
    probs = torch.softmax(x.reshape(-1, x.shape[-1]) @ router, dim=-1)
    idx = moe.top_k(probs, m.top_k)[1].view(2, T, m.top_k)
    assert np.array_equal(idx.numpy(), ref[f"{case}_idx"])
    x_e, table, order, _, _, keep = moe.dispatch(x, idx, m.n_experts, C)
    assert np.array_equal(keep.numpy(), ref[f"{case}_keep"])
    assert np.array_equal(order.numpy(), ref[f"{case}_order"])
    assert np.array_equal(x_e.numpy(), ref[f"{case}_x_e"])
    if cf is not None:
        assert not keep.all()                 # the case drops
    if pads:
        # every slot a pad's expert has goes to the pads first
        first = table.reshape(2, m.n_experts, C)[0, :, 0]
        pad_experts = idx[0, 0].tolist()
        assert all(int(first[e]) == 0 for e in pad_experts)


def test_moe_combine_bf16_bit_for_bit(ref):
    """Each token's contributions added in bf16, in ascending expert
    order, from +0.0: the same bits as `.at[token].add`."""
    idx, y_e, gates, C = combine_inputs()
    B, T, K = idx.shape
    bf = torch.bfloat16
    idx_t = T_(idx).long()
    _, _, order, sorted_e, rank, keep = moe.dispatch(
        torch.zeros(B, T, 1), idx_t, y_e.shape[1], C)
    y = moe.combine(T_(y_e).to(bf), T_(gates).to(bf), idx_t, order,
                    sorted_e, rank, keep, C)
    assert not keep.all()
    assert np.array_equal(y.view(torch.uint16).numpy().view(np.uint16),
                          ref["combine_bf16"])


def test_moe_top_k_breaks_ties_to_the_lower_index(ref):
    probs = torch.tensor([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.4, 0.1, 0.4]])
    idx = moe.top_k(probs, 3)[1]
    assert np.array_equal(idx.numpy(), ref["topk_ties"])
    assert idx.tolist() == [[1, 2, 0], [0, 1, 2], [1, 3, 0]]


def test_moe_rows_are_independent():
    """Dispatch runs per batch row: a row's output does not depend on the
    other rows (so a refill never moves a live slot)."""
    cfg, p = port(GRANITE)
    m = moe_cfg("granite_drop")
    x = T_(moe_input("granite_drop"))
    y, _ = moe.moe(p.stack.layers[0].mlp, x, m, cfg.act)
    y0, _ = moe.moe(p.stack.layers[0].mlp, x[:1], m, cfg.act)
    assert torch.equal(y[:1], y0)


@pytest.mark.parametrize("arch", QK_ARCHS)
def test_attention_with_qk_norm(ref, arch):
    cfg, p = port(arch)
    a = p.stack.layers[0].mixer
    assert a.q_gamma.shape == (cfg.head_dim,)
    window = cfg.window if cfg.pattern[0][0] == "la" else None
    x, pos = rand(50, 2, 10, cfg.d_model), torch.arange(10)
    y, _ = attention.attention(cfg, a, T_(x), pos, window=window)
    close(y, ref[f"qk_{arch}_y"])
    shape = (2, 16, cfg.n_kv_heads, cfg.head_dim)
    cache = (torch.zeros(shape), torch.zeros(shape))
    _, cache = attention.attention(cfg, a, T_(x), pos, window=window,
                                   cache=cache, cache_pos=torch.tensor(0))
    cp = torch.tensor([10, 10])
    yd, _ = attention.attention(cfg, a, T_(rand(51, 2, 1, cfg.d_model)),
                                cp[:, None], window=window, cache=cache,
                                cache_pos=cp)
    close(yd, ref[f"qk_{arch}_decode"])


@pytest.mark.parametrize("arch", UNEMBED_ARCHS)
def test_unembed(ref, arch):
    cfg, p = port(arch)
    assert hasattr(p, "unembed") == (not cfg.tie_embeddings)
    close(lm.unembed(cfg, p, T_(rand(60, 2, 5, cfg.d_model))),
          ref[f"unembed_{arch}"])


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_logits(ref, arch):
    cfg, p = port(arch)
    logits, aux = lm.forward(cfg, p, {"tokens": T_(tokens(arch))})
    assert logits.shape == (2, 12, cfg.vocab_size)
    close(logits, ref[f"fwd_{arch}"])


@pytest.mark.parametrize("arch", [GRANITE, LLAMA4, RWKV])
def test_aux_loss_sums_the_moe_layers(ref, arch):
    cfg, p = port(arch)
    _, aux = lm.forward(cfg, p, {"tokens": T_(tokens(arch))})
    assert aux.dtype == torch.float32 and aux.dim() == 0
    close(aux, ref[f"aux_{arch}"])
    assert (float(aux) > 0) == (arch != RWKV)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_matches_forward(arch, dtype):
    """The JAX package's check (`tests/test_arch_smoke.py`) in the port:
    8 decode steps from an empty cache equal the forward's logits; bf16
    at its tolerance (rtol 2e-2, atol 0.25), fp32 at 2e-4."""
    cfg = smoke(arch, dtype)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = T_(tokens(arch, seed=7, T=8))
    with torch.no_grad():
        full, _ = lm.forward(cfg, params, {"tokens": toks})
        cache = lm.init_cache(cfg, 2, 8, device="cpu")
        outs = []
        for i in range(8):
            lg, cache = lm.decode_step(cfg, params, cache, toks[:, i:i + 1])
            outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=0.25)
    close(dec, full.float(), **tol)
    assert int(cache["pos"]) == 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
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


@pytest.mark.parametrize("arch", NEW_ARCHS)
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


def test_init_params_draws_the_jax_constants():
    """The port's own init: RWKV's lerp weights 0.5, decay_w0 -6, bonus_u
    0, ln_gamma 1, lora width max(32, d // 32); qk-norm gains 1 in the
    model dtype; the router in fp32."""
    gen = torch.Generator().manual_seed(0)
    p = lm.init_params(smoke(RWKV, "bfloat16"), gen, "cpu")
    mix = p.stack.layers[0].mixer
    assert torch.equal(mix.mu_w, torch.full_like(mix.mu_w, 0.5))
    assert torch.equal(mix.decay_w0, torch.full_like(mix.decay_w0, -6.0))
    assert not mix.bonus_u.any() and bool((mix.ln_gamma == 1).all())
    assert mix.decay_a.shape == (128, 32) and mix.w_r.dtype == torch.bfloat16
    assert torch.equal(p.stack.layers[1].mlp.mu_k,
                       torch.full((128,), 0.5))
    assert p.unembed.shape == (128, 512)
    q = lm.init_params(smoke("qwen3-0.6b", "bfloat16"), gen, "cpu")
    g = q.stack.layers[0].mixer.q_gamma
    assert g.dtype == torch.bfloat16 and bool((g == 1).all())
    r = lm.init_params(smoke(GRANITE, "bfloat16"), gen, "cpu")
    assert r.stack.layers[0].mlp.router.dtype == torch.float32
    assert r.stack.layers[0].mlp.w_in.shape == (8, 128, 64)


if __name__ == "__main__":
    _main(sys.argv[1:])
