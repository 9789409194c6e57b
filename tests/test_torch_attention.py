"""Blockwise attention of the port against the JAX package, on the CPU.

`repro_torch.kernels.ops.attention` on CPU tensors (the plain version
`repro_torch.kernels.ref.attention`) against the JAX package's oracle
`repro.kernels.ref.attention` and its Pallas kernel in interpret mode
(`repro.kernels.ops.attention(..., interpret=True)`), within 2e-5 (fp32,
the tolerance of `tests/test_kernels.py`) and one bf16 ulp of the output
(bf16: all three compute in fp32 and round once at the output).  Inputs are
numpy-seeded fp32 arrays, cast to bf16 on each side for the bf16 cases
(both casts round to nearest even: the same bits).  The CUDA kernels
(`csrc/flash_attention_sm90.cu`, `csrc/flash_decode.cu`,
`csrc/flash_attention.cu`) need the card: `tests/test_torch_cuda.py` and
`chip_smoke.py` hold them against this plain version.  Here, the design of
the first two is held instead: the rule that picks a kernel by shape
(`kernels.flash_attention.variant`), and plain-torch models of their
arithmetic (tile order, the split P = p_hi + p_lo in bf16, the kv split and
its ordered merge) against the plain version, within one bf16 ulp and 2e-5
(fp32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as kfa

TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2.0 ** -7, 1e-4)}  # rtol, atol


def _case(bh, t, s, d, dtype="float32", *, pallas=True, qk_scale=1.0,
          **kw):
    return dict(shape=(bh, t, s, d), dtype=dtype, pallas=pallas,
                qk_scale=qk_scale, kw=dict(kw))


CASES = {
    # the causal shapes x dtypes of tests/test_kernels.py::TestFlashAttention
    **{f"causal-{t}x{s}x{d}-{dt}": _case(2, t, s, d, dt, causal=True)
       for t, s, d in [(128, 128, 64), (256, 256, 64), (128, 384, 128),
                       (256, 256, 80)]
       for dt in ("float32", "bfloat16")},
    **{f"window-{w}": _case(2, 256, 256, 64, causal=True, window=w)
       for w in (64, 128, 1024)},
    "softcap-50": _case(1, 128, 128, 64, qk_scale=4.0, causal=True,
                        softcap=50.0),
    "decode-offset": _case(1, 128, 512, 64, causal=True),
    "decode-T1-window": _case(2, 1, 256, 64, causal=True, window=64),
    "bidirectional-window": _case(2, 128, 256, 64, causal=False, window=100),
    "bidirectional-window-T>S": _case(1, 256, 128, 64, causal=False,
                                      window=64),
    "bidirectional-window-bf16": _case(2, 128, 128, 128, "bfloat16",
                                       causal=False, window=32),
    # ragged T and S: the Pallas wrapper asserts divisibility, so the
    # oracle only
    "ragged-bidirectional": _case(3, 100, 300, 80, pallas=False,
                                  causal=False, window=64),
    "ragged-causal-window": _case(2, 37, 101, 24, "bfloat16", pallas=False,
                                  causal=True, window=50),
    "ragged-softcap-scale": _case(1, 45, 45, 40, pallas=False, qk_scale=3.0,
                                  causal=True, softcap=20.0, scale=0.1),
}


def _inputs(bh, t, s, d, seed, qk_scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, t, d)).astype(np.float32) * qk_scale
    k = rng.standard_normal((bh, s, d)).astype(np.float32) * qk_scale
    v = rng.standard_normal((bh, s, d)).astype(np.float32)
    return q, k, v


def _jax(x, dtype):
    j = jnp.asarray(x)
    return j.astype(jnp.bfloat16) if dtype == "bfloat16" else j


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype][0], atol=TOL[dtype][1])


@pytest.mark.parametrize("name", list(CASES))
def test_plain_attention_matches_jax(name):
    c = CASES[name]
    dtype, kw = c["dtype"], c["kw"]
    arrays = _inputs(*c["shape"], seed=sum(c["shape"]),
                     qk_scale=c["qk_scale"])
    J = [_jax(x, dtype) for x in arrays]
    got = ops.attention(*(_torch(x, dtype) for x in arrays), **kw)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == arrays[0].shape
    _close(got, jref.attention(*J, **kw), dtype)
    if c["pallas"]:
        _close(got, jops.attention(*J, interpret=True, **kw), dtype)


def test_gqa_repeated_kv_head():
    """10 query heads over 1 KV head, repeated to 10 before the call on
    both sides, as RecurrentGemma's local attention does."""
    rng = np.random.default_rng(10)
    q = rng.standard_normal((10, 64, 32)).astype(np.float32)
    k = rng.standard_normal((1, 64, 32)).astype(np.float32)
    v = rng.standard_normal((1, 64, 32)).astype(np.float32)
    kw = dict(causal=True, window=16)
    kr, vr = np.repeat(k, 10, axis=0), np.repeat(v, 10, axis=0)
    for dtype in ("float32", "bfloat16"):
        tq = _torch(q, dtype)
        got = ops.attention(tq, _torch(k, dtype).repeat_interleave(10, 0),
                            _torch(v, dtype).repeat_interleave(10, 0), **kw)
        J = [_jax(x, dtype) for x in (q, kr, vr)]
        _close(got, jref.attention(*J, **kw), dtype)
        _close(got, jops.attention(*J, interpret=True, **kw), dtype)
        # one head alone gives the same rows
        one = ops.attention(tq[3:4], _torch(k, dtype), _torch(v, dtype),
                            **kw)
        assert torch.equal(one[0], got[3])


def test_causal_t_above_s_is_refused():
    """Causal with T > S: the first T - S query rows see no key.  The JAX
    package's kernel writes 0 there and its oracle the mean of v, so the
    port refuses the call rather than pick one."""
    q, k, v = _inputs(1, 256, 128, 64, seed=3)
    J = [jnp.asarray(x) for x in (q, k, v)]
    kern = np.asarray(jops.attention(*J, causal=True, interpret=True))
    oracle = np.asarray(jref.attention(*J, causal=True))
    assert np.abs(kern - oracle).max() > 0.1
    assert not kern[:, :128].any()
    np.testing.assert_allclose(oracle[:, :128],
                               np.broadcast_to(v.mean(axis=1, keepdims=True),
                                               (1, 128, 64)), atol=1e-5)
    np.testing.assert_allclose(kern[:, 128:], oracle[:, 128:], rtol=2e-5,
                               atol=2e-5)
    with pytest.raises(ValueError, match="T > S"):
        ops.attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    # bidirectional T > S is a valid call: every row sees a key
    ops.attention(*map(torch.from_numpy, (q, k, v)), causal=False)


@pytest.mark.parametrize("kw,match", [
    (dict(window=0), "window"), (dict(softcap=0.0), "softcap"),
    (dict(softcap=-1.0), "softcap")])
def test_arguments_that_see_nothing_are_refused(kw, match):
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match=match):
        ops.attention(x, x, x, **kw)


def test_mismatched_shapes_are_refused():
    q = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="expected"):
        ops.attention(q, torch.zeros(2, 4, 16), torch.zeros(2, 4, 16))
    with pytest.raises(ValueError, match="expected"):
        ops.attention(q, torch.zeros(2, 4, 8), torch.zeros(2, 5, 8))


def test_cpu_call_launches_no_kernel():
    ops.reset_launch_counts()
    q, k, v = map(torch.from_numpy, _inputs(2, 16, 32, 8, seed=1))
    ops.attention(q, k, v, causal=True, window=8)
    assert ops.launch_counts()["flash_attention"] == 0
    assert _build.launches["flash_attention"] == 0
    assert not any(kfa.variant_launches.values())
    assert "flash_attention" in ops.ATTN_KERNELS
    assert set(ops.KERNELS) == set(ops.launch_counts())


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(2, 3, 8)
    kw = dict(causal=True, window=None, softcap=None, scale=1.0)
    with pytest.raises(ValueError, match="dtype"):
        kfa.flash_attention(x.half(), x.half(), x.half(), **kw)
    big = torch.zeros(2, 3, 257)
    with pytest.raises(ValueError, match="head dim"):
        kfa.flash_attention(big, big, big, **kw)
    with pytest.raises(ValueError, match="not CUDA"):
        kfa.flash_attention(x, x, x, **kw)
    m = torch.zeros(2, 3, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.attention(m, m, m)


# -- the design of the CUDA kernels, held on the CPU ------------------------

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("args,kind", [
    # chip_smoke.py's attn_kernels shapes: (dtype, T, S, D, aligned)
    ((BF16, 2048, 2048, 256, True), "wgmma"),      # rg_local_prefill
    ((BF16, 4096, 4096, 256, True), "wgmma"),      # rg_local_long
    ((BF16, 1, 2048, 256, True), "splitkv"),       # rg_local_decode
    ((F32, 1024, 1024, 128, True), "simt"),        # fp32_causal
    ((BF16, 512, 512, 128, True), "wgmma"),        # softcap
    ((F32, 100, 300, 80, True), "simt"),           # bidir_ragged
    ((BF16, 1000, 1000, 256, True), "wgmma"),      # rg_local_ragged
    # the edges
    ((BF16, 63, 2048, 256, True), "splitkv"),
    ((BF16, 64, 2048, 256, True), "wgmma"),
    ((F32, 63, 512, 128, True), "splitkv"),
    ((F32, 64, 512, 128, True), "simt"),
    ((BF16, 128, 128, 80, True), "wgmma"),
    ((BF16, 1, 128, 80, True), "splitkv"),
    ((BF16, 128, 128, 20, True), "simt"),
    ((F32, 1, 128, 20, True), "simt"),
    ((BF16, 2048, 2048, 256, False), "simt"),
    ((BF16, 1, 2048, 256, False), "simt"),
    ((BF16, 64, 0, 64, True), "simt"),
], ids=lambda x: "-".join(map(str, x)) if isinstance(x, tuple) else x)
def test_variant_rule(args, kind):
    assert kfa.variant(*args) == kind


@pytest.mark.parametrize("args,match", [
    ((BF16, 128, 128, 264, True), "head dim"),
    ((BF16, 128, 128, 0, True), "head dim"),
    ((torch.float16, 128, 128, 64, True), "dtype"),
])
def test_variant_rule_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        kfa.variant(*args)


def _visible(t, s, causal, window):
    q_pos = torch.arange(t)[:, None] + (s - t)
    k_pos = torch.arange(s)[None, :]
    seen = torch.ones((t, s), dtype=torch.bool)
    if causal:
        seen &= k_pos <= q_pos
    if window is not None:
        seen &= k_pos > q_pos - window
    return seen


def _scores(q, k, causal, window, softcap, scale):
    s = torch.einsum("td,sd->ts", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s


def _online(x, v, state, split_p):
    """One step of the online softmax over scores x [R, n] (masked already
    at -1e30) and values v [n, D]; `split_p`: p @ v as p_hi @ v + p_lo @ v
    with p_hi = bf16(p), p_lo = bf16(p - p_hi)."""
    m, l, acc = state
    m_new = torch.maximum(m, x.max(dim=1).values)
    c = torch.exp(m - m_new)
    p = torch.exp(x - m_new[:, None])
    if split_p:
        hi = p.to(BF16).float()
        pv = hi @ v + (p - hi).to(BF16).float() @ v
    else:
        pv = p @ v
    return m_new, l * c + p.sum(dim=1), acc * c[:, None] + pv


def _merge(states):
    """States merged in the given (ascending key) order, each weighed by
    exp(m_state - m)."""
    m = torch.stack([st[0] for st in states]).max(dim=0).values
    l, acc = 0.0, 0.0
    for m_i, l_i, a_i in states:
        w = torch.exp(m_i - m)
        l, acc = l + w * l_i, acc + w[:, None] * a_i
    return m, l, acc


def _fresh(rows, d):
    return (torch.full((rows,), -1.0e30), torch.zeros(rows),
            torch.zeros(rows, d))


def _prefill_model(q, k, v, *, causal, window, softcap, scale):
    """csrc/flash_attention_sm90.cu's arithmetic in plain torch: 64-row q
    tiles; the kv tiles of 64 keys some row of the tile sees, from an
    aligned start, cut in two contiguous halves; each half walked in
    ascending order with an online softmax (-1e30 sentinel, p split in
    bf16 hi and lo), tiles no row sees skipped; the halves merged in key
    order.  Returns o and the rows whose first computed tile of a half was
    fully masked for them."""
    BH, T, D = q.shape
    S = k.shape[1]
    seen = _visible(T, S, causal, window)
    out = torch.empty(BH, T, D)
    cleared = 0
    vf = v.float()
    for b in range(BH):
        for r0 in range(0, T, 64):
            rows = slice(r0, min(r0 + 64, T))
            vis = seen[rows]
            cols = vis.any(dim=0).nonzero()
            k_first = int(cols.min()) // 64 * 64
            n = (int(cols.max()) - k_first) // 64 + 1
            half = (n + 1) // 2
            x_all = _scores(q[b, rows], k[b], causal, window, softcap, scale)
            x_all = x_all.masked_fill(~vis, -1.0e30)
            states = []
            for tiles in (range(0, half), range(half, n)):
                st, first = _fresh(vis.shape[0], D), True
                for i in tiles:
                    ks = slice(k_first + 64 * i, min(k_first + 64 * i + 64, S))
                    if not vis[:, ks].any():
                        continue
                    if first:
                        cleared += int((~vis[:, ks].any(dim=1)).sum())
                        first = False
                    st = _online(x_all[:, ks], vf[b, ks], st, split_p=True)
                states.append(st)
            _, l, acc = _merge(states)
            out[b, rows] = acc / torch.where(l == 0, 1.0, l)[:, None]
    return out.to(q.dtype), cleared


def _splitkv_model(q, k, v, *, causal, window, softcap, scale, split):
    """csrc/flash_decode.cu's arithmetic in plain torch: for each (bh, row)
    and split of `split` keys, the keys of the split the row sees, in four
    contiguous shares walked 8 keys at a time with an online softmax and
    merged in share order; a split that sees no key gives (-1e30, 0, 0);
    the splits merged in ascending order.  Returns o and the number of
    (row, split) pairs that saw no key."""
    BH, T, D = q.shape
    S = k.shape[1]
    seen = _visible(T, S, causal, window)
    out = torch.empty(BH, T, D)
    empty = 0
    for b in range(BH):
        x_all = _scores(q[b], k[b], causal, window, softcap, scale)
        for t in range(T):
            splits = []
            for s0 in range(0, S, split):
                keys = (seen[t, s0:s0 + split].nonzero()[:, 0] + s0).tolist()
                if not keys:
                    empty += 1
                    splits.append(_fresh(1, D))
                    continue
                lo, hi = keys[0], keys[-1]
                assert keys == list(range(lo, hi + 1))  # contiguous
                per = (hi - lo + 4) // 4
                shares = []
                for w in range(4):
                    st = _fresh(1, D)
                    w_hi = min(hi, lo + (w + 1) * per - 1)
                    for j0 in range(lo + w * per, w_hi + 1, 8):
                        ks = slice(j0, min(j0 + 8, w_hi + 1))
                        st = _online(x_all[t:t + 1, ks], v[b, ks].float(), st,
                                     split_p=False)
                    shares.append(st)
                splits.append(_merge(shares))
            _, l, acc = _merge(splits)
            out[b, t] = acc[0] / (l[0] if l[0] != 0 else 1.0)
    return out.to(q.dtype), empty


PREFILL_CASES = {
    **{n: c for n, c in CASES.items() if c["dtype"] == "bfloat16"},
    # rows 64..127 see keys from 65 on: the block's first tile (keys 0-63)
    # is fully masked for row 127, and the two halves are one tile each
    "causal-window-64-bf16": _case(2, 256, 256, 64, "bfloat16", causal=True,
                                   window=64),
    # rows 448..511 with a window of 100: tiles from key 320, cut 2 + 1;
    # row 511's first computed tile (keys 320-383) is fully masked for it
    "causal-window-100-bf16": _case(1, 512, 512, 128, "bfloat16",
                                    causal=True, window=100),
    "softcap-window-bf16": _case(2, 200, 200, 80, "bfloat16", qk_scale=4.0,
                                 causal=True, window=90, softcap=50.0),
}


@pytest.mark.parametrize("name", list(PREFILL_CASES))
def test_prefill_kernel_model_within_one_ulp(name):
    c = PREFILL_CASES[name]
    arrays = _inputs(*c["shape"], seed=sum(c["shape"]),
                     qk_scale=c["qk_scale"])
    q, k, v = (_torch(x, "bfloat16") for x in arrays)
    kw = dict(dict(causal=True, window=None, softcap=None, scale=None),
              **c["kw"])
    scale = q.shape[2] ** -0.5 if kw["scale"] is None else kw["scale"]
    got, cleared = _prefill_model(q, k, v, causal=kw["causal"],
                                  window=kw["window"], softcap=kw["softcap"],
                                  scale=scale)
    want = ops.attention(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=TOL["bfloat16"][0],
                               atol=TOL["bfloat16"][1])
    if "window" in name and "causal-window-" in name:
        assert cleared > 0   # the -1e30 clearing was exercised


SPLITKV_CASES = {
    # split 0 of keys 0-127 sees no key of the row (window 64 of 256)
    "decode-T1-window": (2, 1, 256, 64, dict(causal=True, window=64)),
    # every split of 128 keys but the last sees no key
    "decode-window-last-split": (2, 1, 2048, 128,
                                 dict(causal=True, window=100)),
    "decode-T16-bidirectional": (2, 16, 300, 64,
                                 dict(causal=False, window=64)),
    "decode-T5-softcap": (1, 5, 260, 40, dict(causal=True, softcap=20.0)),
}


@pytest.mark.parametrize("name", list(SPLITKV_CASES))
def test_splitkv_model_within_fp32_tolerance(name):
    bh, t, s, d, kw = SPLITKV_CASES[name]
    q, k, v = map(torch.from_numpy, _inputs(bh, t, s, d, seed=t + s + d))
    kw = dict(dict(window=None, softcap=None), **kw)
    got, empty = _splitkv_model(q, k, v, scale=d ** -0.5,
                                split=kfa.DECODE_SPLIT, **kw)
    want = ops.attention(q, k, v, **kw)
    torch.testing.assert_close(got, want, rtol=TOL["float32"][0],
                               atol=TOL["float32"][1])
    if "window" in name and kw["causal"]:
        assert empty > 0   # a split that sees no key weighed 0
