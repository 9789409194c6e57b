"""Blockwise attention of the port against the JAX package, on the CPU.

`repro_torch.kernels.ops.attention` on CPU tensors (the plain version
`repro_torch.kernels.ref.attention`) against the JAX package's oracle
`repro.kernels.ref.attention` and its Pallas kernel in interpret mode
(`repro.kernels.ops.attention(..., interpret=True)`), within 2e-5 (fp32,
the tolerance of `tests/test_kernels.py`) and one bf16 ulp of the output
(bf16: all three compute in fp32 and round once at the output).  Inputs are
numpy-seeded fp32 arrays, cast to bf16 on each side for the bf16 cases
(both casts round to nearest even: the same bits).  The CUDA kernel
(`csrc/flash_attention.cu`) needs the card: `tests/test_torch_cuda.py` and
`chip_smoke.py` hold it against this plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
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
    assert kfa.launches == 0
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
