"""The RG-LRU scan of the port against the JAX package, on the CPU.

`repro_torch.kernels.ref.rg_lru_scan` (the plain version, a sequential
loop) against the JAX package's associative-scan oracle
`repro.kernels.ref.rg_lru_scan` and against its Pallas kernel in interpret
mode (`repro.kernels.ops.rg_lru_scan(..., interpret=True)`), at the
shapes and the 1e-5 tolerance of `tests/test_kernels.py`, plus T = 1 and
h0 = None.  The CUDA kernel (`csrc/rg_lru.cu`) needs the card:
`chip_smoke.py` holds it bit for bit against this plain version.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import rg_lru as krg

SHAPES = [(2, 64, 128), (3, 100, 96), (8, 256, 256), (1, 17, 130),
          (4, 1, 96)]
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(shape, seed):
    B, T, D = shape
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.8, 0.999, shape).astype(np.float32)
    b = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_scan_matches_jax(shape):
    a, b, h0 = _inputs(shape, sum(shape))
    got = ops.rg_lru_scan(*map(torch.from_numpy, (a, b, h0))).numpy()
    J = (jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    np.testing.assert_allclose(got, np.asarray(jref.rg_lru_scan(*J)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jops.rg_lru_scan(*J, interpret=True)), **TOL)


def test_plain_scan_without_h0_starts_from_zero():
    a, b, _ = _inputs((2, 33, 40), 5)
    got = ops.rg_lru_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = jops.rg_lru_scan(jnp.asarray(a), jnp.asarray(b), None)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_plain_scan_is_sequential_multiply_then_add():
    """Each step rounds the product, then the sum (no FMA): the semantics
    the CUDA kernel reproduces bit for bit."""
    a, b, h0 = _inputs((2, 50, 24), 9)
    got = ref.rg_lru_scan(*map(torch.from_numpy, (a, b, h0))).numpy()
    h = h0.copy()
    for t in range(a.shape[1]):
        h = (a[:, t] * h).astype(np.float32) + b[:, t]
        assert np.array_equal(got[:, t].view(np.int32), h.view(np.int32))
    assert ops.launch_counts()["rg_lru_scan"] == 0


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(2, 3, 4)
    h0 = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="not CUDA"):
        krg.rg_lru_scan(x, x, h0)
    m = torch.zeros(2, 3, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.rg_lru_scan(m, m)


def test_every_c_entry_point_is_defined_in_csrc():
    """The ctypes signatures name functions the sources export (the
    sources compile only on the machine with the card)."""
    text = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    defined = set(re.findall(r'extern "C" int (\w+)\(', text))
    assert set(_build.SIGNATURES) == defined
    assert Path(_build.CSRC / "rg_lru.cu").exists()
    assert len(_build.SIGNATURES["repro_rg_lru_scan"]) == 8
