"""The backward of the RG-LRU scan: `kernels.ref.rg_lru_scan_bwd`, the
`ops.RGLRUScan` autograd function, and the CUDA kernel
`csrc/rg_lru.cu::rg_lru_scan_bwd_kernel` (card tests, skipped without one).

* The plain backward equals autograd through the plain forward loop bit
  for bit (the same operations in the same order), and `jax.grad` of the
  JAX package's associative-scan oracle (`repro.kernels.ref.rg_lru_scan`,
  run in an AVX subprocess: this file is its script) within 1e-5.
* `torch.autograd.gradcheck` of the function in float64.
* On the card, the kernel equals the plain backward on a CPU copy bit for
  bit at ragged T (chunks of 32 steps) and D (warps of 32 channels), T = 0
  and 1, and the training shape; a gradient through `ops.rg_lru_scan`
  launches the forward and the backward once each, and a call under
  `no_grad` only the forward.
"""
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_reference import SRC, run_avx  # noqa: E402

sys.path.insert(0, str(SRC))         # also when run as a script

from repro_torch.kernels import ops, ref  # noqa: E402

#: (B, T, D, with h0): the JAX comparison's cases
JAX_CASES = ((2, 37, 5, True), (2, 37, 5, False), (1, 130, 40, True),
             (3, 1, 7, True))
JAX_TOL = 1e-5


def scan_inputs(B, T, D, seed=0):
    """a in [0.5, 0.999), b ~ N(0, 0.1^2), h0 and gh ~ N(0, 1), fp32 numpy."""
    rng = np.random.default_rng([seed, B, T, D])
    f = lambda x: np.asarray(x, np.float32)
    return (f(rng.uniform(0.5, 0.999, (B, T, D))),
            f(rng.standard_normal((B, T, D)) * 0.1),
            f(rng.standard_normal((B, D))),
            f(rng.standard_normal((B, T, D))))


def _jax_main(path):
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    out = {}
    for i, (B, T, D, with_h0) in enumerate(JAX_CASES):
        a, b, h0, gh = map(jnp.asarray, scan_inputs(B, T, D))
        if not with_h0:
            h0 = jnp.zeros_like(h0)
        _, vjp = jax.vjp(jref.rg_lru_scan, a, b, h0)
        for k, g in zip(("da", "db", "dh0"), vjp(gh)):
            out[f"{i}_{k}"] = np.asarray(g)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_grads():
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "scan.npz")
        run_avx(__file__, [["--jax", path]])
        with np.load(path) as z:
            return {k: z[k] for k in z.files}


def bits(x):
    return x.detach().contiguous().view(torch.int32)


def _autograd(a, b, h0, gh, fn):
    """h and its gradients (zeros where T = 0 leaves an input unused)."""
    xs = [torch.from_numpy(x).requires_grad_() for x in (a, b, h0)]
    h = fn(*xs)
    if not h.requires_grad:             # the plain loop at T = 0
        return h, [torch.zeros_like(x) for x in xs]
    gs = torch.autograd.grad(h, xs, torch.from_numpy(gh), allow_unused=True,
                             materialize_grads=True)
    return h.detach(), gs


@pytest.mark.parametrize("shape", [(2, 37, 5), (1, 1, 3), (3, 64, 33),
                                   (2, 0, 4)])
def test_plain_backward_is_autograd_through_the_plain_loop(shape):
    a, b, h0, gh = scan_inputs(*shape)
    h, want = _autograd(a, b, h0, gh, ref.rg_lru_scan)
    got = ref.rg_lru_scan_bwd(torch.from_numpy(a), torch.from_numpy(h0), h,
                              torch.from_numpy(gh))
    for g, w in zip(got, want):
        assert torch.equal(bits(g), bits(w))


@pytest.mark.parametrize("case", range(len(JAX_CASES)))
def test_plain_backward_against_jax_grad_of_the_oracle(jax_grads, case):
    B, T, D, with_h0 = JAX_CASES[case]
    a, b, h0, gh = scan_inputs(B, T, D)
    if not with_h0:
        h0 = np.zeros_like(h0)
    _, got = _autograd(a, b, h0, gh, ops.rg_lru_scan)
    for k, g in zip(("da", "db", "dh0"), got):
        np.testing.assert_allclose(g.numpy(), jax_grads[f"{case}_{k}"],
                                   rtol=JAX_TOL, atol=JAX_TOL)


def test_function_gradcheck_float64():
    a, b, h0, _ = scan_inputs(2, 9, 3, seed=1)
    args = tuple(torch.from_numpy(x).double().requires_grad_()
                 for x in (a, b, h0))
    assert torch.autograd.gradcheck(ops.rg_lru_scan, args)
    assert torch.autograd.gradcheck(lambda x, y: ops.rg_lru_scan(x, y),
                                    args[:2])


def test_function_under_no_grad_keeps_the_plain_bits():
    a, b, h0, _ = scan_inputs(2, 37, 5)
    a, b, h0 = map(torch.from_numpy, (a, b, h0))
    with torch.no_grad():
        h = ops.rg_lru_scan(a, b, h0)
    assert h.grad_fn is None
    assert torch.equal(bits(h), bits(ref.rg_lru_scan(a, b, h0)))


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 512, 2560), (1, 512, 2560),
                                   (3, 100, 96), (2, 77, 100), (2, 0, 8),
                                   (1, 1, 33), (2, 31, 40), (1, 33, 40),
                                   (2, 129, 7)])
def test_backward_kernel_equals_plain_version(cuda, shape):
    from repro_torch.kernels import rg_lru as krg
    a, b, h0, gh = map(torch.from_numpy, scan_inputs(*shape))
    h = ref.rg_lru_scan(a, b, h0)
    with ref.flush_denormal():
        want = ref.rg_lru_scan_bwd(a, h0, h, gh)
    ops.reset_launch_counts()
    got = krg.rg_lru_scan_bwd(*(x.to(cuda) for x in (a, h0, h, gh)))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(bits(g.cpu()), bits(w))
    assert ops.launch_counts()["rg_lru_scan_bwd"] == (1 if shape[1] else 0)


@pytest.mark.cuda
def test_gradient_on_card_launches_both_kernels_once(cuda):
    a, b, h0, gh = scan_inputs(2, 77, 100)
    _, want = _autograd(a, b, h0, gh, ops.rg_lru_scan)
    xs = [torch.from_numpy(x).to(cuda).requires_grad_() for x in (a, b, h0)]
    ops.reset_launch_counts()
    h = ops.rg_lru_scan(*xs)
    got = torch.autograd.grad(h, xs, torch.from_numpy(gh).to(cuda))
    counts = ops.launch_counts()
    assert (counts["rg_lru_scan"], counts["rg_lru_scan_bwd"]) == (1, 1)
    for g, w in zip(got, want):
        assert torch.equal(bits(g.cpu()), bits(w))
    ops.reset_launch_counts()
    with torch.no_grad():
        ops.rg_lru_scan(*xs)
    counts = ops.launch_counts()
    assert (counts["rg_lru_scan"], counts["rg_lru_scan_bwd"]) == (1, 0)


if __name__ == "__main__":
    if sys.argv[1:2] != ["--jax"]:
        raise SystemExit(f"usage: {sys.argv[0]} --jax OUT.npz")
    _jax_main(sys.argv[2])
