"""The port's AER packing (`repro_torch.core.aer`) against the JAX
package's (`repro.core.aer`), exactly, on numpy-seeded masks.

Both sides are integer and boolean work only, so JAX runs in this
process: no floating-point operation whose bits an instruction set could
change.  Cases: empty, sparse, dense and full masks, capacities below the
selected count (entries dropped), gid tables with -1 pads, and received
buffers with INVALID pads matched against source tables with -1 pads.
The port's functions also work along the last axis of stacked [H, N]
masks; each row equals the one-row call.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aer as jaer
from repro_torch.core import aer

N = 257
DENSITIES = [0.0, 0.02, 0.3, 1.0]
CAPS = [N, 64, 5, 1]


def _mask(density, seed, n=N):
    return np.random.default_rng(seed).random(n) < density


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("density", DENSITIES)
def test_compact_indices_equals_jax(density, cap):
    mask = _mask(density, seed=int(density * 100) + cap)
    ids, dropped = aer.compact_indices(_t(mask), cap, fill=N)
    want_ids, want_dropped = jaer.compact_indices(jnp.asarray(mask), cap,
                                                  fill=N)
    assert ids.dtype == torch.int32 and dropped.dtype == torch.int32
    assert np.array_equal(ids.numpy(), np.asarray(want_ids))
    assert int(dropped) == int(want_dropped)
    if mask.sum() > cap:
        assert int(dropped) == mask.sum() - cap > 0     # over capacity


def _gid_table(seed, n=N, pads=40):
    """Ascending gids with -1 pads at the tail (capacity padding)."""
    rng = np.random.default_rng(seed)
    gid = np.sort(rng.choice(10 * n, n - pads, replace=False))
    return np.concatenate([gid, np.full(pads, -1)]).astype(np.int32)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("density", DENSITIES)
def test_pack_equals_jax(density, cap):
    spiked = _mask(density, seed=7 + cap)
    gid = _gid_table(seed=cap)
    ids, count = aer.pack(_t(spiked), _t(gid), cap)
    want_ids, want_count = jaer.pack(jnp.asarray(spiked), jnp.asarray(gid),
                                     cap)
    assert np.array_equal(ids.numpy(), np.asarray(want_ids))
    assert int(count) == int(want_count)
    # pads never pack, and the tail is INVALID
    assert int(count) == min(int((spiked & (gid >= 0)).sum()), cap)
    assert bool((ids[int(count):] == aer.INVALID).all())


@pytest.mark.parametrize("density", DENSITIES)
def test_match_sources_equals_jax(density):
    gid = _gid_table(seed=3)
    ids, _ = jaer.pack(jnp.asarray(_mask(density, seed=11)),
                       jnp.asarray(gid), N)
    rng = np.random.default_rng(5)
    # a source table: some gids that may have spiked, some that never do,
    # -1 pads at arbitrary positions
    src = np.sort(np.concatenate([rng.choice(gid[gid >= 0], 60),
                                  rng.choice(10 * N, 30)])).astype(np.int32)
    src[rng.choice(src.shape[0], 12, replace=False)] = -1
    got = aer.match_sources(_t(np.asarray(ids)), _t(src))
    want = jaer.match_sources(ids, jnp.asarray(src))
    assert np.array_equal(got.numpy(), np.asarray(want))
    if density == 1.0:
        assert bool(got.any())


def test_stacked_rows_equal_one_row_calls():
    """[H, N] masks pack row by row, as the JAX package's vmap does."""
    H = 4
    spiked = np.stack([_mask(d, seed=h) for h, d in
                       enumerate((0.0, 0.05, 0.5, 1.0))])
    gid = np.stack([_gid_table(seed=h) for h in range(H)])
    ids, count = aer.pack(_t(spiked), _t(gid), 64)
    for h in range(H):
        want_ids, want_count = jaer.pack(jnp.asarray(spiked[h]),
                                         jnp.asarray(gid[h]), 64)
        assert np.array_equal(ids[h].numpy(), np.asarray(want_ids))
        assert int(count[h]) == int(want_count)
    src = np.stack([np.sort(gid[h][::3]) for h in range(H)])
    got = aer.match_sources(ids, _t(src))
    for h in range(H):
        assert np.array_equal(got[h].numpy(), np.asarray(
            jaer.match_sources(jnp.asarray(ids[h].numpy()),
                               jnp.asarray(src[h]))))
