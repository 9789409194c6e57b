"""Reproducible distributed "thalamic" external stimulus.

Paper: "generate patterns of external thalamic stimulus to the network,
e.g. prescribing the number of events per ms per neural column", identically
for any distribution of the network over processes.

Each event k of column c at step t targets neuron
    n = randint(fold_in(fold_in(key, t), c)) mod neurons_per_column
and injects `stim_amplitude` mV into that neuron's summed current.

The JAX package draws these with `jax.random` (threefry2x32 in counter
mode).  This port rewrites the same draws in numpy uint32 arithmetic on the
host, following jax 0.9.0 with `jax_threefry_partitionable=True`
(`jax/_src/prng.py` and `jax/_src/random.py::_randint`), so the events are
equal to the reference's integer for integer.  The engine computes the
whole [T, H, C*K] table of target gids of a run once and uploads it in one
copy; on the card the phase-A kernel adds each step's amplitudes to its
neurons itself (`stim_current`, from `kernels.ref`, is the plain version
of that sum).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.ref import stim_current  # noqa: F401  (re-exported)
from .params import GridConfig

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al., 2011), as
    `jax._src.prng._threefry2x32_lowering`.  All arguments broadcast
    uint32 arrays; returns the two output words."""
    k0, k1, x0, x1 = (np.asarray(a, dtype=_U32) for a in (k0, k1, x0, x1))
    with np.errstate(over="ignore"):
        ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
        x = [x0 + ks[0], x1 + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """`jax.random.key(seed)` data: [..., 2] uint32 (high word, low word)."""
    s = int(seed)
    return np.array([(s >> 32) & 0xFFFFFFFF, s & 0xFFFFFFFF], dtype=_U32)


def fold_in(k: np.ndarray, data) -> np.ndarray:
    """`jax.random.fold_in`: threefry of the count (0, uint32(data)) under
    key k.  k [..., 2] uint32, data broadcasts against k[..., 0]."""
    d = np.asarray(data).astype(np.int64) & 0xFFFFFFFF
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], np.zeros_like(d), d)
    return np.stack([y0, y1], axis=-1)


def _split2(k: np.ndarray):
    """`jax.random.split(k, 2)` under the partitionable threefry: key i is
    the threefry of the count (0, i)."""
    a = threefry2x32(k[..., 0], k[..., 1], 0, 0)
    b = threefry2x32(k[..., 0], k[..., 1], 0, 1)
    return np.stack(a, axis=-1), np.stack(b, axis=-1)


def _bits32(k: np.ndarray, n: int) -> np.ndarray:
    """`random_bits(k, 32, (n,))`: word0 ^ word1 of threefry at (0, i)."""
    i = np.arange(n, dtype=_U32)
    y0, y1 = threefry2x32(k[..., 0, None], k[..., 1, None], 0, i)
    return y0 ^ y1


def randint(k: np.ndarray, n: int, minval: int, maxval: int) -> np.ndarray:
    """`jax.random.randint(k, (n,), minval, maxval, int32)`: two words of
    bits per value reduced modulo the span.  Returns [..., n] int32."""
    k1, k2 = _split2(k)
    hi, lo = _bits32(k1, n), _bits32(k2, n)
    span = _U32(max(maxval - minval, 1))
    with np.errstate(over="ignore"):
        mult = _U32(2 ** 16) % span
        mult = (mult * mult) % span
        off = ((hi % span) * mult + lo % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def stim_key(cfg: GridConfig) -> np.ndarray:
    return key(cfg.seed ^ 0x57D11)


def column_events(cfg: GridConfig, k: np.ndarray, columns, t) -> np.ndarray:
    """Target gids of the events of `columns` at steps `t`.

    columns [C] int (pad -1), t scalar or [T].  Returns [C, K] int32 for a
    scalar t, else [T, C, K] (rows of -1 columns are garbage, as in the
    reference: the caller masks by ownership)."""
    with np.errstate(over="ignore"):
        cols = np.asarray(columns).astype(np.int64)
        ts = np.atleast_1d(np.asarray(t)).astype(np.int64)
        kt = fold_in(k[None, :], ts)                          # [T, 2]
        kc = fold_in(kt[:, None, :], cols[None, :])           # [T, C, 2]
        n = randint(kc, cfg.stim_events_per_ms_per_column, 0,
                    cfg.neurons_per_column)                   # [T, C, K]
        gids = (cols[None, :, None] * cfg.neurons_per_column + n
                ).astype(np.int32)
    return gids[0] if np.ndim(t) == 0 else gids


def stim_table(cfg: GridConfig, columns: np.ndarray, t0: int,
               n_steps: int) -> np.ndarray:
    """[T, H, C*K] int32 target gids of steps t0 .. t0+T-1 for the stacked
    per-shard column tables `columns` [H, C]."""
    H, C = columns.shape
    ts = np.arange(t0, t0 + n_steps, dtype=np.int64)
    ev = column_events(cfg, stim_key(cfg), columns.reshape(-1), ts)
    return ev.reshape(n_steps, H, -1)


def stim_inputs(cfg: GridConfig, columns: torch.Tensor, gid_to_local,
                gids: torch.Tensor, n_local: int):
    """Scatter operands of a run's stimulus, on the table's device.

    gids [T, H, C*K] from `stim_table`; columns [H, C] (pad -1);
    `gid_to_local(gids) -> (local_idx, owned)` is the shards' ownership map
    (broadcasting over [.., H, ..]).  Returns (index [T, H, C*K] int64,
    amp [T, H, C*K] fp32): events outside the shard, of a -1 column pad, or
    with a local index out of range get index 0 and amplitude +0.0 (the
    reference's `mode="drop"` forgives those; a torch index does not)."""
    K = cfg.stim_events_per_ms_per_column
    owned_col = torch.repeat_interleave(columns >= 0, K, dim=1)   # [H, C*K]
    local, owned = gid_to_local(gids)
    keep = owned & owned_col[None] & (local >= 0) & (local < n_local)
    index = torch.where(keep, local, 0).to(torch.int64)
    amp = torch.where(keep, torch.tensor(np.float32(cfg.stim_amplitude),
                                         device=gids.device),
                      torch.tensor(np.float32(0.0), device=gids.device))
    return index, amp
