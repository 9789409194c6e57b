"""Production of observables (paper §Methods).

The DPSNN-STDP code "can produce files tracing several observables (list of
individual spiking times and spiking neuron identity, mean spiking rates,
membrane potentials, synaptic values)".  Here: raster <-> (t, gid) event
lists, per-window rates, and text/CSV dumps used by the examples and the
streaming tenants of `repro.simserve` (chunk-at-a-time event extraction +
append-mode CSV flushes).
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def raster_events(raster: np.ndarray, gid: np.ndarray, t0: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """raster [T, H, N] bool + gid [H, N] -> sorted (times, gids) events.

    `t0` offsets the time axis: a chunk of a longer run streamed from step
    t0 produces the same absolute event times the full-run extraction
    would."""
    t, h, n = np.nonzero(np.asarray(raster))
    g = np.asarray(gid)[h, n]
    order = np.lexsort((g, t))
    return t[order] + t0, g[order]


def events_signature(times: np.ndarray, gids: np.ndarray) -> bytes:
    """Digest of an already-extracted (times, gids) event list.

    `raster_signature` delegates here, so a signature accumulated from
    streamed chunks (concatenate each chunk's `raster_events` output in
    chunk order — time is non-decreasing across chunks, so the
    concatenation IS the canonical order) is bit-equal to the full-run
    signature by construction."""
    import hashlib
    return hashlib.sha256(
        np.stack([np.asarray(times).astype(np.int64),
                  np.asarray(gids).astype(np.int64)]).tobytes()).digest()


def raster_signature(raster: np.ndarray, gid: np.ndarray) -> bytes:
    """Order-canonical digest of the full spike list; equal signatures mean
    the paper's 'identical spiking neurons and timings' check passes."""
    return events_signature(*raster_events(raster, gid))


def mean_rate_hz(raster: np.ndarray, n_neurons: int, dt_ms: float = 1.0
                 ) -> float:
    """Mean firing rate over the run, in Hz."""
    r = np.asarray(raster)
    t_seconds = r.shape[0] * dt_ms / 1000.0
    return float(r.sum() / (n_neurons * t_seconds))


def rate_per_window(raster: np.ndarray, n_neurons: int, window: int = 100,
                    dt_ms: float = 1.0) -> np.ndarray:
    r = np.asarray(raster).reshape(raster.shape[0], -1).sum(axis=1)
    T = (r.shape[0] // window) * window
    per = r[:T].reshape(-1, window).sum(axis=1)
    return per / (n_neurons * window * dt_ms / 1000.0)


def dump_events_csv(path: str, raster: np.ndarray, gid: np.ndarray,
                    append: bool = False, t0: int = 0) -> None:
    """Write (or, with append=True, extend) a spike-event CSV.

    Streaming tenants flush one raster chunk per round: pass the chunk's
    absolute start step as `t0` and append=True; the resulting file is
    byte-identical to a single full-run dump."""
    t, g = raster_events(raster, gid, t0=t0)
    mode = "a" if append else "w"
    header = not append or not os.path.exists(path) \
        or os.path.getsize(path) == 0
    with open(path, mode) as f:
        if header:
            f.write("time_ms,neuron_gid\n")
        for ti, gi in zip(t.tolist(), g.tolist()):
            f.write(f"{ti},{gi}\n")
