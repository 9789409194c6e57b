"""Wall-clock measurement of the port's device work.

All timings follow the same discipline:

  1. untimed warm-up calls (pay the kernel build, first-touch
     allocations and transfers),
  2. a synchronise of every CUDA device the outputs lie on, inside every
     timed region (PyTorch returns before the card finishes),
  3. median of k repetitions with the (max - min) / median spread, so a
     single preempted rep cannot masquerade as a regression.

The paper's normalised metric — wall seconds per synapse per simulated
second per Hz of activity (Table 1's size-independence check) — lives here
too so every suite computes it the same way.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Timing:
    """Median-of-k wall-clock sample (seconds)."""

    reps_s: tuple

    @property
    def median_s(self) -> float:
        xs = sorted(self.reps_s)
        n = len(xs)
        mid = n // 2
        return xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])

    @property
    def min_s(self) -> float:
        return min(self.reps_s)

    @property
    def max_s(self) -> float:
        return max(self.reps_s)

    @property
    def spread(self) -> float:
        """(max - min) / median: a jitter indicator, not a metric to gate
        on."""
        m = self.median_s
        return (self.max_s - self.min_s) / m if m > 0 else 0.0


def _devices(tree, out: set) -> set:
    if isinstance(tree, torch.Tensor):
        out.add(tree.device)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _devices(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _devices(x, out)
    return out


def synchronize(tree):
    """Wait for every CUDA device a tensor of `tree` (tensors in nested
    tuples, lists and dicts) lies on; returns `tree`.  CPU work is done
    when the call returns."""
    for dev in _devices(tree, set()):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return tree


def time_fn(fn: Callable, *args, reps: int = 3, warmup: int = 1) -> Timing:
    """Time `fn(*args)`: warm-up runs, then `reps` timed calls, each ended
    by a synchronise of the devices of its outputs."""
    for _ in range(max(warmup, 0)):
        synchronize(fn(*args))
    samples = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        synchronize(fn(*args))
        samples.append(time.perf_counter() - t0)
    return Timing(reps_s=tuple(samples))


class Timer:
    """`with Timer() as t: ...` then `t.s` — single-shot wall clock."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.s = time.perf_counter() - self.t0


def steps_per_sec(wall_s: float, n_steps: int) -> float:
    return n_steps / wall_s if wall_s > 0 else 0.0


def norm_seconds(wall_s: float, n_synapses: int, n_steps: int,
                 rate_hz: float, dt_ms: float = 1.0) -> float:
    """The paper's Table 1 metric: wall seconds per synapse per simulated
    second, divided by the mean firing rate (size-independent when the
    engine scales linearly in synaptic events)."""
    sim_seconds = n_steps * dt_ms / 1000.0
    return wall_s / (n_synapses * sim_seconds * max(rate_hz, 1e-9))


def summarize(samples: Sequence[float]) -> dict:
    """Round-tripable dict view of a list of per-rep seconds."""
    t = Timing(reps_s=tuple(samples))
    return dict(median_s=round(t.median_s, 6), min_s=round(t.min_s, 6),
                max_s=round(t.max_s, 6), spread=round(t.spread, 4),
                reps=len(samples))
