"""Pluggable lateral-connectivity profiles (DESIGN.md §Connectivity
profiles).

The paper fixes synaptic projection to the first/second/third Chebyshev
neighbour rings of a source column (76/12/8/4%).  The follow-up study on
the same simulator (Pastorelli et al., arXiv:1803.08833) replaces that
kernel with Gaussian / exponential distance decay and shows the
compute/communication balance shifts with connectivity reach.  This
module makes the kernel a first-class, pluggable object so the repo can
measure that trade-off instead of hard-coding one point of it.

A `ConnectivityProfile` is *one* thing: a vector of unnormalized target
masses per Chebyshev ring of the column grid,

    ring_masses()[r]  ~  P(forward synapse targets a column at ring r),

plus its derived `reach()` (the largest ring with nonzero mass).  Every
profile draws from the SAME four counter-based `splitmix64` streams as
the paper kernel (`connectivity.forward_synapses`): lane 0 picks the
ring from the cumulative mass fractions, lane 1 the member column within
the ring, lanes 2/3 the target neuron and delay.  Because the draws are
a pure function of (seed, source gid, slot), connectivity — and hence
the simulated raster — is independent of shard count, placement and
process count for EVERY profile, exactly as for the paper default
(`tests/test_profiles.py`, `tests/test_determinism_scaling.py`).

Out-degree stays fixed at M synapses per neuron for all profiles (the
engine's static shapes and the canonical synapse order depend on it);
"connection probability" is therefore the per-synapse target-column
distribution, the fixed-fan-out formulation of the decaying kernels.

`reach()` is the single number the distribution layer needs: the halo of
a shard is the union of `reach`-ring neighbourhoods of its columns
(`topology.shard_halo_columns`), from which `distributed.halo_offsets`
derives the static shard-to-shard exchange schedule.  A wider kernel
widens the halo and the exchange cost; the `connectivity_sweep` bench
suite measures exactly that.

Profile specs (CLI `--profile`, `GridConfig.connectivity`):

    ring3                        paper default (bit-identical legacy kernel)
    ring1 / ring2 / ring5 ...    variable-radius ring kernel
    ring:max_ring=5              same, explicit form
    gaussian:sigma=1.5           ring mass ~ ring_size * exp(-r^2 / 2 sigma^2)
    gaussian:sigma=1.5,cutoff=3  truncated at reach = ceil(cutoff * sigma)
    exponential:lambda=1.0       ring mass ~ ring_size * exp(-r / lambda)
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np

#: The paper's self / 1st / 2nd / 3rd-ring target fractions (main text).
PAPER_RING_FRACTIONS: Tuple[float, ...] = (0.76, 0.12, 0.08, 0.04)

#: Spec string of the default profile (the paper's exact kernel).
DEFAULT_SPEC = "ring3"


def ring_size(r: int) -> int:
    """Number of columns at Chebyshev distance exactly `r` (8r, or 1 at 0)."""
    return 1 if r == 0 else 8 * r


@dataclasses.dataclass(frozen=True)
class ConnectivityProfile:
    """Base class: a lateral kernel as per-ring target masses.

    Subclasses implement `ring_masses` and `spec`; everything else
    (`reach`, normalized cumulative fractions, offset tables) derives
    from those.  Instances are frozen dataclasses — hashable, comparable,
    and safe to embed in `SimSpec`-adjacent static config.
    """

    def ring_masses(self) -> Tuple[float, ...]:
        """Unnormalized target mass per ring, index 0..reach."""
        raise NotImplementedError

    def reach(self) -> int:
        """Largest Chebyshev ring this profile can target — the halo depth
        the distribution layer must provision (DESIGN.md §Connectivity
        profiles)."""
        return len(self.ring_masses()) - 1

    def spec(self) -> str:
        """Canonical spec string; `parse(p.spec())` round-trips."""
        raise NotImplementedError

    def cum_fractions(self) -> np.ndarray:
        """Normalized cumulative ring fractions, float64 [reach + 1].

        This is the exact quantity the legacy kernel computed from
        `GridConfig.ring_fractions` (cumsum then divide by the last
        entry), so the paper profile reproduces the historical draws
        bit-for-bit."""
        fr = np.cumsum(np.asarray(self.ring_masses(), dtype=np.float64))
        return fr / fr[-1]


@dataclasses.dataclass(frozen=True)
class RingProfile(ConnectivityProfile):
    """Uniform-within-ring kernel with explicit per-ring fractions.

    `RingProfile()` is the paper's exact 3-ring kernel; `with_radius(R)`
    derives a variable-radius variant from the paper fractions
    (truncate + implicit renormalization for R < 3, extend by halving the
    last fraction for R > 3 — and R == 3 returns the paper fractions
    unchanged, keeping `ring:max_ring=3` bit-identical to `ring3`).
    """

    fractions: Tuple[float, ...] = PAPER_RING_FRACTIONS

    def ring_masses(self) -> Tuple[float, ...]:
        return self.fractions

    def spec(self) -> str:
        if self.fractions == PAPER_RING_FRACTIONS:
            return "ring3"
        return f"ring:max_ring={len(self.fractions) - 1}"

    @classmethod
    def with_radius(cls, max_ring: int,
                    base: Tuple[float, ...] = PAPER_RING_FRACTIONS
                    ) -> "RingProfile":
        if max_ring < 0:
            raise ValueError(f"max_ring must be >= 0, got {max_ring}")
        fr = list(base[:max_ring + 1])
        while len(fr) < max_ring + 1:
            fr.append(fr[-1] / 2.0)
        return cls(fractions=tuple(fr))


@dataclasses.dataclass(frozen=True)
class GaussianProfile(ConnectivityProfile):
    """Gaussian distance decay (arXiv:1803.08833): per-column target
    probability ~ exp(-r² / 2σ²), truncated at reach = ceil(cutoff·σ).

    Ring mass multiplies the per-column decay by the ring population
    (8r columns at ring r), so the kernel decays per *column*, not per
    ring — most synapses land in the near rings but the mode moves
    outward with σ, as in the reference study.
    """

    sigma: float = 1.5
    cutoff: float = 3.0

    def reach(self) -> int:
        return max(1, int(math.ceil(self.cutoff * self.sigma)))

    def ring_masses(self) -> Tuple[float, ...]:
        s2 = 2.0 * self.sigma * self.sigma
        return tuple(ring_size(r) * math.exp(-(r * r) / s2)
                     for r in range(self.reach() + 1))

    def spec(self) -> str:
        return f"gaussian:sigma={self.sigma:g},cutoff={self.cutoff:g}"


@dataclasses.dataclass(frozen=True)
class ExponentialProfile(ConnectivityProfile):
    """Exponential distance decay (arXiv:1803.08833): per-column target
    probability ~ exp(-r / λ), truncated at reach = ceil(cutoff·λ)."""

    lam: float = 1.0
    cutoff: float = 5.0

    def reach(self) -> int:
        return max(1, int(math.ceil(self.cutoff * self.lam)))

    def ring_masses(self) -> Tuple[float, ...]:
        return tuple(ring_size(r) * math.exp(-r / self.lam)
                     for r in range(self.reach() + 1))

    def spec(self) -> str:
        return f"exponential:lambda={self.lam:g},cutoff={self.cutoff:g}"


# ----------------------------------------------------------------------------
# spec parsing
# ----------------------------------------------------------------------------

_ALIASES = {"paper": "ring3", "default": "ring3", "exp": "exponential"}


def _kwargs(body: str) -> dict:
    out = {}
    for item in body.split(","):
        if not item:
            continue
        k, _, v = item.partition("=")
        if not _:
            raise ValueError(f"malformed profile parameter {item!r} "
                             f"(expected key=value)")
        out[k.strip()] = v.strip()
    return out


def parse(spec: str,
          ring_fractions: Tuple[float, ...] = PAPER_RING_FRACTIONS
          ) -> ConnectivityProfile:
    """Parse a profile spec string (see module docstring grammar).

    `ring_fractions` supplies the paper fractions for the ring family so
    `GridConfig.ring_fractions` overrides keep working (`from_config`).
    """
    s = spec.strip().lower()
    name, _, body = s.partition(":")
    name = _ALIASES.get(name, name)

    if name.startswith("ring") and name[4:].isdigit():
        radius = int(name[4:])
        if body:
            raise ValueError(f"ring{radius} takes no parameters: {spec!r}")
        if radius == len(ring_fractions) - 1:
            return RingProfile(fractions=tuple(ring_fractions))
        return RingProfile.with_radius(radius, tuple(ring_fractions))

    kw = _kwargs(body)
    try:
        if name == "ring":
            radius = int(kw.pop("max_ring"))
            _reject_extra(kw, spec)
            if radius == len(ring_fractions) - 1:
                return RingProfile(fractions=tuple(ring_fractions))
            return RingProfile.with_radius(radius, tuple(ring_fractions))
        if name == "gaussian":
            sigma = float(kw.pop("sigma", 1.5))
            cutoff = float(kw.pop("cutoff", 3.0))
            _reject_extra(kw, spec)
            if sigma <= 0 or cutoff <= 0:
                raise ValueError("sigma and cutoff must be > 0")
            return GaussianProfile(sigma=sigma, cutoff=cutoff)
        if name == "exponential":
            if "lambda" in kw and "lam" in kw:
                raise ValueError(f"profile {spec!r}: give lambda= or lam=, "
                                 f"not both")
            if "lambda" in kw:
                lam = float(kw.pop("lambda"))
            else:
                lam = float(kw.pop("lam", 1.0))
            cutoff = float(kw.pop("cutoff", 5.0))
            _reject_extra(kw, spec)
            if lam <= 0 or cutoff <= 0:
                raise ValueError("lambda and cutoff must be > 0")
            return ExponentialProfile(lam=lam, cutoff=cutoff)
    except KeyError as e:
        raise ValueError(f"profile {spec!r} missing parameter {e}") from None
    raise ValueError(
        f"unknown connectivity profile {spec!r}; expected one of "
        f"ring3 | ringN | ring:max_ring=N | gaussian:sigma=S[,cutoff=C] "
        f"| exponential:lambda=L[,cutoff=C]")


def _reject_extra(kw: dict, spec: str) -> None:
    if kw:
        raise ValueError(f"unknown parameters {sorted(kw)} in profile "
                         f"{spec!r}")


def from_config(cfg) -> ConnectivityProfile:
    """The profile a `GridConfig` selects (`cfg.connectivity` spec string,
    with `cfg.ring_fractions` feeding the ring family)."""
    return parse(cfg.connectivity, tuple(cfg.ring_fractions))


# ----------------------------------------------------------------------------
# flattened ring-offset tables, shared by connectivity generation
# ----------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def offset_tables(reach: int):
    """(off [K, 2] int64, start [reach + 2] int64): the (dx, dy) offsets of
    rings 0..reach flattened in canonical order, and per-ring start
    indices.  Cached per reach — identical tables for identical reach, so
    repeated builds don't re-enumerate offsets."""
    from . import topology
    off = np.concatenate([np.asarray(topology.ring_offsets(r),
                                     dtype=np.int64).reshape(-1, 2)
                          for r in range(reach + 1)])
    start = np.concatenate([[0], np.cumsum([ring_size(r)
                                            for r in range(reach + 1)])]
                           ).astype(np.int64)
    return off, start
