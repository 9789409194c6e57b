"""`StepProgram`: the one constructor for the DPSNN step (PyTorch port).

    sp = StepProgram(cfg, eng)                    # on the card
    sp = StepProgram(cfg, eng, device="cpu")      # plain PyTorch on the CPU
    state, raster, tm = sp.run(sp.init_state(), 0, 500)

This is the single-process subset of `repro.core.step_program.StepProgram`
(`mesh=None`, dense delivery, materialized connectivity), with the shards
stacked on a leading [H] axis of one device.  The rest of the JAX facade
raises `NotImplementedError` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np

from . import engine
from .engine import ShardPlan, ShardState, SimSpec
from .params import (DEFAULT_IZH, DEFAULT_STDP, EngineConfig, GridConfig,
                     IzhikevichParams, StdpParams)


def check_supported(eng: EngineConfig, mesh=None) -> None:
    """Raise NotImplementedError for what this port does not run yet."""
    if eng.delivery != "dense":
        raise NotImplementedError(
            f"delivery={eng.delivery!r}: event delivery is not ported yet "
            f"(ROADMAP queue 1, item 6)")
    if eng.connectivity != "materialized":
        raise NotImplementedError(
            f"connectivity={eng.connectivity!r}: streamed connectivity is "
            f"not ported yet (ROADMAP queue 1, item 7)")
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh is not ported yet; shards run stacked on one "
            "device (ROADMAP queue 1, item 8)")


class StepProgram:
    """Run handle for one (GridConfig, EngineConfig) on one device.

    `device=None` means the card; without one it raises.  Pass
    `device="cpu"` for the plain PyTorch path (what the tests do)."""

    def __init__(self, cfg: GridConfig, eng: EngineConfig, *,
                 device=None, mesh=None,
                 izh: Optional[IzhikevichParams] = None,
                 stdp: Optional[StdpParams] = None):
        check_supported(eng, mesh)
        dev = engine.resolve_device(device)
        spec, plan, state = engine.build(cfg, eng, izh or DEFAULT_IZH,
                                         stdp or DEFAULT_STDP, device=dev)
        self._init(spec, plan, state)

    @classmethod
    def from_parts(cls, spec: SimSpec, plan: ShardPlan,
                   state0: Optional[ShardState] = None) -> "StepProgram":
        """Wrap an already-built (spec, plan[, state]) without re-running
        connectivity construction (e.g. a plan from `convert.from_jax`)."""
        check_supported(spec.eng)
        sp = cls.__new__(cls)
        sp._init(spec, plan, state0)
        return sp

    def _init(self, spec, plan, state0):
        self.spec: SimSpec = spec
        self.plan: ShardPlan = plan
        self.device = plan.gid.device
        self._state0 = state0

    def init_state(self) -> ShardState:
        """The freshly-built initial state."""
        if self._state0 is None:
            raise ValueError("no initial state: this StepProgram wraps "
                             "prebuilt parts without state0")
        return self._state0

    def run(self, state: ShardState, t0: int, n_steps: int):
        """(state, raster [T, H, N] bool, timings) on this device; the
        input state is not modified."""
        return engine.run(self.spec, self.plan, state, t0, n_steps)

    def weight_signature(self, state: ShardState) -> bytes:
        """sha256 over the valid synapse weights in canonical per-shard
        order (the plastic-state counterpart of the raster signature),
        byte-compatible with the JAX package's."""
        w = state.w.detach().cpu().numpy()
        valid = self.plan.syn_valid.cpu().numpy()
        h = hashlib.sha256()
        for hh in range(w.shape[0]):
            h.update(np.ascontiguousarray(w[hh][valid[hh]]).tobytes())
        return h.digest()
