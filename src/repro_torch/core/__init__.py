"""DPSNN-STDP core in PyTorch: `repro.core` (dense and event delivery over
materialized connectivity, dense delivery over streamed connectivity),
with the shards stacked on one device or cut into blocks over the ranks of
a `torch.distributed` job (`distributed`); layout-free checkpoints that
the JAX package reads too (`checkpoint`, `integrity`)."""

from .params import (EngineConfig, GridConfig, IzhikevichParams, StdpParams,
                     DEFAULT_IZH, DEFAULT_STDP)
from .engine import (ShardPlan, ShardState, SimSpec, build, init_state,
                     make_step_fn, run)
from . import (aer, checkpoint, connectivity, convert, distributed,
               event_engine, integrity, neuron, observables, profiles,
               stimulus, stream_engine, topology)
from .step_program import StepProgram

__all__ = [
    "EngineConfig", "GridConfig", "IzhikevichParams", "StdpParams",
    "DEFAULT_IZH", "DEFAULT_STDP", "ShardPlan", "ShardState", "SimSpec",
    "StepProgram", "build", "init_state", "make_step_fn", "run",
    "aer", "checkpoint", "connectivity", "convert", "distributed",
    "event_engine", "integrity", "neuron", "observables", "profiles",
    "stimulus", "stream_engine", "topology",
]
