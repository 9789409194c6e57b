"""repro_torch.simserve: the multi-tenant SNN simulation service (port of
`repro.simserve`).

Many independent tenant simulations (each its own GridConfig, seed
included, its own engine layout and its own step budget) admitted into
one process and advanced in lockstep rounds.  Tenants whose configs
differ only by seed share ONE round program: on the card one captured
CUDA graph of `round_steps` steps, with the tenants folded onto the shard
axis (`batcher`), each slot at its own step.

The correctness contract, checked by the tests, the CLI and
`chip_smoke.py`: every tenant's streamed raster signature equals the same
config run solo through `core.StepProgram`, whatever its batch companions,
slot-refill order or evict / resume cycles, resumes into another shard
layout through the layout-free `core.checkpoint` format included.

    python -m repro_torch.simserve demo      # verified mixed fleet
    python -m repro_torch.simserve soak      # overload + forced evict/resume
"""
from .batcher import (BatchGroup, CompiledRound, GroupCaps, ProgramCache,
                      build_parts, measure_caps, negotiate, shape_key,
                      solo_signature)
from .metrics import ServiceMetrics
from .queue import SimService
from .session import (DONE, EVICTED, FAILED, QUEUED, RUNNING, RasterStream,
                      TenantRequest, TenantSession)

__all__ = [
    "BatchGroup", "CompiledRound", "GroupCaps", "ProgramCache",
    "build_parts", "measure_caps", "negotiate", "shape_key",
    "solo_signature", "ServiceMetrics", "SimService", "DONE", "EVICTED",
    "FAILED", "QUEUED", "RUNNING", "RasterStream", "TenantRequest",
    "TenantSession",
]
