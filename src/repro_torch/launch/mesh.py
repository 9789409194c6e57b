"""Mesh constructors, re-exported from `repro_torch.dist.mesh` so that
launch scripts and tests keep a stable import path (as
`repro.launch.mesh` does): the SNN's mesh and the LM's production mesh
(16x16 ('data', 'model'), or 2x16x16 with 'pod' in front), which
`dist.mesh.bind` binds to a job of that many ranks."""
from __future__ import annotations

from repro_torch.dist.mesh import (make_lm_mesh, make_production_mesh,
                                   make_snn_mesh, spans_processes)

__all__ = ["make_lm_mesh", "make_production_mesh", "make_snn_mesh",
           "spans_processes"]
