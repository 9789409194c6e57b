"""Mesh constructors, re-exported from `repro_torch.dist.mesh` so that
launch scripts and tests keep a stable import path (as
`repro.launch.mesh` does).  The LM's production mesh is ROADMAP queue 1,
item 13.5."""
from __future__ import annotations

from repro_torch.dist.mesh import make_snn_mesh, spans_processes

__all__ = ["make_snn_mesh", "spans_processes"]
