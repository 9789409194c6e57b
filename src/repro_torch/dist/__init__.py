"""Distribution over a `torch.distributed` job: the meshes and their wire
(`mesh`: the SNN's flat mesh, the LM's named `LmMesh` and production
mesh), the placement of the SNN's stacked trees and the LM's sharding
rules (`sharding`), and the LM's train state in blocks by those rules
(`lm_blocks`).  The JAX package's `dist/compat.py` is jax version glue and
has no counterpart."""
from .mesh import (LmMesh, SnnMesh, Wire, make_lm_mesh, make_production_mesh,
                   make_snn_mesh, spans_processes)
from .sharding import replicated_put, shard_put

__all__ = ["LmMesh", "SnnMesh", "Wire", "make_lm_mesh",
           "make_production_mesh", "make_snn_mesh", "spans_processes",
           "shard_put", "replicated_put"]
