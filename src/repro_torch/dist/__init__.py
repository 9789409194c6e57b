"""Distribution over a `torch.distributed` job: the SNN mesh and its wire
(`mesh`), and the placement of stacked trees on it (`sharding`).  The JAX
package's `dist/compat.py` is jax version glue and has no counterpart."""
from .mesh import SnnMesh, Wire, make_snn_mesh, spans_processes
from .sharding import replicated_put, shard_put

__all__ = ["SnnMesh", "Wire", "make_snn_mesh", "spans_processes",
           "shard_put", "replicated_put"]
