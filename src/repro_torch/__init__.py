"""DPSNN-STDP mini-application (arXiv 1310.8478) ported to PyTorch and CUDA.

The JAX package `repro` is the reference; this package runs the same
simulation with hand-written CUDA kernels for Hopper (`kernels/`,
`csrc/`), and with their plain PyTorch versions on the CPU.  It imports
neither `jax` nor `repro`.

Subpackages: `core` (the spiking engine), `kernels` (CUDA wrappers, plain
versions, dispatch), `dist` (the mesh over a job's ranks and its wire),
`cluster` (joining a `torch.distributed` job), `bench` (measuring
tools and suites), `launch` (entry points).
"""

__version__ = "0.1.0"
