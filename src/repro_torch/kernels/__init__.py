"""Kernels of the dense DPSNN-STDP step: CUDA wrappers (`izhikevich`,
`stdp`, `segment_sum`, built by `_build` from `csrc/`), their plain
PyTorch versions (`ref`) and the device dispatch (`ops`).  Nothing here
imports triton or builds a kernel at import time."""
