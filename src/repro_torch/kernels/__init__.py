"""Kernels of the port: CUDA wrappers (`izhikevich`, `stdp`, `segment_sum`
for the DPSNN-STDP step, `rg_lru` for the RG-LRU scan of the LM,
`flash_attention` behind `ops.attention`; built by
`_build` from `csrc/`), their plain PyTorch versions (`ref`) and the device
dispatch (`ops`).  Nothing here imports triton or builds a kernel at
import time."""
