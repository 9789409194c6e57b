"""The LM substrate in PyTorch: the `recurrentgemma-2b` serving path
(RG-LRU and local attention layers, dense MLPs).  Port of `repro.models`.
"""
from . import attention, common, convert, lm, mlp, recurrent, transformer

__all__ = ["attention", "common", "convert", "lm", "mlp", "recurrent",
           "transformer"]
