"""The LM substrate in PyTorch: the serving path of every decoder-only,
token-input architecture (attention with qk-norm, RG-LRU, RWKV-6, dense
and MoE MLPs, tied or untied embeddings).  Port of `repro.models`.
"""
from . import (attention, common, convert, lm, mlp, moe, recurrent,
               transformer)

__all__ = ["attention", "common", "convert", "lm", "mlp", "moe",
           "recurrent", "transformer"]
