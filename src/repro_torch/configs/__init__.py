"""Architecture registry of the port: `--arch <id>` resolution.

Every architecture of the JAX package (`repro.configs.ARCH_IDS`) is
ported, in the same order: its serving path runs here, the
encoder-decoder `seamless-m4t-medium` and the `embeds` input of
`llava-next-34b` included.
"""
from __future__ import annotations

from .base import ModelConfig, MoEConfig
from . import (gemma3_27b, granite_moe_3b_a800m, internlm2_20b,
               llama4_maverick_400b_a17b, llava_next_34b, minicpm_2b,
               qwen3_0_6b, recurrentgemma_2b, rwkv6_1_6b,
               seamless_m4t_medium)

_MODULES = {
    "minicpm-2b": minicpm_2b,
    "internlm2-20b": internlm2_20b,
    "gemma3-27b": gemma3_27b,
    "qwen3-0.6b": qwen3_0_6b,
    "llava-next-34b": llava_next_34b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "rwkv6-1.6b": rwkv6_1_6b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _MODULES[arch].SMOKE


__all__ = ["ModelConfig", "MoEConfig", "ARCH_IDS", "get_config",
           "get_smoke_config"]
