"""Architecture registry of the port: `--arch <id>` resolution.

Every decoder-only, token-input architecture of the JAX package
(`repro.configs.ARCH_IDS`) is ported: its serving path runs here.  The
two that are not, `seamless-m4t-medium` (encoder-decoder) and
`llava-next-34b` (the `embeds` frontend), wait for ROADMAP queue 1 item
13.4; asking for one raises and says so.
"""
from __future__ import annotations

from .base import ModelConfig, MoEConfig
from . import (gemma3_27b, granite_moe_3b_a800m, internlm2_20b,
               llama4_maverick_400b_a17b, minicpm_2b, qwen3_0_6b,
               recurrentgemma_2b, rwkv6_1_6b)

_MODULES = {
    "minicpm-2b": minicpm_2b,
    "internlm2-20b": internlm2_20b,
    "gemma3-27b": gemma3_27b,
    "qwen3-0.6b": qwen3_0_6b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "rwkv6-1.6b": rwkv6_1_6b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b,
}

#: The JAX package's architectures that the port refuses, and why.
NOT_PORTED = {
    "seamless-m4t-medium": "encoder-decoder",
    "llava-next-34b": "the 'embeds' input frontend",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        why = f" ({NOT_PORTED[arch]})" if arch in NOT_PORTED else ""
        raise NotImplementedError(
            f"architecture {arch!r}{why} is not ported to PyTorch yet "
            f"(ROADMAP queue 1 item 13.4); ported: {', '.join(ARCH_IDS)}")
    return _MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


__all__ = ["ModelConfig", "MoEConfig", "ARCH_IDS", "NOT_PORTED",
           "get_config", "get_smoke_config"]
