"""Architecture registry of the port: `--arch <id>` resolution.

Only `recurrentgemma-2b` is ported so far (its serving path).  The JAX
package's other architectures (`repro.configs.ARCH_IDS`) wait for the
rest of ROADMAP queue 1 item 13 (RWKV-6, MoE, enc-dec and frontends); asking
for one raises and says so.
"""
from __future__ import annotations

from .base import ModelConfig, MoEConfig
from . import recurrentgemma_2b

_MODULES = {
    "recurrentgemma-2b": recurrentgemma_2b,
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported to PyTorch yet (ROADMAP "
            f"queue 1 item 13); ported: {', '.join(ARCH_IDS)}")
    return _MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


__all__ = ["ModelConfig", "MoEConfig", "ARCH_IDS", "get_config",
           "get_smoke_config"]
