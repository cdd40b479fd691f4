"""repro_torch.configs — model configurations of the port.

The port has the hybrid family (Zamba2, served) and the dense family
(llama3.2-3b, trained) so far; the other architectures of the reference
wait for their slice (ROADMAP queue 1) and are refused by name.
"""

from importlib import import_module
from typing import Dict

from .base import (ModelConfig, ShapeConfig, SHAPES, applicable,
                   smoke_reduce)

_ARCH_MODULES = {
    "llama3.2-3b": "llama3_2_3b",
    "zamba2-7b": "zamba2_7b",
}

ARCH_NAMES = list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; the port "
                       f"has {ARCH_NAMES} (ROADMAP queue 1)")
    mod = import_module(f".{_ARCH_MODULES[arch]}", __name__)
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_NAMES}


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "applicable",
           "smoke_reduce", "ARCH_NAMES", "get_config", "all_configs"]
