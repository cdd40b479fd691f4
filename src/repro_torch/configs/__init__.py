"""repro_torch.configs — model configurations of the port.

Every architecture of the reference: the port serves the dense family
(llama3.2-3b, granite-8b, mistral-nemo-12b, qwen3-32b, and qwen2-vl-72b's
M-RoPE backbone), the MoE family (olmoe-1b-7b, grok-1-314b), the SSM
family (mamba2-2.7b), the hybrid family (zamba2-7b) and the enc-dec family
(whisper-small, its audio front end a stub), and trains the dense family.
"""

from importlib import import_module
from typing import Dict

from .base import (ModelConfig, ShapeConfig, SHAPES, applicable,
                   smoke_reduce)

_ARCH_MODULES = {
    "qwen3-32b": "qwen3_32b",
    "granite-8b": "granite_8b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "llama3.2-3b": "llama3_2_3b",
    "zamba2-7b": "zamba2_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "mamba2-2.7b": "mamba2_2p7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "grok-1-314b": "grok_1_314b",
    "whisper-small": "whisper_small",
}

ARCH_NAMES = list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; choices: {ARCH_NAMES}")
    mod = import_module(f".{_ARCH_MODULES[arch]}", __name__)
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_NAMES}


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "applicable",
           "smoke_reduce", "ARCH_NAMES", "get_config", "all_configs"]
