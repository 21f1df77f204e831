"""Registry of the ported architectures (the dense, gemma, SSM and MoE
families so far), under the JAX package's names."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, reduce_config

_MODULES = {
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "llama3.1-8b": "repro_torch.configs.llama31_8b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return reduce_config(get_config(name[: -len("-reduced")]))
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG
