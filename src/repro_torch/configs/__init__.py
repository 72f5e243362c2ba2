"""Config registry: ``get_config(name)``, ``get_smoke_config(name)`` and
``list_archs()``, with the arch ids of ``repro.configs``.

Every id of the reference is listed, and the port carries each one's
config.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    InputShape,
    RAgeKConfig,
    INPUT_SHAPES,
    TRAIN_4K,
    PREFILL_32K,
    DECODE_32K,
    LONG_500K,
)

# arch id -> its config module
_ARCHS = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "gemma-2b": "gemma_2b",
    "internlm2-1.8b": "internlm2_1_8b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mamba2-780m": "mamba2_780m",
    "whisper-large-v3": "whisper_large_v3",
    "zamba2-2.7b": "zamba2_2_7b",
    "pixtral-12b": "pixtral_12b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen1.5-110b": "qwen1_5_110b",
    # the paper's own networks (FederatedEngine builds them directly)
    "mnist-mlp": "mnist_mlp",
    "cifar-cnn": "cifar_cnn",
}


# the LM archs (the paper's nets are built by the engine, not the zoo)
ASSIGNED_ARCHS = [a for a in _ARCHS if a not in ("mnist-mlp", "cifar-cnn")]


def list_archs() -> list[str]:
    return list(_ARCHS)


def _module(name: str):
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCHS[name]}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).smoke_config()
