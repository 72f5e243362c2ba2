"""Config registry: ``get_config(name)``, ``get_smoke_config(name)`` and
``list_archs()``, with the arch ids of ``repro.configs``.

Every id is listed; an arch whose config the port does not carry yet
raises ``NotImplementedError`` naming the ROADMAP item that ports it.
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

# arch id -> its config module, or, where the port does not carry it yet,
# the ROADMAP item (queue 1) that brings it over
_ARCHS = {
    "granite-moe-3b-a800m": "item 16.2 (MoE)",
    "gemma-2b": "item 16.1 (the other dense configs)",
    "internlm2-1.8b": "internlm2_1_8b",
    "deepseek-v2-236b": "item 16.3 (MLA)",
    "mamba2-780m": "item 16.4 (SSM)",
    "whisper-large-v3": "item 16.7 (audio)",
    "zamba2-2.7b": "item 16.5 (hybrid)",
    "pixtral-12b": "item 16.6 (VLM)",
    "phi4-mini-3.8b": "item 16.1 (the other dense configs)",
    "qwen1.5-110b": "item 16.1 (the other dense configs)",
    # the paper's own networks (FederatedEngine builds them directly)
    "mnist-mlp": "item 14 (the fl_train CLI)",
    "cifar-cnn": "items 2 and 14 (the CNN slice, the fl_train CLI)",
}


def list_archs() -> list[str]:
    return list(_ARCHS)


def _module(name: str):
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCHS)}")
    if _ARCHS[name].startswith("item"):
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet: ROADMAP queue "
            f"1, {_ARCHS[name]}")
    return importlib.import_module(f"repro_torch.configs.{_ARCHS[name]}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).smoke_config()
