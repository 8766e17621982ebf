"""Architecture registry for the dense-LM presets.

``get_config(arch_id)`` returns the full-scale ModelConfig;
``get_smoke_config(arch_id)`` a reduced same-family config for CPU tests.
The values are the JAX package's (``repro.configs``), copied.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config import ModelConfig

_MODULES = ["gemma_7b", "yi_9b", "yi_6b", "stablelm_3b"]

_REGISTRY: Dict[str, dict] = {}


def register(arch_id: str, full: ModelConfig, smoke: ModelConfig) -> None:
    _REGISTRY[arch_id] = {"full": full, "smoke": smoke}


def _load():
    if not _REGISTRY:
        for m in _MODULES:
            importlib.import_module(f"repro_torch.configs.{m}")


def get_config(arch_id: str) -> ModelConfig:
    _load()
    return _REGISTRY[arch_id]["full"]


def get_smoke_config(arch_id: str) -> ModelConfig:
    _load()
    return _REGISTRY[arch_id]["smoke"]


def list_archs() -> List[str]:
    _load()
    return sorted(_REGISTRY)
