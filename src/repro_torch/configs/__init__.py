"""Architecture registry: the dense-LM presets, ResNet-18, ResNet-50,
DenseNet-121, BERT-SNLI, Mamba-2-130m, RecurrentGemma-9B, InternVL2-1B,
whisper-medium and the mixture-of-experts LMs arctic-480b and
kimi-k2-1t-a32b.

``get_config(arch_id)`` returns the full-scale ModelConfig;
``get_smoke_config(arch_id)`` a reduced same-family config for CPU tests.
The values are the JAX package's (``repro.configs``), copied.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config import ModelConfig

_MODULES = ["gemma_7b", "yi_9b", "yi_6b", "stablelm_3b", "resnet18",
            "resnet50", "densenet121", "bert_snli", "mamba2_130m",
            "recurrentgemma_9b", "internvl2_1b", "whisper_medium",
            "arctic_480b", "kimi_k2_1t"]

ASSIGNED_ARCHS: List[str] = [
    "gemma-7b", "yi-9b", "stablelm-3b", "yi-6b", "kimi-k2-1t-a32b",
    "arctic-480b", "whisper-medium", "mamba2-130m", "recurrentgemma-9b",
    "internvl2-1b",
]

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
