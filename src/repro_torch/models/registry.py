"""Model abstraction + registry.

A ``Model`` bundles plain functions over a flat parameter dict
(``{"embed": ..., "blocks.wq": ..., ...}``, leaf names and layouts as in
the JAX package) and the device it runs on.  This slice carries the
serving hooks; the training hooks come with the training slice.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, Optional

import torch

from repro_torch.config import ModelConfig, QuantConfig, resolve_device


@dataclasses.dataclass
class Model:
    config: ModelConfig
    quant: QuantConfig
    device: torch.device
    init: Callable                    # seed -> params (on ``device``)
    # params -> params with the block weights cast once to the compute
    # dtype (what the serving functions expect; see transformer.prepare)
    prepare: Callable
    # serving (decoder families)
    prefill: Optional[Callable] = None       # (params, batch) -> (logits, cache)
    decode_step: Optional[Callable] = None   # (params, cache, token) -> (logits, cache)
    # continuous batching: decode_slots(params, cache, tokens, active) ->
    # (logits, cache) with per-slot positions in cache["pos"]
    decode_slots: Optional[Callable] = None
    slot_cache_spec: Optional[Callable] = None
    kv_formats: tuple = ("none",)


_BUILDERS: Dict[str, Callable[..., Model]] = {}


def register_family(name: str):
    def deco(fn):
        _BUILDERS[name] = fn
        return fn
    return deco


def build_model(config: ModelConfig, quant: Optional[QuantConfig] = None,
                device=None) -> Model:
    """Build the model for ``config`` on ``device`` (default CUDA; raises
    when no GPU is available and ``device`` was not given)."""
    dev = resolve_device(device)
    quant = quant or QuantConfig()
    importlib.import_module("repro_torch.models.transformer")
    if config.family not in _BUILDERS:
        raise ValueError(f"unknown model family: {config.family}")
    return _BUILDERS[config.family](config, quant, dev)
