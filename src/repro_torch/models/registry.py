"""Model abstraction + registry.

A ``Model`` bundles plain functions over a flat parameter dict
(``{"embed": ..., "blocks.wq": ..., ...}``, leaf names and layouts as in
the JAX package) and the device it runs on: the serving hooks of the
decoder families (dense LMs, Mamba-2, the Griffin hybrid, the VLM, the
encoder-decoder, the mixture-of-experts LMs) and the training hooks of
the ResNet, DenseNet, dense-LM, BERT, Mamba-2, Griffin, VLM,
encoder-decoder and MoE families.
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
    # training: loss_fn(params, batch, qflags) -> mean loss; qflags is one
    # host-side bool per DPQuant policy layer, or the trainer's flags
    # tensor.  forward(params, image, qflags) -> logits (resnet,
    # densenet); forward(params, tokens, qflags) -> logits (bert)
    forward: Optional[Callable] = None
    loss_fn: Optional[Callable] = None
    # ghost DP (dense_lm, resnet, densenet): per_example_loss(params,
    # batch, qflags, hooks=None) -> (B,), hooks a ghost pass's GhostHooks;
    # ghost_mask(params) -> {name: bool}; ghost_aux(qflags) -> GhostAux
    # (dense_lm only)
    per_example_loss: Optional[Callable] = None
    ghost_mask: Optional[Callable] = None
    ghost_aux: Optional[Callable] = None
    # batch_spec(batch, seq) -> {name: (shape, dtype)} of a batch's inputs
    # (the VLM's carries ``vision_embeds``, the encoder-decoder's
    # ``enc_embeds``); None: token ids only
    batch_spec: Optional[Callable] = None
    # serving (decoder families)
    prefill: Optional[Callable] = None       # (params, batch) -> (logits, cache)
    decode_step: Optional[Callable] = None   # (params, cache, token) -> (logits, cache)
    # continuous batching: decode_slots(params, cache, tokens, active) ->
    # (logits, cache) with per-slot positions in cache["pos"]
    decode_slots: Optional[Callable] = None
    slot_cache_spec: Optional[Callable] = None
    # KV-cache storage formats of the serve path; the callers pass a
    # ``kv_fmt`` argument only for formats beyond "none", so a family
    # without a KV cache takes none
    kv_formats: tuple = ("none",)
    # param_axes() -> {name: logical axes} of every parameter (the
    # reference's ``param_axes``): what lays the params out over a mesh's
    # model axis (dense_lm, moe_lm); None: the family trains only with
    # whole params on every rank
    param_axes: Optional[Callable] = None
    # cache_axes(kv_fmt="none") -> {name: logical axes} of the serving
    # cache (the reference's ``kv_cache_axes``): what splits it over a
    # model group (dense_lm, moe_lm); None: the family serves only with
    # whole params on every rank
    cache_axes: Optional[Callable] = None


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
    for module in ("transformer", "resnet", "densenet", "bert", "mamba2",
                   "griffin", "vlm", "encdec", "moe"):
        importlib.import_module(f"repro_torch.models.{module}")
    if config.family not in _BUILDERS:
        raise ValueError(f"unknown model family: {config.family}")
    return _BUILDERS[config.family](config, quant, dev)
