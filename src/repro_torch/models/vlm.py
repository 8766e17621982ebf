"""VLM backbone (internvl2-1b): the dense decoder LM with a vision prefix.

The counterpart of ``repro.models.vlm``.  As there, the InternViT
frontend is a stub: a batch may carry precomputed patch embeddings
``vision_embeds`` (B, n_vision_tokens, d_model) in the compute dtype,
which replace the first ``n_vision_tokens`` positions of the token
embeddings.  The loss leaves the first ``n_vision_tokens`` predictions
out (``transformer.lm_loss``'s ``loss_mask_prefix``), and, unlike the
``dense_lm`` family, the token embeddings are not scaled by
``sqrt(d_model)``.  Everything else is the dense GQA transformer
(``repro_torch.models.transformer``): its training forward (the vmap
engine: no ghost hooks, as in the reference) and its oneshot ``prefill``
and ``decode_step`` with an unquantized KV cache (``kv_fmt`` "none"
only; no per-slot decode).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.config import ModelConfig, QuantConfig, torch_dtype
from repro_torch.models import transformer as tfm
from repro_torch.models.registry import Model, register_family


def batch_spec(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """``{name: (shape, dtype)}`` of a batch: the token ids and the vision
    prefix's embeddings."""
    return {
        "tokens": ((batch, seq), torch.int32),
        "vision_embeds": ((batch, cfg.n_vision_tokens, cfg.d_model),
                          torch_dtype(cfg.compute_dtype)),
    }


@register_family("vlm")
def build_vlm(cfg: ModelConfig, quant: QuantConfig, device) -> Model:
    return Model(
        config=cfg, quant=quant, device=device,
        init=functools.partial(tfm.init_params, cfg=cfg, device=device),
        prepare=functools.partial(tfm.prepare, cfg=cfg),
        loss_fn=functools.partial(tfm.lm_loss, cfg=cfg, quant=quant,
                                  loss_mask_prefix=cfg.n_vision_tokens),
        batch_spec=functools.partial(batch_spec, cfg),
        prefill=functools.partial(tfm.prefill, cfg=cfg, quant=quant),
        decode_step=functools.partial(tfm.decode_step, cfg=cfg, quant=quant),
        kv_formats=("none",),
    )
