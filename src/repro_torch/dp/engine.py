"""DP gradient modes: what the port's DP engine can run.

The counterpart of ``repro.dp.engine``.  ``grad_mode="vmap"``: per-example
gradients from ``torch.func.vmap``, clipped and summed by
``repro_torch.dp.clip``.  ``grad_mode="ghost"``: the two-pass ghost-norm
engine of ``repro_torch.dp.ghost`` (the dense LMs, ResNet and DenseNet),
whose data-parallel driver runs both passes on each rank's block of the
batch.
Both are noised by ``repro_torch.dp.noise``; the train step
(``repro_torch.launch.steps``) assembles them, as the JAX package's
``build_train_setup`` does.
"""
from __future__ import annotations

from repro_torch.config import DPConfig


def validate_grad_mode(dp: DPConfig, model=None) -> None:
    """Fail fast on grad-mode knob combinations the engine cannot honor.

    ``model`` (a ``repro_torch.models.registry.Model``) is optional; when
    given, ghost mode also needs the family's ghost hooks.
    """
    if dp.grad_mode not in ("vmap", "ghost"):
        raise ValueError(f"dp.grad_mode must be 'vmap' or 'ghost', "
                         f"got {dp.grad_mode!r}")
    if dp.clip_backend not in ("ref", "fused"):
        raise ValueError(f"dp.clip_backend must be 'ref' or 'fused', "
                         f"got {dp.clip_backend!r}")
    if dp.grad_mode != "ghost":
        return
    if dp.ghost_microbatch < 0:
        raise ValueError(f"dp.ghost_microbatch must be >= 0, "
                         f"got {dp.ghost_microbatch}")
    if dp.ghost_sharded not in ("auto", "on", "off"):
        raise ValueError(f"dp.ghost_sharded must be 'auto', 'on' or 'off', "
                         f"got {dp.ghost_sharded!r}")
    if dp.partial_accum:
        raise ValueError("grad_mode='ghost' computes the clipped grad sum "
                         "in one reweighted backward and keeps no per-shard "
                         "partial sums; disable dp.partial_accum or use "
                         "grad_mode='vmap'")
    if dp.clip_backend == "fused":
        raise ValueError("clip_backend='fused' operates on materialized "
                         "(B, D) per-example grads, which ghost mode never "
                         "forms; use clip_backend='ref' with "
                         "grad_mode='ghost'")
    if model is None:
        return
    if model.per_example_loss is None or model.ghost_mask is None:
        raise ValueError(
            f"model family {model.config.family!r} has no ghost hooks "
            f"(per_example_loss/ghost_mask); grad_mode='ghost' supports "
            f"dense_lm, resnet and densenet - use grad_mode='vmap'")
