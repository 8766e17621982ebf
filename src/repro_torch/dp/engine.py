"""DP gradient modes: what the port's DP engine can run.

The counterpart of ``repro.dp.engine``.  Only ``grad_mode="vmap"`` is
ported: per-example gradients from ``torch.func.vmap``, clipped and summed
by ``repro_torch.dp.clip``, noised by ``repro_torch.dp.noise``; the train
step (``repro_torch.launch.steps``) assembles them, as the JAX package's
``build_train_setup`` does.  Ghost clipping comes with its own slice.
"""
from __future__ import annotations

from repro_torch.config import DPConfig


def validate_grad_mode(dp: DPConfig) -> None:
    """Fail fast on DP knobs the port cannot honor yet."""
    if dp.grad_mode == "ghost":
        raise NotImplementedError(
            "grad_mode='ghost' (ghost-norm clipping) is not ported to "
            "repro_torch yet; use grad_mode='vmap'")
    if dp.grad_mode != "vmap":
        raise ValueError(f"dp.grad_mode must be 'vmap' or 'ghost', "
                         f"got {dp.grad_mode!r}")
    if dp.clip_backend not in ("ref", "fused"):
        raise ValueError(f"dp.clip_backend must be 'ref' or 'fused', "
                         f"got {dp.clip_backend!r}")
