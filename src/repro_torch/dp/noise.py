"""Gaussian noise injection for DP-SGD.

The counterpart of ``repro.dp.noise``.  Abadi et al. (2016) convention
(also Opacus'): noise N(0, (sigma*C)^2) is added to the *sum* of clipped
per-example gradients, then the sum is divided by the batch size:

    g_hat = (sum_i clip_C(g_i) + N(0, sigma^2 C^2 I)) / B

The noise comes from an explicitly seeded ``torch.Generator`` on the
gradients' device (the JAX package uses a step-derived threefry key; the
two cannot give the same numbers, so the tests compare the noise
statistically).  Per paper A.17 it is sampled and added in float32,
before any quantization.

On a model group (``layout``) a leaf split over the group adds its slice
of the noise the one-process step draws for the whole leaf: every rank
draws each whole leaf, in the same leaf order from the same generator
state, and keeps its block, so the sharded sum plus noise is the
one-process one.  The whole leaf's draw is a transient of the leaf's
full size; a counter-based draw of the slice alone would avoid it.
"""
from __future__ import annotations

import torch


def add_gaussian_noise(grad_sum: dict, *, clip_norm: float,
                       noise_multiplier: float, batch_size: int,
                       generator: torch.Generator, layout=None) -> dict:
    """Noise the clipped-gradient sum and average: returns the DP update.
    ``layout``: ``{name: (whole shape, index)}`` of the leaves this rank
    holds a block of (module docstring)."""
    std = noise_multiplier * clip_norm
    out = {}
    layout = layout or {}
    for name, g in grad_sum.items():
        shape, index = layout.get(name, (g.shape, None))
        noise = torch.randn(shape, generator=generator, device=g.device,
                            dtype=torch.float32)
        if index is not None:
            noise = noise[index]
        out[name] = (g.float() + std * noise) / batch_size
    return out
