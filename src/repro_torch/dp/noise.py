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
"""
from __future__ import annotations

import torch


def add_gaussian_noise(grad_sum: dict, *, clip_norm: float,
                       noise_multiplier: float, batch_size: int,
                       generator: torch.Generator) -> dict:
    """Noise the clipped-gradient sum and average: returns the DP update."""
    std = noise_multiplier * clip_norm
    out = {}
    for name, g in grad_sum.items():
        noise = torch.randn(g.shape, generator=generator, device=g.device,
                            dtype=torch.float32)
        out[name] = (g.float() + std * noise) / batch_size
    return out
