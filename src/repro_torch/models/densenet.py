"""DenseNet-121 (the paper's third CNN), DP-compatible (GroupNorm).

The counterpart of ``repro.models.densenet``: blocks (6, 12, 24, 16),
growth 32, bottleneck 4x, compression 0.5, GroupNorm in place of
BatchNorm.  Params are a flat dict with the JAX package's leaf names and
shapes (``stem.conv`` HWIO, ``blocks.<b>.layers.<l>.conv1`` / ``conv2`` /
``gn1`` / ``gn2``, ``blocks.<b>.transition.conv`` / ``gn``,
``final_gn``, ``head.w``, ``head.b``).  ``forward`` takes NHWC images and
computes in NCHW, concatenating the growth channels on dim 1; a
transition's 2x2 average pool (stride 2, VALID) is the reference's
``reduce_window`` sum over 4.

DPQuant policy: each dense layer and each transition is one schedulable
layer, ``policy_len() = sum(blocks) + len(blocks)`` (62 for 121).  The
flag and seed indexing is the reference's, kept exactly: the stem runs
under flag 0 with seed 0 and the layer index is not advanced after it,
so the stem shares policy layer 0 (and conv seed 0) with the first dense
layer's ``conv1``; the dense layers and transitions then take indices 0
to ``policy_len() - 2``, and the last index quantizes no conv.

Ghost DP: ``per_example_loss`` and ``resnet.conv_ghost_mask``, as in the
JAX package.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.config import (ModelConfig, QuantConfig, generator)
from repro_torch.models import common as cm
from repro_torch.models import resnet
from repro_torch.models.registry import Model, register_family
from repro_torch.quant.fake_quant import qconv2d

BN_SIZE = 4          # bottleneck width: BN_SIZE * growth


def init_params(seed: int, cfg: ModelConfig, device) -> dict:
    """Random parameters from ``seed`` (the JAX package's shapes and init
    scales, torch's own stream)."""
    gen = generator(device)
    gen.manual_seed(seed)
    g = cfg.growth_rate

    def conv(shape):                      # HWIO, He init
        fan_in = shape[0] * shape[1] * shape[2]
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return t.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)

    def gn(prefix, c):
        return {f"{prefix}.scale": torch.ones(c, device=device),
                f"{prefix}.bias": torch.zeros(c, device=device)}

    c = 2 * g
    params = {"stem.conv": conv((3, 3, cfg.in_channels, c)),
              **gn("stem.gn", c)}
    for bi, n in enumerate(cfg.densenet_blocks):
        for li in range(n):
            pre = f"blocks.{bi}.layers.{li}."
            params.update(gn(pre + "gn1", c))
            params[pre + "conv1"] = conv((1, 1, c, BN_SIZE * g))
            params.update(gn(pre + "gn2", BN_SIZE * g))
            params[pre + "conv2"] = conv((3, 3, BN_SIZE * g, g))
            c += g
        if bi < len(cfg.densenet_blocks) - 1:
            pre = f"blocks.{bi}.transition."
            params.update(gn(pre + "gn", c))
            params[pre + "conv"] = conv((1, 1, c, c // 2))
            c //= 2
    params.update(gn("final_gn", c))
    head = torch.empty((c, cfg.num_classes), device=device)
    params["head.w"] = head.normal_(0.0, 1.0 / math.sqrt(c), generator=gen)
    params["head.b"] = torch.zeros(cfg.num_classes, device=device)
    return params


def conv_layers(cfg: ModelConfig) -> list:
    """Number of quantized convolutions of each policy layer: layer 0
    has 3 (the stem, the first dense layer's two), another dense layer 2,
    a transition 1, and the last index 0 (no conv reads it)."""
    counts = []
    for bi, n in enumerate(cfg.densenet_blocks):
        counts += [2] * n
        if bi < len(cfg.densenet_blocks) - 1:
            counts.append(1)
    counts[0] += 1                        # the stem
    return counts + [0]


def forward(params: dict, image: torch.Tensor, qflags,
            cfg: ModelConfig, quant: QuantConfig, hooks=None) -> torch.Tensor:
    """Logits (B, classes) of NHWC ``image``; ``qflags`` one flag per
    policy layer (a float32 device tensor or host bools, as in
    ``resnet.forward``).  ``hooks``: a ghost pass's
    ``repro_torch.dp.ghost.GhostHooks`` (as in ``resnet.forward``)."""
    if len(qflags) != cfg.policy_len():
        raise ValueError(f"{len(qflags)} flags for {cfg.policy_len()} layers")
    p = params
    conv = qconv2d if hooks is None else hooks.qconv2d
    n = image.shape[0]

    def leaf(name):
        return p[name] if hooks is None else hooks.leaf(name, p[name], n)

    def qc(x, w, flag, seed):
        return conv(x, w, seed=seed, flag=flag, fmt=quant.fmt,
                    q_fwd=quant.quantize_fwd, q_dgrad=quant.quantize_dgrad,
                    q_wgrad=quant.quantize_wgrad, backend=quant.backend)

    def gn_relu(x, prefix):
        return torch.relu(cm.groupnorm(x, leaf(prefix + ".scale"),
                                       leaf(prefix + ".bias")))

    li = 0
    x = image.permute(0, 3, 1, 2)
    x = gn_relu(qc(x, p["stem.conv"], qflags[li], 11 * li), "stem.gn")
    for bi, n_layers in enumerate(cfg.densenet_blocks):
        for j in range(n_layers):
            pre = f"blocks.{bi}.layers.{j}."
            flag, sd = qflags[li], 11 * li
            h = qc(gn_relu(x, pre + "gn1"), p[pre + "conv1"], flag, sd)
            h = qc(gn_relu(h, pre + "gn2"), p[pre + "conv2"], flag, sd + 1)
            x = torch.cat([x, h], dim=1)
            li += 1
        if bi < len(cfg.densenet_blocks) - 1:
            pre = f"blocks.{bi}.transition."
            t = qc(gn_relu(x, pre + "gn"), p[pre + "conv"], qflags[li],
                   11 * li)
            x = F.avg_pool2d(t, 2)
            li += 1
    x = gn_relu(x, "final_gn").mean(dim=(2, 3))
    return cm.dense_head(x, leaf("head.w"), leaf("head.b"))


def loss_fn(params, batch, qflags, cfg: ModelConfig, quant: QuantConfig,
            per_example: bool = False, hooks=None):
    """Mean (or per-example) cross-entropy of ``batch`` = {"image" NHWC,
    "label"}.  ``hooks``: as in ``forward``."""
    logits = forward(params, batch["image"], qflags, cfg, quant, hooks)
    return cm.softmax_xent(logits, batch["label"], per_example=per_example)


@register_family("densenet")
def build_densenet(cfg: ModelConfig, quant: QuantConfig, device) -> Model:
    return Model(
        config=cfg, quant=quant, device=device,
        init=functools.partial(init_params, cfg=cfg, device=device),
        prepare=lambda params: params,
        forward=functools.partial(forward, cfg=cfg, quant=quant),
        loss_fn=functools.partial(loss_fn, cfg=cfg, quant=quant),
        per_example_loss=functools.partial(loss_fn, cfg=cfg, quant=quant,
                                           per_example=True),
        ghost_mask=resnet.conv_ghost_mask,
    )
