"""ResNet-18 (the paper's primary CNN), DP-compatible (GroupNorm).

The counterpart of ``repro.models.resnet`` for the basic-block ResNets:
CIFAR/GTSRB-style stem (3x3, stride 1) for 32x32 inputs, GroupNorm in
place of BatchNorm (per-example DP gradients forbid cross-example
statistics).

Params are a flat dict with the JAX package's leaf names and shapes, the
nesting joined with dots: ``stem.conv`` (3, 3, C_in, 64) HWIO,
``stem.gn.scale``, ``stages.<s>.<b>.conv1`` / ``conv2`` / ``proj``,
``stages.<s>.<b>.gn1.scale`` ..., ``head.w`` (512, classes), ``head.b``.
The public ``forward`` takes NHWC images as the JAX package does and
computes in NCHW, the layout of PyTorch's convolutions.

DPQuant policy granularity: the stem and every residual block are one
schedulable layer; ``qconv2d`` gates every conv GEMM of the layer under
its flag.  The conv seeds are the JAX package's ``11 * layer + j``.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import torch

from repro_torch.config import ModelConfig, QuantConfig
from repro_torch.models import common as cm
from repro_torch.models.registry import Model, register_family
from repro_torch.quant.fake_quant import qconv2d

WIDTHS = (64, 128, 256, 512)


def _check_basic(cfg: ModelConfig) -> None:
    if sum(cfg.resnet_blocks) > 8:
        raise NotImplementedError(
            f"{cfg.name}: bottleneck ResNets (ResNet-50) are not ported yet")


def _stride(si: int, bi: int) -> int:
    return 2 if (si > 0 and bi == 0) else 1


def init_params(seed: int, cfg: ModelConfig, device) -> dict:
    """Random parameters from ``seed`` (the JAX package's shapes and init
    scales, torch's own stream)."""
    _check_basic(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def conv(shape):                      # HWIO, He init
        fan_in = shape[0] * shape[1] * shape[2]
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return t.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)

    def gn(prefix, c):
        return {f"{prefix}.scale": torch.ones(c, device=device),
                f"{prefix}.bias": torch.zeros(c, device=device)}

    params = {"stem.conv": conv((3, 3, cfg.in_channels, 64)),
              **gn("stem.gn", 64)}
    in_c = 64
    for si, (n, w) in enumerate(zip(cfg.resnet_blocks, WIDTHS)):
        for bi in range(n):
            pre = f"stages.{si}.{bi}."
            params[pre + "conv1"] = conv((3, 3, in_c, w))
            params.update(gn(pre + "gn1", w))
            params[pre + "conv2"] = conv((3, 3, w, w))
            params.update(gn(pre + "gn2", w))
            if _stride(si, bi) != 1 or in_c != w:
                params[pre + "proj"] = conv((1, 1, in_c, w))
                params.update(gn(pre + "proj_gn", w))
            in_c = w
    head = torch.empty((in_c, cfg.num_classes), device=device)
    params["head.w"] = head.normal_(0.0, 1.0 / math.sqrt(in_c), generator=gen)
    params["head.b"] = torch.zeros(cfg.num_classes, device=device)
    return params


def conv_layers(cfg: ModelConfig) -> list:
    """Number of convolutions of each policy layer (stem 1, a block 2, a
    block with a projection 3)."""
    counts, in_c = [1], 64
    for si, (n, w) in enumerate(zip(cfg.resnet_blocks, WIDTHS)):
        for bi in range(n):
            counts.append(3 if (_stride(si, bi) != 1 or in_c != w) else 2)
            in_c = w
    return counts


def forward(params: dict, image: torch.Tensor, qflags: Sequence[bool],
            cfg: ModelConfig, quant: QuantConfig) -> torch.Tensor:
    """Logits (B, classes) of NHWC ``image``; ``qflags`` one host-side
    bool per policy layer."""
    _check_basic(cfg)
    if len(qflags) != cfg.policy_len():
        raise ValueError(f"{len(qflags)} flags for {cfg.policy_len()} layers")
    p = params

    def qc(x, w, flag, seed, stride=1):
        return qconv2d(x, w, seed=seed, flag=bool(flag), stride=stride,
                       fmt=quant.fmt, q_fwd=quant.quantize_fwd,
                       q_dgrad=quant.quantize_dgrad,
                       q_wgrad=quant.quantize_wgrad, backend=quant.backend)

    def gn(x, prefix):
        return cm.groupnorm(x, p[prefix + ".scale"], p[prefix + ".bias"])

    x = image.permute(0, 3, 1, 2)
    x = torch.relu(gn(qc(x, p["stem.conv"], qflags[0], 0), "stem.gn"))
    li = 1
    for si, n in enumerate(cfg.resnet_blocks):
        for bi in range(n):
            pre = f"stages.{si}.{bi}."
            stride, flag, sd = _stride(si, bi), qflags[li], 11 * li
            h = torch.relu(gn(qc(x, p[pre + "conv1"], flag, sd, stride),
                              pre + "gn1"))
            h = gn(qc(h, p[pre + "conv2"], flag, sd + 1), pre + "gn2")
            shortcut = x
            if pre + "proj" in p:
                shortcut = gn(qc(x, p[pre + "proj"], flag, sd + 3, stride),
                              pre + "proj_gn")
            x = torch.relu(h + shortcut)
            li += 1
    x = x.mean(dim=(2, 3))
    return x @ p["head.w"] + p["head.b"]


def loss_fn(params, batch, qflags, cfg: ModelConfig, quant: QuantConfig,
            per_example: bool = False):
    """Mean (or per-example) cross-entropy of ``batch`` = {"image" NHWC,
    "label"}.  The JAX package's ``loss_fn`` also takes an rng, which it
    deletes; the port leaves it out."""
    logits = forward(params, batch["image"], qflags, cfg, quant)
    return cm.softmax_xent(logits, batch["label"], per_example=per_example)


@register_family("resnet")
def build_resnet(cfg: ModelConfig, quant: QuantConfig, device) -> Model:
    _check_basic(cfg)
    return Model(
        config=cfg, quant=quant, device=device,
        init=functools.partial(init_params, cfg=cfg, device=device),
        prepare=lambda params: params,
        forward=functools.partial(forward, cfg=cfg, quant=quant),
        loss_fn=functools.partial(loss_fn, cfg=cfg, quant=quant),
    )
