"""ResNet-18 and ResNet-50 (the paper's CNNs), DP-compatible (GroupNorm).

The counterpart of ``repro.models.resnet``: CIFAR/GTSRB-style stem (3x3,
stride 1) for 32x32 inputs, GroupNorm in place of BatchNorm (per-example
DP gradients forbid cross-example statistics).  A config with more than
8 blocks (ResNet-50, (3, 4, 6, 3)) builds bottleneck blocks, 1x1 -> 3x3
(the block's stride) -> 1x1 to 4 w; fewer, basic blocks (3x3 -> 3x3).

Params are a flat dict with the JAX package's leaf names and shapes, the
nesting joined with dots: ``stem.conv`` (3, 3, C_in, 64) HWIO,
``stem.gn.scale``, ``stages.<s>.<b>.conv1`` / ``conv2`` (/ ``conv3``) /
``proj``, ``stages.<s>.<b>.gn1.scale`` ..., ``head.w`` (C, classes),
``head.b``.  The public ``forward`` takes NHWC images as the JAX package
does and computes in NCHW, the layout of PyTorch's convolutions.

Ghost DP: ``per_example_loss(params, batch, qflags, hooks=None)`` and
``conv_ghost_mask`` (every conv hooked; the GroupNorm parameters and the
head take the engine's norm-only fallback).

DPQuant policy granularity: the stem and every residual block are one
schedulable layer; ``qconv2d`` gates every conv GEMM of the layer under
its flag (an entry of the flags tensor, never read on the host).  The conv seeds are the JAX package's ``11 * layer + j``: j = 0,
1 (, 2) for the block's convs in order, 3 for the projection.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.config import (ModelConfig, QuantConfig, generator)
from repro_torch.models import common as cm
from repro_torch.models.registry import Model, register_family
from repro_torch.quant.fake_quant import qconv2d

WIDTHS = (64, 128, 256, 512)


def _is_bottleneck(cfg: ModelConfig) -> bool:
    return sum(cfg.resnet_blocks) > 8          # resnet50 (3, 4, 6, 3)


def _stride(si: int, bi: int) -> int:
    return 2 if (si > 0 and bi == 0) else 1


def _blocks(cfg: ModelConfig):
    """(prefix, stride, in_c, w, out_c) of every block, in order."""
    expansion = 4 if _is_bottleneck(cfg) else 1
    in_c = 64
    for si, (n, w) in enumerate(zip(cfg.resnet_blocks, WIDTHS)):
        for bi in range(n):
            yield f"stages.{si}.{bi}.", _stride(si, bi), in_c, w, w * expansion
            in_c = w * expansion


def init_params(seed: int, cfg: ModelConfig, device) -> dict:
    """Random parameters from ``seed`` (the JAX package's shapes and init
    scales, torch's own stream)."""
    gen = generator(device)
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
    for pre, stride, in_c, w, out_c in _blocks(cfg):
        if _is_bottleneck(cfg):
            shapes = ((1, 1, in_c, w), (3, 3, w, w), (1, 1, w, out_c))
        else:
            shapes = ((3, 3, in_c, w), (3, 3, w, out_c))
        for j, shape in enumerate(shapes, 1):
            params[f"{pre}conv{j}"] = conv(shape)
            params.update(gn(f"{pre}gn{j}", shape[3]))
        if stride != 1 or in_c != out_c:
            params[pre + "proj"] = conv((1, 1, in_c, out_c))
            params.update(gn(pre + "proj_gn", out_c))
    head = torch.empty((out_c, cfg.num_classes), device=device)
    params["head.w"] = head.normal_(0.0, 1.0 / math.sqrt(out_c),
                                    generator=gen)
    params["head.b"] = torch.zeros(cfg.num_classes, device=device)
    return params


def conv_layers(cfg: ModelConfig) -> list:
    """Number of convolutions of each policy layer: the stem 1, a block 2
    (basic) or 3 (bottleneck), one more with a projection."""
    per_block = 3 if _is_bottleneck(cfg) else 2
    return [1] + [per_block + (stride != 1 or in_c != out_c)
                  for _, stride, in_c, _, out_c in _blocks(cfg)]


def forward(params: dict, image: torch.Tensor, qflags,
            cfg: ModelConfig, quant: QuantConfig, hooks=None) -> torch.Tensor:
    """Logits (B, classes) of NHWC ``image``; ``qflags`` one flag per
    policy layer: the trainer's (policy_len,) float32 device tensor, read
    on the device by the quantizers (``fake_quant``), or host bools.
    ``hooks``: a ghost pass's
    ``repro_torch.dp.ghost.GhostHooks``, whose ``qconv2d`` then runs every
    conv and whose ``leaf`` hands out the GroupNorm and head params."""
    if len(qflags) != cfg.policy_len():
        raise ValueError(f"{len(qflags)} flags for {cfg.policy_len()} layers")
    p = params
    bottleneck = _is_bottleneck(cfg)
    conv = qconv2d if hooks is None else hooks.qconv2d
    n = image.shape[0]

    def leaf(name):
        return p[name] if hooks is None else hooks.leaf(name, p[name], n)

    def qc(x, w, flag, seed, stride=1):
        return conv(x, w, seed=seed, flag=flag, stride=stride,
                    fmt=quant.fmt, q_fwd=quant.quantize_fwd,
                    q_dgrad=quant.quantize_dgrad,
                    q_wgrad=quant.quantize_wgrad, backend=quant.backend)

    def gn(x, prefix):
        return cm.groupnorm(x, leaf(prefix + ".scale"), leaf(prefix + ".bias"))

    x = image.permute(0, 3, 1, 2)
    x = torch.relu(gn(qc(x, p["stem.conv"], qflags[0], 0), "stem.gn"))
    for li, (pre, stride, _, _, _) in enumerate(_blocks(cfg), 1):
        flag, sd = qflags[li], 11 * li
        if bottleneck:
            h = torch.relu(gn(qc(x, p[pre + "conv1"], flag, sd),
                              pre + "gn1"))
            h = torch.relu(gn(qc(h, p[pre + "conv2"], flag, sd + 1, stride),
                              pre + "gn2"))
            h = gn(qc(h, p[pre + "conv3"], flag, sd + 2), pre + "gn3")
        else:
            h = torch.relu(gn(qc(x, p[pre + "conv1"], flag, sd, stride),
                              pre + "gn1"))
            h = gn(qc(h, p[pre + "conv2"], flag, sd + 1), pre + "gn2")
        shortcut = x
        if pre + "proj" in p:
            shortcut = gn(qc(x, p[pre + "proj"], flag, sd + 3, stride),
                          pre + "proj_gn")
        x = torch.relu(h + shortcut)
    x = x.mean(dim=(2, 3))
    return cm.dense_head(x, leaf("head.w"), leaf("head.b"))


def loss_fn(params, batch, qflags, cfg: ModelConfig, quant: QuantConfig,
            per_example: bool = False, hooks=None):
    """Mean (or per-example) cross-entropy of ``batch`` = {"image" NHWC,
    "label"}.  The JAX package's ``loss_fn`` also takes an rng, which it
    deletes; the port leaves it out.  ``hooks``: as in ``forward``."""
    logits = forward(params, batch["image"], qflags, cfg, quant, hooks)
    return cm.softmax_xent(logits, batch["label"], per_example=per_example)


def conv_ghost_mask(params: dict) -> dict:
    """Ghost hooks cover every conv kernel (stem, blocks, projections): a
    leaf whose last name component starts with ``conv`` or is ``proj``.
    The GroupNorm scales and biases and the dense head take the norm-only
    fallback.  Shared by the resnet and densenet families, as in the JAX
    package."""
    def hooked(name: str) -> bool:
        last = name.rsplit(".", 1)[-1]
        return last.startswith("conv") or last == "proj"
    return {k: hooked(k) for k in params}


@register_family("resnet")
def build_resnet(cfg: ModelConfig, quant: QuantConfig, device) -> Model:
    return Model(
        config=cfg, quant=quant, device=device,
        init=functools.partial(init_params, cfg=cfg, device=device),
        prepare=lambda params: params,
        forward=functools.partial(forward, cfg=cfg, quant=quant),
        loss_fn=functools.partial(loss_fn, cfg=cfg, quant=quant),
        per_example_loss=functools.partial(loss_fn, cfg=cfg, quant=quant,
                                           per_example=True),
        ghost_mask=conv_ghost_mask,
    )
