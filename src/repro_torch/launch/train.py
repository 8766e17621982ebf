"""Training CLI: DP-SGD under the DPQuant scheduler.

    # ResNet-18 (full config) on the GPU: LUQ-FP4 convs through the
    # luq_quant kernel, the fused per-example clip through per_sample_clip
    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet18 \\
        --mode dpquant --fmt luq_fp4 --backend cuda --clip-backend fused

    # at smoke size on the CPU (the kernels' plain versions)
    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet18 \\
        --smoke --device cpu --epochs 2 --steps-per-epoch 3 --batch 8 \\
        --microbatch 8 --dataset-size 256

The flags are those of ``repro.launch.train`` for this path (the ResNet
family, vmap DP), without the executor, checkpoint, preemption and
ghost-mode ones (the port has the per-step loop only, and the rest is not
ported yet), plus ``--device`` (default
``cuda``; without a GPU the run raises unless ``--device cpu`` is given)
and ``--backend ref|cuda`` (default ``cuda``, the hand-written kernels;
``REPRO_QUANT_BACKEND`` overrides it).  Prints one line per epoch,
``epoch e: loss=... eps=... k=... acc=...``, as the JAX CLI does.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.config import (DPConfig, ModelConfig, OptimConfig,
                                QuantConfig, RunConfig, resolve_device)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.synthetic import ImageClassDataset
from repro_torch.train_loop import Trainer

ARCHS = ("resnet18",)
EVAL_SIZE = 512


def make_dataset(cfg: ModelConfig, n: int, seed: int = 0):
    if cfg.family != "resnet":
        raise NotImplementedError(
            f"training the {cfg.family!r} family is not ported yet")
    return ImageClassDataset(n=n, num_classes=cfg.num_classes,
                             image_size=cfg.image_size, seed=seed)


def build_run(args) -> RunConfig:
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    return RunConfig(
        model=cfg,
        quant=QuantConfig(fmt=args.fmt, backend=args.backend),
        dp=DPConfig(enabled=not args.no_dp, clip_norm=args.clip_norm,
                    noise_multiplier=args.noise_multiplier,
                    microbatch_size=args.microbatch,
                    quant_fraction=args.quant_fraction,
                    clip_backend=args.clip_backend),
        optim=OptimConfig(name=args.optimizer, lr=args.lr),
        global_batch=args.batch, steps_per_epoch=args.steps_per_epoch,
        steps=args.epochs * args.steps_per_epoch, seed=args.seed)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-scale)")
    ap.add_argument("--mode", default="dpquant",
                    choices=["dpquant", "pls", "static"])
    ap.add_argument("--no-dp", action="store_true")
    ap.add_argument("--fmt", default="luq_fp4")
    ap.add_argument("--backend", default="cuda", choices=["ref", "cuda"],
                    help="quantizer backend (repro_torch.quant.backend); "
                         "REPRO_QUANT_BACKEND overrides")
    ap.add_argument("--clip-backend", default="ref", choices=["ref", "fused"],
                    help="per-example clip path: plain PyTorch or the "
                         "per_sample_clip kernel")
    ap.add_argument("--quant-fraction", type=float, default=0.9)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--steps-per-epoch", type=int, default=10)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--dataset-size", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "momentum", "adam", "adamw"])
    ap.add_argument("--clip-norm", type=float, default=1.0)
    ap.add_argument("--noise-multiplier", type=float, default=1.0)
    ap.add_argument("--eps", type=float, default=None,
                    help="stop when the privacy budget is reached")
    ap.add_argument("--microbatch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build_datasets(args, cfg: ModelConfig):
    """``(train, eval)`` datasets of the run: ``--dataset-size`` images
    from ``--seed``, and 512 held-out images from the next seed."""
    return (make_dataset(cfg, args.dataset_size, args.seed),
            make_dataset(cfg, EVAL_SIZE, args.seed + 1))


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    # The configuration is float32: keep cuDNN's convolutions (and
    # cuBLAS's products) out of TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    run = build_run(args)
    ds, ev = build_datasets(args, run.model)
    tr = Trainer(run, ds, eval_dataset=ev, mode=args.mode, device=device)
    tr.train(args.epochs, eps_budget=args.eps, verbose=True)
    final = tr.history[-1]
    print(f"final: loss={final.loss:.4f} eps={final.eps:.3f} "
          f"acc={final.accuracy}")


if __name__ == "__main__":
    main()
