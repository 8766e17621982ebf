"""Training CLI: DP-SGD under the DPQuant scheduler.

    # ResNet-18 (full config) on the GPU: LUQ-FP4 convs through the
    # luq_quant kernel, the fused per-example clip through per_sample_clip
    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet18 \\
        --mode dpquant --fmt luq_fp4 --backend cuda --clip-backend fused

    # stablelm-3b (full config) in ghost mode on the GPU: LUQ-FP4
    # projections, per-example norms through the ghost_norm kernel
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
        --mode dpquant --fmt luq_fp4 --backend cuda --grad-mode ghost \\
        --clip-backend ref --ghost-microbatch 4 --batch 8 --seq-len 256

    # at smoke size on the CPU (the kernels' plain versions)
    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet18 \\
        --smoke --device cpu --epochs 2 --steps-per-epoch 3 --batch 8 \\
        --microbatch 8 --dataset-size 256
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
        --smoke --device cpu --grad-mode ghost --batch 4 \\
        --ghost-microbatch 2 --seq-len 16

    # the per-step executor, e.g. against the default scan executor
    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet18 \
        --smoke --device cpu --executor loop

    # ResNet-50 and DenseNet-121 (full configs) the same way
    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet50 \
        --mode dpquant --fmt luq_fp4 --backend cuda --clip-backend fused \
        --batch 256 --microbatch 64

    # a CNN in ghost mode: the conv taps' per-example norms, no
    # per-example gradient of a conv (pass 1 in chunks of 64 images)
    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet18 \
        --mode dpquant --fmt luq_fp4 --backend cuda --grad-mode ghost \
        --clip-backend ref --ghost-microbatch 64 --batch 256 --microbatch 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch densenet121 \
        --smoke --device cpu --grad-mode ghost --batch 8 --microbatch 8 \
        --ghost-microbatch 4 --epochs 2 --steps-per-epoch 3 \
        --dataset-size 256

    # BERT-SNLI (the paper's NLP experiment, DP-AdamW) and Mamba-2-130m,
    # whole, on the GPU; at smoke size on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch bert-snli \
        --mode dpquant --fmt luq_fp4 --backend cuda --clip-backend fused \
        --optimizer adamw --lr 1e-3 --batch 256 --microbatch 16 \
        --seq-len 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --mode dpquant --fmt luq_fp4 --backend cuda --clip-backend fused \
        --batch 32 --microbatch 8 --seq-len 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch bert-snli \
        --smoke --device cpu --optimizer adamw --lr 1e-3 --batch 8 \
        --microbatch 4 --seq-len 32 --epochs 2 --steps-per-epoch 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --smoke --device cpu --batch 4 --microbatch 2 --seq-len 24 \
        --epochs 2 --steps-per-epoch 2

    # RecurrentGemma-9B (vmap mode; the workload cuts the depth to 5
    # layers, launch/workload.py) and InternVL2-1B whole, at smoke size
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch recurrentgemma-9b --smoke --device cpu --batch 4 \
        --microbatch 2 --seq-len 16 --epochs 2 --steps-per-epoch 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-1b \
        --smoke --device cpu --batch 4 --microbatch 2 --seq-len 16 \
        --epochs 2 --steps-per-epoch 2

    # whisper-medium (the encoder-decoder) whole on the GPU, and at smoke
    # size on the CPU: each sequence comes with Gaussian encoder frames
    # (enc_embeds), as many as its tokens
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch whisper-medium --mode dpquant --fmt luq_fp4 --backend cuda \
        --clip-backend fused --batch 32 --microbatch 4 --seq-len 448 \
        --epochs 3 --steps-per-epoch 2
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch whisper-medium --smoke --device cpu --batch 4 \
        --microbatch 2 --seq-len 16 --epochs 2 --steps-per-epoch 2

    # the MoE family (vmap mode: no ghost hooks in the reference) at smoke
    # size; on the GPU the workload cuts arctic-480b to 2 layers of 8
    # experts at full width (launch/workload.py, TRAIN_MOE_ARGV)
    PYTHONPATH=src python -m repro_torch.launch.train --arch arctic-480b \
        --smoke --device cpu --batch 4 --microbatch 2 --seq-len 16 \
        --epochs 2 --steps-per-epoch 2

    # data parallel: two ranks on the CPU (gloo), each with its block of
    # every batch, one all-reduce of the clipped sums a step; on a node
    # with one card a rank (NCCL), without --device cpu
    PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 2 \
        -m repro_torch.launch.train --arch stablelm-3b --smoke \
        --device cpu --grad-mode ghost --ghost-sharded on --executor loop \
        --batch 4 --ghost-microbatch 2 --seq-len 16

    # tensor parallel: two ranks on the CPU (gloo) each holding half of
    # every layer (heads, MLP columns, vocab rows; the MoE LMs' experts),
    # the same loss, epsilon and k as one process
    PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 2 \
        -m repro_torch.launch.train --arch stablelm-3b --smoke \
        --device cpu --grad-mode ghost --model-parallel 2 --executor loop \
        --batch 4 --ghost-microbatch 2 --seq-len 16

    # preempted at global step 2 (a mid-epoch checkpoint, exit 0), then
    # resumed bit for bit by the same command without --preempt-at
    PYTHONPATH=src python -m repro_torch.launch.train --arch resnet18 \
        --smoke --device cpu --checkpoint-dir /tmp/ck --preempt-at 2

The flags are those of ``repro.launch.train`` for these paths (the CNNs
and the dense LMs, in vmap or ghost mode; BERT, Mamba-2, the Griffin
hybrid, the VLM, the encoder-decoder and the MoE LMs in vmap mode), among them
``--executor scan|loop`` (default ``scan``: each epoch's steps replay one
CUDA graph of the train step a quantization policy), ``--epoch-chunk``,
``--epoch-unroll`` (1 only), ``--checkpoint-dir`` (a rerun restores the
latest checkpoint there and trains what is left of ``--epochs``, the
run's total), ``--preempt-at``, ``--handle-signals`` and
``--ghost-sharded``, plus ``--device`` (default
``cuda``; without a GPU the run raises unless ``--device cpu`` is given)
and ``--backend ref|cuda`` (default ``cuda``, the hand-written kernels;
``REPRO_QUANT_BACKEND`` overrides it).  Prints one line per
epoch, ``epoch e: loss=... eps=... k=... acc=...``, as the JAX CLI does
(``acc=None`` for an LM: it has no eval set).

Under ``python -m torch.distributed.run`` (``WORLD_SIZE`` in the
environment) each rank joins the process group (``launch.mesh``: NCCL
on CUDA, one card a rank, ``cuda:LOCAL_RANK``; gloo with ``--device
cpu``), the run trains on the host mesh ``(world / m, m)`` over
``("data", "model")``, ``m`` the ``--model-parallel`` degree (default
1: data parallel alone; above 1 the dense and MoE LMs only, every other
family raises), and rank 0 alone prints and writes checkpoints (whole
trees).

The reference's CLI cannot train the encoder-decoder: its
``make_dataset`` gives that family a ``TokenDataset``, whose batches hold
``tokens`` only, while the family's ``loss_fn`` reads
``batch["enc_embeds"]`` and ``build_train_setup`` shards the batch by a
``batch_spec`` that declares it, so the run stops at the batch's pytree
("symmetric difference on key sets is enc_embeds").  This CLI feeds the
family an ``EncDecDataset``: the same tokens with Gaussian frame
embeddings drawn per example from ``--seed``.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.config import (DPConfig, ModelConfig, OptimConfig,
                                QuantConfig, RunConfig, resolve_device)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.synthetic import (EncDecDataset, ImageClassDataset,
                                        NLIDataset, TokenDataset)
from repro_torch.launch.mesh import init_distributed, make_host_mesh
from repro_torch.runtime.faults import FaultEvent, FaultPlan
from repro_torch.runtime.preemption import Preempted, PreemptionHandler
from repro_torch.train_loop import Trainer

ARCHS = ("resnet18", "resnet50", "densenet121", "yi-6b", "gemma-7b",
         "stablelm-3b", "yi-9b", "bert-snli", "mamba2-130m",
         "recurrentgemma-9b", "internvl2-1b", "whisper-medium",
         "arctic-480b", "kimi-k2-1t-a32b")
CNN_FAMILIES = ("resnet", "densenet")
# the families with an eval set (class labels): the CNNs and BERT
CLASSIFIER_FAMILIES = CNN_FAMILIES + ("bert",)
EVAL_SIZE = 512


def make_dataset(cfg: ModelConfig, n: int, seq_len: int, seed: int = 0):
    if cfg.family in CNN_FAMILIES:
        return ImageClassDataset(n=n, num_classes=cfg.num_classes,
                                 image_size=cfg.image_size, seed=seed)
    if cfg.family == "bert":
        return NLIDataset(n=n, vocab=cfg.vocab_size, seq_len=seq_len,
                          num_classes=cfg.num_classes, seed=seed)
    if cfg.family in ("dense_lm", "moe_lm", "ssm", "hybrid", "vlm"):
        # a VLM batch carries no vision_embeds here, as in the JAX CLI;
        # its loss still leaves the vision prefix out
        return TokenDataset(n=n, vocab=cfg.vocab_size, seq_len=seq_len,
                            seed=seed)
    if cfg.family == "encdec":
        return EncDecDataset(n=n, vocab=cfg.vocab_size, seq_len=seq_len,
                             seed=seed, d_model=cfg.d_model)
    raise NotImplementedError(
        f"training the {cfg.family!r} family is not ported yet")


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
                    clip_backend=args.clip_backend,
                    grad_mode=args.grad_mode,
                    ghost_microbatch=args.ghost_microbatch,
                    ghost_sharded=args.ghost_sharded),
        optim=OptimConfig(name=args.optimizer, lr=args.lr),
        global_batch=args.batch, seq_len=args.seq_len,
        steps_per_epoch=args.steps_per_epoch,
        steps=args.epochs * args.steps_per_epoch, seed=args.seed,
        epoch_executor=args.executor, epoch_chunk=args.epoch_chunk,
        epoch_unroll=args.epoch_unroll, model_parallel=args.model_parallel)


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
    ap.add_argument("--grad-mode", default="vmap", choices=["vmap", "ghost"],
                    help="per-example gradient engine: vmap (materialized "
                         "per-example grads) or ghost (two-pass ghost-norm "
                         "clipping; dense LMs and CNNs)")
    ap.add_argument("--ghost-microbatch", type=int, default=0,
                    help="ghost pass-1 chunk size (0 = the whole batch)")
    ap.add_argument("--ghost-sharded", default="auto",
                    choices=["auto", "on", "off"],
                    help="data-parallel ghost driver: each rank runs both "
                         "passes on its block of the batch, one all-reduce "
                         "of the clipped sums (auto = when the mesh's data "
                         "axes have degree > 1)")
    ap.add_argument("--quant-fraction", type=float, default=0.9)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--steps-per-epoch", type=int, default=10)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--dataset-size", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "momentum", "adam", "adamw"])
    ap.add_argument("--clip-norm", type=float, default=1.0)
    ap.add_argument("--noise-multiplier", type=float, default=1.0)
    ap.add_argument("--eps", type=float, default=None,
                    help="stop when the privacy budget is reached")
    ap.add_argument("--microbatch", type=int, default=16)
    ap.add_argument("--executor", default="scan", choices=["scan", "loop"],
                    help="epoch executor: each epoch's steps as replays of "
                         "one CUDA graph of the step (default) or the "
                         "per-step eager loop")
    ap.add_argument("--epoch-chunk", type=int, default=0,
                    help="scan chunk size in steps (0 = whole epoch)")
    ap.add_argument("--epoch-unroll", type=int, default=1,
                    help="steps per loop iteration of the scan executor "
                         "(1 only)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--preempt-at", type=int, default=None,
                    help="inject a preemption at this global step: the "
                         "trainer writes a mid-epoch checkpoint and exits; "
                         "a rerun resumes bit-identically")
    ap.add_argument("--handle-signals", action="store_true",
                    help="checkpoint-and-exit on SIGTERM (scheduler "
                         "eviction notice) instead of dying mid-step")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="the host mesh's model axis degree under "
                         "torch.distributed.run (tensor and expert "
                         "parallelism; it must divide the world)")
    return ap.parse_args(argv)


def build_datasets(args, cfg: ModelConfig):
    """``(train, eval)`` datasets of the run: ``--dataset-size`` examples
    from ``--seed``, and, for a classification family (the CNNs, BERT),
    512 held-out examples from the next seed (an LM has no eval set, as
    in the JAX CLI)."""
    ds = make_dataset(cfg, args.dataset_size, args.seq_len, args.seed)
    ev = (make_dataset(cfg, EVAL_SIZE, args.seq_len, args.seed + 1)
          if cfg.family in CLASSIFIER_FAMILIES else None)
    return ds, ev


def main(argv=None):
    args = parse_args(argv)
    mp = build_run(args).model_parallel
    mesh = None
    if "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if mp < 1 or world % mp:
            raise ValueError(f"--model-parallel {mp} does not divide the "
                             f"world of {world} ranks")
        device = init_distributed(args.device)
        mesh = make_host_mesh(mp)
    else:
        if mp != 1:
            raise ValueError("--model-parallel above 1 needs ranks: run "
                             "under python -m torch.distributed.run")
        device = resolve_device(args.device)
    try:
        _train(args, device, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _train(args, device, mesh) -> None:
    lead = mesh is None or mesh.rank == 0     # the rank that prints
    # The configuration is float32: keep cuDNN's convolutions (and
    # cuBLAS's products) out of TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    run = build_run(args)
    ds, ev = build_datasets(args, run.model)
    handler = None
    if args.preempt_at is not None or args.handle_signals:
        plan = (FaultPlan([FaultEvent(kind="preempt", at=args.preempt_at)],
                          seed=args.seed)
                if args.preempt_at is not None else None)
        handler = PreemptionHandler(faults=plan,
                                    handle_signals=args.handle_signals)
    tr = Trainer(run, ds, eval_dataset=ev, mode=args.mode, device=device,
                 checkpoint_dir=args.checkpoint_dir, preemption=handler,
                 mesh=mesh)
    resumed = tr.restore_latest()
    if resumed is not None and lead:
        print(f"resumed from checkpoint at epoch {resumed}"
              + (" (mid-epoch)" if tr._mid_epoch is not None else ""))
    # --epochs is the run's *total* epoch count: train whatever is left
    # past the epoch cursor (a finished run is a clean no-op restart)
    remaining = max(0, args.epochs - tr._next_epoch)
    try:
        tr.train(remaining, eps_budget=args.eps, verbose=True)
    except Preempted as p:
        if lead:
            print(f"preempted at step {p.step}; checkpoint written — rerun "
                  "to resume")
        return
    finally:
        if tr.ckpt:
            tr.ckpt.wait()
    final = tr.history[-1]
    if lead:
        print(f"final: loss={final.loss:.4f} eps={final.eps:.3f} "
              f"acc={final.accuracy}")


if __name__ == "__main__":
    main()
