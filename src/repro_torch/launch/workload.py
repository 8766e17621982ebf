"""The workloads that ``chip_smoke.py`` drives and ``profile_serve`` /
``profile_train`` profile.  One definition each, so they read the same run.

Serving: yi-6b at full size with a luq_fp4 logits head on the ``cuda``
backend, 4 slots of 1024 positions, 8 greedy requests with prompts of
64-512 tokens and 32 new tokens each.

Training: ResNet-18 at full width, DP-SGD under the DPQuant scheduler
with the options of ``launch.train --arch resnet18 --mode dpquant --fmt
luq_fp4 --backend cuda --clip-backend fused``: synthetic images (4096,
seed 0; 512 more for eval, seed 1), global batch 256 in microbatches of
64, sigma = C = 1, SGD at lr 0.5, quant_fraction 0.9, 3 epochs of 3
steps; the analysis runs in epochs 0 and 2 (interval 2; 10 probe runs x 2
reps at a probe batch of 64), and the policy is drawn anew every epoch.
The run is the one the CLI builds from ``TRAIN_ARGV``.

LM training: stablelm-3b at full size (32 layers, d_model 2560, untied
head, bf16 compute, float32 params), ghost-mode DP-SGD under the DPQuant
scheduler with the options of ``launch.train --arch stablelm-3b --mode
dpquant --fmt luq_fp4 --backend cuda --grad-mode ghost --clip-backend ref
--ghost-microbatch 4 --batch 8 --seq-len 256``: synthetic planted-bigram
tokens (4096 sequences, seed 0; no eval set), global batch 8 of 256
tokens, pass 1 in chunks of 4, sigma = C = 1, SGD at lr 0.5,
quant_fraction 0.9 (k = 29 of 32 layers), each block under remat (the
config's default), 3 epochs of 2 steps; the analysis runs in epochs 0
and 2 (33 probe runs x 2 reps at a probe batch of 8).  The run is the
one the CLI builds from ``TRAIN_LM_ARGV``.

The paper's other two CNNs, each at full width and depth under the
options of the ResNet-18 workload (``launch.train --arch <arch> --mode
dpquant --fmt luq_fp4 --backend cuda --clip-backend fused --batch 256
--microbatch 64``), 3 epochs of 2 steps, the analysis in epochs 0 and 2:
ResNet-50 (bottleneck blocks (3, 4, 6, 3), 23,588,459 parameters,
quant_fraction 0.9: k = 15 of 17 layers; 18 probe runs x 2 reps at a
probe batch of 64) from ``TRAIN_RESNET50_ARGV`` and DenseNet-121 (blocks
(6, 12, 24, 16), growth 32, 6,990,251 parameters, k = 56 of 62 layers,
the last of which quantizes no conv; 63 probe runs x 2 reps) from
``TRAIN_DENSENET121_ARGV``.

BERT-SNLI, the paper's NLP experiment, whole (12 layers, d_model 768, 12
heads, d_ff 3072, vocab 30,522, 128 positions, float32 compute;
136,825,347 parameters): DP-AdamW under the DPQuant scheduler with the
options of ``launch.train --arch bert-snli --mode dpquant --fmt luq_fp4
--backend cuda --clip-backend fused --optimizer adamw --lr 1e-3 --batch
256 --microbatch 16 --seq-len 128`` (``TRAIN_BERT_ARGV``): synthetic NLI
sequences (4096, seed 0; 512 more for eval, seed 1), sigma = C = 1,
quant_fraction 0.9 (k = 11 of 12 layers), 3 epochs of 2 steps, the
analysis in epochs 0 and 2 (13 probe runs x 2 reps at a probe batch of
32, two microbatches).  The CLI's default lr of 0.5 is an SGD rate;
every layer trains (neither CLI sets ``trainable_last_only``).  The
microbatch is 16, not 32: at 32 the probe graph's pool holds 45.9 GiB
(the per-example gradients, 16.3 GiB, stacked from the layers' pieces,
and the fused clip's ``torch.cat`` copy), and the epoch graph's eager
warm-up step (train batch 256 is another shape) needs as much again
beside it, beyond the card's 80 GB.

Mamba-2-130m, whole (24 layers, d_model 768, d_inner 1536, 24 SSD heads
of 64, state 128, chunk 256, bf16 compute, float32 params; 128,971,200
parameters): DP-SGD under the DPQuant scheduler with the options of
``launch.train --arch mamba2-130m --mode dpquant --fmt luq_fp4 --backend
cuda --clip-backend fused --batch 32 --microbatch 8 --seq-len 512``
(``TRAIN_MAMBA2_ARGV``): planted-bigram tokens (4096 sequences, seed 0;
no eval set), SGD at lr 0.5, sigma = C = 1, quant_fraction 0.9 (k = 22 of
24), 3 epochs of 2 steps, the analysis in epochs 0 and 2 (25 probe runs x
2 reps at a probe batch of 32).

Mamba-2-130m serving (``SERVE_MAMBA2_ARGV``, ``launch.serve --arch
mamba2-130m --engine oneshot``): a batch of 8 random prompts of 512
tokens from seed 0, 64 new tokens, greedy, bf16 compute, eager decode
steps (its logits are float32 einsums: no kernel of the port runs).

RecurrentGemma-9B training (``TRAIN_GRIFFIN_ARGV``, ``launch.train --arch
recurrentgemma-9b --mode dpquant --fmt luq_fp4 --backend cuda
--clip-backend fused --batch 8 --microbatch 1 --seq-len 256 --epochs 3
--steps-per-epoch 2``): the Griffin hybrid at full width (d_model 4096,
lru_width 4096, d_ff 12288, 16 heads of 256 over one KV head, vocab
256,000, window 2048, bf16 compute, float32 params) cut to
``TRAIN_GRIFFIN_LAYERS`` = 5 layers, which its callers pass to
:func:`setup` (no CLI flag: the argv alone trains all 38): one (rec,
rec, attn) superblock and the 2-layer recurrent tail the 9B has (38 =
12 x 3 + 2),
2,174,889,984 parameters.  The reference's hybrid has no ghost hooks, so
it trains in the vmap engine, where one example's gradient is a full
float32 copy of the parameters (the tied embedding alone 4.2 GB); 38
layers do not fit, and at 3 layers the scheduler's k = round(0.9 x 3) = 3
would quantize every layer every epoch.  At 5, k = 4.  Planted-bigram
tokens (4096 sequences, seed 0), SGD at lr 0.5, sigma = C = 1, the
analysis in epochs 0 and 2 (6 probe runs x 2 reps at a probe batch of 8:
microbatch 1 makes the probe batch the train batch's shape, so the probe
graph's capture needs no eager warm-up).  At 256 tokens the window does
not bite in training.

RecurrentGemma-9B serving (``SERVE_GRIFFIN_ARGV``, ``launch.serve --arch
recurrentgemma-9b --engine oneshot``), whole (38 layers, 9,396,195,328
parameters): 4 random prompts of 2,560 tokens (beyond the window: the
ring wraps in prefill), 32 new tokens, greedy, eager decode steps.

InternVL2-1B training (``TRAIN_VLM_ARGV``, ``launch.train --arch
internvl2-1b --mode dpquant --fmt luq_fp4 --backend cuda --clip-backend
fused --batch 32 --microbatch 8 --seq-len 512 --epochs 3
--steps-per-epoch 2``), whole (24 layers, d_model 896, 14 heads padded
to 16 over 2 KV heads, d_ff 4864, vocab 151,655 padded to 151,680, bf16
compute; 499,280,768 parameters): the first 256 predictions (the vision
prefix) masked; planted-bigram tokens and no vision embeddings in a
training batch, as in the reference's CLI; k = 22 of 24, the analysis in
epochs 0 and 2 (25 probe runs x 2 reps at a probe batch of 32).

InternVL2-1B serving (``SERVE_VLM_ARGV``, ``launch.serve --arch
internvl2-1b --engine oneshot --quant-fmt luq_fp4``): 8 prompts of 512
positions, the first 256 Gaussian ``vision_embeds`` (bf16, from the
seed), 32 new tokens, greedy, the logits head through ``luq_matmul``
(8 rows x 896 x 151,680, one shared key a step), eager decode steps.

whisper-medium training (``TRAIN_WHISPER_ARGV``, ``launch.train --arch
whisper-medium --mode dpquant --fmt luq_fp4 --backend cuda
--clip-backend fused --batch 32 --microbatch 4 --seq-len 448 --epochs 3
--steps-per-epoch 2``), whole (24 encoder and 24 decoder layers, d_model
1024, 16 heads of 64, d_ff 4096, vocab 51,865 padded to 51,968, bf16
compute, float32 params; 757,983,232 parameters): planted-bigram tokens
(4096 sequences, seed 0) of 448 positions, whisper's decoder context,
each with 448 Gaussian encoder frames (the reference ties the encoder's
length to the decoder's), SGD at lr 0.5, sigma = C = 1, k = 43 of 48
policy layers, the analysis in epochs 0 and 2 (49 probe runs x 2 reps at
a probe batch of 32).  No ghost hooks in the reference: the vmap engine,
one example's gradient a float32 copy of the parameters (3.03 GB); at
microbatch 8 the clip's copy of them does not fit beside the graphs.

whisper-medium serving (``SERVE_WHISPER_ARGV``, ``launch.serve --arch
whisper-medium --engine oneshot``): 8 random prompts of 384 tokens, each
with 384 Gaussian encoder frames (bf16, from the seed), 64 new tokens,
greedy, so the cache holds 448 positions; eager decode steps, float32
logits: no kernel of the port runs.

arctic-480b training (``TRAIN_MOE_ARGV``, ``launch.train --arch
arctic-480b --mode dpquant --fmt luq_fp4 --backend cuda --clip-backend
fused --batch 8 --microbatch 1 --seq-len 256 --quant-fraction 0.5
--epochs 3 --steps-per-epoch 2``): the MoE family at arctic's full
per-token width (d_model 7168, 56 heads padded to 64 over 8 KV heads of
128, expert d_ff 4864, top-2 at capacity factor 1.25, the dense residual
MLP of 7168, vocab 32,000, tied, bf16 params and compute) cut by
``TRAIN_MOE_CUT`` to 2 layers (of 35) of 8 experts (of 128), which its
callers pass to :func:`setup`: 2,475,576,320 parameters.  One layer's 128
experts hold 13.39 G parameters, and the vmap engine holds one example's
float32 gradient beside the weights, so not even one whole layer trains
on the card.  No ghost hooks in the reference: the vmap engine, one
example a microbatch.  quant_fraction 0.5: k = 1 of 2 (at 0.9 k would be
both layers and the scheduler would choose nothing).  Per sequence of 256
tokens an expert takes C = ceil(256 x 2 x 1.25 / 8) = 80 pairs against a
mean load of 64, so some pairs drop.  Planted-bigram tokens (4096
sequences, seed 0), SGD at lr 0.5, sigma = C = 1, the analysis in epochs 0
and 2 (3 probe runs x 2 reps at a probe batch of 8).

MoE serving (``SERVE_MOE_ARGV``, ``launch.serve --arch <arch> --engine
oneshot``) of one full layer with every published expert
(``SERVE_MOE_CUT``): arctic-480b (128 experts, top-2, 13,904,794,624
parameters; C = 10 a prompt of 512) and kimi-k2-1t-a32b (384 experts,
top-8, head_dim 112, vocab 163,840; 18,204,218,368 parameters; C = 14), 8
random prompts of 512 tokens, 32 new tokens, greedy, bf16, eager decode
steps, float32 logits: no kernel of the port runs.

The ResNet-18 and ResNet-50 workloads again in ghost mode
(``TRAIN_RESNET_GHOST_ARGV``, ``TRAIN_RESNET50_GHOST_ARGV``): the same
command lines with ``--grad-mode ghost --clip-backend ref
--ghost-microbatch 64`` in place of the fused clip, so pass 1 runs in
chunks of 64 images and pass 2 over the whole batch of 256; the probe
batch stays 64 (``--microbatch``).
"""
from __future__ import annotations

import numpy as np

ARCH = "yi-6b"
QUANT_FMT = "luq_fp4"
SEED = 0
SLOTS, MAX_SEQ = 4, 1024
REQUESTS, NEW_TOKENS = 8, 32
PROMPT_MIN, PROMPT_MAX = 64, 512


def prompts(vocab: int, seed: int = SEED) -> list[np.ndarray]:
    """The ``REQUESTS`` prompts, lengths uniform over the prompt range."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(PROMPT_MIN, PROMPT_MAX + 1, REQUESTS)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lengths]


TRAIN_ARCH = "resnet18"
TRAIN_BATCH, TRAIN_MICROBATCH = 256, 64
TRAIN_EPOCHS, TRAIN_STEPS = 3, 3
TRAIN_DATASET = 4096


def _cnn_argv(arch: str, epochs: int, steps: int) -> tuple:
    """The command line of a CNN training workload; the rest are the
    CLI's defaults (sigma = C = 1, SGD at lr 0.5, quant_fraction 0.9,
    seed 0)."""
    return ("--arch", arch, "--mode", "dpquant", "--fmt", "luq_fp4",
            "--backend", "cuda", "--clip-backend", "fused",
            "--batch", str(TRAIN_BATCH), "--microbatch", str(TRAIN_MICROBATCH),
            "--epochs", str(epochs), "--steps-per-epoch", str(steps),
            "--dataset-size", str(TRAIN_DATASET))


def _ghost(argv: tuple) -> tuple:
    """``argv`` in ghost mode: the plain clip (ghost mode forms no (B, D)
    matrix for the fused one), pass 1 in chunks of one microbatch."""
    i = argv.index("--clip-backend")
    return (argv[:i] + ("--clip-backend", "ref", "--grad-mode", "ghost",
                        "--ghost-microbatch", str(TRAIN_MICROBATCH))
            + argv[i + 2:])


TRAIN_ARGV = _cnn_argv(TRAIN_ARCH, TRAIN_EPOCHS, TRAIN_STEPS)
TRAIN_RESNET50_ARGV = _cnn_argv("resnet50", TRAIN_EPOCHS, 2)
TRAIN_DENSENET121_ARGV = _cnn_argv("densenet121", TRAIN_EPOCHS, 2)
TRAIN_RESNET_GHOST_ARGV = _ghost(TRAIN_ARGV)
TRAIN_RESNET50_GHOST_ARGV = _ghost(TRAIN_RESNET50_ARGV)

TRAIN_LM_ARCH = "stablelm-3b"
TRAIN_LM_BATCH, TRAIN_LM_SEQ, TRAIN_LM_CHUNK = 8, 256, 4
TRAIN_LM_EPOCHS, TRAIN_LM_STEPS = 3, 2
# --microbatch sets the probe batch: the trainer probes with
# max(microbatch, min(32, batch)) examples, as the JAX trainer does; ghost
# mode itself ignores it
TRAIN_LM_ARGV = (
    "--arch", TRAIN_LM_ARCH, "--mode", "dpquant", "--fmt", "luq_fp4",
    "--backend", "cuda", "--grad-mode", "ghost", "--clip-backend", "ref",
    "--ghost-microbatch", str(TRAIN_LM_CHUNK),
    "--batch", str(TRAIN_LM_BATCH), "--microbatch", str(TRAIN_LM_BATCH),
    "--seq-len", str(TRAIN_LM_SEQ),
    "--epochs", str(TRAIN_LM_EPOCHS), "--steps-per-epoch", str(TRAIN_LM_STEPS),
    "--dataset-size", str(TRAIN_DATASET))

TRAIN_BERT_EPOCHS, TRAIN_BERT_STEPS = 3, 2
TRAIN_BERT_MICROBATCH, TRAIN_BERT_SEQ = 16, 128
TRAIN_BERT_ARGV = (
    "--arch", "bert-snli", "--mode", "dpquant", "--fmt", "luq_fp4",
    "--backend", "cuda", "--clip-backend", "fused",
    "--optimizer", "adamw", "--lr", "1e-3",
    "--batch", "256", "--microbatch", str(TRAIN_BERT_MICROBATCH),
    "--seq-len", str(TRAIN_BERT_SEQ),
    "--epochs", str(TRAIN_BERT_EPOCHS),
    "--steps-per-epoch", str(TRAIN_BERT_STEPS),
    "--dataset-size", str(TRAIN_DATASET))

TRAIN_MAMBA2_EPOCHS, TRAIN_MAMBA2_STEPS = 3, 2
TRAIN_MAMBA2_MICROBATCH = 8
TRAIN_MAMBA2_ARGV = (
    "--arch", "mamba2-130m", "--mode", "dpquant", "--fmt", "luq_fp4",
    "--backend", "cuda", "--clip-backend", "fused",
    "--batch", "32", "--microbatch", str(TRAIN_MAMBA2_MICROBATCH),
    "--seq-len", "512",
    "--epochs", str(TRAIN_MAMBA2_EPOCHS),
    "--steps-per-epoch", str(TRAIN_MAMBA2_STEPS),
    "--dataset-size", str(TRAIN_DATASET))

SERVE_MAMBA2_ARGV = ("--arch", "mamba2-130m", "--engine", "oneshot",
                     "--batch", "8", "--prompt-len", "512", "--gen", "64",
                     "--seed", str(SEED))

TRAIN_GRIFFIN_EPOCHS, TRAIN_GRIFFIN_STEPS = 3, 2
TRAIN_GRIFFIN_MICROBATCH, TRAIN_GRIFFIN_SEQ = 1, 256
TRAIN_GRIFFIN_ARGV = (
    "--arch", "recurrentgemma-9b", "--mode", "dpquant", "--fmt", "luq_fp4",
    "--backend", "cuda", "--clip-backend", "fused",
    "--batch", "8", "--microbatch", str(TRAIN_GRIFFIN_MICROBATCH),
    "--seq-len", str(TRAIN_GRIFFIN_SEQ),
    "--epochs", str(TRAIN_GRIFFIN_EPOCHS),
    "--steps-per-epoch", str(TRAIN_GRIFFIN_STEPS),
    "--dataset-size", str(TRAIN_DATASET))
#: The depth ``TRAIN_GRIFFIN_ARGV`` trains at (width untouched)
TRAIN_GRIFFIN_LAYERS = 5

SERVE_GRIFFIN_ARGV = ("--arch", "recurrentgemma-9b", "--engine", "oneshot",
                      "--batch", "4", "--prompt-len", "2560", "--gen", "32",
                      "--seed", str(SEED))

TRAIN_VLM_EPOCHS, TRAIN_VLM_STEPS = 3, 2
TRAIN_VLM_MICROBATCH, TRAIN_VLM_SEQ = 8, 512
TRAIN_VLM_ARGV = (
    "--arch", "internvl2-1b", "--mode", "dpquant", "--fmt", "luq_fp4",
    "--backend", "cuda", "--clip-backend", "fused",
    "--batch", "32", "--microbatch", str(TRAIN_VLM_MICROBATCH),
    "--seq-len", str(TRAIN_VLM_SEQ),
    "--epochs", str(TRAIN_VLM_EPOCHS),
    "--steps-per-epoch", str(TRAIN_VLM_STEPS),
    "--dataset-size", str(TRAIN_DATASET))

SERVE_VLM_ARGV = ("--arch", "internvl2-1b", "--engine", "oneshot",
                  "--batch", "8", "--prompt-len", "512", "--gen", "32",
                  "--quant-fmt", "luq_fp4", "--backend", "cuda",
                  "--seed", str(SEED))

TRAIN_WHISPER_EPOCHS, TRAIN_WHISPER_STEPS = 3, 2
TRAIN_WHISPER_MICROBATCH, TRAIN_WHISPER_SEQ = 4, 448
TRAIN_WHISPER_ARGV = (
    "--arch", "whisper-medium", "--mode", "dpquant", "--fmt", "luq_fp4",
    "--backend", "cuda", "--clip-backend", "fused",
    "--batch", "32", "--microbatch", str(TRAIN_WHISPER_MICROBATCH),
    "--seq-len", str(TRAIN_WHISPER_SEQ),
    "--epochs", str(TRAIN_WHISPER_EPOCHS),
    "--steps-per-epoch", str(TRAIN_WHISPER_STEPS),
    "--dataset-size", str(TRAIN_DATASET))

SERVE_WHISPER_ARGV = ("--arch", "whisper-medium", "--engine", "oneshot",
                      "--batch", "8", "--prompt-len", "384", "--gen", "64",
                      "--seed", str(SEED))

TRAIN_MOE_EPOCHS, TRAIN_MOE_STEPS = 3, 2
TRAIN_MOE_MICROBATCH, TRAIN_MOE_SEQ = 1, 256
TRAIN_MOE_ARGV = (
    "--arch", "arctic-480b", "--mode", "dpquant", "--fmt", "luq_fp4",
    "--backend", "cuda", "--clip-backend", "fused",
    "--batch", "8", "--microbatch", str(TRAIN_MOE_MICROBATCH),
    "--seq-len", str(TRAIN_MOE_SEQ), "--quant-fraction", "0.5",
    "--epochs", str(TRAIN_MOE_EPOCHS),
    "--steps-per-epoch", str(TRAIN_MOE_STEPS),
    "--dataset-size", str(TRAIN_DATASET))
#: The cut ``TRAIN_MOE_ARGV`` trains at (every per-token width untouched)
TRAIN_MOE_CUT = {"n_layers": 2, "n_experts": 8}

MOE_SERVE_ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")
SERVE_MOE_ARGV = {arch: ("--arch", arch, "--engine", "oneshot",
                         "--batch", "8", "--prompt-len", "512",
                         "--gen", "32", "--seed", str(SEED))
                  for arch in MOE_SERVE_ARCHS}
#: One full layer with every published expert
SERVE_MOE_CUT = {"n_layers": 1}

#: The training workloads by name (``profile_train --workload``): each
#: its argv and the config fields it is cut to (none: the config's).
TRAIN_WORKLOADS = {"resnet": (TRAIN_ARGV, {}),
                   "resnet50": (TRAIN_RESNET50_ARGV, {}),
                   "densenet121": (TRAIN_DENSENET121_ARGV, {}),
                   "resnet-ghost": (TRAIN_RESNET_GHOST_ARGV, {}),
                   "resnet50-ghost": (TRAIN_RESNET50_GHOST_ARGV, {}),
                   "lm": (TRAIN_LM_ARGV, {}), "bert": (TRAIN_BERT_ARGV, {}),
                   "mamba2": (TRAIN_MAMBA2_ARGV, {}),
                   "griffin": (TRAIN_GRIFFIN_ARGV,
                               {"n_layers": TRAIN_GRIFFIN_LAYERS}),
                   "vlm": (TRAIN_VLM_ARGV, {}),
                   "whisper": (TRAIN_WHISPER_ARGV, {}),
                   "moe": (TRAIN_MOE_ARGV, TRAIN_MOE_CUT)}


def _cut(cfg, n_layers=None, **fields):
    """``cfg`` with ``fields`` replaced and cut to ``n_layers`` if given
    (an encoder-decoder: each of its two stacks)."""
    import dataclasses

    if n_layers is not None:
        fields["n_layers"] = n_layers
        if cfg.family == "encdec":
            fields.update(n_enc_layers=n_layers, n_dec_layers=n_layers)
    return dataclasses.replace(cfg, **fields) if fields else cfg


def setup(argv, n_layers=None, **cut) -> tuple:
    """``(run, dataset, eval_dataset)`` of the training workload of
    ``argv``, built by ``launch.train`` as the CLI builds them (the eval
    set is None for an LM), the model cut to ``n_layers`` if given (an
    encoder-decoder: each of its two stacks) and to the other config
    fields of ``cut`` (``n_experts=8``)."""
    import dataclasses

    from repro_torch.launch import train

    args = train.parse_args(list(argv))
    run = train.build_run(args)
    run = dataclasses.replace(run, model=_cut(run.model, n_layers, **cut))
    return (run, *train.build_datasets(args, run.model))


def train_setup():
    """The ResNet-18 training workload (``TRAIN_ARGV``)."""
    return setup(TRAIN_ARGV)


def train_lm_setup():
    """The LM training workload (``TRAIN_LM_ARGV``)."""
    return setup(TRAIN_LM_ARGV)


def serve_setup(argv, device=None, **cut) -> tuple:
    """``(model, params, batch, args)`` of the oneshot serving workload of
    ``argv``, built as ``launch.serve`` builds them: the model on
    ``device`` (default CUDA), cut to the config fields of ``cut``
    (``n_layers=1``), its params from ``--seed`` prepared for serving,
    the prompt batch on the device."""
    from repro_torch.launch import serve

    args = serve.parse_args(list(argv) + (["--device", device]
                                          if device else []))
    model, params = serve.build(args, **cut)
    return (model, model.prepare(params),
            serve.oneshot_batch(args, model), args)
