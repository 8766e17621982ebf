#!/usr/bin/env python3
"""Drive the PyTorch port's training and serving paths on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one Hopper GPU and nvcc.
It imports the port (``src/repro_torch``) and nothing of JAX, and:

1. prints the card (``nvidia-smi`` name and power limit) and versions;
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes of its path (ResNet-18, ResNet-50 and DenseNet-121 training:
   ``luq_quant`` and ``per_sample_clip``; ResNet-18 and ResNet-50 ghost
   training: ``luq_quant``, pass 2's rows the whole batch of 256;
   stablelm-3b ghost training:
   ``luq_quant`` and
   ``ghost_norm_sq``; BERT-SNLI and Mamba-2-130m training: ``luq_quant``
   at a weight and at per-example rows (Mamba-2's the SSD's gate
   operand) and ``per_sample_clip`` at their parameter counts (of the
   depth phases 10 and 14 train);
   RecurrentGemma-9B (cut to 5 layers), InternVL2-1B and whisper-medium
   (cut to 3 + 3 layers) training: ``luq_quant`` at an MLP weight and a
   microbatch's MLP hidden rows, ``per_sample_clip`` at their parameter
   counts (the Griffin's 2,174,889,984, the first row beyond 2^31
   elements); arctic-480b training (2 layers of 8 experts):
   ``luq_quant`` at an expert stack whole (8 x 7168 x 4864) and one
   example's dispatch buffer (8 x 80 x 7168), ``per_sample_clip`` at its
   2,475,576,320 parameters; yi-6b serving: the
   KV cache write, decode attention and the quantized matmul; InternVL2-1B
   serving: the quantized matmul, 8 rows x 896 x 151,680 against one
   shared key), and times kernel, plain version, the least
   time the card could take (``bound_ms``) and, where PyTorch computes
   the same function, that yardstick (``library_ms``; for the LUQ matmul
   and the ghost norm, ``torch.bmm`` of the bf16 LUQ codes with float32
   output, the float32 values' time beside it as ``library_f32_ms``);
   the decode logits head takes its per-row keys as the (R, 2) device
   tensor the decode graph builds, and must give the bits of the same
   keys passed from the host, in the kernel and in the plain version;
   for the wrappers that launch more than one kernel, and for the KV
   write, also each kernel's own device time from a ``torch.profiler``
   trace (``device_us``); the quantize op and the ghost norm also under
   a policy flag read from device memory: at 1 the same bits, at 0 the
   operand copied through (the ghost norm: the Grams of the operands
   themselves, within 1e-5 of float64), that pass-through timed against
   its bound (``pass_ms``, ``pass_bound_ms``);
4. trains ResNet-18 at full width (random init from a seed, synthetic
   data) with DP-SGD under the DPQuant scheduler through
   ``repro_torch.train_loop.Trainer``, with the options of
   ``repro_torch.launch.train --arch resnet18 --mode dpquant --fmt
   luq_fp4 --backend cuda --clip-backend fused``: 3 epochs x 3 steps of
   256 images in microbatches of 64, analysis in epochs 0 and 2 (10 probe
   runs x 2 reps at a probe batch of 64), under the default ``scan``
   executor: every epoch's steps replay one CUDA graph of the step and
   every probe step one graph of the probe step, each captured once
   after an eager warm-up step, the policy a device tensor the kernels
   read; every loss finite, k = 8 quantized layers each epoch, epsilon >
   0 and in the first two epochs that of commit 27090d7 (the policy as
   host bools), one capture of each graph, clip launches and quantizer
   launches of every layer in every step (a layer whose flag is 0
   copies its operands through), two
   kernels a quantize call; prints each epoch's median step (each
   chunk's wall over its steps), the capture seconds, the analysis wall,
   the peak memory and, over one more profiled epoch, the host's
   ``cudaLaunchKernel`` and ``cudaGraphLaunch`` calls;
   then, under deterministic cuDNN, DPQuant (quant fraction 0.5,
   softmax temperature 0, so the policy rotates) through the loop
   executor (eager steps and probes) and through the scan executor, as
   many epochs of 3 steps as the loop needs to draw a second policy
   (momentum, cosine schedule, sigma 1): params, momentum, losses,
   epsilon, the EMA scores and the policies bit for bit the same; the DP
   noise under the graph: replays at successive seeds draw what the loop
   draws at each seed, and differ from each other; and a step captured
   under one policy and replayed under another (every layer's flag
   changed) against an eager step under the second, bit for bit, in
   ResNet-18 and in stablelm-3b cut to 2 layers (ghost, bf16, remat);
   then the paper's other two CNNs at full width and depth the same way,
   3 epochs x 2 steps each (``TRAIN_RESNET50_ARGV``,
   ``TRAIN_DENSENET121_ARGV``): ResNet-50 (bottleneck blocks, 23,588,459
   parameters, k = 15 of 17) and DenseNet-121 (6,990,251 parameters, k =
   56 of 62; the reference's last policy layer quantizes no conv, and the
   quantizer's count follows it); the same checks, the parameter counts
   too, and each phase's wall;
   then preemption on the card: ResNet-50 under deterministic cuDNN, scan
   in chunks of 2, one epoch of 4 steps with its analysis, run
   uninterrupted, preempted at global step 2 by a ``FaultPlan`` (which
   must raise ``Preempted(2)`` after a mid-epoch checkpoint), and resumed
   from that checkpoint by a fresh ``Trainer`` and by the preempted one:
   params, optimizer state, per-step and epoch losses, epsilon, the
   accountant, the scheduler, the history and the sampler's and probe
   RNG's next draws bit for bit those of the uninterrupted run, and no
   probe launched in a resumed run;
   then ghost mode in the three CNNs (``cnn_ghost_vs_vmap``): ResNet-18,
   ResNet-50 and DenseNet-121 at full width and depth, 8 images, float32,
   every layer quantized; at fmt none and at an identity format the ghost
   pass-1 norms within rtol 1e-4 of the vmap engine's and the clipped
   sums within rtol 2e-4, atol 2e-5; at luq_fp4 the differences printed;
   no clip and no ``ghost_norm_sq`` launch; and pass 1 over a chunk of 64
   images timed with and without the norm-only fallback's per-example
   copies; then ResNet-18 and ResNet-50 trained in ghost mode
   (``TRAIN_RESNET_GHOST_ARGV``, ``TRAIN_RESNET50_GHOST_ARGV``: the vmap
   workloads with ``--grad-mode ghost --clip-backend ref
   --ghost-microbatch 64``), the same checks with the ghost passes'
   quantizer counts, no clip launch, epsilon equal to the vmap run's of
   this call, and their numbers printed beside the vmap runs'; and the
   ResNet-18 ghost step through loop and scan under deterministic cuDNN,
   bit for bit;
5. trains stablelm-3b at full size (32 layers, random init from a seed,
   synthetic tokens) with ghost-mode DP-SGD under the DPQuant scheduler,
   with the options of ``repro_torch.launch.train --arch stablelm-3b
   --mode dpquant --fmt luq_fp4 --backend cuda --grad-mode ghost
   --clip-backend ref --ghost-microbatch 4 --batch 8 --seq-len 256``, each
   block under remat: 3 epochs x 2 steps under ``scan``, analysis in
   epochs 0 and 2 (33 probe runs x 2 reps at a probe batch of 8), one
   graph of the step and one of the probe step; every loss finite, k =
   29 each epoch, epsilon and the first two policies those of commit
   27090d7, ``ghost_norm_sq`` launched for every layer in every step (at flag 0
   it takes the Grams of the operands themselves; replays and warm-ups
   counted as above), at most two kernels a quantize call, and no clip
   launch (ghost mode forms no (B, D) matrix); prints the same numbers
   as the CNNs'; then one epoch of 2 steps (SGD, cosine schedule)
   through both executors: bitwise the target, else the largest
   difference printed and the losses held at rtol 1e-3, epsilon and k
   exactly; then its memory and step with remat on and off at pass-1
   chunks of 4 (the losses within rtol 1e-3, bitwise printed), and with
   remat on a batch of 32 in one chunk under the graph and of 64 in
   eager steps, until one does not fit;
6. holds ghost mode against per-example gradients inside the real model:
   stablelm-3b at full width cut to 2 layers, in bf16 and in float32,
   every layer in LUQ-FP4 on the ``cuda`` backend, 4 sequences of 256
   tokens: inside the ghost pass the kernel against the unfused route
   (rtol 1e-4), and, example by example, the per-example norms of ghost
   pass 1 (``ghost_norm_sq`` launched) within rtol 1e-4 of the norms of
   the per-example gradients (in float32 also of the vmap engine's) and
   the clipped gradients within rtol 2e-4, atol 2e-5 (the JAX package's
   tolerances; ``ghost_vs_vmap`` says why example by example); and
   witnesses why a chunk of 4 gives other LUQ norms than one example at a
   time (``batch_shape_witness``): at fmt none and at an identity format
   the two agree within rtol 1e-4, and at luq_fp4 it counts, for every
   projection, the forward inputs and output cotangents that differ and
   the LUQ codes that flip;
7. serves yi-6b at full width and depth (random weights from a seed)
   through ``ContinuousEngine`` with the workload of
   ``repro_torch/launch/workload.py``: 4 slots, 8 requests, prompts of
   64-512 tokens, 32 new tokens, greedy, luq_fp4 logits head, once with an
   int8 and once with a luq_fp4 KV cache, on the ``cuda`` backend, the
   decode step replayed from its CUDA graph every tick and each bucket's
   prefill from its own (captured in a warm-up run); every request must
   finish with its 32 tokens, every kernel (the matmul at decode and at
   prefill) must have run, the KV write must have launched once a layer
   and decode tick (counted a replay) and once a prefill, the decode
   graph must have been replayed once a tick and the prefill graphs once
   an admission; prints the wall per tick and, over a profiled rerun,
   the host's launch calls per tick;
7b. serves the same requests at temperature 1.0 (seed 3, ``max_retries``
   5), int8 and luq_fp4 KV: fault-free; then under the supervisor with
   all five fault kinds (a prefill and a decode failure, slot poison, a
   frozen clock, a replica death seen through heartbeat files), every
   request ``ok`` and token-identical to the fault-free run, the counters
   the plan implies, decode graph replays equal to the ticks and the
   replayed prefix steps, prefill graph replays, prefill KV writes and
   prefill logits heads equal to the admissions; then pushed past the
   supervisor's slot-fault threshold into the oneshot drain,
   token-identical too; each bucket's prefill replay bitwise the eager
   prefill of the same padded prompt (the length as an int and as a
   device scalar); prints the three runs' walls, each bucket's capture
   seconds, one admission's host wall and launch calls eager against
   replay, and two witnesses over 16 positions of one request: the
   reference's replay (``prompt + prefix`` prefilled at once) against
   the fault-free tokens, and the B=1 lockstep decode's logits against
   the slot row's, bit for bit;
8. checks the engine (its graphed tick) against the oneshot driver for
   one request, token for token;
9. trains BERT-SNLI whole (12 layers, d_model 768, 136,806,915
   parameters, float32, random init from a seed, synthetic NLI data)
   with DP-AdamW under the DPQuant scheduler, the options of
   ``repro_torch.launch.train --arch bert-snli --mode dpquant --fmt
   luq_fp4 --backend cuda --clip-backend fused --optimizer adamw --lr
   1e-3 --batch 256 --microbatch 16 --seq-len 128`` (vmap engine): 3
   epochs x 2 steps under ``scan``, analysis in epochs 0 and 2; every
   loss finite, k = 11 of 12 each epoch, epsilon > 0 and equal to a host
   accountant charged with the run's steps and analyses as the trainer
   charges them, one capture of the epoch graph and one of the probe
   graph, the clip launched once a microbatch pass and the quantizer at
   every projection's six points in every pass (replays and warm-ups
   counted); prints each epoch's median step, the capture seconds, the
   analysis wall, the peak memory and the eval accuracy;
10. trains Mamba-2-130m at full width (d_model 768, bf16 compute,
   float32 params) cut to 6 of its 24 layers (61,218,480 parameters;
   whole, it left phase 16 no time: ``CUT_LAYERS``) the same way with
   DP-SGD, ``--arch mamba2-130m --batch 32 --microbatch 8 --seq-len
   512``: k = 5 of 6, the same checks (the SSD's two contractions
   quantize both operands per example);
11. serves Mamba-2-130m whole through the oneshot engine (``launch.serve
   --arch mamba2-130m --engine oneshot``: 8 random prompts of 512
   tokens, 64 new tokens, greedy, bf16, eager decode steps): the tokens'
   shape and range, no kernel of the port launched (the path has none);
   decode's logits against a prefill of the prompt extended by the
   decoded tokens over 3 steps, within 1e-2 of the largest logit in
   float32 at full depth and within 3e-2 in bf16 at full width cut to 2
   layers (decode runs the conv on bf16 weights, prefill on float32
   ones, as the reference does; at random init each layer amplifies
   that rounding difference, and the bf16 full-depth difference is
   printed); prints prefill ms and decode tokens/s;
12. trains RecurrentGemma-9B (the Griffin hybrid) at full width cut to 5
   layers (one (rec, rec, attn) superblock and the 2-layer recurrent
   tail; 2,174,889,984 parameters, bf16 compute) the way of phases 9-10,
   ``TRAIN_GRIFFIN_ARGV`` (``--batch 8 --microbatch 1 --seq-len 256``):
   k = 4 of 5, the same checks;
13. serves RecurrentGemma-9B whole (38 layers, 9,396,195,328 parameters)
   through the oneshot engine (``SERVE_GRIFFIN_ARGV``: 4 prompts of 2,560
   tokens, beyond the attention window of 2,048, 32 new tokens, greedy,
   bf16, eager decode steps): the tokens' shape and range, no kernel of
   the port launched; prints prefill ms, decode tokens/s and the peak
   memory; then in float32 at 5 layers (the first superblock and the
   tail) decode's logits against a prefill of the extended prompt within
   1e-2 of the largest logit, for a 64-token prompt in a cache of 96
   positions (32 steps; the ring of the window, which the reference sizes
   by the prompt) and for a 2,100-token prompt (8 steps past the window);
14. trains InternVL2-1B at full width cut to 6 of its 24 layers
   (226,749,824 parameters, bf16 compute; ``CUT_LAYERS``) the same
   way, ``TRAIN_VLM_ARGV`` (``--batch 32 --microbatch 8 --seq-len
   512``): k = 5 of 6, the same checks; and, with the
   trained params on 2 sequences with a Gaussian vision prefix, the
   masked prefix takes no part in the loss (the token ids under it change
   nothing, bit for bit; the loss within 1e-5 of the mean NLL of the
   unmasked predictions computed apart);
15. serves InternVL2-1B whole through the oneshot engine
   (``SERVE_VLM_ARGV``: 8 prompts of 512 positions, the first 256 a
   Gaussian vision prefix, 32 new tokens, greedy, the luq_fp4 logits head
   on the ``cuda`` backend): the tokens' shape and range, ``luq_matmul``
   launched at prefill and at every decode step; prints prefill ms and
   decode tokens/s; then in float32 with an exact head decode's logits
   against a prefill of the extended prompt (the same vision prefix),
   within 1e-2 of the largest logit;
16. trains whisper-medium at full width cut to 3 encoder and 3
   decoder layers (141,313,024 parameters, bf16 compute, float32 params;
   whole, it left phase 18 no time, and deeper phase 22 too little:
   ``WHISPER_CUT_LAYERS``) the way of phases 9-10, ``TRAIN_WHISPER_ARGV``
   (``--batch 32 --microbatch 4 --seq-len 448``: each sequence with 448
   Gaussian encoder frames, cast to bf16 on the card): k = 5 of 6, the
   same checks (each microbatch pass quantizes 48 projections, the
   cross-attention's K and V from the encoder's output per example);
   prints the host time of a batch's frames;
17. serves whisper-medium whole through the oneshot engine
   (``SERVE_WHISPER_ARGV``: 8 prompts of 384 tokens with 384 Gaussian
   encoder frames, 64 new tokens, greedy, bf16, eager decode steps): the
   parameter count, the cache's 448 rows, the tokens' shape and range, no
   kernel of the port launched; prints prefill ms, decode tokens/s and
   the peak memory; then in float32 at full depth decode's logits against
   a prefill of the extended prompt (the same encoder frames), within
   1e-2 of the largest logit;
18. data parallelism on the one card: two ranks of this script
   (``--dp-rank``) over gloo with CUDA tensors on a (2, 1) host mesh,
   the loop executor's step: (a) stablelm-3b at full width cut to 2
   layers (remat), ghost, 8 x 256 tokens, pass-1 chunks of 4: the
   sharded ghost driver (each rank 4 sequences, one all-reduce of the
   clipped sums) against rank 0's one-process driver: the metrics held
   at rtol 2e-4 / atol 2e-5 in float32 and bf16, at fmt none and
   luq_fp4; the sums at those tolerances in float32, and within the
   relative L2 limits of ``DP_SUM_LIMITS`` in bf16 at fmt none and
   luq_fp4, where a control with rank 1's quantizers keyed from another
   seed must fail the limit (``ghost_norm_sq`` and ``luq_quant`` launched
   on each rank for every layer, no clip); (b) ResNet-18 whole in the
   vmap engine, 256 images in global microbatches of 64 (32 a rank): the
   fused clip (launched once a local microbatch) with ``partial_accum``
   off and the plain clip with it on (fused with it raises), at fmt none
   and luq_fp4, against rank 0's one-process engine at the rank's
   microbatch of 32 (the metrics held as in (a), the sums at rtol 2e-4 /
   atol 2e-5 at fmt none and within their limit, with its control, at
   luq_fp4) and at 64 (printed); after one DP
   step of each workload through ``build_train_setup`` on the mesh the
   ranks' params are the same bits; each part's wall and the
   all-reduce's own time printed; (c) one rank under NCCL
   (``--nccl-capture``): a ``StepGraph`` around ``all_reduce_sum``,
   captured after the scan executor's warm-up (one collective, then the
   step), gives back its input bit for bit on each replay;
19. trains arctic-480b, the MoE family, at its full per-token width
   (d_model 7168, 64 padded heads over 8 KV heads, expert d_ff 4864,
   top-2 at capacity factor 1.25, the dense residual MLP, vocab 32,000,
   bf16) cut to 2 layers of 8 experts (``TRAIN_MOE_CUT``: 2,475,576,320
   parameters) the way of phases 9-10, ``TRAIN_MOE_ARGV`` (``--batch 8
   --microbatch 1 --seq-len 256 --quant-fraction 0.5``): k = 1 of 2, the
   same checks (each microbatch pass quantizes 20 projections); prints
   the dropped share of (token, slot) pairs of a training batch by layer
   (C = 80 a sequence against a mean load of 64); then, in float32 at the
   same cut with the capacity factor at E / k (nothing dropped), 8 decode
   steps after a prompt of 64 held against a prefill of the extended
   prompt within 1e-2 of the largest logit, and at the published factor
   the same gap printed, not held (the prompt's prefill drops pairs,
   one-token decode never does);
20. serves arctic-480b (128 experts, top-2) and kimi-k2-1t-a32b (384
   experts, top-8), one after the other, one full layer with every
   published expert (``SERVE_MOE_ARGV``, ``SERVE_MOE_CUT``: 8 prompts of
   512 tokens, 32 new tokens, greedy, bf16, eager decode steps): the
   parameter counts (13,904,794,624 and 18,204,218,368), the tokens'
   shape and range, no kernel of the port launched, the prefill's logits
   finite; prints prefill ms, decode tokens/s, a decode step's time
   against reading every expert's weights once (8.0 and 10.1 ms at the
   card's memory rate), the prefill's dropped share and the peak;
21. holds each workload of phases 4-20 against its roofline on the card:
   ResNet-18 vmap and ghost, stablelm-3b ghost, BERT-SNLI, Mamba-2,
   RecurrentGemma-9B, InternVL2-1B, whisper-medium and arctic-480b
   training, the yi-6b decode tick (both KV formats) and the MoE layers'
   decode steps, each at its phase's ``RunConfig`` and cut, are traced on
   the host (``repro_torch.launch.op_analysis`` on ``meta`` tensors, in
   ``ANALYSIS_WORKERS`` processes); prints each one's FLOPs by class,
   bytes, the roofline terms (``repro_torch.launch.roofline``), dominant
   term, ``bound_s``, model FLOPs and ``useful_ratio``, the wall its phase
   measured (the fastest epoch's median step, a replay of the decode
   graph, an eager MoE decode step), ``share = bound_s / wall`` and the
   trace's peak beside the phase's ``max_memory_allocated``; every share
   must be at most ``SHARE_LIMIT`` (1.05); a trace's kernel calls, on fake
   CUDA tensors and on ``meta`` ones, must be the launches of one eager
   step on the card (ResNet-18 vmap, stablelm-3b ghost at 2 layers, a
   yi-6b decode tick at 2 layers: all six kernels), and at full depth the
   tick's launches that the decode graph's capture ran; the phase's wall
   must stay under ``ROOFLINE_PHASE_S`` (90 s);
22. the model mesh axis on the one card: two ranks of this script
   (``--tp-rank``) over gloo with CUDA tensors on a (1, 2) host mesh
   over ``("data", "model")``, each holding its blocks of every layer
   (``TrainSetup.shard``; its parameter bytes the sum of its
   ``local_slice`` shapes), the loop executor's step: (c) the three
   kernels of the sharded step on a rank's shard at the phase's shapes
   (``luq_quant`` as ``luq_row_max``, an all-reduce MAX and
   ``luq_round`` under the shard's index map, on a stablelm-3b q weight
   split by heads, an arctic dispatch row split by experts and, for the
   element path, an MLP of 6,910 split in two: bitwise the plain version
   and the whole operand's slice; the split clip at the arctic cut's
   per-rank row: norms rtol 1e-5; ``ghost_norm_sq`` of a column- and a
   row-parallel tap, the ranks' parts within 1e-5 of sum |XX o GG| of
   the whole operands), timed on rank 0; (a) stablelm-3b at full width
   cut to 2 layers, ghost, 8 x 256 tokens, pass-1 chunks of 4, remat;
   (b) arctic-480b at full per-token width cut to 2 layers of 8 experts,
   4 a rank, vmap, 8 x 256 in microbatches of 1, the fused clip: the
   sharded step's clipped sums and metrics (``TrainSetup.grad_fn``)
   against the one-process step's, each rank holding its own blocks
   against its own one-process run, alone on the card after the sharded
   runs are freed: float32 at fmt none at rtol 2e-4 / atol 2e-5, bf16 at
   fmt none (22a) and luq_fp4 (in float32 too in 22a) within
   ``TP_SUM_LIMITS``, a control with
   rank 1's quantizers keyed from another seed beyond it, the metrics at
   rtol 2e-4 / atol 2e-5 in float32 and within the sums' limit
   otherwise; arctic's dropped share of (token, slot) pairs in a forward
   equal to the one-process forward's in every layer at fmt none in
   float32 (under LUQ a code the row-parallel sums' order flips moves
   the router's input: printed); (d) one DP step of each workload through
   ``build_train_setup`` on the mesh: the replicated leaves the same bits
   on both ranks, the update within ``TP_SUM_LIMITS`` of the one-process
   step's; prints each part's walls, both ranks' peaks and the
   one-process peak, the step wall and the count and bytes of the
   model-group all-reduces;
23. serving on the model axis, in phase 22's two ranks after their
   training checks: (a) the three serving kernels on a rank's shard at
   yi-6b's shapes, timed on rank 0 (``luq_matmul`` on the rank's 4096 x
   32000 of the 64000-column head, 4 rows with a key a row and 1 row:
   the whole head's columns bit for bit; ``decode_attn``'s two passes
   apart, int8 and luq_fp4, at 4 slots x 4 KV heads x 8, head_dim 128,
   each rank 512 of 1024 rows: merged over the ranks bit for bit the
   whole cache's output; ``kv_quant_write`` of a tick's rows and of a
   prompt's rows into a sequence shard: the held rows bitwise the whole
   cache's slice, the others untouched); (b) yi-6b at full width cut to
   ``TP_SERVE_LAYERS`` layers through ``ContinuousEngine`` on the mesh,
   eager (gloo), the luq_fp4 head on the cuda backend, the workload's 8
   greedy requests on 4 slots of 1024 positions with an int8 and a
   luq_fp4 cache, split by heads and then by rows (``kv_seq``, forced by
   a ``sharding_overrides`` rule): both ranks' tokens the same, the first
   prompt's logits and the tokens within ``TP_SERVE_LIMITS`` of rank 0's
   one-process engine, a control (rank 1's head keyed from another
   seed) beyond them, every logits head on a vocab shard and, split by
   rows, every KV write and attention on a sequence shard; (c)
   arctic-480b at phase 22b's cut, oneshot in float32: a prefill and 8
   decode steps against one process at rtol 2e-4 / atol 2e-5.

Every kernel row's ``bound_ms`` (and its side bounds) is
``repro_torch.launch.roofline.kernel_cost`` at the card's peaks, the
formulas the analysis costs each traced kernel call by.

Each phase prints its wall, and a ``phase walls`` line sums them up.  The
line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, and the
script exits non-zero; without a GPU, or without the repository around
it, it exits non-zero before printing a result.

Tolerances: KV caches bitwise (codes and scales, the rows not written
untouched), the same bits twice; LUQ values bitwise (the kernel's Philox
draws are the plain twin's words), the same bits twice; decode
attention atol = rtol = 1e-5 (float32, summed in another order), bit for
bit across two runs and between a slot alone and its row of the batch;
the quantized matmul within 1e-5 of the sum of absolute products per
output (its Philox draws are the plain twin's words, so the operands
agree bitwise and only the summation order differs), bit for bit across
two runs; the clip: norms rtol 1e-5, the sum within 1e-5 of sum_b
|scale_b g_bd| per column, bit for bit across two runs; the ghost norm
within 1e-5 of sum_ij |XX_ij GG_ij| per example (its bf16 codes times
alpha are the plain version's quantized operands bit for bit; the Grams
of the codes are summed in another order and scaled at the end), and bit
for bit across two runs.  TF32 is off everywhere (training, plain
versions, library calls).
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path


ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0                  # of the kernel checks' inputs


def kernel_bound(name: str, variant=None, sm_clock_mhz=None,
                 **shape) -> dict:
    """``{"bound_ms", "bound_by"}`` of kernel ``name`` at ``shape``: its
    least work by ``repro_torch.launch.roofline.kernel_cost`` at the
    card's peaks (at ``sm_clock_mhz``, the int32 work's clock)."""
    from repro_torch.launch import roofline
    clock = {} if sm_clock_mhz is None else {"sm_clock_mhz": sm_clock_mhz}
    ms, by = roofline.bound(roofline.kernel_cost(name, variant, **shape),
                            **clock)
    return {"bound_ms": ms, "bound_by": by}


def time_ms(torch, fn, reps: int) -> float:
    """Median time of ``fn`` on the card by CUDA events, after a warm-up,
    with the 50 MB L2 cache overwritten before each run."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_us(torch, fn, kernels, reps: int) -> dict:
    """{kernel: device microseconds a call} for each name in ``kernels``
    that ``fn`` launches, from a torch.profiler trace of ``reps`` runs,
    each after the L2 is overwritten as in ``time_ms``; None for a name
    the trace does not show."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    found = dict.fromkeys(kernels)
    for evt in prof.key_averages():
        for k in kernels:
            if k in evt.key:
                found[k] = float(evt.self_device_time_total) / reps
    return found


def _stale_kv_cache(torch, kvc, fmt, N0, N1, S, hd, gen):
    """K and V codes and scales (N0, N1, S, ...) full of stale values."""
    code_dtype, code_dim = kvc.code_spec(fmt, hd)
    codes = [torch.randint(-100, 100, (N0, N1, S, code_dim), device="cuda",
                           generator=gen).to(code_dtype) for _ in range(2)]
    scales = [(torch.rand(N0, N1, S, device="cuda", generator=gen) * 50)
              .to(kvc.SCALE_DTYPE) for _ in range(2)]
    return codes + scales


def check_kv_write(torch, ops, ref, kvc, fmt, n0, n1, t, s, hd, wpos,
                   reps=50):
    """The fused K+V cache write: bf16 K and V rows (n0, n1, t, hd) into
    whole caches (n0, n1, s, ...) of stale rows, at each slot's ``wpos``
    (decode: t = 1) or from row 0 (``wpos`` None: prefill).  Bitwise the
    plain version's caches (``kv_cache.kv_quant`` plus the index writes),
    the rows it does not write untouched, the same bits twice."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k = (torch.randn(n0, n1, t, hd, device="cuda", generator=gen) * 3)
    v = torch.randn(n0, n1, t, hd, device="cuda", generator=gen)
    k[0, 0, 0] = 0                                        # an all-zero row
    k, v = k.bfloat16(), v.bfloat16()
    if wpos is not None:
        wpos = torch.tensor(wpos, device="cuda").clamp(max=s - 1)
    cache = _stale_kv_cache(torch, kvc, fmt, n0, n1, s, hd, gen)
    stale = [c.clone() for c in cache]
    want = [c.clone() for c in cache]
    ops.kv_quant_write(k, v, *cache, fmt, wpos)
    ref.kv_quant_write_ref(k, v, *want, fmt, wpos)
    written = torch.zeros(n0, s, dtype=torch.bool, device="cuda")
    w = (torch.zeros(n0, dtype=torch.long, device="cuda") if wpos is None
         else wpos)
    for i in range(t):
        written[torch.arange(n0, device="cuda"), w + i] = True
    for got, exp, old in zip(cache, want, stale):
        if not torch.equal(got, exp):
            raise AssertionError(f"kv_quant_write[{fmt}] ({n0}, {n1}, {t}, "
                                 f"{hd}): the cache differs from the plain "
                                 "version's")
        if not torch.equal(exp.transpose(1, 2)[~written],
                           old.transpose(1, 2)[~written]):
            raise AssertionError(f"kv_quant_write[{fmt}]: a row it does not "
                                 "write changed")
    again = [c.clone() for c in stale]
    ops.kv_quant_write(k, v, *again, fmt, wpos)
    if not all(torch.equal(a, b) for a, b in zip(again, cache)):
        raise AssertionError(f"kv_quant_write[{fmt}]: two runs differ")
    shape = dict(rows=2 * n0 * n1 * t, head_dim=hd,
                 code_dim=cache[0].shape[-1], elem=k.element_size(),
                 slots=0 if wpos is None else n0)
    return {
        "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: ops.kv_quant_write(k, v, *cache, fmt,
                                                        wpos), reps),
        "plain_ms": time_ms(torch, lambda: ref.kv_quant_write_ref(
            k, v, *want, fmt, wpos), reps),
        **kernel_bound("kv_quant_write", **shape),
        "library_ms": None,
        "device_us": device_us(
            torch, lambda: ops.kv_quant_write(k, v, *cache, fmt, wpos),
            ("kv_quant_write_kernel",), reps),
    }


def check_decode_attn(torch, ops, ref, kvc, fmt, B, S, reps=50):
    KV, g, hd = 4, 8, 128
    pos_list = [63, 300, 700, S - 1]                      # ragged positions
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    kc, ks = kvc.kv_quant(fmt, torch.randn(B, KV, S, hd, device="cuda",
                                           generator=gen))
    vc, vs = kvc.kv_quant(fmt, torch.randn(B, KV, S, hd, device="cuda",
                                           generator=gen))
    for b, p in enumerate(pos_list):      # stale rows past pos: garbage
        kc[b, :, p + 1:] = 7
        ks[b, :, p + 1:] = 50.0
        vs[b, :, p + 1:] = 50.0
    q = torch.randn(B, KV * g, hd, device="cuda", generator=gen)
    pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
    args = (q, kc, vc, ks, vs, pos)
    kw = dict(fmt=fmt, n_kv=KV, scale=hd ** -0.5)
    out = ops.decode_attn_fused(*args, **kw)
    want = ref.decode_attn_ref(*args, **kw)
    err = (out - want).abs().max().item()
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    if not torch.equal(out, ops.decode_attn_fused(*args, **kw)):
        raise AssertionError(f"decode_attn_fused[{fmt}]: two runs differ")
    # batch invariance: each slot alone gives its row of the batch bit for
    # bit (the splits depend on row indices only), as the engine's parity
    # with the oneshot driver needs
    for b in range(B):
        one = [t[b:b + 1].contiguous() for t in args]
        if not torch.equal(ops.decode_attn_fused(*one, **kw)[0], out[b]):
            raise AssertionError(f"decode_attn_fused[{fmt}]: slot {b} alone "
                                 "differs from its row of the batch")
    # the yardstick: SDPA over the dequantized cache, the g query rows of
    # a kv head as its query length
    kd, vd = kvc.kv_dequant(fmt, kc, ks), kvc.kv_dequant(fmt, vc, vs)
    qd = q.reshape(B, KV, g, hd)
    mask = (torch.arange(S, device="cuda")[None, :] <= pos[:, None])
    mask = mask[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(qd, kd, vd, attn_mask=mask, scale=hd ** -0.5)
    torch.testing.assert_close(lib_out.reshape(B, KV * g, hd), want,
                               atol=1e-3, rtol=1e-3)
    shape = dict(batch=B, kv_heads=KV, group=g, head_dim=hd,
                 code_dim=kc.shape[-1],
                 live_rows=sum(p + 1 for p in pos_list))
    return {
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: ops.decode_attn_fused(*args, **kw), reps),
        "plain_ms": time_ms(torch, lambda: ref.decode_attn_ref(*args, **kw),
                            reps),
        **kernel_bound("decode_attn_fused", **shape),
        "library_ms": time_ms(torch, lambda: sdpa(qd, kd, vd, attn_mask=mask,
                                                  scale=hd ** -0.5), reps),
        "device_us": device_us(
            torch, lambda: ops.decode_attn_fused(*args, **kw),
            ("decode_attn_split_kernel", "decode_attn_merge_kernel"), reps),
    }


def check_luq_matmul(torch, ops, ref, folds, sm_clock_mhz, reps=10,
                     K=4096, N=64000, shared=False):
    """The logits head, (R, K) x (K, N) (yi-6b's 4096 x 64000 by default),
    drawing its uniforms with Philox from the logits head's keys, one key
    and one scale a row, the keys an (R, 2) device tensor built from the
    rows' folds as the graphs build them: at decode the slots' folds 2 pos
    + 1, at prefill one row with the fold 2 prompt_len.  ``shared``: the
    R rows quantized as one matrix (one scale) against the one key of
    ``folds[0]``, as a lockstep batch's prefill and decode quantize them
    (the VLM's head).  The plain version draws the same stream in
    PyTorch, b in column chunks; the kernel must agree within the
    tolerance and give the same bits twice; the device keys must give the
    bits of the same keys as a host list, in the kernel and in the plain
    version, and one row's device key the bits of its fold's shared key
    (the lockstep prefill's branch)."""
    from repro_torch.models.common import logits_key, logits_keys
    from repro_torch.quant import philox
    from repro_torch.quant.formats import luq_fp4, luq_fp4_codes

    R = len(folds)
    key_list = [logits_key(f) for f in folds[:1 if shared else R]]
    keys = (key_list[0] if shared else
            logits_keys(torch.tensor(folds, dtype=torch.int32, device="cuda")))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2 + (R > 1))
    a = torch.randn(R, K, device="cuda", generator=gen)
    b = torch.randn(K, N, device="cuda", generator=gen) / 64
    alpha_a = a.abs().amax() if shared else a.abs().amax(dim=1)
    alpha_b = b.abs().amax()
    args = (a, b, keys, alpha_a, alpha_b)
    out = ops.luq_matmul(*args)
    if not torch.equal(out, ops.luq_matmul(*args)):
        raise AssertionError(f"luq_matmul (R = {R}): two runs differ")
    want = ref.luq_matmul_keys_ref(*args)
    if not shared and not torch.equal(out, ops.luq_matmul(
            a, b, key_list, alpha_a, alpha_b)):
        raise AssertionError("luq_matmul: device keys and host keys give "
                             "other bits")
    if not shared and not torch.equal(want, ref.luq_matmul_keys_ref(
            a, b, key_list, alpha_a, alpha_b)):
        raise AssertionError("luq_matmul's plain version: device keys and "
                             "host keys give other bits")
    if R == 1 and not shared and not torch.equal(out, ops.luq_matmul(
            a, b, key_list[0], alpha_a.reshape(()), alpha_b)):
        raise AssertionError("luq_matmul: one row's device key and its "
                             "shared key give other bits")
    if shared:
        ua = philox.uniforms(key_list[0], 0, R * K, "cuda").reshape(R, K)
    else:
        ua = torch.stack([philox.uniforms(k, 0, K, "cuda") for k in key_list])
    aq = luq_fp4(a, ua, alpha_a.reshape(-1, 1))
    ca = luq_fp4_codes(a, ua, alpha_a.reshape(-1, 1))
    # Q(b) of each key's draw, in full (one GB each), and its bf16 codes
    # Q(b) / alpha_b: the tolerance and the yardsticks' operands
    bq, cb = [], []
    for k in key_list:
        ub = philox.uniforms(k, 1, K * N, "cuda").reshape(K, N)
        bq.append(luq_fp4(b, ub, alpha_b))
        cb.append(luq_fp4_codes(b, ub, alpha_b))
        del ub
    bq, cb = torch.stack(bq), torch.stack(cb)
    # the yardsticks, one batched product of operands quantized
    # beforehand: the bf16 codes with float32 sums and output, scaled at
    # the end (products of codes are exact), and the float32 values; a
    # shared key's rows are one batch entry
    if shared:
        aq3, ca3 = aq[None], ca[None]
    else:
        aq3, ca3 = aq[:, None, :], ca[:, None, :]
    scale = (alpha_a * alpha_b).reshape(-1, 1, 1)

    def rows(t):
        return t[0] if shared else t[:, 0]

    def codes_bmm():
        return scale * torch.bmm(ca3, cb, out_dtype=torch.float32)

    err = (out - want).abs().max().item()
    lib, lib32 = rows(codes_bmm()), rows(torch.bmm(aq3, bq))
    for i in range(R):
        tol = 1e-5 * (aq[i].abs() @ bq[0 if shared else i].abs()) + 1e-6
        for what, got in (("luq_matmul", out), ("the bf16 codes' bmm", lib),
                          ("the float32 bmm", lib32)):
            if not ((got[i] - want[i]).abs() <= tol).all():
                raise AssertionError(
                    f"{what} row {i} outside tolerance (max abs err "
                    f"{(got[i] - want[i]).abs().max().item()})")
    del lib, lib32
    shape = dict(rows=R, k=K, n=N, keys=len(key_list))
    result = {
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: ops.luq_matmul(*args), reps),
        "plain_ms": time_ms(torch, lambda: ref.luq_matmul_keys_ref(*args), 3),
        **kernel_bound("luq_matmul", sm_clock_mhz=sm_clock_mhz, **shape),
        # the previous design's convention: its uniforms read from memory
        "bound_uniforms_from_memory_ms": kernel_bound(
            "luq_matmul", "uniforms_from_memory", **shape)["bound_ms"],
        "library_ms": time_ms(torch, codes_bmm, reps),
        "library_f32_ms": time_ms(torch, lambda: torch.bmm(aq3, bq), reps),
    }
    del bq, cb
    return result


def _luq_edges(torch, x):
    """Mixes the rounding's edge values into every row of ``x`` in place:
    alpha = 4 (the values lie in [-3.5, 3.5]), exact levels 4 2^-k, one ulp
    of x's dtype below them, their negatives and zeros; with several rows,
    row 1 all zero (alpha = 0)."""
    levels = (4.0 * 2.0 ** -torch.arange(0, 9, device="cuda")).to(x.dtype)
    ints = torch.int32 if x.dtype == torch.float32 else torch.int16
    below = (levels.view(ints) - 1).view(x.dtype)         # positive: one ulp
    edges = torch.cat([levels, -levels, below, -below,
                       torch.zeros(4, device="cuda", dtype=x.dtype)])
    x[:, 0] = 4.0
    x[:, 1:1 + edges.numel()] = edges
    if x.shape[0] > 1:
        x[1] = 0.0


def check_luq_quant(torch, ops, ref, rows, n, dtype, sm_clock_mhz, reps=50):
    """The keyed LUQ-FP4 quantize op on (rows, n) in ``dtype``: the kernel
    takes each row's max and draws the key's Philox stream itself.  Edge
    values in every row and an all-zero row (one-row shapes: a second,
    all-zero call); bitwise the plain version, the same bits twice.  Under
    a policy flag read from device memory: at 1 the same bits, at 0 ``x``
    itself (and the codes ``x`` in bf16), bitwise the plain version; the
    pass-through timed against its bound, one read and one write."""
    from repro_torch.quant.fake_quant import stream_key
    key = stream_key(3 * 97 + 4, 4)         # a stablelm-3b layer-3 wgrad key
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = torch.randn(rows, n, device="cuda", generator=gen).clamp(-3.5, 3.5)
    x = x.to(dtype)
    _luq_edges(torch, x)
    out = ops.luq_quant(x, key)
    want = ref.luq_quant_ref(x, key)
    if not torch.equal(out, want):
        bad = (out != want).sum().item()
        raise AssertionError(f"luq_quant ({rows} x {n}, {dtype}): {bad} "
                             "values differ from the plain version")
    if not torch.equal(out, ops.luq_quant(x, key)):
        raise AssertionError(f"luq_quant ({rows} x {n}): two runs differ")
    zero = torch.zeros_like(x[:1])
    if rows == 1 and ops.luq_quant(zero, key).any():
        raise AssertionError("luq_quant of an all-zero row is not zero")
    on = torch.ones((), device="cuda")
    off = torch.zeros((), device="cuda")
    if not (torch.equal(ops.luq_quant(x, key, flag=on), out)
            and torch.equal(ops.luq_quant(x, key, flag=off), x)
            and torch.equal(ops.luq_quant(x, key, codes=True, flag=off),
                            ref.luq_quant_ref(x, key, True, off))
            and torch.equal(ops.luq_quant(x, key, codes=True, flag=on),
                            ops.luq_quant(x, key, codes=True))):
        raise AssertionError(f"luq_quant ({rows} x {n}, {dtype}): the flag "
                             "is not read as the plain version reads it")
    shape = dict(rows=rows, n=n, elem=x.element_size(),
                 sm_clock_mhz=sm_clock_mhz)
    return {
        "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: ops.luq_quant(x, key), reps),
        # the plain version five times: at the expert stack it takes half
        # a second a run, 27 s of the script at 50
        "plain_ms": time_ms(torch, lambda: ref.luq_quant_ref(x, key), 5),
        **kernel_bound("luq_quant", **shape),
        # the kernel's own passes: x read twice (the row max, the
        # rounding), the result written once
        "bound_three_passes_ms": kernel_bound(
            "luq_quant", "three_passes", **shape)["bound_ms"],
        # the first design's convention: float32 x and uniforms read, the
        # float32 result written
        "bound_float32_uniforms_ms": kernel_bound(
            "luq_quant", "float32_uniforms", **shape)["bound_ms"],
        "library_ms": None,
        "device_us": device_us(torch, lambda: ops.luq_quant(x, key),
                               ("luq_row_max_kernel", "luq_round_kernel"),
                               reps),
        # the layer's flag at 0: x copied through, read once, written once
        "pass_ms": time_ms(torch, lambda: ops.luq_quant(x, key, flag=off),
                           reps),
        "pass_bound_ms": kernel_bound("luq_quant", "pass",
                                      **shape)["bound_ms"],
        "pass_device_us": device_us(
            torch, lambda: ops.luq_quant(x, key, flag=off),
            ("luq_row_max_kernel", "luq_round_kernel"), reps),
    }


def _rows_product(torch, v, m):
    """``v @ m`` of (B,) and (B, D): one call, or one a column chunk of
    2^30 where D is beyond what one cuBLAS call takes."""
    if m.shape[1] < 2 ** 31 - 1:
        return v @ m
    return torch.cat([v @ m[:, c0:c0 + 2 ** 30]
                      for c0 in range(0, m.shape[1], 2 ** 30)])


def check_per_sample_clip(torch, ops, ref, B, D, reps=10):
    """Per-example clip and sum of (B, D) rows, with a zero row and a row
    whose norm is below C (given two rows); the yardstick is two PyTorch
    calls:
    ``torch.linalg.vector_norm(g, dim=1)``, then ``scale @ g`` (in
    column chunks of 2^30 beyond cuBLAS's 2^31 - 1 columns)."""
    C = 1.0
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    g = torch.randn(B, D, device="cuda", generator=gen) * 1e-3
    if B > 1:
        g[0] = 0.0
        g[1] *= 0.1 / g[1].norm()
    out, norms = ops.clip_and_sum(g, C)
    want, want_norms = ref.per_sample_clip_ref(g, C)
    # the norms in float64, a chunk of columns at a time: the float32
    # sums' rounding (the kernel's and the plain version's) against them
    sq64 = torch.zeros(B, dtype=torch.float64, device="cuda")
    step = (1 << 28) // B
    for c0 in range(0, D, step):
        sq64 += g[:, c0:c0 + step].double().square().sum(dim=1)
    norms64 = sq64.sqrt()
    norm_err = {
        "kernel": ((norms.double() - norms64).abs() / norms64.clamp(
            min=1e-30)).max().item(),
        "plain": ((want_norms.double() - norms64).abs() / norms64.clamp(
            min=1e-30)).max().item()}
    torch.testing.assert_close(norms, want_norms, rtol=1e-5, atol=0.0)
    scale = torch.clamp(C / torch.clamp(want_norms, min=1e-12), max=1.0)
    err = (out - want).abs()
    tol = 1e-5 * _rows_product(torch, scale, g.abs()) + 1e-12
    if not (err <= tol).all():
        raise AssertionError(f"clip_and_sum outside tolerance (max abs err "
                             f"{err.max().item()})")
    max_err = err.max().item()
    del err, tol
    again, again_norms = ops.clip_and_sum(g, C)
    if not (torch.equal(out, again) and torch.equal(norms, again_norms)):
        raise AssertionError("clip_and_sum: two runs differ")
    del again

    def two_calls():
        n = torch.linalg.vector_norm(g, dim=1)
        return _rows_product(
            torch, torch.clamp(C / torch.clamp(n, min=1e-12), max=1.0), g)

    lib = two_calls()
    torch.testing.assert_close(lib, want, rtol=1e-4, atol=1e-6)
    shape = dict(rows=B, n=D)
    return {
        "max_abs_err": max_err,
        "norm_rel_err_float64": norm_err,
        "ms": time_ms(torch, lambda: ops.clip_and_sum(g, C), reps),
        "plain_ms": time_ms(torch, lambda: ref.per_sample_clip_ref(g, C), reps),
        **kernel_bound("clip_and_sum", **shape),
        # the floor of any kernel taking a (B, D) matrix from device
        # memory: each clip factor needs its whole row's norm before a
        # column can be summed, and the matrix is far beyond the L2, so it
        # is read twice
        "bound_two_reads_ms": kernel_bound("clip_and_sum", "two_reads",
                                           **shape)["bound_ms"],
        "library_ms": time_ms(torch, two_calls, reps),
        "device_us": device_us(torch, lambda: ops.clip_and_sum(g, C),
                               ("row_sumsq_kernel", "column_sum_kernel"),
                               reps),
    }


def check_ghost_norm(torch, ops, ref, B, T, Dx, Dg, reps=20):
    """The ghost norm of B examples' (T, Dx) / (T, Dg) bf16 operands (the
    LM's compute dtype), with the rounding's edge values mixed in and an
    all-zero example (alpha = 0), quantized against the keys of a
    layer's wgrad folds 4 and 5; the yardstick is two ``torch.bmm`` Grams
    of the bf16 LUQ codes computed beforehand, with float32 sums and
    output (the kernel's arithmetic), then ``(alpha_x alpha_g)^2 (XX *
    GG).sum((1, 2))``; the same two Grams over float32 codes are timed
    beside it.  Under a policy flag read from device memory: at 1 the same
    bits; at 0 the norm of the unquantized bf16 operands, within 1e-5 of
    sum_ij |XX_ij GG_ij| of float64 Grams per example, timed against its
    bound (the operands read once, the Grams' products on the bf16 tensor
    cores)."""
    from repro_torch.quant.fake_quant import stream_key
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6 + Dg)
    x = torch.randn(B, T, Dx, device="cuda", generator=gen).clamp(-3.5, 3.5)
    g = torch.randn(B, T, Dg, device="cuda", generator=gen).clamp(-3.5, 3.5)
    g *= 1e-3
    x[:, 0, 0] = 4.0
    g[:, 0, 0] = 4e-3
    levels = 4.0 * 2.0 ** -torch.arange(0, 9, device="cuda")
    below = torch.nextafter(levels, torch.zeros_like(levels))
    edges = torch.cat([levels, -levels, below, -below,
                       torch.zeros(4, device="cuda")])
    x[:, 1, :edges.numel()] = edges
    g[:, 1, :edges.numel()] = edges * 1e-3
    x[1] = 0.0                                        # an all-zero example
    x, g = x.bfloat16(), g.bfloat16()
    kx, kg = stream_key(97 * 3 + 4, 4), stream_key(97 * 3 + 4, 5)
    args = (x, g, kx, kg)
    out = ops.ghost_norm_sq(*args)
    again = ops.ghost_norm_sq(*args)
    if not torch.equal(out, again):
        raise AssertionError(f"ghost_norm_sq ({B}, {T}, {Dx}, {Dg}): two runs "
                             "differ")
    want = ref.ghost_norm_ref(*args)
    xq = ref.luq_quant_ref(x.reshape(B, -1), kx).reshape(x.shape).float()
    gq = ref.luq_quant_ref(g.reshape(B, -1), kg).reshape(g.shape).float()
    # the yardsticks' operands: the codes Q(v) / alpha, exact in bf16,
    # whose Grams cuBLAS sums exactly; the scales come in at the end
    cx = ref.luq_quant_ref(x.reshape(B, -1), kx, codes=True).reshape(x.shape)
    cg = ref.luq_quant_ref(g.reshape(B, -1), kg, codes=True).reshape(g.shape)
    cx32, cg32 = cx.float(), cg.float()
    ax = x.float().abs().amax(dim=(1, 2))
    ag = g.float().abs().amax(dim=(1, 2))
    scale2 = (ax * ag) ** 2

    def grams_bmm():
        xx = torch.bmm(cx, cx.transpose(1, 2), out_dtype=torch.float32)
        gg = torch.bmm(cg, cg.transpose(1, 2), out_dtype=torch.float32)
        return scale2 * (xx * gg).sum(dim=(1, 2))

    def grams_bmm_f32():
        xx = torch.bmm(cx32, cx32.transpose(1, 2))
        gg = torch.bmm(cg32, cg32.transpose(1, 2))
        return scale2 * (xx * gg).sum(dim=(1, 2))

    xx32 = torch.bmm(xq, xq.transpose(1, 2))
    gg32 = torch.bmm(gq, gq.transpose(1, 2))
    tol = 1e-5 * (xx32.abs() * gg32.abs()).sum(dim=(1, 2))
    # the plain version takes its Grams in float64: float32 sums of values
    # that all carry alpha's mantissa are biased; printed, not checked
    f32_err = ((xx32 * gg32).sum(dim=(1, 2)) - want).abs().max().item()
    del xx32, gg32
    err = (out - want).abs()
    if not (err <= tol).all() or out[1].item() != 0.0:
        raise AssertionError(f"ghost_norm_sq ({B}, {T}, {Dx}, {Dg}): "
                             f"{out.tolist()} against {want.tolist()} "
                             f"(tolerance {tol.tolist()})")
    for lib in (grams_bmm, grams_bmm_f32):
        torch.testing.assert_close(lib(), want, rtol=1e-5, atol=0.0)
    on = torch.ones((), device="cuda")
    off = torch.zeros((), device="cuda")
    if not torch.equal(ops.ghost_norm_sq(*args, on), out):
        raise AssertionError("ghost_norm_sq at flag 1 differs from no flag")
    passed = ops.ghost_norm_sq(*args, off)
    x64, g64 = x.double(), g.double()
    xx64 = x64 @ x64.transpose(1, 2)
    gg64 = g64 @ g64.transpose(1, 2)
    plain = (xx64 * gg64).sum(dim=(1, 2))
    pass_tol = 1e-5 * (xx64.abs() * gg64.abs()).sum(dim=(1, 2))
    pass_err = (passed.double() - plain).abs()
    del xx64, gg64, x64, g64
    if not (pass_err <= pass_tol).all() or passed[1].item() != 0.0:
        raise AssertionError(f"ghost_norm_sq at flag 0: {passed.tolist()} "
                             f"against {plain.tolist()}")
    shape = dict(batch=B, t=T, dx=Dx, dg=Dg, elem_x=x.element_size(),
                 elem_g=g.element_size())
    return {
        "max_abs_err": err.max().item(),
        "f32_values_err": f32_err,
        "ms": time_ms(torch, lambda: ops.ghost_norm_sq(*args), reps),
        "plain_ms": time_ms(torch, lambda: ref.ghost_norm_ref(*args), reps),
        **kernel_bound("ghost_norm_sq", **shape),
        # the convention of the other rows: both whole Grams in float32
        "bound_f32_full_grams_ms": kernel_bound(
            "ghost_norm_sq", "f32_full_grams", **shape)["bound_ms"],
        "library_ms": time_ms(torch, grams_bmm, reps),
        "library_f32_ms": time_ms(torch, grams_bmm_f32, reps),
        "device_us": device_us(
            torch, lambda: ops.ghost_norm_sq(*args),
            ("luq_row_max_kernel", "luq_round_kernel", "gram_tiles_kernel",
             "sum_partials_kernel"), reps),
        # the layer's flag at 0: the Grams of the operands themselves
        "pass_max_abs_err": pass_err.max().item(),
        "pass_ms": time_ms(torch, lambda: ops.ghost_norm_sq(*args, off),
                           reps),
        "pass_bound_ms": kernel_bound("ghost_norm_sq", "pass",
                                      **shape)["bound_ms"],
        "pass_device_us": device_us(
            torch, lambda: ops.ghost_norm_sq(*args, off),
            ("luq_row_max_kernel", "luq_round_kernel", "gram_tiles_kernel",
             "sum_partials_kernel"), reps),
    }


def host_calls(torch, fn) -> dict:
    """The host's kernel launch and graph launch calls while ``fn`` runs,
    ``{"cudaLaunchKernel": n, "cudaGraphLaunch": n}`` (every variant of
    each name), from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    calls = {"cudaLaunchKernel": 0, "cudaGraphLaunch": 0}
    for evt in prof.key_averages():
        for name in calls:
            if evt.key.startswith(name):
                calls[name] += evt.count
    return calls


# Phases 10 and 14 train Mamba-2-130m and InternVL2-1B at full width cut
# to CUT_LAYERS layers (k = 5 of 6): whole, their analyses (25 probe runs x
# 2 reps, twice) took 89 and 126 s of the script's 1,200 s on an H100,
# which whisper-medium's phase 16 (331 s there) needs.  Their profile_train
# workloads stay whole.
CUT_LAYERS = 6
# The parameter counts of BERT-SNLI whole and Mamba-2-130m cut (those of
# the JAX package's configs, eval_shape)
BERT_PARAMS = 136_806_915
MAMBA2_PARAMS = 61_218_480
# quantize calls of one row (the weights) and of rows (per example) that
# one microbatch's forward and backward make: BERT, 6 projections a layer
# x 12 layers, each 2 one-row and 4 row calls; Mamba-2, each layer's in
# and out projections (2 and 4 each) and the SSD's two contractions, both
# operands per example (6 row calls each)
BERT_PER_PASS = (12 * 6 * 2, 12 * 6 * 4)
MAMBA2_PER_PASS = (CUT_LAYERS * 2 * 2, CUT_LAYERS * (2 * 4 + 2 * 6))

# RecurrentGemma-9B whole and cut to 5 layers, InternVL2-1B cut to
# CUT_LAYERS (the JAX package's eval_shape)
GRIFFIN_PARAMS = 9_396_195_328
GRIFFIN_TRAIN_PARAMS = 2_174_889_984
VLM_PARAMS = 226_749_824
# quantize calls of one row and of rows a microbatch pass makes (2 and 4 a
# projection): the 5-layer Griffin, four recurrent layers of 5 mixer and
# 3 MLP projections and one attention layer of 4 and 3; InternVL2-1B,
# layers of 7
GRIFFIN_PER_PASS = (2 * 39, 4 * 39)
VLM_PER_PASS = (CUT_LAYERS * 7 * 2, CUT_LAYERS * 7 * 4)
# whisper-medium whole (the JAX package's eval_shape), served whole in
# phase 17.  Phase 16 trains it at full width cut to WHISPER_CUT_LAYERS
# encoder and as many decoder blocks (k = 5 of 6): whole, its two
# analyses of 98 probe replays made the phase 331 s and left phase 18 no
# room in the script's 1,200 s (it ran 1,176 s on an H100 80GB HBM3 at
# 700 W); at 12 + 12 (106-113 s), and at 6 + 6 (50.4 s, the script's
# phases 1,113 s), it left phase 22 too little.  Its profile_train workload stays whole.  Its projections a
# microbatch pass: encoder blocks of 6 (q, k, v, o, the MLP's two) and
# decoder blocks of 10 (self and cross q, k, v, o, the MLP's two), each 2
# one-row and 4 row calls (the cross K and V from the encoder's output,
# per example too)
WHISPER_PARAMS = 757_983_232
WHISPER_CUT_LAYERS = 3
WHISPER_TRAIN_PARAMS = 141_313_024
WHISPER_PER_PASS = (2 * WHISPER_CUT_LAYERS * (6 + 10),
                    4 * WHISPER_CUT_LAYERS * (6 + 10))

# arctic-480b at full per-token width cut to 2 layers of 8 experts
# (TRAIN_MOE_CUT: one layer's 128 experts and one example's float32
# gradient of them pass the card's 80 GB), trained in phase 19; served in
# phase 20 at one layer with every published expert, as kimi-k2-1t-a32b
# (the JAX package's eval_shape).  Ten projections a block (q, k, v, o,
# the experts' gate, up and down, the dense residual's three), each 2
# one-row and 4 row calls a microbatch pass
MOE_TRAIN_PARAMS = 2_475_576_320
MOE_SERVE_PARAMS = {"arctic-480b": 13_904_794_624,
                    "kimi-k2-1t-a32b": 18_204_218_368}
MOE_PER_PASS = (2 * 10 * 2, 4 * 10 * 2)
# phase 19's float32 decode against prefill: 8 tokens after a prompt of 64
MOE_DECODE_PROMPT, MOE_DECODE_STEPS = 64, 8

# Epsilon by epoch of each workload's run under commit 27090d7 (its
# chip_smoke.py, the policy host bools, the first two epochs): the
# accountant's events do not depend on the numerics, so they must not
# move
EARLIER_EPS = {"resnet18": [5.014532294663283, 5.059241537126444],
              "resnet50": [4.99962921384223, 5.029435375484336],
              "densenet121": [4.99962921384223, 5.029435375484336],
              "stablelm-3b": [3.19802284444497, 3.198049342859754]}
# stablelm-3b's policies under commit 27090d7, epochs 0 and 1: the LM's
# run is deterministic (the CNNs' are not: cuDNN's default algorithms),
# and a layer whose flag is 0 keeps its bits (the ghost tap's plain
# norm), so the probe losses, scores and policies do not move
EARLIER_LM_POLICIES = [
    [0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 12, 13, 14, 15, 16, 18, 19, 20, 21, 22,
     23, 24, 25, 26, 27, 28, 29, 30, 31],
    [0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
     23, 24, 25, 26, 27, 28, 29, 30, 31]]


def _epochs_of(torch, tr, epochs: int, name: str, want_k: int) -> dict:
    """Trains ``epochs`` epochs of ``tr``, printing each; checks every
    loss finite, k = ``want_k``, epsilon > 0 and the first epochs'
    epsilon those of commit 27090d7 (where that commit ran the workload);
    returns the run's numbers: policies,
    epsilon,
    analysis and capture seconds by epoch, each epoch's median step (its
    chunk walls over their steps), the captures."""
    import statistics
    policies, analysis_s, probe_capture_s, capture_s = [], [], [], []
    for _ in range(epochs):
        (stats,) = tr.train(1)[-1:]
        policies.append(list(tr.scheduler.current.layers))
        analysis_s.append(tr.last_analysis_s)
        probe_capture_s.append(tr.last_probe_capture_s)
        capture_s.append(tr.last_capture_s)
        print(f"epoch {stats.epoch}: loss={stats.loss:.4f} "
              f"eps={stats.eps:.3f} k={stats.quantized_layers} "
              f"acc={stats.accuracy} (loss {stats.loss!r}, eps "
              f"{stats.eps!r}, wall {stats.wall_s!r} s, analysis "
              f"{tr.last_analysis_s!r} s (probe graph warm-up and capture "
              f"{tr.last_probe_capture_s!r} s), epoch graph warm-up and "
              f"capture {tr.last_capture_s!r} s, layers {policies[-1]})",
              flush=True)
    torch.cuda.synchronize()
    steps = tr.run.steps_per_epoch
    walls = [t * 1e3 for t in tr.step_wall_s]
    medians = [statistics.median(walls[e * steps:(e + 1) * steps])
               for e in range(epochs)]
    eps = [s.eps for s in tr.history]
    for s in tr.history:
        if not math.isfinite(s.loss):
            raise AssertionError(f"{name} epoch {s.epoch}: loss {s.loss}")
        if s.quantized_layers != want_k:
            raise AssertionError(f"{name} epoch {s.epoch}: k = "
                                 f"{s.quantized_layers}, want {want_k}")
        if not s.eps > 0:
            raise AssertionError(f"{name} epoch {s.epoch}: eps = {s.eps}")
    earlier = EARLIER_EPS.get(tr.run.model.name, [])
    if eps[:len(earlier)] != earlier:
        raise AssertionError(f"{name}: epsilon {eps} moved from the "
                             f"{earlier} of commit 27090d7")
    captures = {"epoch": len(tr.epoch_fn.captured),
                "probe": len(tr.probe_fn.captured)}
    if captures != {"epoch": 1, "probe": 1}:
        raise AssertionError(f"{name}: captures {captures} over policies "
                             f"{policies}, want one of each")
    warmups = {"epoch": tr.epoch_fn.warmups, "probe": tr.probe_fn.warmups}
    return {"policies": policies, "eps": eps, "analysis_s": analysis_s,
            "probe_capture_s": probe_capture_s, "capture_s": capture_s,
            "median_step_ms_by_epoch": medians, "captures": captures,
            "warmups": warmups,
            "analyses": tr.scheduler.n_analyses,
            "distinct_policies": len({tuple(p) for p in policies})}


def train_cnn(torch, ops, wl, argv, want_k, want_params):
    """DP-SGD on a CNN under the DPQuant scheduler, the training workload
    of ``argv`` (``repro_torch/launch/workload.py``), vmap or ghost mode,
    under the scan executor: 3 epochs, the analysis in epochs 0 and 2, a
    new policy drawn every epoch, one CUDA graph of the train step and one
    of the probe step for all of them; returns the launch counts of the
    run and its summary (epsilon by epoch, each epoch's median step,
    images/s, analysis and capture seconds, captures, peak memory)."""
    from repro_torch.models import densenet, resnet
    from repro_torch.quant import backend as qbackend
    from repro_torch.train_loop import Trainer

    t_phase = time.perf_counter()
    run, ds, ev = wl.setup(argv)
    ghost = run.dp.grad_mode == "ghost"
    if (qbackend.get_quantizer("luq_fp4", "cuda")[1] != "cuda"
            or (not ghost and qbackend.get_clip_sum("fused")[1] != "cuda")):
        raise AssertionError("the quantizer or the fused clip does not run "
                             "on the cuda backend")
    if run.epoch_executor != "scan":
        raise AssertionError(f"the workload runs {run.epoch_executor!r}")
    cfg = run.model
    name = cfg.name + (" ghost" if ghost else "")
    batch, micro = run.global_batch, run.dp.microbatch_size
    steps = run.steps_per_epoch
    epochs = run.steps // steps
    tr = Trainer(run, ds, eval_dataset=ev, mode="dpquant", device="cuda")
    n_params = sum(t.numel() for t in tr.params.values())
    print(f"{name}: {n_params} params, {cfg.policy_len()} policy layers; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    if n_params != want_params:
        raise AssertionError(f"{name}: {n_params} params, want {want_params}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = _epochs_of(torch, tr, epochs, name, want_k)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(ops.LAUNCHES)
    launches.update({f"luq_quant[{k}]": v
                     for k, v in ops.LUQ_QUANT_LAUNCHES.items()})
    med = out["median_step_ms_by_epoch"]
    replays = tr.epoch_fn._graph.replays
    probe_replays = tr.probe_fn._graph.replays
    flags = tr.scheduler.current.flags()
    calls = host_calls(torch,
                       lambda: tr._train_steps_scan(tr._set_flags(flags)))
    print(f"train {name} (scan): {epochs} epochs x {steps} steps of "
          f"{batch} images: median step by epoch {med!r} ms (chunk walls "
          f"over their steps: {[t * 1e3 for t in tr.step_wall_s]}), "
          f"{batch / med[-1] * 1e3!r} images/s in the last epoch, analysis "
          f"by epoch {out['analysis_s']!r} s (probe graph warm-up and "
          f"capture {out['probe_capture_s']!r} s), epoch graph warm-up and "
          f"capture by epoch {out['capture_s']!r} s; captures "
          f"{out['captures']} for {out['distinct_policies']} policies "
          f"({replays} epoch and {probe_replays} probe replays), wall "
          f"{wall!r} s, peak device memory {peak!r} GiB, launches (replays "
          f"counted) {launches}; host calls over one more epoch of {steps} "
          f"steps (profiled, after the checks' counts): {calls}")

    # every step runs every conv's quantize points whatever the policy
    # (a layer whose flag is 0 copies its operands through): the train
    # steps, the probe steps (one probe batch of max(micro, min(32,
    # batch)) examples; one run for the baseline and one per layer, x
    # reps, each analysis) and the captures' eager warm-up steps
    probe_batch = max(micro, min(run.dp.analysis_batch_size, batch))
    probe_steps = (out["analyses"] * (len(tr.scheduler.policies) + 1)
                   * run.dp.analysis_reps)

    def units(n):
        """The conv passes a step over ``n`` examples makes: one per
        microbatch in vmap mode; in ghost mode one per pass-1 chunk and
        pass 2."""
        if not ghost:
            return n // micro
        chunk = run.dp.ghost_microbatch
        return (n // chunk if 0 < chunk < n else 1) + 1

    passes = ((epochs * steps + out["warmups"]["epoch"]) * units(batch)
              + (probe_steps + out["warmups"]["probe"]) * units(probe_batch))
    want_clip = 0 if ghost else passes
    if launches["clip_and_sum"] != want_clip:
        raise AssertionError(f"clip_and_sum launched "
                             f"{launches['clip_and_sum']} times, want "
                             f"{want_clip}")
    if ghost and launches.get("ghost_norm_sq", 0):
        raise AssertionError(f"ghost_norm_sq launched "
                             f"{launches['ghost_norm_sq']} times in a CNN")
    # a conv pass quantizes the weight for the forward and the dgrad (one
    # row each) and x and the cotangent per example for the forward, dgrad
    # and wgrad (ghost pass 1: the tap's wgrad operands) (four calls of
    # rows); the stem's input, the images, needs no gradient, so it skips
    # the dgrad's two; DenseNet's last policy layer has no conv; two
    # kernels a call
    convs = sum({"resnet": resnet, "densenet": densenet}[cfg.family]
                .conv_layers(cfg))
    q_convs, q_stems = passes * convs, passes
    calls = 6 * q_convs - 2 * q_stems
    want_q = {"luq_quant": calls, "luq_quant[whole]": 2 * q_convs - q_stems,
              "luq_quant[per_example]": 4 * q_convs - q_stems,
              "luq_quant[kernels]": 2 * calls}
    for key, n in want_q.items():
        if launches[key] != n:
            raise AssertionError(f"{key} launched {launches[key]} times, "
                                 f"want {n} (policies {out['policies']})")
    print(f"{name} quantize calls {launches['luq_quant']}, kernel launches "
          f"{launches['luq_quant[kernels]']}, "
          f"{launches['luq_quant[kernels]'] / launches['luq_quant']} a call; "
          f"phase wall {time.perf_counter() - t_phase!r} s")
    summary = {**out, "images_per_s": batch / med[-1] * 1e3,
               "peak_gib": peak}
    del tr
    _free(torch)
    return launches, summary


def _compare_runs(torch, a, b):
    """(bitwise, largest abs difference, its leaf) of two trees of
    tensors."""
    from torch.utils._pytree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        raise AssertionError(f"{len(la)} leaves against {len(lb)}")
    worst, where, same = 0.0, None, True
    for i, (x, y) in enumerate(zip(la, lb)):
        if torch.equal(x, y):
            continue
        same = False
        d = (x.float() - y.float()).abs().max().item()
        if where is None or d > worst:
            worst, where = d, i
    return same, worst, where


def check_noise_replays(torch, n):
    """The DP noise under the scan executor's graph: a step that returns
    its noise (n values) as the new params, run by ``EpochRunner`` at seeds
    5 and 6 (one replay each), then 7 and 8 (two replays in one call).
    Each replay's draw must be the eager draw of a generator seeded as the
    loop seeds it, and two successive replays must differ."""
    from repro_torch.dp.noise import add_gaussian_noise
    from repro_torch.launch.steps import (NOISE_SEED_OFFSET, EpochRunner,
                                          TrainSetup)
    gen = torch.Generator(device="cuda")

    def step_fn(params, opt_state, batch, seed, qflags, lr):
        if seed is not None:
            gen.manual_seed(NOISE_SEED_OFFSET + int(seed))
        zero = torch.zeros_like(params["w"])      # the noise alone
        noise = add_gaussian_noise({"w": zero}, clip_norm=1.0,
                                   noise_multiplier=1.0, batch_size=1,
                                   generator=gen)["w"]
        return {"w": noise}, opt_state, {"loss": noise.sum()}

    def eager(seed):
        g = torch.Generator(device="cuda")
        g.manual_seed(NOISE_SEED_OFFSET + seed)
        return torch.randn(n, generator=g, device="cuda")

    runner = EpochRunner(TrainSetup(step_fn, lambda p: (), gen), "cuda")
    params = {"w": torch.zeros(n, device="cuda")}
    x, lrs = torch.zeros(2, 1, device="cuda"), torch.zeros(2, device="cuda")
    draws = []
    for seed in (5, 6):
        params, _, _ = runner(params, (), {"x": x[:1]}, [seed], (), lrs[:1])
        draws.append(params["w"].clone())
        if not torch.equal(draws[-1], eager(seed)):
            raise AssertionError(f"the replay at seed {seed} did not draw "
                                 "the loop's noise")
    if torch.equal(draws[0], draws[1]):
        raise AssertionError("two successive replays drew the same noise")
    params, _, metrics = runner(params, (), {"x": x}, [7, 8], (), lrs)
    if not (torch.equal(params["w"], eager(8)) and metrics["loss"].tolist()
            == [eager(7).sum().item(), eager(8).sum().item()]):
        raise AssertionError("two replays in one call did not draw the "
                             "loop's noise")
    if len(runner.captured) != 1 or runner._graph.replays != 4:
        raise AssertionError(f"{len(runner.captured)} captures, "
                             f"{runner._graph.replays} replays")
    print(f"noise under the graph: replays at seeds 5, 6, 7, 8 each drew "
          f"the eager draw of their seed ({n} values), 5 and 6 differ in "
          f"{int((draws[0] != draws[1]).sum().item())} values")
    runner.close()


def loop_vs_scan(torch, setup_fn, name, optim, rtol=None, dpquant=None):
    """One epoch of ``setup_fn``'s workload (mode static: no probes) under
    ``optim`` with sigma 1, through the loop executor and through the scan
    executor, under deterministic cuDNN: params, optimizer state, losses
    and epsilon must agree bit for bit; with ``rtol``, when the params do
    not, the losses within ``rtol`` and epsilon and k exactly (printed).
    With ``dpquant`` (``DPConfig`` fields, e.g. a lower quant fraction and
    softmax temperature, so that the policies rotate): DPQuant, the
    analysis every second epoch from epoch 0 (the loop's eager probe
    steps, the scan's probe graph), a policy drawn each epoch, as many
    epochs as the loop trainer needs to draw a second policy (at most 4);
    then also the EMA scores and the policies bit for bit, and the scan
    trainer's one epoch graph and one probe graph for all of them."""
    import dataclasses
    from repro_torch.train_loop import Trainer
    run, ds, _ = setup_fn()
    epochs, mode = 1, "static"
    if dpquant is not None:
        epochs, mode = 4, "dpquant"
        run = dataclasses.replace(run, dp=dataclasses.replace(run.dp,
                                                              **dpquant))
    run = dataclasses.replace(run, optim=optim,
                              steps=epochs * run.steps_per_epoch)
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for executor in ("loop", "scan"):
            tr = Trainer(dataclasses.replace(run, epoch_executor=executor),
                         ds, mode=mode, device="cuda")
            policies = []
            while len(policies) < epochs:
                tr.train(1)
                policies.append(list(tr.scheduler.current.layers))
                if executor == "loop" and len({tuple(p) for p in
                                               policies}) > 1:
                    epochs = len(policies)      # the scan runs as many
            torch.cuda.synchronize()
            captures = (None if tr.epoch_fn is None else
                        (len(tr.epoch_fn.captured),
                         len(tr.probe_fn.captured)))
            out[executor] = ((tr.params, tr.opt_state), tr.history,
                             sorted(tr.step_wall_s), tr.last_capture_s,
                             tr.scheduler.scores.tolist(), policies, captures)
            del tr
            _free(torch)
    finally:
        torch.backends.cudnn.deterministic = False
    (state_l, hist_l, walls_l, _, scores_l, pol_l, _), \
        (state_s, hist_s, walls_s, cap, scores_s, pol_s, captures) = \
        out["loop"], out["scan"]
    same, worst, where = _compare_runs(torch, state_l, state_s)
    losses_l = [h.loss for h in hist_l]
    losses_s = [h.loss for h in hist_s]
    print(f"{name} loop vs scan ({epochs} x {run.steps_per_epoch} steps, "
          f"mode {mode}, {optim.name} {optim.schedule}, deterministic "
          f"cuDNN): params and optimizer state bitwise {same} (largest "
          f"difference {worst!r}, leaf {where}), losses {losses_l} / "
          f"{losses_s}, eps {hist_l[-1].eps!r} / {hist_s[-1].eps!r}, k "
          f"{hist_l[-1].quantized_layers} / {hist_s[-1].quantized_layers}, "
          f"EMA scores equal {scores_l == scores_s}, policies {pol_l} / "
          f"{pol_s}, scan captures (epoch, probe) {captures}; step walls "
          f"(ms) loop {[t * 1e3 for t in walls_l]} scan "
          f"{[t * 1e3 for t in walls_s]}, capture {cap!r} s")
    if [h.eps for h in hist_l] != [h.eps for h in hist_s] or \
            [h.quantized_layers for h in hist_l] != \
            [h.quantized_layers for h in hist_s]:
        raise AssertionError(f"{name}: epsilon or k differ")
    if mode == "dpquant":
        if scores_l != scores_s or pol_l != pol_s:
            raise AssertionError(f"{name}: the probe graph's scores "
                                 f"{scores_s} or policies {pol_s} are not "
                                 f"the eager probes' {scores_l} / {pol_l}")
        if len({tuple(p) for p in pol_s}) < 2 or captures != (1, 1):
            raise AssertionError(f"{name}: policies {pol_s}, captures "
                                 f"{captures}")
    if same and losses_l == losses_s:
        return
    if rtol is None:
        raise AssertionError(f"{name}: loop and scan differ (losses "
                             f"{losses_l} / {losses_s}, params by {worst})")
    import numpy as np
    np.testing.assert_allclose(losses_s, losses_l, rtol=rtol)


def check_policy_switch(torch, wl):
    """One graph for every policy, on the card: a step captured under
    policy A, then replayed under policy B from the same snapshot, against
    an eager step under B, bit for bit (deterministic cuDNN): ResNet-18 at
    full width (the vmap engine, the fused clip, ``luq_quant`` reading
    its flag) and stablelm-3b at full width cut to 2 layers (ghost mode,
    bf16, remat, ``ghost_norm_sq`` reading its flag).  A and B split the
    layers between them, so every layer changes its flag."""
    import dataclasses
    import numpy as np
    from repro_torch.launch.steps import EpochRunner, build_train_setup
    from repro_torch.models.registry import build_model

    found = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, setup_fn in (("resnet18", wl.train_setup),
                               ("stablelm-3b 2 layers", wl.train_lm_setup)):
            run, ds, _ = setup_fn()
            if name.startswith("stablelm"):
                run = dataclasses.replace(run, model=dataclasses.replace(
                    run.model, n_layers=2))
            model = build_model(run.model, run.quant, device="cuda")
            setup = build_train_setup(model, run)
            params = model.init(wl.SEED)
            opt = setup.opt_init_fn(params)
            n = run.model.policy_len()
            a = torch.tensor([float(i % 2 == 0) for i in range(n)],
                             device="cuda")
            b = 1.0 - a
            flat = ds.get(np.arange(run.global_batch))
            batches = {k: v[None].cuda() for k, v in flat.items()}
            lrs = torch.full((1,), 0.5, device="cuda")
            runner = EpochRunner(setup, "cuda", adopt=False)
            runner(params, opt, batches, [7], a, lrs)          # capture: A
            got_p, got_o, got_m = runner(params, opt, batches, [7], b, lrs)
            torch.cuda.synchronize()
            want_p, want_o, want_m = setup.step_fn(
                params, opt, {k: v[0] for k, v in batches.items()}, 7, b,
                lrs[0])
            same, worst, where = _compare_runs(torch, (got_p, got_o),
                                               (want_p, want_o))
            same_loss = got_m["loss"][0].item() == want_m["loss"].item()
            found[name] = {"bitwise": same and same_loss,
                           "captures": len(runner.captured),
                           "replays": runner._graph.replays}
            print(f"policy switch ({name}): captured under {a.tolist()}, "
                  f"replayed under {b.tolist()}: params and optimizer state "
                  f"bitwise the eager step's {same} (largest difference "
                  f"{worst!r}, leaf {where}), loss {got_m['loss'].tolist()} "
                  f"/ {want_m['loss'].item()!r}; {found[name]}", flush=True)
            if not (same and same_loss) or len(runner.captured) != 1:
                raise AssertionError(f"{name}: the replay under B is not "
                                     f"the eager step under B")
            runner.close()
            del runner, params, opt, got_p, got_o, want_p, want_o, model
            _free(torch)
    finally:
        torch.backends.cudnn.deterministic = False
    return found


def lm_remat(torch, ops, wl):
    """stablelm-3b's training memory and step with remat on and off: the
    LM workload under the scan executor, one epoch of its 2 steps (mode
    static: no probes), pass-1 chunks of 4 both ways, the losses within
    rtol 1e-3 (bitwise printed); then, each way, one eager step of a
    batch of 64, 128 and 256 sequences in one chunk, until one does not
    fit (an out-of-memory error in an eager step is caught safely).
    Prints each run's peak device memory and step walls; returns them."""
    import dataclasses
    from repro_torch.train_loop import Trainer
    run, ds, _ = wl.train_lm_setup()
    found = {}
    # (remat, batch, pass-1 chunk, executor): the workload's chunk both
    # ways under the graph; then one chunk of a whole batch in one eager
    # step, doubling, each way, until one does not fit
    cases = [(False, 8, 4, "scan"), (True, 8, 4, "scan")]
    cases += [(remat, n, n, "loop") for remat in (True, False)
              for n in (64, 128, 256)]
    too_big = set()
    for remat, batch, chunk, executor in cases:
        if remat in too_big:
            continue
        steps = run.steps_per_epoch if executor == "scan" else 1
        r = dataclasses.replace(
            run, model=dataclasses.replace(run.model, remat=remat),
            dp=dataclasses.replace(run.dp, ghost_microbatch=chunk,
                                   microbatch_size=batch),
            global_batch=batch, steps=steps, steps_per_epoch=steps,
            epoch_executor=executor)
        tag = (f"remat {'on' if remat else 'off'}, batch {batch}, chunk "
               f"{chunk}, {executor}")
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        tr, oom = None, None
        try:
            tr = Trainer(r, ds, mode="static", device="cuda")
            tr.train(1)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            oom = str(e).splitlines()[0][:160]
        if oom is not None:        # the error's frames are gone here
            found[tag] = {"fits": False,
                          "peak_gib": torch.cuda.max_memory_allocated()
                          / 2**30}
            print(f"stablelm-3b {tag}: out of memory ({oom})", flush=True)
            del tr
            _free(torch)
            too_big.add(remat)
            continue
        walls = sorted(t * 1e3 for t in tr.step_wall_s)
        found[tag] = {"fits": True, "peak_gib":
                      torch.cuda.max_memory_allocated() / 2**30,
                      "step_ms": walls, "tokens_per_s":
                      batch * r.seq_len / walls[0] * 1e3,
                      "capture_s": tr.last_capture_s,
                      "loss": tr.history[-1].loss}
        print(f"stablelm-3b {tag}: {json.dumps(found[tag])}", flush=True)
        del tr
        _free(torch)
    on = found["remat on, batch 8, chunk 4, scan"]
    off = found["remat off, batch 8, chunk 4, scan"]
    print(f"stablelm-3b remat on / off at chunk 4: loss {on['loss']!r} / "
          f"{off['loss']!r} (bitwise {on['loss'] == off['loss']}), peak "
          f"{on['peak_gib']!r} / {off['peak_gib']!r} GiB, step "
          f"{on['step_ms']} / {off['step_ms']} ms")
    if not math.isclose(on["loss"], off["loss"], rel_tol=1e-3):
        raise AssertionError(f"stablelm-3b: remat moved the loss "
                             f"({on['loss']!r} / {off['loss']!r})")
    return found


def _recording_losses(tr) -> list:
    """Wraps ``tr._train_steps_scan`` to keep each epoch's per-step
    losses (a resumed epoch's include those before the preemption)."""
    inner, out = tr._train_steps_scan, []

    def wrapped(*args, **kwargs):
        losses = inner(*args, **kwargs)
        out.append(list(losses))
        return losses

    tr._train_steps_scan = wrapped
    return out


def _state_bytes(tr) -> dict:
    """What must come back bit for bit after a resume, as bytes: the
    epsilon, the accountant's and the scheduler's state, the history, and
    the sampler's and the probe RNG's next draws (drawn from copies)."""
    import copy
    import pickle
    sampler, probe = copy.deepcopy(tr.sampler), copy.deepcopy(tr._probe_rng)
    return {"eps": pickle.dumps(tr.accountant.get_epsilon(tr.run.dp.delta)),
            "accountant": pickle.dumps(tr.accountant.state_dict()),
            "scheduler": pickle.dumps(tr.scheduler.state_dict()),
            "history": pickle.dumps([(h.epoch, h.loss, h.eps,
                                      h.quantized_layers, h.accuracy)
                                     for h in tr.history]),
            "sampler_next": pickle.dumps(sampler.sample()),
            "probe_next": pickle.dumps(probe.randint(0, 1 << 30, 8)),
            "step": pickle.dumps(tr.step)}


def preempt_resume(torch, ops, wl, ckpt_root):
    """Preemption and a bit-identical resume on the card: the ResNet-50
    workload at full width under deterministic cuDNN, scan in chunks of 2,
    one epoch of 4 steps with its analysis.  Run 1 uninterrupted; run 2
    with a checkpoint directory and a FaultPlan preempt at global step 2
    (after the first chunk), which must raise Preempted(2); run 3 a fresh
    Trainer on that directory that restores the mid-epoch checkpoint and
    finishes the epoch without a probe (its clip launches are the two
    steps' and one capture warm-up's); run 4 the trainer of run 2 itself,
    restored and finished (its graph, captured before the preemption, is
    replayed over the restored params and optimizer state); each resumed
    run reads its own copy of run 2's directory.  Runs 3 and 4
    must equal run 1 bit for bit: params, optimizer state, per-step and
    epoch losses, epsilon, the accountant, the scheduler, the history and
    the sampler's and probe RNG's next draws."""
    import dataclasses
    import shutil
    from repro_torch.runtime.faults import FaultEvent, FaultPlan
    from repro_torch.runtime.preemption import Preempted, PreemptionHandler
    from repro_torch.train_loop import Trainer

    t_phase = time.perf_counter()
    run, ds, ev = wl.setup(wl.TRAIN_RESNET50_ARGV)
    run = dataclasses.replace(run, steps_per_epoch=4, steps=4, epoch_chunk=2)
    n_micro = run.global_batch // run.dp.microbatch_size
    torch.backends.cudnn.deterministic = True
    try:
        ref = Trainer(run, ds, eval_dataset=ev, mode="dpquant",
                      device="cuda")
        ref_losses = _recording_losses(ref)
        ref.train(1)
        want_state = _state_bytes(ref)
        want = (ref.params, ref.opt_state)
        del ref
        _free(torch)          # its graph and pool (the wrapper is a cycle)
        handler = PreemptionHandler(
            faults=FaultPlan([FaultEvent(kind="preempt", at=2)]))
        tr2 = Trainer(run, ds, eval_dataset=ev, mode="dpquant",
                      device="cuda", checkpoint_dir=ckpt_root / "run2",
                      preemption=handler)
        try:
            tr2.train(1)
            raise AssertionError("run 2 was not preempted")
        except Preempted as p:
            if p.step != 2:
                raise AssertionError(f"preempted at step {p.step}, want 2")
        shutil.copytree(ckpt_root / "run2", ckpt_root / "run3")
        results = {}
        # one trainer's graph pool at a time: the preempted trainer first
        for tag in ("preempted trainer", "fresh trainer"):
            if tag == "fresh trainer":
                del tr2
                _free(torch)
                tr = Trainer(run, ds, eval_dataset=ev, mode="dpquant",
                             device="cuda", checkpoint_dir=ckpt_root / "run3")
            else:
                tr = tr2
            print(f"resnet50 resume ({tag}): device memory allocated "
                  f"{torch.cuda.memory_allocated() / 2**30!r} GiB, reserved "
                  f"{torch.cuda.memory_reserved() / 2**30!r} GiB", flush=True)
            tr.preemption = None
            if tr.restore_latest() != 0 or tr._mid_epoch is None \
                    or tr.step != 2:
                raise AssertionError(f"{tag}: no mid-epoch checkpoint at "
                                     f"step 2 (step {tr.step})")
            losses = _recording_losses(tr)
            ops.reset_launch_counts()
            tr.train(1 - tr._next_epoch)
            tr.ckpt.wait()                   # the epoch's checkpoint
            torch.cuda.synchronize()
            clips = ops.LAUNCHES["clip_and_sum"]
            captures = 1 if tag == "fresh trainer" else 0
            if tr.last_analysis_s != 0.0 or clips != (2 + captures) * n_micro:
                raise AssertionError(f"{tag}: analysis {tr.last_analysis_s} "
                                     f"s, {clips} clip launches, want "
                                     f"{(2 + captures) * n_micro}")
            same, worst, where = _compare_runs(torch, want,
                                               (tr.params, tr.opt_state))
            state = _state_bytes(tr)
            differ = [k for k in want_state if state[k] != want_state[k]]
            results[tag] = (same, worst, where, losses, differ)
            print(f"resnet50 resume ({tag}): params and optimizer state "
                  f"bitwise {same} (largest difference {worst!r}, leaf "
                  f"{where}); per-step losses {losses} against "
                  f"{ref_losses}; differing: {differ or 'nothing'}; "
                  f"clip launches {clips}", flush=True)
            del tr
    finally:
        torch.backends.cudnn.deterministic = False
    for tag, (same, worst, where, losses, differ) in results.items():
        if not same or losses != ref_losses or differ:
            raise AssertionError(f"{tag}: the resumed run differs from the "
                                 f"uninterrupted one ({differ}, params by "
                                 f"{worst})")
    del want
    _free(torch)
    print(f"resnet50 preemption and resume: phase wall "
          f"{time.perf_counter() - t_phase!r} s")


def _free(torch):
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


class _ProjectionOperands:
    """Ghost-pass hooks (``repro_torch.dp.ghost.GhostHooks``' interface)
    that keep every projection's forward input and the cotangent of its
    output, and tap nothing."""

    def __init__(self):
        self.inputs, self.cotangents = [], {}

    def qeinsum(self, spec, x, w, **kw):
        from repro_torch.quant import fake_quant
        i = len(self.inputs)
        self.inputs.append((x.detach(), kw["seed"]))
        y = fake_quant.qeinsum(spec, x, w, per_example=True, **kw)
        y.register_hook(lambda g: self.cotangents.__setitem__(i, g.detach()))
        return y

    def rmsnorm_scale(self, scale, x):
        return scale


def _luq_codes(torch, t, seed: int, fold: int):
    """(alpha, Q(t) / alpha) of the one-example tensor ``t``: the LUQ
    codes (+-2^-k or 0, exact) that fake-quant's ``fold`` gives it."""
    from repro_torch.quant import fake_quant
    q = fake_quant._quantize_per_example(t, "luq_fp4", "cuda", seed, fold)
    alpha = t.float().abs().amax()
    return alpha, q.float() / torch.clamp(alpha, min=1e-30)


def batch_shape_witness(torch, cfg, params, batch, rel):
    """Why a chunk of B examples and one example at a time give other
    LUQ norms: (1) the same pass-1 comparison at fmt ``none`` and at a
    format registered as the identity (nothing rounds to a grid; every
    fold still runs through the hooks), which must agree within the norm
    tolerance, rtol 1e-4; (2) at luq_fp4, for example 0 in a batch of B
    and alone, every projection's forward input (fold 0) and output
    cotangent (fold 5, the wgrad's): how many values differ, whether the
    operand's max (LUQ's scale) differs, and how many LUQ codes flip.
    Returns the printed numbers."""
    from repro_torch.config import QuantConfig
    from repro_torch.dp import ghost
    from repro_torch.models.registry import build_model
    from repro_torch.quant import backend as qbackend

    flags = (True,) * cfg.n_layers
    found = {}
    identity = {("quantize", "identity", "ref"):
                    lambda rows, key: rows.clone(),
                ("ghost_norm", "identity", "ref"):
                    lambda x, g, kx, kg: ghost._matpair_sq_norm(x, g)}
    qbackend._REGISTRY.update(identity)
    try:
        for fmt in ("none", "identity"):
            model = build_model(cfg, QuantConfig(fmt=fmt, backend="cuda"))
            kw = dict(hooked_mask=model.ghost_mask(params),
                      aux=model.ghost_aux(flags))

            def pel(p, b, hooks, model=model):
                return model.per_example_loss(p, b, flags, hooks=hooks)

            _, n_batch = ghost.ghost_per_example_norms(pel, params, batch,
                                                       **kw)
            _, n_one = ghost.ghost_per_example_norms(pel, params, batch,
                                                     microbatch=1, **kw)
            found[f"norms {fmt}"] = rel(n_batch, n_one)
    finally:
        for key in identity:
            qbackend._REGISTRY.pop(key)
    model = build_model(cfg, QuantConfig(fmt="luq_fp4", backend="cuda"))
    runs = []
    for b in (batch, {"tokens": batch["tokens"][:1]}):
        rec = _ProjectionOperands()
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        model.per_example_loss(leaves, b, flags, hooks=rec).sum().backward()
        del leaves
        runs.append([(x, rec.cotangents[i], seed)
                     for i, (x, seed) in enumerate(rec.inputs)])
    for name, j, fold in (("input", 0, 0), ("cotangent", 1, 5)):
        values, scales, codes = [], [], []
        for ops_b, ops_1 in zip(*runs):
            tb, t1, seed = ops_b[j][:1], ops_1[j], ops_1[2]
            values.append(int((tb != t1).sum().item()))
            (ab, cb), (a1, c1) = (_luq_codes(torch, t, seed, fold)
                                  for t in (tb, t1))
            scales.append(int(ab.item() != a1.item()))
            codes.append(int((cb != c1).sum().item()))
        found[f"{name}: values differing"] = values
        found[f"{name}: max differs"] = scales
        found[f"{name}: codes flipped"] = codes
    found["elements per projection"] = [x.numel() for x, _, _ in runs[1]]
    return found


def ghost_vs_vmap(torch, ops, wl):
    """stablelm-3b at full width cut to 2 layers, every layer in LUQ-FP4
    on the cuda backend, B = 4 sequences of the LM workload's length, in
    bf16 (the config's compute dtype) and in float32.

    Checked, in both: (1) inside the ghost pass, the kernel (B = 4
    examples a launch) against the unfused route (quantize, then Grams in
    PyTorch), rtol 1e-4; (2) ghost pass-1 norms (chunks of one example,
    the kernel launched) against the norms of the per-example gradients,
    each from autograd of a one-example batch, rtol 1e-4; (3) the clipped
    gradients, example by example, each clipped by exactly 1/8 (clip norm
    = its ghost norm / 8), rtol 2e-4, atol 2e-5.  In float32 also (4) the
    ghost norms against the vmap engine's (``torch.func``, one-example
    batches), rtol 1e-4.

    Why example by example, and why 1/8: LUQ's rounding is a step
    function of its input and of the operand's max.  A product summed in
    another order (another batch shape, or functorch's bf16 rounding)
    moves the odd value across a step; so does pass 2's cotangent scaled
    by a clip factor that is not a power of two, since ``Q(s g) = s Q(g)``
    holds only as far as ``s g`` is exact.  Those differences are
    printed, not checked: the batch-4 norms against the one-example ones,
    the vmap engine's bf16 norms, and the sums at clip norm 1.
    :func:`batch_shape_witness` holds the batch-4 pass against one
    example at a time where nothing rounds to a grid, and counts the code
    flips at luq_fp4."""
    import dataclasses
    from repro_torch.config import QuantConfig
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenDataset
    from repro_torch.dp.clip import per_example_clipped_grad_sum
    from repro_torch.dp.ghost import (ghost_clipped_grad_sum,
                                      ghost_per_example_norms)
    from repro_torch.models.registry import build_model
    from repro_torch.quant import backend as qbackend

    B = 4

    def rel(a, b):
        return ((a - b).abs() / b.abs()).max().item()

    for dtype in ("bfloat16", "float32"):
        # remat off: the witness's hooks record each projection's operands
        # in the forward, and a block recomputed in the backward would
        # record them again
        cfg = dataclasses.replace(get_config(wl.TRAIN_LM_ARCH), n_layers=2,
                                  compute_dtype=dtype, remat=False)
        model = build_model(cfg, QuantConfig(fmt="luq_fp4", backend="cuda"))
        params = model.init(wl.SEED)
        tokens = TokenDataset(n=B, vocab=cfg.vocab_size,
                              seq_len=wl.TRAIN_LM_SEQ,
                              seed=wl.SEED).get(list(range(B)))["tokens"]
        batch = {"tokens": tokens.cuda()}
        one = [{"tokens": batch["tokens"][i:i + 1]} for i in range(B)]
        flags = (True,) * cfg.n_layers
        kw = dict(hooked_mask=model.ghost_mask(params),
                  aux=model.ghost_aux(flags))

        def pel(p, b, hooks):
            return model.per_example_loss(p, b, flags, hooks=hooks)

        def loss_one(p, ex):
            return model.loss_fn(p, {k: v[None] for k, v in ex.items()},
                                 flags)

        ops.reset_launch_counts()
        _, g1 = ghost_per_example_norms(pel, params, batch, microbatch=1,
                                        **kw)
        torch.cuda.synchronize()
        launched = ops.LAUNCHES["ghost_norm_sq"]
        _, g4 = ghost_per_example_norms(pel, params, batch, **kw)
        fused = qbackend._REGISTRY.pop(("ghost_norm", "luq_fp4", "cuda"))
        try:
            _, g4u = ghost_per_example_norms(pel, params, batch, **kw)
        finally:
            qbackend._REGISTRY[("ghost_norm", "luq_fp4", "cuda")] = fused
        vnorms = torch.stack([per_example_clipped_grad_sum(
            loss_one, params, ex, clip_norm=1.0, microbatch_size=1)[1][
                "grad_norm_max"] for ex in one])
        # per example: the autograd gradient, its norm, and the largest
        # gap to ghost's clipped gradient at clip norms g1 / 8 and 1
        pnorms, gaps = [], {"1/8": [], "C=1": []}
        for b, ex in enumerate(one):
            leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
            grads = torch.autograd.grad(model.loss_fn(leaves, ex, flags),
                                        list(leaves.values()))
            grads = dict(zip(leaves, grads))
            del leaves
            n = torch.sqrt(sum(t.float().square().sum()
                               for t in grads.values()))
            pnorms.append(n)
            for tag, clip in (("1/8", g1[b].item() / 8), ("C=1", 1.0)):
                gsum, _ = ghost_clipped_grad_sum(pel, params, ex,
                                                 clip_norm=clip, **kw)
                scale = torch.clamp(clip / n, max=1.0)
                for name, t in grads.items():
                    want = scale * t.float()
                    if tag == "1/8":
                        torch.testing.assert_close(
                            gsum[name], want, rtol=2e-4, atol=2e-5,
                            msg=lambda m, name=name: f"{dtype} {name}: {m}")
                    gaps[tag].append((gsum[name] - want).abs().max().item())
                del gsum
            del grads
        pnorms = torch.stack(pnorms)
        print(f"ghost vs per-example gradients (stablelm-3b, 2 layers at "
              f"full width, {dtype}, luq_fp4, {B} x {wl.TRAIN_LM_SEQ} "
              f"tokens): max rel diff of the norms: kernel vs unfused "
              f"(B = {B}) {rel(g4, g4u)}, ghost vs autograd example by "
              f"example {rel(g1, pnorms)}, ghost vs vmap engine "
              f"{rel(g1, vnorms)}, vmap engine vs autograd "
              f"{rel(vnorms, pnorms)}, ghost B = {B} vs example by example "
              f"{rel(g4, g1)}; clipped gradients max abs diff: factor 1/8 "
              f"{max(gaps['1/8'])}, clip norm 1 {max(gaps['C=1'])}; norms "
              f"autograd {pnorms.tolist()} ghost {g1.tolist()} vmap "
              f"{vnorms.tolist()}; ghost_norm_sq launches in the "
              f"one-example pass 1: {launched}")
        if launched != 7 * cfg.n_layers * B:
            raise AssertionError(f"ghost pass 1 launched ghost_norm_sq "
                                 f"{launched} times, want "
                                 f"{7 * cfg.n_layers * B}")
        torch.testing.assert_close(g4, g4u, rtol=1e-4, atol=0.0)
        torch.testing.assert_close(g1, pnorms, rtol=1e-4, atol=0.0)
        if dtype == "float32":
            torch.testing.assert_close(g1, vnorms, rtol=1e-4, atol=0.0)
        witness = batch_shape_witness(torch, cfg, params, batch, rel)
        print(f"batch {B} against one example at a time ({dtype}): "
              f"{json.dumps(witness)}")
        for fmt in ("none", "identity"):
            if not witness[f"norms {fmt}"] <= 1e-4:
                raise AssertionError(
                    f"{dtype} fmt {fmt}: pass-1 norms of a chunk of {B} "
                    f"are {witness[f'norms {fmt}']} (relative) from those "
                    f"of one-example chunks, above 1e-4")
        del params, model
        _free(torch)


def cnn_ghost_vs_vmap(torch, ops, wl):
    """Ghost mode against the vmap engine inside the paper's three CNNs
    at full width and depth (random init, float32), on 8 synthetic 32x32
    images, every layer quantized, at fmt none, at a format registered as
    the identity (every fold runs through the conv taps and the quantized
    conv's backward, nothing rounds) and at luq_fp4, on the cuda backend.

    At none and identity: ghost pass-1 norms within rtol 1e-4 of the vmap
    engine's per-example norms, fallback leaves (GroupNorm, head)
    included; the clipped sums (clip norm between the middle two norms)
    within rtol 2e-4, atol 2e-5, the LM phase's limits.  At luq_fp4 the
    largest differences are printed, not held: LUQ's rounding is a step
    function, and cuDNN sums a batch of 8 in another order than vmap's
    one-example lanes, which moves odd values across a step.  Ghost mode
    must launch no clip and no ``ghost_norm_sq`` (the conv taps are plain
    matmuls).  Then the cost of the norm-only fallback: pass 1 over a
    chunk of 64 images at luq_fp4 with the per-example copies of the
    GroupNorm parameters and head, against the same pass with every
    leaf marked hooked (no copies; its norms leave those leaves out, so
    it is timed only).  Returns the printed numbers."""
    import numpy as np
    from torch.func import grad, vmap
    from repro_torch.config import QuantConfig
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import ImageClassDataset
    from repro_torch.dp import ghost
    from repro_torch.dp.clip import per_example_clipped_grad_sum
    from repro_torch.models.registry import build_model
    from repro_torch.quant import backend as qbackend

    B, CHUNK = 8, 64

    def rel(a, b):
        return ((a - b).abs() / b.abs()).max().item()

    identity = {("quantize", "identity", "ref"):
                lambda rows, key: rows.clone()}
    qbackend._REGISTRY.update(identity)
    found = {}
    try:
        for arch in ("resnet18", "resnet50", "densenet121"):
            cfg = get_config(arch)
            ds = ImageClassDataset(n=CHUNK, num_classes=cfg.num_classes,
                                   image_size=cfg.image_size, seed=wl.SEED)
            chunk = {k: v.cuda() for k, v in ds.get(np.arange(CHUNK)).items()}
            batch = {k: v[:B] for k, v in chunk.items()}
            flags = (True,) * cfg.policy_len()
            params = None
            for fmt in ("none", "identity", "luq_fp4"):
                model = build_model(cfg, QuantConfig(fmt=fmt, backend="cuda"))
                if params is None:
                    params = model.init(wl.SEED)
                mask = model.ghost_mask(params)

                def pel(p, b, hooks, model=model):
                    return model.per_example_loss(p, b, flags, hooks=hooks)

                def loss_one(p, ex, model=model):
                    return model.loss_fn(p, {k: v[None] for k, v in
                                             ex.items()}, flags)

                grads = vmap(grad(loss_one), in_dims=(None, 0),
                             randomness="same")(params, batch)
                vnorms = torch.sqrt(sum(
                    g.float().square().sum(dim=tuple(range(1, g.dim())))
                    for g in grads.values()))
                del grads
                mid = vnorms.sort().values
                clip = float(mid[B // 2 - 1] + mid[B // 2]) / 2
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                _, gnorms = ghost.ghost_per_example_norms(
                    pel, params, batch, hooked_mask=mask)
                gsum, _ = ghost.ghost_clipped_grad_sum(
                    pel, params, batch, clip_norm=clip, hooked_mask=mask)
                torch.cuda.synchronize()
                launched = {k: ops.LAUNCHES[k]
                            for k in ("clip_and_sum", "ghost_norm_sq",
                                      "luq_quant")}
                vsum, _ = per_example_clipped_grad_sum(
                    loss_one, params, batch, clip_norm=clip,
                    microbatch_size=B)
                # per leaf, the largest |ghost - vmap| over the limit
                # atol + rtol |vmap| (at most 1 passes), and over the
                # leaf's largest |vmap|
                limit = max(((gsum[k] - v).abs() / (2e-5 + 2e-4 * v.abs()))
                            .max().item() for k, v in vsum.items())
                sum_rel = max(((gsum[k] - v).abs().max()
                               / v.abs().max().clamp(min=1e-30)).item()
                              for k, v in vsum.items())
                found[f"{arch} {fmt}"] = {
                    "norms rel": rel(gnorms, vnorms),
                    "sum over its limit": limit,
                    "sum rel to the leaf max": sum_rel,
                    "launches": launched}
                print(f"cnn ghost vs vmap ({arch}, {B} images, float32, "
                      f"fmt {fmt}, clip norm {clip!r}): norms max rel diff "
                      f"{rel(gnorms, vnorms)!r}, clipped sums' largest diff "
                      f"over its limit {limit!r} (over the leaf's largest "
                      f"entry {sum_rel!r}); launches {launched}; norms "
                      f"vmap {vnorms.tolist()} ghost {gnorms.tolist()}")
                if launched["clip_and_sum"] or launched["ghost_norm_sq"]:
                    raise AssertionError(f"{arch} {fmt}: ghost mode "
                                         f"launched {launched}")
                if fmt == "luq_fp4" and not launched["luq_quant"]:
                    raise AssertionError(f"{arch}: no luq_quant launch")
                if fmt != "luq_fp4":
                    torch.testing.assert_close(gnorms, vnorms, rtol=1e-4,
                                               atol=0.0)
                    for k, v in vsum.items():
                        torch.testing.assert_close(
                            gsum[k], v, rtol=2e-4, atol=2e-5,
                            msg=lambda m, k=k: f"{arch} {fmt} {k}: {m}")
                del gsum, vsum
            # the norm-only fallback's cost: pass 1 over a chunk, with
            # and without the fallback leaves' per-example copies
            walls = {}
            for tag, m in (("fallback", mask),
                           ("no fallback", dict.fromkeys(mask, True))):
                def pass1(m=m):
                    return ghost.ghost_per_example_norms(
                        pel, params, chunk, hooked_mask=m)
                pass1()
                walls[tag] = time_ms(torch, pass1, 10)
            fallback = sum(t.numel() for k, t in params.items()
                           if not mask[k])
            found[f"{arch} pass1 ms"] = walls
            print(f"{arch} ghost pass 1 ({CHUNK} images, luq_fp4, eager): "
                  f"{walls['fallback']!r} ms with the per-example copies of "
                  f"the {fallback} fallback parameters, "
                  f"{walls['no fallback']!r} ms without (timing only)")
            del params, model, chunk, batch
            _free(torch)
    finally:
        for key in identity:
            qbackend._REGISTRY.pop(key)
    return found


def train_stablelm(torch, ops, wl):
    """Ghost-mode DP-SGD on stablelm-3b under the DPQuant scheduler, the
    LM workload of ``repro_torch/launch/workload.py`` (each block under
    remat), under the scan executor: 3 epochs, the analysis in epochs 0
    and 2, one graph of the train step and one of the probe step; returns
    the launch counts of the run and its summary."""
    from repro_torch.dp.ghost import per_example_state_bytes
    from repro_torch.quant import backend as qbackend
    from repro_torch.train_loop import Trainer

    if (qbackend.get_quantizer("luq_fp4", "cuda")[1] != "cuda"
            or qbackend.get_ghost_norm("luq_fp4", "cuda")[1] != "cuda"):
        raise AssertionError("the quantizer or the ghost norm does not run "
                             "on the cuda backend")
    run, ds, ev = wl.train_lm_setup()
    if run.epoch_executor != "scan" or not run.model.remat:
        raise AssertionError(f"the workload runs {run.epoch_executor!r}, "
                             f"remat {run.model.remat}")
    cfg = run.model
    batch, chunk, seq = run.global_batch, run.dp.ghost_microbatch, run.seq_len
    steps, epochs = run.steps_per_epoch, wl.TRAIN_LM_EPOCHS
    t0 = time.perf_counter()
    tr = Trainer(run, ds, eval_dataset=ev, mode="dpquant", device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tr.params.values())
    state = per_example_state_bytes(
        tr.params, tr.model.ghost_mask(tr.params), batch,
        aux=tr.model.ghost_aux(tr.qflags))
    print(f"stablelm-3b: {n_params} params, init {time.perf_counter() - t0} "
          f"s; per_example_state_bytes at batch {batch}: {state}")
    if state["ghost_bytes"] != 0:
        raise AssertionError(f"ghost mode keeps per-example state: {state}")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = _epochs_of(torch, tr, epochs, "stablelm-3b", 29)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    launches.update({f"ghost_norm_sq[{k}]": v
                     for k, v in ops.GHOST_NORM_LAUNCHES.items()})
    launches.update({f"luq_quant[{k}]": v
                     for k, v in ops.LUQ_QUANT_LAUNCHES.items()})
    med = out["median_step_ms_by_epoch"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    flags = tr.scheduler.current.flags()
    calls = host_calls(torch,
                       lambda: tr._train_steps_scan(tr._set_flags(flags)))
    print(f"train stablelm-3b (ghost, scan, remat): {epochs} epochs x "
          f"{steps} steps of {batch} x {seq} tokens: median step by epoch "
          f"{med!r} ms (chunk walls over their steps: "
          f"{[t * 1e3 for t in tr.step_wall_s]}), "
          f"{batch * seq / med[-1] * 1e3!r} tokens/s in the last epoch, "
          f"analysis by epoch {out['analysis_s']!r} s (probe graph warm-up "
          f"and capture {out['probe_capture_s']!r} s), epoch graph warm-up "
          f"and capture by epoch {out['capture_s']!r} s; captures "
          f"{out['captures']} for {out['distinct_policies']} policies, wall "
          f"{wall!r} s, peak device memory {peak!r} GiB, launches (replays "
          f"counted) {launches}; host calls over one more epoch of {steps} "
          f"steps (profiled, after the checks' counts): {calls}")
    if out["policies"][:2] != EARLIER_LM_POLICIES:
        raise AssertionError(f"stablelm-3b: policies {out['policies']} are "
                             f"not those of commit 27090d7 "
                             f"{EARLIER_LM_POLICIES}")
    # every step launches the kernel once per pass-1 chunk and hooked
    # projection (7 a layer) of every layer, whatever its flag (at 0 the
    # kernel takes the Grams of the operands themselves): the train
    # steps, the probe steps (each analysis: the baseline and one run per
    # layer, x reps) and the captures' eager warm-up steps (one: the
    # probe batch has the train batch's shape, and the second capture
    # skips it)
    n_chunks = batch // chunk
    probe_chunks = max(run.dp.microbatch_size,
                       min(run.dp.analysis_batch_size, batch)) // chunk
    probe_steps = (out["analyses"] * (len(tr.scheduler.policies) + 1)
                   * run.dp.analysis_reps)
    want = 7 * cfg.n_layers * (
        (epochs * steps + out["warmups"]["epoch"]) * n_chunks
        + (probe_steps + out["warmups"]["probe"]) * probe_chunks)
    if launches["ghost_norm_sq"] != want:
        raise AssertionError(f"ghost_norm_sq launched "
                             f"{launches['ghost_norm_sq']} times, want {want} "
                             f"(policies {out['policies']})")
    if launches["clip_and_sum"] != 0:
        raise AssertionError(f"ghost training launched clip_and_sum "
                             f"{launches['clip_and_sum']} times")
    calls, kernels = launches["luq_quant"], launches["luq_quant[kernels]"]
    print(f"stablelm-3b quantize calls {calls}, kernel launches {kernels}, "
          f"{kernels / calls} a call")
    if not 0 < kernels <= 2 * calls:
        raise AssertionError(f"{calls} quantize calls launched {kernels} "
                             "kernels, want at most 2 a call")
    summary = {**out, "tokens_per_s": batch * seq / med[-1] * 1e3,
               "peak_gib": peak}
    del tr
    _free(torch)
    return launches, summary


def serve_yi6b(torch, kv_fmt, model, params, ops, wl):
    """Serve the workload's requests through the engine; returns its
    summary and the launch counts of the run, the matmul's also by
    branch."""
    from repro_torch.config import ServeConfig
    from repro_torch.quant import backend as qbackend
    from repro_torch.serve import ContinuousEngine

    for get, fmt in ((qbackend.get_matmul, "luq_fp4"),
                     (qbackend.get_kv_write, kv_fmt),
                     (qbackend.get_decode_attn, kv_fmt)):
        _, actual = get(fmt, "cuda")
        if actual != "cuda":
            raise AssertionError(f"{get.__name__}({fmt!r}) runs on {actual}")
    serve = ServeConfig(max_slots=wl.SLOTS, max_seq=wl.MAX_SEQ,
                        max_new_tokens=wl.NEW_TOKENS, kv_fmt=kv_fmt)
    engine = ContinuousEngine(model, params, serve)
    prompts = wl.prompts(model.config.vocab_size)
    # warm-up: captures the decode graph and every bucket's prefill graph
    for p in prompts:
        engine.submit(p, max_new_tokens=2)
    engine.run()
    engine.reset()
    for p in prompts:
        engine.submit(p, max_new_tokens=wl.NEW_TOKENS)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    replays = engine.decode_replays
    prefill_replays = engine.prefill_replays
    results = engine.run()
    torch.cuda.synchronize()
    replays = engine.decode_replays - replays
    prefill_replays = engine.prefill_replays - prefill_replays
    launches = serve_launches(ops)
    if sorted(results) != list(range(wl.REQUESTS)):
        raise AssertionError(f"served {sorted(results)}")
    for rid, r in results.items():
        if r.status != "ok" or r.tokens.size != wl.NEW_TOKENS:
            raise AssertionError(f"request {rid}: {r.status}, "
                                 f"{r.tokens.size} tokens")
        if not ((r.tokens >= 0) & (r.tokens < model.config.padded_vocab)).all():
            raise AssertionError(f"request {rid}: token ids out of range")
    zero = [k for k, n in launches.items()
            if n == 0 and k not in ("luq_quant", "clip_and_sum",
                                    "ghost_norm_sq")]
    if zero:
        raise AssertionError(f"kernels not launched on the serving path: "
                             f"{zero}")
    summary = engine.metrics.summary()
    summary["prompt_lengths"] = [p.size for p in prompts]
    ticks = summary["decode_ticks"]
    summary["graph_replays_per_tick"] = replays / ticks
    summary["prefill_programs"] = engine.prefill_programs
    if replays != ticks:
        raise AssertionError(f"{replays} decode graph replays in {ticks} "
                             "ticks")
    if not (prefill_replays == launches["luq_matmul[prefill]"]
            == wl.REQUESTS):
        raise AssertionError(
            f"{prefill_replays} prefill graph replays and "
            f"{launches['luq_matmul[prefill]']} prefill logits heads for "
            f"{wl.REQUESTS} admissions")
    if engine.prefill_programs > math.ceil(math.log2(wl.MAX_SEQ)):
        raise AssertionError(f"{engine.prefill_programs} prefill programs")
    engine.reset()
    for p in prompts:
        engine.submit(p, max_new_tokens=wl.NEW_TOKENS)
    calls = host_calls(torch, engine.run)
    summary["host_calls_per_tick"] = {
        k: v / engine.metrics.decode_ticks for k, v in calls.items()}
    # one decode tick: a replay of the decode graph (phase 21's wall), and
    # the launches of the tick its capture ran
    summary["decode_tick_ms"] = time_ms(torch, engine._decode, 20)
    summary["tick_launches"] = engine._decode.recorded["launches"]
    # one K+V write a layer and decode tick, one a prefill
    want_kv = {"decode": model.config.n_layers * summary["decode_ticks"],
               "prefill": wl.REQUESTS}
    for branch, n in want_kv.items():
        if launches[f"kv_quant_write[{branch}]"] != n:
            raise AssertionError(
                f"kv_quant_write[{branch}] launched "
                f"{launches[f'kv_quant_write[{branch}]']} times, want {n}")
    return summary, launches


# phase 7b's fault plans: the five kinds, and a run pushed past the
# supervisor's slot-fault threshold (2) into the oneshot fallback
CHAOS_EVENTS = (("prefill_fail", 1), ("decode_fail", 3),
                ("replica_death", 4, 1), ("clock_freeze", 5, -1, 6),
                ("slot_corrupt", 8, 2))
DRAIN_EVENTS = (("slot_corrupt", 2, 0), ("decode_fail", 4))


def _ticking_clock(dt=0.05):
    """An injected clock that advances ``dt`` a read: heartbeat ages, and
    so the detection of a dead replica, in reads, not in wall time."""
    t = [0.0]

    def clock():
        t[0] += dt
        return t[0]

    return clock


def _host_ms(torch, fn, reps=5):
    """Median host wall of ``fn`` ending in a synchronize, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def serve_faults_yi6b(torch, kv_fmt, model, params, ops, wl):
    """Phase 7b: the workload of phase 7 at temperature 1.0 (seed 3,
    ``max_retries`` 5) through the engine's failure model and the
    supervisor.  Returns the printed summary and the launch counts of the
    supervised run."""
    import tempfile

    from repro_torch.config import ServeConfig
    from repro_torch.runtime import (FaultEvent, FaultPlan, ServeSupervisor,
                                     run_supervised)
    from repro_torch.serve import ContinuousEngine, build_oneshot_fns
    from repro_torch.serve.engine import (prefill_bucket, sample_tokens,
                                          sampling_seed)
    from repro_torch.serve.slots import init_slot_cache

    serve = ServeConfig(max_slots=wl.SLOTS, max_seq=wl.MAX_SEQ,
                        max_new_tokens=wl.NEW_TOKENS, temperature=1.0,
                        seed=3, kv_fmt=kv_fmt, max_retries=5)
    engine = ContinuousEngine(model, params, serve)
    prompts = wl.prompts(model.config.vocab_size)
    for p in prompts:                   # captures every graph of the run
        engine.submit(p, max_new_tokens=2)
    engine.run()

    def run(events=(), seed=0, **supervision):
        engine.reset()
        plan = FaultPlan([FaultEvent(*e) for e in events], seed=seed)
        engine.faults, engine.on_tick = (plan if events else None), None
        sup = (ServeSupervisor(engine, faults=plan, **supervision)
               if events else None)
        for p in prompts:
            engine.submit(p, max_new_tokens=wl.NEW_TOKENS)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        before = engine.decode_replays, engine.prefill_replays
        t0 = time.perf_counter()
        results = (run_supervised(engine, clock=_ticking_clock())
                   if events else engine.run())
        torch.cuda.synchronize()
        rec = {"wall_s": time.perf_counter() - t0,
               "tokens": {r: v.tokens.tolist() for r, v in results.items()},
               "statuses": {v.status for v in results.values()},
               "summary": engine.metrics.summary(),
               "decode_replays": engine.decode_replays - before[0],
               "prefill_replays": engine.prefill_replays - before[1],
               "admissions": sum(engine.pool.admissions),
               "replayed_steps": engine.replayed_steps,
               "launches": serve_launches(ops)}
        if events and plan.pending:
            raise AssertionError(f"faults not fired: {plan.pending}")
        return rec, sup

    # 1. fault-free
    free, _ = run()
    if free["statuses"] != {"ok"} or any(
            len(t) != wl.NEW_TOKENS for t in free["tokens"].values()):
        raise AssertionError(f"fault-free run: {free['statuses']}")
    # 2. all five kinds under the supervisor, a dead replica's heartbeats
    # in files
    with tempfile.TemporaryDirectory() as hb_dir:
        chaos, sup = run(CHAOS_EVENTS, seed=11, n_replicas=3, hb_dir=hb_dir,
                         slot_fault_threshold=10)
    s = chaos["summary"]
    # the plan's counters: the prefill failure's victim, the decode
    # failure's (every slot busy at tick 3) and the poisoned slot 2's
    # occupant (busy at tick 8) retried; one re-plan for the dead replica,
    # whose slot cap is 4 x 2 // 3
    want = {"faults_injected": 5, "slot_faults": 2, "retried": 6,
            "degraded_events": 1, "shed": 0, "deadline_missed": 0}
    got = {k: s[k] for k in want}
    if got != want or sup.dead != {1} or engine.slot_cap != 2:
        raise AssertionError(f"chaos run: counters {got}, want {want}; "
                             f"dead {sup.dead}, slot cap {engine.slot_cap}")
    if chaos["statuses"] != {"ok"} or chaos["tokens"] != free["tokens"]:
        raise AssertionError("chaos run: tokens differ from the fault-free "
                             "run's")
    for name, rec in (("fault-free", free), ("chaos", chaos)):
        ticks = rec["summary"]["decode_ticks"]
        n = rec["admissions"]
        if rec["decode_replays"] != ticks + rec["replayed_steps"]:
            raise AssertionError(
                f"{name}: {rec['decode_replays']} decode graph replays for "
                f"{ticks} ticks and {rec['replayed_steps']} replayed steps")
        if not (rec["prefill_replays"] == n
                == rec["launches"]["kv_quant_write[prefill]"]
                == rec["launches"]["luq_matmul[prefill]"]):
            raise AssertionError(
                f"{name}: {rec['prefill_replays']} prefill graph replays, "
                f"{rec['launches']['kv_quant_write[prefill]']} prefill KV "
                f"writes for {n} admissions")
    # 3. past the slot-fault threshold: the oneshot drain
    drain, dsup = run(DRAIN_EVENTS, seed=5, slot_fault_threshold=2)
    if dsup.events[-1]["kind"] != "oneshot_fallback" or \
            drain["statuses"] != {"ok"} or drain["tokens"] != free["tokens"]:
        raise AssertionError("oneshot drain: tokens differ from the "
                             "fault-free run's")
    # 4. each bucket's prefill replay against the eager prefill of the
    # same padded prompt, bit for bit
    capture_s, admission = {}, {}
    for bucket, step in sorted(engine._prefills.items()):
        n = max(p.size for p in prompts if prefill_bucket(p.size,
                                                          wl.MAX_SEQ)
                == bucket)
        prompt = next(p for p in prompts if p.size == n)
        buf = engine._prefill_in[bucket]
        host = torch.zeros((bucket + 1,), dtype=torch.int32)
        host[:n] = torch.from_numpy(prompt)
        host[bucket] = n
        buf.copy_(host)
        logits, pcache = (t.clone() if torch.is_tensor(t) else
                          {k: v.clone() for k, v in t.items()}
                          for t in step())
        tokens = buf[:bucket].view(1, bucket)
        for plen in (n, buf[bucket]):
            want_l, want_c = model.prefill(engine.params, {"tokens": tokens},
                                           prompt_len=plen, kv_fmt=kv_fmt)
            same = torch.equal(logits, want_l) and all(
                torch.equal(pcache[k], want_c[k]) for k in want_c
                if k != "pos")
            if not same:
                raise AssertionError(f"bucket {bucket}: the prefill replay "
                                     "differs from the eager prefill")
        capture_s[bucket] = step.capture_s
        if bucket == max(engine._prefills):
            def eager():
                return model.prefill(engine.params, {"tokens": tokens},
                                     prompt_len=buf[bucket], kv_fmt=kv_fmt)
            admission = {
                "bucket": bucket,
                "eager_ms": _host_ms(torch, eager),
                "replay_ms": _host_ms(torch, step),
                "eager_calls": host_calls(torch, eager),
                "replay_calls": host_calls(torch, step)}
    # the replay witnesses: request 0's fault-free tokens against the
    # reference's replay (prompt + prefix prefilled at once, the token
    # drawn from the prefill's logits), and the slot row's logits against
    # the B=1 lockstep decode's
    p, toks, J = prompts[0], free["tokens"][0], 16
    n = p.size
    reprefill = 0
    for j in range(1, J + 1):
        seq = torch.from_numpy(p).new_zeros(
            (1, prefill_bucket(n + j, wl.MAX_SEQ)))
        seq[0, :n] = torch.from_numpy(p)
        seq[0, n:n + j] = torch.tensor(toks[:j])
        lg, _ = model.prefill(engine.params, {"tokens": seq.cuda()},
                              prompt_len=n + j, kv_fmt=kv_fmt)
        reprefill += int(sample_tokens(lg, 1.0, [sampling_seed(
            3, 0, n + j)])[0]) == toks[j]
    prefill, decode = build_oneshot_fns(model, wl.MAX_SEQ, kv_fmt)
    _, lock = prefill(engine.params, {"tokens": torch.from_numpy(p)[None]
                                      .cuda()})
    slots = init_slot_cache(model, wl.SLOTS, wl.MAX_SEQ, kv_fmt=kv_fmt)
    b = prefill_bucket(n, wl.MAX_SEQ)
    seq = torch.zeros((1, b), dtype=torch.int32)
    seq[0, :n] = torch.from_numpy(p)
    _, pc = model.prefill(engine.params, {"tokens": seq.cuda()},
                          prompt_len=n, kv_fmt=kv_fmt)
    for k, arr in slots.items():
        if k != "pos":
            arr[:, :1, :, :b] = pc[k]
    slots["pos"][0] = n
    row = torch.zeros((wl.SLOTS,), dtype=torch.int32, device="cuda")
    active = torch.zeros((wl.SLOTS,), dtype=torch.bool, device="cuda")
    active[0] = True
    lockstep_equal = 0
    for j in range(J):
        row[0] = toks[j]
        want, _ = model.decode_slots(engine.params, slots, row, active,
                                     kv_fmt=kv_fmt)
        got, lock = decode(engine.params, lock, row[:1])
        lockstep_equal += torch.equal(got[0], want[0])
    del slots, lock
    summary = {
        "fault_free_wall_s": free["wall_s"], "chaos_wall_s": chaos["wall_s"],
        "drain_wall_s": drain["wall_s"],
        "chaos": {k: s[k] for k in ("faults_injected", "retried",
                                    "recovered", "slot_faults",
                                    "degraded_events", "decode_ticks")},
        "chaos_replayed_steps": chaos["replayed_steps"],
        "chaos_decode_replays": chaos["decode_replays"],
        "chaos_prefill_replays": chaos["prefill_replays"],
        "fault_free_ticks": free["summary"]["decode_ticks"],
        "drain_events": [e["kind"] for e in dsup.events],
        "prefill_capture_s": capture_s, "admission": admission,
        "witness": {"positions": J,
                    "reference_replay_tokens_equal": reprefill,
                    "lockstep_b1_logits_bitwise": lockstep_equal}}
    return summary, chaos["launches"]


def host_epsilon(run, n_data: int, epochs: int) -> list:
    """Epsilon by epoch of a host ``RDPAccountant`` charged as the trainer
    charges it under DPQuant: in an analysis epoch one "analysis" SGM step
    (sigma_measure at the probe batch's rate), then the epoch's training
    steps at the sampler's rate."""
    from repro_torch.dp.accountant import RDPAccountant
    dp = run.dp
    acc = RDPAccountant()
    nb = max(dp.microbatch_size, min(dp.analysis_batch_size,
                                     run.global_batch))
    out = []
    for e in range(epochs):
        if e % max(dp.analysis_interval, 1) == 0:
            acc.step(noise_multiplier=dp.analysis_noise,
                     sample_rate=min(1.0, nb / n_data), steps=1,
                     label="analysis")
        acc.step(noise_multiplier=dp.noise_multiplier,
                 sample_rate=run.global_batch / n_data,
                 steps=run.steps_per_epoch, label="train")
        out.append(acc.get_epsilon(dp.delta)[0])
    return out


def train_vmap_lm(torch, ops, wl, argv, want_k, want_params, per_pass,
                  n_layers=None, after=None, cut=None):
    """DP training of a token model (BERT-SNLI, Mamba-2-130m, Griffin,
    InternVL2-1B) in vmap mode with the fused clip under the DPQuant
    scheduler, the workload of ``argv`` (``repro_torch/launch/workload.py``)
    at ``n_layers`` (None: the config's depth) and the other config fields
    of ``cut`` (the MoE workload's expert count), under the scan executor: 3
    epochs, the analysis in epochs 0 and 2, one graph of the step and one
    of the probe step.  ``per_pass``: the quantize calls of whole tensors
    and of per-example rows that one microbatch's forward and backward
    make.  Checks every loss finite, k, epsilon equal to a host
    accountant's, one capture of each graph, the parameter count and the
    clip's and quantizer's launches; ``after(trainer)``, if given, runs
    on the trained model and its result joins the summary; returns the
    launch counts and the run's summary."""
    from repro_torch.quant import backend as qbackend
    from repro_torch.train_loop import Trainer

    if (qbackend.get_quantizer("luq_fp4", "cuda")[1] != "cuda"
            or qbackend.get_clip_sum("fused")[1] != "cuda"):
        raise AssertionError("the quantizer or the fused clip does not run "
                             "on the cuda backend")
    cut = dict(cut or {})
    if n_layers is not None:
        cut["n_layers"] = n_layers
    run, ds, ev = wl.setup(argv, **cut)
    if run.epoch_executor != "scan" or run.dp.grad_mode != "vmap":
        raise AssertionError(f"the workload runs {run.epoch_executor!r}, "
                             f"{run.dp.grad_mode!r}")
    cfg = run.model
    name = cfg.name
    batch, micro, seq = run.global_batch, run.dp.microbatch_size, run.seq_len
    steps = run.steps_per_epoch
    epochs = run.steps // steps
    t0 = time.perf_counter()
    tr = Trainer(run, ds, eval_dataset=ev, mode="dpquant", device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tr.params.values())
    print(f"{name}: {n_params} params, {cfg.policy_len()} policy layers, "
          f"{cfg.compute_dtype} compute, optimizer {run.optim.name} at lr "
          f"{run.optim.lr}; init {time.perf_counter() - t0} s")
    if n_params != want_params:
        raise AssertionError(f"{name}: {n_params} params, want {want_params}")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = _epochs_of(torch, tr, epochs, name, want_k)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(ops.LAUNCHES)
    launches.update({f"luq_quant[{k}]": v
                     for k, v in ops.LUQ_QUANT_LAUNCHES.items()})
    want_eps = host_epsilon(run, ds.n, epochs)
    if out["eps"] != want_eps:
        raise AssertionError(f"{name}: epsilon {out['eps']}, a host "
                             f"accountant charged as the trainer charges "
                             f"gives {want_eps}")
    med = out["median_step_ms_by_epoch"]
    accuracy = [s.accuracy for s in tr.history]
    print(f"train {name} (vmap, fused clip, scan): {epochs} epochs x "
          f"{steps} steps of {batch} x {seq} tokens in microbatches of "
          f"{micro}: median step by epoch {med!r} ms (chunk walls over "
          f"their steps: {[t * 1e3 for t in tr.step_wall_s]}), "
          f"{batch * seq / med[-1] * 1e3!r} tokens/s in the last epoch, "
          f"analysis by epoch {out['analysis_s']!r} s (probe graph warm-up "
          f"and capture {out['probe_capture_s']!r} s), epoch graph warm-up "
          f"and capture by epoch {out['capture_s']!r} s; captures "
          f"{out['captures']} for {out['distinct_policies']} policies, "
          f"epsilon {out['eps']!r} (host accountant {want_eps!r}), eval "
          f"accuracy by epoch {accuracy}, wall {wall!r} s, peak device "
          f"memory {peak!r} GiB, launches (replays counted) {launches}",
          flush=True)
    # every microbatch pass quantizes at every layer's quantize points
    # whatever the policy (a layer whose flag is 0 copies its operands
    # through): the train steps (batch / micro passes), the probe steps
    # (probe batch / micro passes; the baseline and one run per layer, x
    # reps, each analysis) and the captures' eager warm-up steps
    probe_batch = max(micro, min(run.dp.analysis_batch_size, batch))
    probe_steps = (out["analyses"] * (len(tr.scheduler.policies) + 1)
                   * run.dp.analysis_reps)
    passes = ((epochs * steps + out["warmups"]["epoch"]) * (batch // micro)
              + (probe_steps + out["warmups"]["probe"])
              * (probe_batch // micro))
    whole, per_example = (passes * n for n in per_pass)
    want = {"clip_and_sum": passes, "luq_quant": whole + per_example,
            "luq_quant[whole]": whole, "luq_quant[per_example]": per_example,
            "luq_quant[kernels]": 2 * (whole + per_example)}
    for key, n in want.items():
        if launches[key] != n:
            raise AssertionError(f"{name}: {key} launched {launches[key]} "
                                 f"times, want {n}")
    summary = {**out, "tokens_per_s": batch * seq / med[-1] * 1e3,
               "peak_gib": peak, "accuracy": accuracy,
               "host_eps": want_eps, "wall_s": wall}
    if after is not None:
        summary["after"] = after(tr)
        print(f"{name} after training: {json.dumps(summary['after'])}",
              flush=True)
    del tr
    _free(torch)
    return launches, summary


def _logits_rel(torch, got, want) -> float:
    """The largest difference over the largest magnitude of ``want``."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _decode_vs_prefill(torch, model, params, batch, steps: int,
                       cache_len=None, extra=None):
    """The largest ``_logits_rel`` over ``steps`` greedy decode steps of
    decode's logits against a prefill of the prompt extended by the
    tokens so far, and the share of rows whose greedy tokens agree.
    ``cache_len``: the decode cache's positions (default: the prompt and
    the steps); ``extra``: the batch's other inputs (the VLM's
    ``vision_embeds``), in every prefill."""
    from repro_torch.serve import build_oneshot_fns
    extra = extra or {}
    prefill, decode = build_oneshot_fns(model,
                                        cache_len or batch.shape[1] + steps)
    logits, cache = prefill(params, {"tokens": batch, **extra})
    seq, worst, agree = batch, 0.0, []
    for _ in range(steps):
        tok = logits.argmax(-1)
        seq = torch.cat([seq, tok[:, None].to(seq.dtype)], dim=1)
        logits, cache = decode(params, cache, tok)
        want, _ = prefill(params, {"tokens": seq, **extra})
        worst = max(worst, _logits_rel(torch, logits, want))
        agree.append((logits.argmax(-1) == want.argmax(-1)).float().mean()
                     .item())
    return worst, sum(agree) / len(agree)


# decode's logits against a prefill of the extended prompt (3 steps):
# float32 compute at full depth (1.7e-3 on the card, 8e-5 at 2 x 300
# tokens on a CPU: the random-init model amplifies the GEMMs' rounding
# too; a wrong state gives differences of order 1); bf16 compute at full
# width cut to 2 layers (decode runs the conv on bf16 weights, prefill on float32 ones,
# as the reference does: at random init each layer amplifies that
# rounding difference, and at full depth in bf16 decode and prefill are
# printed, not held)
DECODE_F32_REL = 1e-2
DECODE_BF16_REL = 3e-2
DECODE_BF16_LAYERS = 2


def serve_mamba2(torch, ops, wl):
    """Mamba-2-130m whole through the oneshot engine (``SERVE_MAMBA2_ARGV``:
    8 prompts of 512 tokens, 64 new tokens, greedy, bf16, eager decode
    steps): the tokens' shape and range, no kernel of the port launched
    (the path has none), prefill ms and decode tokens/s; decode against
    prefill of the extended prompt held in float32 at full depth and in
    bf16 at full width cut to 2 layers, printed in bf16 at full depth."""
    import dataclasses
    from repro_torch.models.registry import build_model

    model, params, batch, args, gen, timings, launches, peak = _oneshot_run(
        torch, ops, wl, wl.SERVE_MAMBA2_ARGV)
    cfg = model.config
    tokens = batch["tokens"]
    B, plen = tokens.shape
    if any(launches.values()):
        raise AssertionError(f"{cfg.name} serving launched {launches}; its "
                             "path has no kernel of the port")
    full_rel, full_agree = _decode_vs_prefill(torch, model, params, tokens, 3)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    m32 = build_model(cfg32, model.quant)
    p32 = m32.prepare(m32.init(args.seed))
    f32_rel, f32_agree = _decode_vs_prefill(torch, m32, p32, tokens, 3)
    del p32
    cut = dataclasses.replace(cfg, n_layers=DECODE_BF16_LAYERS)
    p_cut = {k: (v[:DECODE_BF16_LAYERS] if k.startswith("blocks.") else v)
             for k, v in params.items()}
    cut_rel, cut_agree = _decode_vs_prefill(
        torch, build_model(cut, model.quant), p_cut, tokens, 3)
    summary = {
        "batch": B, "prompt": plen, "new_tokens": args.gen,
        "prefill_ms": timings["prefill_ms"],
        "prefill_wall_ms": timings["prefill_s"] * 1e3,
        "decode_wall_ms": timings["decode_s"] * 1e3,
        "decode_tokens_per_s": timings["decode_tokens_per_s"],
        "peak_gib": peak,
        "decode_vs_prefill": {
            "bf16_full_depth": {"rel": full_rel, "argmax_agree": full_agree},
            "float32_full_depth": {"rel": f32_rel, "argmax_agree": f32_agree,
                                   "held_at": DECODE_F32_REL},
            f"bf16_{DECODE_BF16_LAYERS}_layers": {
                "rel": cut_rel, "argmax_agree": cut_agree,
                "held_at": DECODE_BF16_REL}},
        "launches": launches}
    print(f"serve {cfg.name} oneshot: {json.dumps(summary)}; first row "
          f"{gen[0, :16].tolist()}", flush=True)
    if not f32_rel <= DECODE_F32_REL:
        raise AssertionError(f"float32 decode vs prefill: {f32_rel} of the "
                             f"largest logit, want <= {DECODE_F32_REL}")
    if not cut_rel <= DECODE_BF16_REL:
        raise AssertionError(f"bf16 decode vs prefill at "
                             f"{DECODE_BF16_LAYERS} layers: {cut_rel} of "
                             f"the largest logit, want <= {DECODE_BF16_REL}")
    del model, params
    _free(torch)
    return summary


# phase 13's float32 decode against prefill at 5 layers: (prompt, cache
# positions, steps): a prompt shorter than the window in a cache that
# serves 96 positions (the reference's decode attends over the prompt's
# length there), and one past the window
GRIFFIN_DECODE_CASES = ((64, 96, 32), (2100, 2108, 8))
GRIFFIN_DECODE_LAYERS = 5


def _oneshot_run(torch, ops, wl, argv, cut=None):
    """The oneshot serving workload of ``argv``, its config cut to the
    fields of ``cut`` if given: a short warm-up, then the timed run with
    the launches counted and the peak memory; returns ``(model, params,
    batch, args, tokens, timings, launches, peak)``."""
    from repro_torch.serve import build_oneshot_fns, oneshot_generate

    model, params, batch, args = wl.serve_setup(argv, **(cut or {}))
    cfg = model.config
    prefill, decode = build_oneshot_fns(model,
                                        args.prompt_len + args.gen)
    oneshot_generate(prefill, decode, params, batch, 2)       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    gen, timings = oneshot_generate(prefill, decode, params, batch, args.gen)
    launches = serve_launches(ops)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if gen.shape != (args.batch, args.gen) or not (
            (gen >= 0) & (gen < cfg.padded_vocab)).all():
        raise AssertionError(f"{cfg.name}: generated {gen.shape} tokens, "
                             f"range {gen.min()}..{gen.max()}")
    timings["prefill_ms"] = time_ms(torch, lambda: prefill(params, batch), 3)
    timings["decode_tokens_per_s"] = ((args.gen - 1) * args.batch
                                      / timings["decode_s"])
    return model, params, batch, args, gen, timings, launches, peak


def serve_griffin(torch, ops, wl):
    """RecurrentGemma-9B whole through the oneshot engine
    (``SERVE_GRIFFIN_ARGV``), no kernel of the port launched; then, in
    float32 at 5 layers, decode against a prefill of the extended prompt
    (``GRIFFIN_DECODE_CASES``), held at ``DECODE_F32_REL``."""
    import dataclasses
    from repro_torch.models.registry import build_model

    t0 = time.perf_counter()
    model, params, batch, args, gen, timings, launches, peak = _oneshot_run(
        torch, ops, wl, wl.SERVE_GRIFFIN_ARGV)
    cfg = model.config
    n_params = sum(t.numel() for k, t in params.items())
    if n_params != GRIFFIN_PARAMS:
        raise AssertionError(f"{cfg.name}: {n_params} params, want "
                             f"{GRIFFIN_PARAMS}")
    if any(launches.values()):
        raise AssertionError(f"{cfg.name} serving launched {launches}; its "
                             "path has no kernel of the port")
    B, plen = batch["tokens"].shape
    if plen <= cfg.attn_window:
        raise AssertionError("the workload's prompt does not pass the window")
    # float32 at 5 layers: one superblock and the 2-layer tail
    f32 = build_model(dataclasses.replace(cfg, compute_dtype="float32",
                                          n_layers=GRIFFIN_DECODE_LAYERS),
                      model.quant)
    del params, model
    _free(torch)
    p32 = f32.prepare(f32.init(args.seed))
    gen32 = torch.Generator(device="cuda").manual_seed(SEED + 13)
    cases = {}
    for prompt, cache_len, steps in GRIFFIN_DECODE_CASES:
        tokens = torch.randint(0, cfg.vocab_size, (2, prompt), device="cuda",
                               generator=gen32)
        rel, agree = _decode_vs_prefill(torch, f32, p32, tokens, steps,
                                        cache_len=cache_len)
        cases[f"prompt {prompt}, cache {cache_len}, {steps} steps"] = {
            "rel": rel, "argmax_agree": agree, "held_at": DECODE_F32_REL}
        if not rel <= DECODE_F32_REL:
            raise AssertionError(f"griffin float32 decode vs prefill, prompt "
                                 f"{prompt}: {rel} of the largest logit, "
                                 f"want <= {DECODE_F32_REL}")
    summary = {
        "params": n_params, "batch": B, "prompt": plen,
        "new_tokens": args.gen, "prefill_ms": timings["prefill_ms"],
        "prefill_wall_ms": timings["prefill_s"] * 1e3,
        "decode_wall_ms": timings["decode_s"] * 1e3,
        "decode_tokens_per_s": timings["decode_tokens_per_s"],
        "peak_gib": peak,
        "decode_vs_prefill_float32_5_layers": cases,
        "wall_s": time.perf_counter() - t0}
    print(f"serve {cfg.name} oneshot: {json.dumps(summary)}; first row "
          f"{gen[0, :16].tolist()}", flush=True)
    del p32
    _free(torch)
    return summary


def vlm_masked_prefix(torch, tr):
    """With the trained params of an InternVL2-1B trainer ``tr``, on 2
    sequences of the workload's length with a Gaussian vision prefix:
    the token ids under the prefix change nothing, bit for bit, and the
    loss is the mean NLL of the unmasked predictions computed apart
    (within 1e-5)."""
    from repro_torch.models import transformer as tfm

    cfg = tr.run.model
    nv, S = cfg.n_vision_tokens, tr.run.seq_len
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    tokens = torch.randint(0, cfg.vocab_size, (2, S), device="cuda",
                           generator=gen)
    vision = torch.randn((2, nv, cfg.d_model), device="cuda",
                         generator=gen).to(torch.bfloat16)
    flags = tr._set_flags(tr.scheduler.current.flags())
    other = tokens.clone()
    other[:, :nv] = (other[:, :nv] + 1) % cfg.vocab_size
    with torch.no_grad():
        loss = tr.model.loss_fn(tr.params, {"tokens": tokens,
                                            "vision_embeds": vision}, flags)
        same = tr.model.loss_fn(tr.params, {"tokens": other,
                                             "vision_embeds": vision}, flags)
        h = tfm.forward_hidden(tr.params, tokens, flags, cfg, tr.model.quant,
                               inputs_embeds=vision)
        logits = h[:, nv:-1].float() @ tr.params["embed"].float().T
        logits[..., cfg.vocab_size:] = -1e30
        nll = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]),
            tokens[:, nv + 1:].reshape(-1).long())
    if not torch.equal(loss, same):
        raise AssertionError("vlm: the token ids under the vision prefix "
                             "change the loss")
    rel = abs(loss.item() - nll.item()) / abs(nll.item())
    if not rel <= 1e-5:
        raise AssertionError(f"vlm: loss {loss.item()} against the unmasked "
                             f"predictions' mean NLL {nll.item()}")
    return {"loss": loss.item(), "unmasked_mean_nll": nll.item(), "rel": rel}


def serve_vlm(torch, ops, wl):
    """InternVL2-1B whole through the oneshot engine (``SERVE_VLM_ARGV``,
    the luq_fp4 head on the cuda backend): ``luq_matmul`` launched at
    prefill and every decode step; then, in float32 with an exact head,
    decode against a prefill of the extended prompt (the same vision
    prefix), held at ``DECODE_F32_REL``; returns the summary and the
    launches."""
    import dataclasses
    from repro_torch.config import QuantConfig
    from repro_torch.models.registry import build_model

    model, params, batch, args, gen, timings, launches, peak = _oneshot_run(
        torch, ops, wl, wl.SERVE_VLM_ARGV)
    cfg = model.config
    want = {"luq_matmul[prefill]": 1, "luq_matmul[decode]": args.gen - 1}
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"{cfg.name} serving: {k} launched "
                                 f"{launches[k]} times, want {n}")
    f32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                      QuantConfig(fmt="none"))
    p32 = f32.prepare(f32.init(args.seed))
    rel, agree = _decode_vs_prefill(
        torch, f32, p32, batch["tokens"], 3,
        extra={"vision_embeds": batch["vision_embeds"].float()})
    summary = {
        "batch": args.batch, "prompt": args.prompt_len,
        "vision_tokens": cfg.n_vision_tokens, "new_tokens": args.gen,
        "prefill_ms": timings["prefill_ms"],
        "prefill_wall_ms": timings["prefill_s"] * 1e3,
        "decode_wall_ms": timings["decode_s"] * 1e3,
        "decode_tokens_per_s": timings["decode_tokens_per_s"],
        "peak_gib": peak, "launches": launches,
        "decode_vs_prefill_float32": {"rel": rel, "argmax_agree": agree,
                                      "held_at": DECODE_F32_REL}}
    print(f"serve {cfg.name} oneshot: {json.dumps(summary)}; first row "
          f"{gen[0, :16].tolist()}", flush=True)
    if not rel <= DECODE_F32_REL:
        raise AssertionError(f"vlm float32 decode vs prefill: {rel} of the "
                             f"largest logit, want <= {DECODE_F32_REL}")
    del model, params, p32
    _free(torch)
    return summary, launches


def whisper_input_host_ms(tr) -> dict:
    """The host time a step of the whisper-medium trainer ``tr`` spends
    making its batch: ``get`` of a batch from a fresh copy of its dataset
    (the planted-bigram tokens, drawn and then cached, and the encoder
    frames, drawn every time), and again with the tokens cached (the
    frames alone)."""
    import dataclasses
    n = tr.run.global_batch
    ds = dataclasses.replace(tr.dataset)          # its token cache empty
    idx = list(range(n))
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        batch = ds.get(idx)
        times.append((time.perf_counter() - t0) * 1e3)
    shape = tuple(batch["enc_embeds"].shape)
    return {"batch": n, "enc_embeds": shape, "get_ms": times[0],
            "get_tokens_cached_ms": times[1]}


def serve_whisper(torch, ops, wl):
    """whisper-medium whole through the oneshot engine
    (``SERVE_WHISPER_ARGV``: 8 prompts of 384 tokens with 384 Gaussian
    encoder frames, 64 new tokens, greedy, bf16, eager decode steps): the
    parameter count, the cache's 448 rows, the tokens' shape and range, no
    kernel of the port launched (the path has none); then, in float32 at
    full depth, decode against a prefill of the extended prompt (the same
    encoder frames), held at ``DECODE_F32_REL``."""
    import dataclasses
    from repro_torch.config import QuantConfig
    from repro_torch.models.registry import build_model

    t0 = time.perf_counter()
    model, params, batch, args, gen, timings, launches, peak = _oneshot_run(
        torch, ops, wl, wl.SERVE_WHISPER_ARGV)
    cfg = model.config
    n_params = sum(t.numel() for t in params.values())
    if n_params != WHISPER_PARAMS:
        raise AssertionError(f"{cfg.name}: {n_params} params, want "
                             f"{WHISPER_PARAMS}")
    if any(launches.values()):
        raise AssertionError(f"{cfg.name} serving launched {launches}; its "
                             "path has no kernel of the port")
    B, plen = batch["tokens"].shape
    if batch["enc_embeds"].shape != (B, plen, cfg.d_model):
        raise AssertionError(f"enc_embeds {tuple(batch['enc_embeds'].shape)}")
    _, cache = model.prefill(params, batch, cache_len=plen + args.gen)
    rows = cache["self_k"].shape[3], cache["cross_k"].shape[3]
    if rows != (plen + args.gen,) * 2:
        raise AssertionError(f"cache rows {rows}, want {plen + args.gen}")
    del cache, params, model
    _free(torch)
    f32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                      QuantConfig(fmt="none"))
    p32 = f32.prepare(f32.init(args.seed))
    rel, agree = _decode_vs_prefill(
        torch, f32, p32, batch["tokens"], 3,
        extra={"enc_embeds": batch["enc_embeds"].float()})
    summary = {
        "params": n_params, "batch": B, "prompt": plen,
        "new_tokens": args.gen, "cache_rows": rows[0],
        "prefill_ms": timings["prefill_ms"],
        "prefill_wall_ms": timings["prefill_s"] * 1e3,
        "decode_wall_ms": timings["decode_s"] * 1e3,
        "decode_tokens_per_s": timings["decode_tokens_per_s"],
        "peak_gib": peak, "launches": launches,
        "decode_vs_prefill_float32": {"rel": rel, "argmax_agree": agree,
                                      "held_at": DECODE_F32_REL},
        "wall_s": time.perf_counter() - t0}
    print(f"serve {cfg.name} oneshot (no kernel of the port on this path: "
          f"float32 head, no KV format): {json.dumps(summary)}; first row "
          f"{gen[0, :16].tolist()}", flush=True)
    if not rel <= DECODE_F32_REL:
        raise AssertionError(f"whisper float32 decode vs prefill: {rel} of "
                             f"the largest logit, want <= {DECODE_F32_REL}")
    del p32
    _free(torch)
    return summary


# --------------------------------------------------------------------------- #
# 18. data parallelism: two ranks on the one card (gloo), one under NCCL
# --------------------------------------------------------------------------- #
DP_RANKS = 2         # ranks sharing the card in 18a and 18b


# The sharded sums against the one-process driver's where a rank's
# shorter pass rounds in another order (bf16) or can flip a LUQ code
# (luq_fp4): the relative L2 norm of the difference over every entry at
# most this.  Set from the readings on an H100 80GB HBM3 at 700 W (3.4e-3
# and 0.137, the same in every run; 2.6e-3 to 3.4e-3) at two to three
# times them; each luq_fp4 limit must also fail a control in which rank 1
# keys its quantizers from another seed (0.733 and 0.422 there).
DP_SUM_LIMITS = {"18a bfloat16 none": 1e-2,
                 "18a bfloat16 luq_fp4": 0.3,
                 "18b luq_fp4": 1e-2}


def _diffs(torch, got: dict, want: dict, metrics: dict,
           wmetrics: dict) -> dict:
    """The sums' largest absolute difference, that over the largest
    |want|, and the relative L2 norm of the difference; both metrics."""
    diff = max((got[k].float() - want[k].float()).abs().max().item()
               for k in want)
    scale = max(want[k].float().abs().max().item() for k in want)
    dn = sum((got[k].float() - want[k].float()).square().sum().item()
             for k in want)
    wn = sum(want[k].float().square().sum().item() for k in want)
    return {"sums": {"max_abs": diff,
                     "rel_to_max": diff / scale if scale else diff,
                     "rel_norm": (dn / wn) ** 0.5 if wn else dn ** 0.5},
            "metrics": {k: [float(metrics[k]), float(wmetrics[k])]
                        for k in wmetrics}}


def _hold_dp(torch, name, got, want, metrics, wmetrics) -> dict:
    """The sharded clipped sum and metrics against the one-process
    driver's: the metrics at rtol 2e-4 / atol 2e-5 (the reference's
    float32 tolerances); the sums at those tolerances, or, where
    ``DP_SUM_LIMITS`` names ``name``, within its limit."""
    out = _diffs(torch, got, want, metrics, wmetrics)
    for k in wmetrics:
        torch.testing.assert_close(
            metrics[k], wmetrics[k], rtol=2e-4, atol=2e-5,
            msg=lambda m, k=k: f"{name} metric {k}: {m}")
    limit = DP_SUM_LIMITS.get(name)
    if limit is None:
        for k in want:
            torch.testing.assert_close(
                got[k], want[k], rtol=2e-4, atol=2e-5,
                msg=lambda m, k=k: f"{name} {k}: {m}")
    elif not out["sums"]["rel_norm"] <= limit:
        raise AssertionError(f"{name}: sums {out['sums']} beyond the "
                             f"limit {limit}")
    return out


def _control(torch, name, ctrl, want) -> dict:
    """The control of ``name``'s limit: sums made with rank 1's
    quantizers keyed from another seed must lie beyond it."""
    sums = _diffs(torch, ctrl, want, {}, {})["sums"]
    if not sums["rel_norm"] > DP_SUM_LIMITS[name]:
        raise AssertionError(f"{name}: the limit {DP_SUM_LIMITS[name]} "
                             f"passes a rank-dependent quantizer key "
                             f"({sums})")
    return sums


@contextlib.contextmanager
def _other_key_on_rank(rank: int):
    """On a rank other than 0, the quantizers' (and the ghost-norm
    kernel's) Philox streams keyed from another seed, for a control."""
    from repro_torch.quant import fake_quant
    key = fake_quant.stream_key
    if rank != 0:
        fake_quant.stream_key = lambda seed, fold: key(
            (seed + 7919) % 2 ** 32, fold)
    try:
        yield
    finally:
        fake_quant.stream_key = key


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def dp_ghost_lm(torch, ops, wl, mesh) -> dict:
    """18a on one rank: stablelm-3b at full width cut to 2 layers (remat),
    ghost, 8 x 256 tokens, pass-1 chunks of 4.  The sharded driver (this
    rank's 4 sequences, one all-reduce of the clipped sums) in float32 at
    fmt none, and in bf16 (the config's) at fmt none and at luq_fp4;
    rank 0 also runs the one-process unsharded driver on all 8 and holds
    the two (``_hold_dp``): the metrics always at the float32
    tolerances, the sums too in float32; in bf16 a rank's pass 2 over 4
    sequences rounds its products and the embedding's scatter-sums in
    another order than over 8 (on an H100 at 700 W: 4.6e-5 apart in
    1,563 of the embedding's 128,778,240 entries at fmt none), and at
    luq_fp4 such a difference can flip a code, so there the sums are held
    within ``DP_SUM_LIMITS``, and at luq_fp4 a control with rank 1's
    quantizers keyed from another seed must fail that limit; the kernels
    each rank launched; then one full DP step of the LM workload through
    ``build_train_setup`` on the mesh, after which the ranks' params must
    be the same bits."""
    import dataclasses
    import numpy as np
    from repro_torch.config import QuantConfig
    from repro_torch.dp.ghost import (ghost_clipped_grad_sum,
                                      sharded_ghost_clipped_grad_sum)
    from repro_torch.launch.steps import build_train_setup
    from repro_torch.models.registry import build_model
    from repro_torch.parallel.collectives import all_reduce_sum, replicas_agree

    world = mesh.axis_group(mesh.axis_names)
    run, ds, _ = wl.setup(wl.TRAIN_LM_ARGV, n_layers=2)
    cfg = run.model
    batch = {"tokens": ds.get(np.arange(wl.TRAIN_LM_BATCH))["tokens"].cuda()}
    flags = torch.ones(cfg.policy_len(), device="cuda")
    out = {}
    for dtype, fmt in (("float32", "none"), ("bfloat16", "none"),
                       ("bfloat16", "luq_fp4")):
        model = build_model(dataclasses.replace(cfg, compute_dtype=dtype),
                            QuantConfig(fmt=fmt, backend="cuda"))
        params = model.init(wl.SEED)
        if not replicas_agree(params.values(), world):
            raise AssertionError("the ranks' initial params differ")
        kw = dict(clip_norm=run.dp.clip_norm,
                  hooked_mask=model.ghost_mask(params),
                  aux=model.ghost_aux(flags),
                  ghost_microbatch=wl.TRAIN_LM_CHUNK)

        def pel(p, b, hooks):
            return model.per_example_loss(p, b, flags, hooks=hooks)

        def sharded():
            return sharded_ghost_clipped_grad_sum(pel, params, batch,
                                                  mesh=mesh, **kw)

        sharded()                                   # warm-up
        ops.reset_launch_counts()
        (got, metrics), wall = _timed(torch, sharded)
        launches = dict(ops.LAUNCHES)
        _, ar_ms = _timed(torch, lambda: all_reduce_sum(
            got, mesh.axis_group(("data",))))
        res = {"wall_ms": wall, "all_reduce_ms": ar_ms,
               "all_reduce_bytes": sum(t.numel() * 4 for t in got.values()),
               "launches": launches}
        if fmt == "luq_fp4" and (
                launches["ghost_norm_sq"] < 7 * cfg.n_layers
                or launches["luq_quant"] < 7 * cfg.n_layers
                or launches["clip_and_sum"]):
            raise AssertionError(f"18a {fmt}: launches {launches}")
        name = f"18a {dtype} {fmt}"
        if mesh.rank == 0:
            (want, wmetrics), res["one_process_ms"] = _timed(
                torch, lambda: ghost_clipped_grad_sum(pel, params, batch,
                                                      **kw))
            res.update(_hold_dp(torch, name, got, want, metrics, wmetrics))
        if fmt == "luq_fp4":
            del got
            with _other_key_on_rank(mesh.rank):
                got, _ = sharded()
            if mesh.rank == 0:
                res["control"] = _control(torch, name, got, want)
        if mesh.rank == 0:
            del want
        out[f"{dtype} {fmt}"] = res
        del got, params, model
        _free(torch)

    # one full DP step of the workload (loop executor) on the mesh
    model = build_model(cfg, run.quant)
    setup = build_train_setup(model, run, mesh)
    if not setup.ghost_sharded:
        raise AssertionError("18a: the LM workload's step is not sharded")
    params = model.init(run.seed)
    opt = setup.opt_init_fn(params)
    lr = torch.tensor(run.optim.lr, device="cuda")
    setup.step_fn(params, opt, batch, 0, flags, lr)          # warm-up
    (p1, _, m), out["dp_step_ms"] = _timed(
        torch, lambda: setup.step_fn(params, opt, batch, 1, flags, lr))
    out["dp_step_loss"] = float(m["loss"])
    out["params_agree"] = replicas_agree(p1.values(), world)
    if not out["params_agree"]:
        raise AssertionError("18a: the ranks' params differ after a step")
    del p1, params, opt, model, setup
    _free(torch)
    return out


def dp_vmap_resnet(torch, ops, wl, mesh) -> dict:
    """18b on one rank: ResNet-18 whole in the vmap engine, a global batch
    of 256 in global microbatches of 64, 32 a rank: the fused clip with
    ``partial_accum`` off (the clip launched once a local microbatch) and
    the plain clip with it on (``fused`` with ``partial_accum`` raises, as
    in the reference), at fmt none and luq_fp4, each against rank 0's
    one-process engine on the same 256 in microbatches of 32, the rank's
    shapes (``_hold_dp``: the metrics at the float32 tolerances, the sums
    too at fmt none and within ``DP_SUM_LIMITS`` at luq_fp4, where the
    fused clip's run is repeated as a control with rank 1's quantizers
    keyed from another seed, which must fail that limit), and in
    microbatches of 64
    (printed: cuDNN's per-example wgrads of 64 examples are not those of
    32 in float32; on an H100 at 700 W 5.6e-5 apart in the stem at fmt
    none); then one full DP step of the workload through
    ``build_train_setup`` on the mesh with each setting, after which the
    ranks' params must be the same bits.  Each engine call's wall is
    printed beside one all-reduce of its sums (45 MB; the call makes 4
    without ``partial_accum``, 1 with it)."""
    import dataclasses
    import numpy as np
    from repro_torch.config import QuantConfig
    from repro_torch.dp.clip import per_example_clipped_grad_sum
    from repro_torch.launch.steps import build_train_setup
    from repro_torch.models.registry import build_model
    from repro_torch.parallel.collectives import all_reduce_sum, replicas_agree

    world = mesh.axis_group(mesh.axis_names)
    shard = mesh.axis_group(("data",))
    run, ds, _ = wl.setup(wl.TRAIN_ARGV)
    mb = wl.TRAIN_MICROBATCH                      # the global microbatch
    run = dataclasses.replace(run, dp=dataclasses.replace(
        run.dp, microbatch_size=mb // DP_RANKS))
    host = ds.get(np.arange(run.global_batch))
    batch = {k: v.cuda() for k, v in host.items()}
    flags = torch.ones(run.model.policy_len(), device="cuda")
    try:
        per_example_clipped_grad_sum(None, {}, batch, clip_norm=1.0,
                                     microbatch_size=mb,
                                     clip_backend="fused", shard=shard,
                                     partial_accum=True)
        raise AssertionError("18b: fused clip with partial_accum ran")
    except ValueError:
        pass
    out = {}
    for fmt in ("none", "luq_fp4"):
        model = build_model(run.model, QuantConfig(fmt=fmt, backend="cuda"))
        params = model.init(run.seed)

        def loss_one(p, ex):
            return model.loss_fn(p, {k: v[None] for k, v in ex.items()},
                                 flags)

        for clip, partial in (("fused", False), ("ref", True)):
            def engine(sh, size=mb):
                return per_example_clipped_grad_sum(
                    loss_one, params, batch, clip_norm=run.dp.clip_norm,
                    microbatch_size=size, clip_backend=clip, shard=sh,
                    partial_accum=partial and sh is not None)

            engine(shard)                           # warm-up
            ops.reset_launch_counts()
            (got, metrics), wall = _timed(torch, lambda: engine(shard))
            launches = dict(ops.LAUNCHES)
            want_clips = run.global_batch // mb if clip == "fused" else 0
            if launches["clip_and_sum"] != want_clips:
                raise AssertionError(f"18b {fmt} {clip}: clip launched "
                                     f"{launches['clip_and_sum']} times, "
                                     f"want {want_clips}")
            _, ar_ms = _timed(torch, lambda: all_reduce_sum(got, shard))
            res = {"wall_ms": wall, "all_reduce_ms": ar_ms,
                   "launches": launches}
            if mesh.rank == 0:
                # the rank's shapes (microbatches of 32): the same
                # per-example gradients, summed in another order
                (want, wmetrics), res["one_process_ms"] = _timed(
                    torch, lambda: engine(None, mb // DP_RANKS))
                res.update(_hold_dp(torch, f"18b {fmt}", got, want,
                                    metrics, wmetrics))
                # the global microbatch of 64 in one process: other conv
                # shapes (printed)
                w64, m64 = engine(None)
                res["vs_microbatch_64"] = _diffs(torch, got, w64, metrics,
                                                 m64)
                del w64
            if fmt == "luq_fp4" and clip == "fused":
                del got
                with _other_key_on_rank(mesh.rank):
                    got, _ = engine(shard)
                if mesh.rank == 0:
                    res["control"] = _control(torch, f"18b {fmt}", got,
                                              want)
            if mesh.rank == 0:
                del want
            out[f"{fmt} {clip} partial={partial}"] = res
            del got
            _free(torch)
        del params, model
        _free(torch)

    for clip, partial in (("fused", False), ("ref", True)):
        r = dataclasses.replace(run, dp=dataclasses.replace(
            run.dp, clip_backend=clip, partial_accum=partial))
        model = build_model(r.model, r.quant)
        setup = build_train_setup(model, r, mesh)
        params = model.init(r.seed)
        opt = setup.opt_init_fn(params)
        lr = torch.tensor(r.optim.lr, device="cuda")
        setup.step_fn(params, opt, batch, 0, flags, lr)      # warm-up
        (p1, _, m), ms = _timed(
            torch, lambda: setup.step_fn(params, opt, batch, 1, flags, lr))
        agree = replicas_agree(p1.values(), world)
        out[f"dp_step {clip} partial={partial}"] = {
            "ms": ms, "loss": float(m["loss"]), "params_agree": agree}
        if not agree:
            raise AssertionError(f"18b {clip}: the ranks' params differ")
        del p1, params, opt, model, setup
        _free(torch)
    return out


def dp_rank_main(argv) -> int:
    """One rank of phase 18: ``chip_smoke.py --dp-rank RANK PORT OUT``
    (started by :func:`data_parallel`): joins a gloo group of
    ``DP_RANKS`` ranks on this card, runs 18a and 18b, and rank 0 writes
    their results to ``OUT`` as JSON."""
    import torch
    import torch.distributed as dist

    rank, port, path = int(argv[0]), int(argv[1]), argv[2]
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build, ops
    from repro_torch.launch import workload as wl
    from repro_torch.launch.mesh import init_distributed, make_host_mesh

    build.load_library()
    init_distributed("cuda", share_device=True,
                     init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                     world_size=DP_RANKS)
    try:
        mesh = make_host_mesh()
        t0 = time.perf_counter()
        out = {"lm": dp_ghost_lm(torch, ops, wl, mesh)}
        out["lm"]["wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["resnet"] = dp_vmap_resnet(torch, ops, wl, mesh)
        out["resnet"]["wall_s"] = time.perf_counter() - t0
        out["backend"] = dist.get_backend()
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        Path(f"{path}.{rank}").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def nccl_capture_main(argv) -> int:
    """18c: ``chip_smoke.py --nccl-capture PORT OUT``: one rank under
    NCCL; a ``StepGraph`` around ``all_reduce_sum`` of a dict of float32
    tensors, captured after the warm-up the scan executor's
    ``EpochRunner`` runs (one collective on the group, then the step, on
    the side stream), replayed twice with new inputs copied in between:
    each replay gives back its input bit for bit."""
    import torch
    import torch.distributed as dist

    port, path = int(argv[0]), argv[1]
    sys.path.insert(0, str(SRC))
    from repro_torch.graph import StepGraph
    from repro_torch.launch.mesh import AxisGroup, init_distributed
    from repro_torch.parallel.collectives import all_reduce_sum

    dev = init_distributed("cuda", init_method=f"tcp://127.0.0.1:{port}",
                           rank=0, world_size=1)
    out = {"backend": dist.get_backend()}
    try:
        axis = AxisGroup(dist.group.WORLD, 0, 1)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        static = {"a": torch.randn(1 << 20, device=dev, generator=gen),
                  "b": torch.randn(37, 5, device=dev, generator=gen)}

        def fn():
            return all_reduce_sum(static, axis)

        def warmup():
            # EpochRunner's: one collective on the group, then the step
            dist.all_reduce(torch.zeros(1, device=dev))
            return fn()

        graph = StepGraph(fn, dev, warmup=warmup)
        for i in range(2):
            for t in static.values():
                t.copy_(torch.randn(t.shape, device=dev, generator=gen))
            got = graph()
            torch.cuda.synchronize()
            for k, t in static.items():
                if not torch.equal(got[k], t):
                    raise AssertionError(f"18c replay {i}: {k} differs")
        out["replays"] = graph.replays
        Path(path).write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(args: list, timeout: float) -> None:
    """Run ``chip_smoke.py`` processes with ``args`` (one list each) at
    once, print what they printed, and raise if one failed or outlived
    ``timeout``; none is left running."""
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               *map(str, a)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a in args]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for a, p, log in zip(args, procs, logs):
        for line in log.splitlines()[-40:]:
            print(f"  [{a[0]} {a[1]}] {line}")
        if p.returncode != 0:
            raise AssertionError(f"{a}: exit code {p.returncode}")


def data_parallel(torch, card: str) -> dict:
    """Phase 18: ``DP_RANKS`` ranks on this card over gloo (18a, 18b:
    :func:`dp_rank_main`), then one rank under NCCL (18c:
    :func:`nccl_capture_main`); prints and returns their results."""
    out_dir = ROOT / "build" / "chip_smoke_dp"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "ranks.json"
    port = _free_port()
    t0 = time.perf_counter()
    _spawn([["--dp-rank", r, port, path] for r in range(DP_RANKS)], 900)
    ranks_s = time.perf_counter() - t0
    result = json.loads(Path(f"{path}.0").read_text())
    t0 = time.perf_counter()
    _spawn([["--nccl-capture", _free_port(), out_dir / "nccl.json"]], 300)
    result["nccl_capture"] = json.loads((out_dir / "nccl.json").read_text())
    result["walls_s"] = {"ranks": ranks_s,
                         "nccl_capture": time.perf_counter() - t0}
    print(f"data parallel, {DP_RANKS} ranks on one card ({card}): "
          f"{json.dumps(result)}", flush=True)
    return result


@contextlib.contextmanager
def _moe_drops():
    """Records the dropped share of (token, slot) pairs of each call of the
    MoE capacity dispatch inside the block, in a list it yields."""
    from repro_torch.models import moe
    shares, orig = [], moe._positions

    def spy(ids, n_experts, capacity):
        pos, overflow = orig(ids, n_experts, capacity)
        shares.append(overflow.float().mean().item())
        return pos, overflow

    moe._positions = spy
    try:
        yield shares
    finally:
        moe._positions = orig


def moe_dropped_share(torch, tr) -> dict:
    """With the trained params of the arctic-480b trainer ``tr``, a
    training batch of the workload (its first ``global_batch`` sequences)
    under the current policy: the dropped share of (token, slot) pairs in
    each layer, the capacity and the mean load an expert."""
    import numpy as np
    from repro_torch.models import moe

    cfg = tr.run.model
    batch = tr._to_device(tr.dataset.get(np.arange(tr.run.global_batch)))
    flags = tr._set_flags(tr.scheduler.current.flags())
    with torch.no_grad(), _moe_drops() as shares:
        loss = tr.model.loss_fn(tr.params, batch, flags)
    S = tr.run.seq_len
    return {"dropped_share_by_layer": shares,
            "capacity": moe._capacity(cfg, S),
            "mean_load": S * cfg.top_k / cfg.n_experts,
            "loss": loss.item()}


def moe_decode_vs_prefill(torch, wl) -> dict:
    """The phase-19 cut of arctic-480b in float32 with the capacity factor
    at E / k (C = S, nothing dropped): ``MOE_DECODE_STEPS`` greedy decode
    steps after a prompt of ``MOE_DECODE_PROMPT`` tokens, each step's
    logits against a prefill of the extended prompt, held at
    ``DECODE_F32_REL``; at the published factor, where the prompt's
    prefill drops pairs and one-token decode never does, the same gap
    printed, not held."""
    import dataclasses
    from repro_torch.config import QuantConfig
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    base = dataclasses.replace(get_config("arctic-480b"), **wl.TRAIN_MOE_CUT,
                               compute_dtype="float32",
                               param_dtype="float32")
    full = dataclasses.replace(base, moe_capacity_factor=(
        base.n_experts / base.top_k))
    model = build_model(full, QuantConfig(fmt="none"))
    params = model.prepare(model.init(SEED))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    tokens = torch.randint(0, base.vocab_size, (2, MOE_DECODE_PROMPT),
                           device="cuda", generator=gen)
    rel, agree = _decode_vs_prefill(torch, model, params, tokens,
                                    MOE_DECODE_STEPS)
    published = build_model(base, QuantConfig(fmt="none"))
    with _moe_drops() as shares:
        published.prefill(params, {"tokens": tokens})
    pub_rel, pub_agree = _decode_vs_prefill(torch, published, params, tokens,
                                            MOE_DECODE_STEPS)
    out = {"factor_E_over_k": {"rel": rel, "argmax_agree": agree,
                               "held_at": DECODE_F32_REL},
           f"factor_{base.moe_capacity_factor}": {
               "rel": pub_rel, "argmax_agree": pub_agree,
               "prompt_dropped_share_by_layer": shares}}
    del params
    _free(torch)
    if not rel <= DECODE_F32_REL:
        raise AssertionError(f"moe float32 decode vs prefill at factor E/k: "
                             f"{rel} of the largest logit, want <= "
                             f"{DECODE_F32_REL}")
    return out


def serve_moe(torch, ops, wl) -> dict:
    """arctic-480b and kimi-k2-1t-a32b, one after the other, one full
    layer with every published expert through the oneshot engine
    (``SERVE_MOE_ARGV``: 8 prompts of 512 tokens, 32 new tokens, greedy,
    bf16, eager decode steps): the parameter count, the tokens' shape and
    range, no kernel of the port launched, the prefill's logits finite;
    prints prefill ms, decode tokens/s, a decode step's time against the
    least time of reading every expert's weights once (and every weight
    the step reads: the experts, attention, the residual MLP, the router
    and the float32 head), the prefill's dropped share and the peak."""
    from repro_torch.launch import roofline
    out = {}
    for arch in wl.MOE_SERVE_ARCHS:
        t0 = time.perf_counter()
        model, params, batch, args, gen, timings, launches, peak = \
            _oneshot_run(torch, ops, wl, wl.SERVE_MOE_ARGV[arch],
                         cut=wl.SERVE_MOE_CUT)
        cfg = model.config
        n_params = sum(t.numel() for k, t in params.items()
                       if k != "head_f32")
        if n_params != MOE_SERVE_PARAMS[arch]:
            raise AssertionError(f"{arch}: {n_params} params, want "
                                 f"{MOE_SERVE_PARAMS[arch]}")
        if any(launches.values()):
            raise AssertionError(f"{arch} serving launched {launches}; its "
                                 "path has no kernel of the port")
        with torch.no_grad(), _moe_drops() as shares:
            logits, _ = model.prefill(params, batch)
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{arch}: prefill logits not finite")
        expert_bytes = sum(t.numel() * t.element_size()
                           for k, t in params.items()
                           if k.split(".")[-1] in ("e_gate", "e_up",
                                                   "e_down"))
        read_bytes = sum(t.numel() * t.element_size()
                         for k, t in params.items() if k != "embed")
        step_ms = timings["decode_s"] / (args.gen - 1) * 1e3
        B, plen = batch["tokens"].shape
        out[arch] = {
            "params": n_params, "experts": cfg.n_experts,
            "top_k": cfg.top_k, "layers": cfg.n_layers, "batch": B,
            "prompt": plen, "new_tokens": args.gen,
            "capacity_prefill": max(1, min(plen, math.ceil(
                plen * cfg.top_k * cfg.moe_capacity_factor
                / cfg.n_experts))),
            "prefill_ms": timings["prefill_ms"],
            "prefill_wall_ms": timings["prefill_s"] * 1e3,
            "decode_wall_ms": timings["decode_s"] * 1e3,
            "decode_step_ms": step_ms,
            "decode_tokens_per_s": timings["decode_tokens_per_s"],
            "decode_bound_experts_ms": roofline.memory_ms(expert_bytes),
            "decode_bound_all_weights_ms": roofline.memory_ms(read_bytes),
            "prefill_dropped_share": shares,
            "peak_gib": peak, "wall_s": time.perf_counter() - t0}
        print(f"serve {arch} oneshot, {cfg.n_layers} layer: "
              f"{json.dumps(out[arch])}; first row {gen[0, :16].tolist()}",
              flush=True)
        del model, params, batch, logits
        _free(torch)
    return out


# --------------------------------------------------------------------------- #
# phase 21: each workload's step against its roofline
# --------------------------------------------------------------------------- #
SHARE_LIMIT = 1.05        # bound / wall above it: the count claims too much
ROOFLINE_PHASE_S = 90.0   # phase 21's own limit
ANALYSIS_WORKERS = 6      # phase 21's trace processes (the host has 8 cores)
# the workloads whose kernel calls a trace must give as one eager step
# launches them: ResNet-18 vmap (luq_quant, clip), stablelm-3b ghost at
# phase 18's 2 layers (ghost_norm_sq) and a yi-6b decode tick at 2
# layers (luq_matmul, kv_quant_write, decode_attn_fused)
COUNT_LAYERS = 2


def _eager_step_launches(torch, ops, run) -> dict:
    """The kernel launches of one eager train step of ``run`` on the
    card: random init, a zero batch of the trainer's shapes, every
    layer's flag 1."""
    from repro_torch.launch.op_analysis import train_batch_spec
    from repro_torch.launch.steps import build_train_setup
    from repro_torch.models.registry import build_model

    model = build_model(run.model, run.quant, device="cuda")
    setup = build_train_setup(model, run)
    params = model.init(run.seed)
    opt_state = setup.opt_init_fn(params)
    batch = {k: torch.zeros(shape, dtype=dtype, device="cuda")
             for k, (shape, dtype) in train_batch_spec(
                 model, run.global_batch, run.seq_len).items()}
    qflags = torch.ones((run.model.policy_len(),), device="cuda")
    lr = torch.full((), run.optim.lr, device="cuda")
    torch.cuda.synchronize()
    before = ops.launch_counts()
    out = setup.step_fn(params, opt_state, batch, None, qflags, lr)
    torch.cuda.synchronize()
    launches = ops.launch_counts_since(before)["launches"]
    del model, params, opt_state, out
    _free(torch)
    return launches


def _decode_tick(torch, oa, wl, kv_fmt, n_layers=None, device="meta"):
    """``(model, params, cache, tokens, active)`` of a yi-6b decode tick
    (``wl.SLOTS`` slots of ``wl.MAX_SEQ`` positions, every slot active)
    on ``device`` (a trace's, inside ``oa.fake_device``, or the card)."""
    import dataclasses

    from repro_torch.config import QuantConfig
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve.slots import init_slot_cache

    cfg = get_config(wl.ARCH)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg, QuantConfig(fmt=wl.QUANT_FMT, backend="cuda"),
                        device=device)
    params = model.prepare(model.init(wl.SEED))
    cache = init_slot_cache(model, wl.SLOTS, wl.MAX_SEQ, kv_fmt=kv_fmt)
    tokens = torch.zeros((wl.SLOTS,), dtype=torch.int32, device=device)
    active = torch.ones((wl.SLOTS,), dtype=torch.bool, device=device)
    return model, params, cache, tokens, active


def _trace_tick(torch, oa, wl, kv_fmt, n_layers=None, device="meta"):
    """The analysis of one yi-6b decode tick (``model.decode_slots``, what
    the engine's decode graph runs), with its ``model_flops``."""
    from repro_torch.launch import roofline

    with oa.fake_device(device) as dev:
        model, params, cache, tokens, active = _decode_tick(
            torch, oa, wl, kv_fmt, n_layers, dev)
        with torch.no_grad():
            res = oa.trace(lambda *a: model.decode_slots(*a, kv_fmt=kv_fmt),
                           params, cache, tokens, active)
        res["model_flops"] = roofline.model_flops(
            model.config, params, "decode", wl.SLOTS, wl.MAX_SEQ)
    return res


def _hold_counts(name, got, want, kernels) -> None:
    for k in kernels:
        if got.get(k, 0) != want.get(k, 0) or not want.get(k, 0):
            raise AssertionError(f"{name}: {k} traced {got.get(k, 0)} "
                                 f"times, launched {want.get(k, 0)}")


def _analysis_job(job) -> dict:
    """One trace of phase 21 in a worker process (``meta`` tensors, no
    device): ``("train", name, argv, cut)``, ``("tick", name, kv_fmt)`` or
    ``("serve", name, arch)``; returns the analysis."""
    import dataclasses
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    from repro_torch.config import QuantConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import op_analysis as oa
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import workload as wl

    kind, _, arg = job[0], job[1], job[2:]
    if kind == "train":
        argv, cut = arg
        run, _, _ = wl.setup(argv, **cut)
        return oa.analyze_train(run)
    if kind == "tick":
        return _trace_tick(torch, oa, wl, arg[0])
    args = serve_cli.parse_args(list(wl.SERVE_MOE_ARGV[arg[0]]))
    cfg = dataclasses.replace(get_config(arg[0]), **wl.SERVE_MOE_CUT)
    return oa.analyze_serve(
        cfg, QuantConfig(fmt=args.quant_fmt, backend=args.backend),
        "decode", args.batch, args.prompt_len + args.gen, seed=args.seed)


def roofline_phase(torch, ops, wl, card, sm_clock_mhz, train_runs,
                   yi6b_ticks, yi6b_peak, moe_serve) -> dict:
    """Phase 21: each workload of the training and serving phases traced
    on the host (``repro_torch.launch.op_analysis``, ``meta`` tensors: no
    device memory; ``ANALYSIS_WORKERS`` processes, while this one runs
    :func:`roofline_counts` on the card) at its phase's ``RunConfig`` and
    cut, its terms (``launch.roofline``) held against the wall that phase
    measured (the fastest epoch's median step; the decode graph's replay;
    the MoE layer's eager decode step): every share ``bound_s / wall`` at
    most ``SHARE_LIMIT``.  The trace's peak is printed beside the phase's
    ``max_memory_allocated``.  At full depth a yi-6b tick's trace must
    count the launches the decode graph's capture ran."""
    import concurrent.futures
    import multiprocessing

    from repro_torch.launch import op_analysis as oa
    from repro_torch.launch import roofline

    jobs = ([("train", name, argv, cut)
             for name, (argv, cut, _) in train_runs.items()]
            + [("tick", f"yi-6b decode tick kv={kv}", kv) for kv in yi6b_ticks]
            + [("serve", f"{arch} decode step", arch) for arch in moe_serve])
    walls = {name: (min(summary["median_step_ms_by_epoch"]),
                    summary["peak_gib"])
             for name, (_, _, summary) in train_runs.items()}
    walls.update({f"yi-6b decode tick kv={kv}": (s["decode_tick_ms"],
                                                  yi6b_peak)
                  for kv, s in yi6b_ticks.items()})
    walls.update({f"{arch} decode step": (s["decode_step_ms"], s["peak_gib"])
                  for arch, s in moe_serve.items()})
    with concurrent.futures.ProcessPoolExecutor(
            ANALYSIS_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {job[1]: pool.submit(_analysis_job, job) for job in jobs}
        roofline_counts(torch, ops, wl, tuple(yi6b_ticks))
        results = {name: f.result() for name, f in futures.items()}

    out = {}
    for name, res in results.items():
        wall_ms, peak_gib = walls[name]
        terms = roofline.derive(res, model_flops_per_device=res["model_flops"],
                                sm_clock_mhz=sm_clock_mhz)
        share = terms.bound_s / (wall_ms / 1e3)
        rec = {"flops_by_class": terms.flops_by_class,
               "int_ops": terms.int_ops, "bytes": terms.bytes_accessed,
               "compute_s": terms.compute_s, "memory_s": terms.memory_s,
               "collective_s": terms.collective_s,
               "dominant": terms.dominant, "bound_s": terms.bound_s,
               "model_flops": terms.model_flops_per_device,
               "useful_ratio": terms.useful_ratio, "wall_ms": wall_ms,
               "share": share, "trips": res.get("trips", 1),
               "kernel_calls": oa.kernel_calls(res),
               "analysis_peak_gib": res["peak_bytes"] / 2**30,
               "measured_peak_gib": peak_gib, "warnings": res["warnings"],
               "trace_s": res["trace_s"]}
        print(f"roofline {name} ({card}): {json.dumps(rec)}", flush=True)
        if not share <= SHARE_LIMIT:
            raise AssertionError(f"{name}: bound {terms.bound_s} s over a "
                                 f"{wall_ms} ms step is a share of {share}, "
                                 f"above {SHARE_LIMIT}: the count claims "
                                 "more work than the card did")
        out[name] = {k: rec[k] for k in ("dominant", "bound_s", "wall_ms",
                                         "share", "useful_ratio")}
    for kv, summary in yi6b_ticks.items():
        _hold_counts(f"yi-6b tick kv={kv} (full depth, the graph's capture)",
                     oa.kernel_calls(results[f"yi-6b decode tick kv={kv}"]),
                     summary["tick_launches"],
                     ("luq_matmul", "kv_quant_write", "decode_attn_fused"))
    return out


def roofline_counts(torch, ops, wl, kv_fmts=("int8", "luq_fp4")) -> dict:
    """The kernel calls of a trace, on fake CUDA tensors
    (``FakeTensorMode``) and on ``meta`` ones alike, must be the launches
    of one eager step on the card: ResNet-18 vmap at its 4 microbatches,
    stablelm-3b ghost at 2 layers and a yi-6b decode tick at 2 layers, so
    all six kernels."""
    from repro_torch.launch import op_analysis as oa

    counted = {}
    for name, argv, cut, kernels in (
            ("resnet18 vmap", wl.TRAIN_ARGV, {},
             ("luq_quant", "clip_and_sum")),
            ("stablelm-3b ghost", wl.TRAIN_LM_ARGV,
             {"n_layers": COUNT_LAYERS}, ("ghost_norm_sq", "luq_quant"))):
        run, _, _ = wl.setup(argv, **cut)
        fake = oa.kernel_calls(oa.analyze_train(run, device="cuda"))
        meta = oa.kernel_calls(oa.analyze_train(run))
        eager = _eager_step_launches(torch, ops, run)
        _hold_counts(f"{name} (fake cuda)", fake, eager, kernels)
        _hold_counts(f"{name} (meta)", meta, eager, kernels)
        counted[name] = eager
    for kv_fmt in kv_fmts:
        fake = oa.kernel_calls(_trace_tick(torch, oa, wl, kv_fmt,
                                           COUNT_LAYERS, "cuda"))
        model, *tick = _decode_tick(torch, oa, wl, kv_fmt, COUNT_LAYERS,
                                    "cuda")
        torch.cuda.synchronize()
        before = ops.launch_counts()
        with torch.no_grad():
            model.decode_slots(*tick, kv_fmt=kv_fmt)
        torch.cuda.synchronize()
        eager = ops.launch_counts_since(before)["launches"]
        del model, tick
        _free(torch)
        _hold_counts(f"yi-6b tick kv={kv_fmt} at {COUNT_LAYERS} layers "
                     "(fake cuda)", fake, eager,
                     ("luq_matmul", "kv_quant_write", "decode_attn_fused"))
        counted[f"yi-6b tick kv={kv_fmt}"] = eager
    print(f"roofline kernel calls: traces == one eager step's launches: "
          f"{json.dumps(counted)}", flush=True)
    return counted


# --------------------------------------------------------------------------- #
# 22. the model axis: two ranks that split every layer, on the one card
# --------------------------------------------------------------------------- #
TP_RANKS = 2         # ranks sharing the card in phase 22
TP_DEVICE = "cuda"
# 22c's operands: a stablelm-3b q weight (d, heads, head_dim), split by
# heads; an arctic dispatch row (1, experts, slots, d), split by experts;
# an MLP's hidden rows (examples, tokens, 6,910), split in two (the
# element path); stablelm-3b's q / o taps (examples, tokens, d)
TP_KERNEL_SHAPES = {"lm_weight": (2560, 32, 80),
                    "moe_dispatch_rows": (1, 8, 80, 7168),
                    "element_path": (4, 256, 6910),
                    "ghost": (4, 256, 2560)}


# The sharded clipped sums (and the DP step's update) against the
# one-process ones where the sharded GEMMs' float32 order (a row-parallel
# partial sum, a GEMM of another width) can flip a LUQ code or a bf16
# rounding, and the flip cascades through the layers (and, in arctic,
# through the router's top-k): the relative L2 norm of the difference over
# every entry at most this.  Readings on an H100 80GB HBM3 at 700 W (the
# same in two calls): 22a float32 luq_fp4 0.3046, bf16 none 0.00571, bf16
# luq_fp4 0.3094, the step 4.29e-5; 22b float32 luq_fp4 0.5766, bf16
# luq_fp4 0.7407 (with float32 luq_fp4 too, dropped from the phase for
# its time), the step 2.92e-4; the controls, rank 1's quantizers
# keyed from another seed, 0.863 (22a) and 1.288 (22b).  Each limit is two
# to three times its reading, except 22b bf16 luq_fp4 (1.49 times): its
# control lies 1.74 times above the reading, and every luq_fp4 limit must
# fail its control.  float32 at fmt none is held at rtol 2e-4 / atol 2e-5.
TP_SUM_LIMITS = {"22a float32 luq_fp4": 0.62,
                 "22a bfloat16 none": 0.015,
                 "22a bfloat16 luq_fp4": 0.62,
                 "22b bfloat16 luq_fp4": 1.1,
                 "22a step": 1e-4,
                 "22b step": 7e-4}


def _tp_stats(torch, got: dict, want: dict) -> list:
    """[sum of squared differences, sum of squared wants, largest |diff|,
    largest |want|] of two dicts of tensors (got may lie on the host)."""
    out = [0.0, 0.0, 0.0, 0.0]
    for k, w in want.items():
        d = got[k].to(w.device).float() - w.float()
        out[0] += d.square().sum().item()
        out[1] += w.float().square().sum().item()
        out[2] = max(out[2], d.abs().max().item())
        out[3] = max(out[3], w.float().abs().max().item())
        del d
    return out


def _tp_kernels(torch, ops, ref, mesh, sm_clock_mhz) -> dict:
    """22c on one rank: the three kernels of the sharded step on this
    rank's shard of an operand, at the phase's shapes, against the plain
    version and, over both ranks, against the kernel's unsharded call on
    the whole operand: ``luq_quant`` given the ranks' max (``luq_row_max``,
    one all-reduce MAX, ``luq_round`` under the shard's index map), bit for
    bit, on a map that keeps Philox groups whole (a stablelm-3b q weight
    split by heads of 80; an arctic dispatch row split by experts) and on
    one that does not (an MLP of 6,910 split in two: the element path);
    the split clip (``clip_sumsq`` over the split columns, the
    replicated ones on the group's first rank only, one all-reduce SUM,
    ``clip_apply``) at the arctic cut's per-rank row: norms rtol 1e-5,
    sums within 1e-5 of sum_b |scale_b g_bd|; ``ghost_norm_sq`` of a
    column-parallel tap (the cotangent split) and a row-parallel one (the
    input split), the ranks' parts summed, within 1e-5 of sum |XX o GG|.
    Rank 0 times the kernels (``luq_row_max`` + ``luq_round``,
    ``clip_sumsq`` + ``clip_apply``, the mapped ``ghost_norm_sq`` with its
    row maxima) while rank 1 waits."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.launch import workload as wl
    from repro_torch.launch.steps import build_train_setup
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import axes as pax
    from repro_torch.parallel.collectives import model_reduce_
    from repro_torch.parallel import partitioner as pt
    from repro_torch.quant.fake_quant import _index_map, stream_key

    m = mesh.model_group()
    key = stream_key(97 + 1, 1)
    out = {}

    def split(t, dim):
        n = t.shape[dim] // m.size
        return t.narrow(dim, m.index * n, n).contiguous(), (
            dim, m.index * n, t.shape[dim])

    def timed(name, fn, plain, bound, library=None, extra=None):
        dist.barrier()
        res = {}
        if m.index == 0:
            res = {"ms": time_ms(torch, fn, 20), "plain_ms":
                   time_ms(torch, plain, 5), **bound,
                   "library_ms": None if library is None
                   else time_ms(torch, library, 20)}
        dist.barrier()
        res.update(extra or {})
        out[name] = res

    with pax.partitioning_context(m):
        # luq_quant on shards: (name, whole operand, split dim, rows)
        dev = TP_DEVICE
        gen = torch.Generator(device=dev).manual_seed(SEED + 22)
        shp = TP_KERNEL_SHAPES
        cases = (("luq_quant[tp_lm_weight]", shp["lm_weight"], 1, 1),
                 ("luq_quant[tp_moe_dispatch_rows]",
                  shp["moe_dispatch_rows"], 1, 1),
                 ("element path", shp["element_path"], 2,
                  shp["element_path"][0]))
        for name, shape, dim, rows in cases:
            whole = torch.randn(shape, device=dev, generator=gen)
            whole = whole.clamp(-3.5, 3.5).bfloat16()
            part, s = split(whole, dim)
            imap = _index_map(part.shape, s)
            prow = part.reshape(rows, -1)
            alpha = model_reduce_(ops.luq_row_max(prow), "max")
            got = ops.luq_round(prow, key, alpha, imap)
            want = ops.luq_quant(whole.reshape(rows, -1), key).reshape(
                whole.shape).narrow(dim, s[1], part.shape[dim])
            if not (torch.equal(got.reshape(part.shape), want)
                    and torch.equal(got, ref.luq_round_ref(
                        prow, key, alpha, imap))):
                raise AssertionError(f"22c {name}: the shard's rounding is "
                                     f"not the whole operand's slice")
            whole_groups = all(v % 4 == 0 for v in imap)
            if (name == "element path") == whole_groups:
                raise AssertionError(f"22c {name}: map {imap}")
            bound = kernel_bound("luq_quant", rows=rows, n=prow.shape[1],
                                 elem=2, sm_clock_mhz=sm_clock_mhz)
            extra = {"max_abs_err": 0.0, "index_map": list(imap),
                     "shard": list(part.shape)}
            if name == "element path":
                timed("luq_quant element path", lambda: ops.luq_round(
                    prow, key, alpha, imap), lambda: ref.luq_round_ref(
                    prow, key, alpha, imap), bound, extra=extra)
                continue
            timed(name, lambda: ops.luq_round(
                prow, key, ops.luq_row_max(prow), imap),
                lambda: ref.luq_round_ref(prow, key, ref.luq_row_max_ref(
                    prow), imap), bound, extra=extra)
        del whole, part, got, want
        out["luq_quant[tp_lm_weight]"]["element_path"] = out.pop(
            "luq_quant element path")

        # the split clip at the arctic cut's per-rank row
        run, _, _ = wl.setup(wl.TRAIN_MOE_ARGV, **wl.TRAIN_MOE_CUT)
        model = build_model(run.model, run.quant, device=dev)
        setup = build_train_setup(model, dataclasses.replace(
            run, model_parallel=m.size), mesh)
        shapes = setup.param_shapes
        rep = sum(math.prod(shapes[k]) for k, s in setup.param_specs.items()
                  if not pt.split_dims(s))
        split_n = sum(math.prod(shapes[k]) for k in shapes) - rep
        del model, setup
        d_loc = split_n // m.size
        cols = slice(m.index * d_loc, (m.index + 1) * d_loc)
        # the whole row (9.9 GB) on one rank at a time: its kernel call,
        # this rank's columns of it and of the result kept
        for r in range(m.size):
            if m.index == r:
                gen = torch.Generator(device=dev).manual_seed(SEED + 23)
                whole = torch.randn(1, split_n + rep, device=dev,
                                    generator=gen) * 1e-3
                want, wnorms = ops.clip_and_sum(whole, 1.0)
                want = torch.cat([want[cols], want[split_n:]])
                local = torch.cat([whole[:, cols], whole[:, split_n:]],
                                  dim=1)
                del whole
                _free(torch)
            dist.barrier()
        n_cols = local.shape[1] if m.index == 0 else d_loc
        sumsq = model_reduce_(ops.clip_sumsq(local, n_cols), "sum")
        got, norms = ops.clip_apply(local, sumsq, 1.0)
        torch.testing.assert_close(norms, wnorms, rtol=1e-5, atol=0.0)
        scale = torch.clamp(1.0 / torch.clamp(wnorms, min=1e-12), max=1.0)
        max_err, step = 0.0, 1 << 28
        for c0 in range(0, local.shape[1], step):
            err = (got[c0:c0 + step] - want[c0:c0 + step]).abs()
            tol = 1e-5 * scale[0] * local[0, c0:c0 + step].abs() + 1e-12
            if not (err <= tol).all():
                raise AssertionError(f"22c split clip: max abs err "
                                     f"{err.max().item()}")
            max_err = max(max_err, err.max().item())
        del want, got, err, tol
        _free(torch)

        def lib():
            n = torch.linalg.vector_norm(local, dim=1)
            return _rows_product(torch, torch.clamp(
                1.0 / torch.clamp(n, min=1e-12), max=1.0), local)

        timed("per_sample_clip[tp_moe]",
              lambda: ops.clip_apply(local, ops.clip_sumsq(local, n_cols),
                                     1.0),
              lambda: ref.clip_apply_ref(local, ref.clip_sumsq_ref(
                  local, n_cols), 1.0),
              kernel_bound("clip_and_sum", rows=1, n=local.shape[1]), lib,
              {"max_abs_err": max_err, "row": local.shape[1],
               "split_columns": d_loc, "replicated_columns": rep})
        del local
        _free(torch)

        # ghost_norm_sq of a column- and a row-parallel tap: stablelm-3b's
        # q projection (the cotangent split by heads) and its o projection
        # (the input split), 4 sequences of 256 tokens, bf16
        gen = torch.Generator(device=dev).manual_seed(SEED + 24)
        kx, kg = stream_key(97 * 1 + 3, 4), stream_key(97 * 1 + 3, 5)
        x = torch.randn(shp["ghost"], device=dev, generator=gen)
        g = torch.randn(shp["ghost"], device=dev, generator=gen) * 1e-3
        x, g = x.bfloat16(), g.bfloat16()
        B, T, D = shp["ghost"]
        res = {}
        for tap, (xs, gs) in (("column", (None, 2)), ("row", (2, None))):
            xl, sx = split(x, 2) if xs else (x, None)
            gl, sg = split(g, 2) if gs else (g, None)
            ax = (None if sx is None else model_reduce_(ops.luq_row_max(
                xl.reshape(B, -1)), "max"))
            ag = (None if sg is None else model_reduce_(ops.luq_row_max(
                gl.reshape(B, -1)), "max"))
            mx = None if sx is None else _index_map(xl.shape, sx)
            mg = None if sg is None else _index_map(gl.shape, sg)
            part = ops.ghost_norm_sq(xl, gl, kx, kg, alpha_x=ax, alpha_g=ag,
                                     map_x=mx, map_g=mg)
            if not torch.equal(part, ops.ghost_norm_sq(
                    xl, gl, kx, kg, alpha_x=ax, alpha_g=ag, map_x=mx,
                    map_g=mg)):
                raise AssertionError(f"22c ghost {tap}: two runs differ")
            total = model_reduce_(part.clone(), "sum")
            want = ops.ghost_norm_sq(x, g, kx, kg)
            xq = ref.luq_quant_ref(x.reshape(B, -1), kx).reshape(
                x.shape).double()
            gq = ref.luq_quant_ref(g.reshape(B, -1), kg).reshape(
                g.shape).double()
            tol = 1e-5 * ((xq @ xq.transpose(1, 2)).abs()
                          * (gq @ gq.transpose(1, 2)).abs()).sum(dim=(1, 2))
            err = (total.double() - want.double()).abs()
            if not (err <= tol).all():
                raise AssertionError(f"22c ghost {tap}: {total.tolist()} "
                                     f"against {want.tolist()}")
            res[tap] = {"max_abs_err": err.max().item(),
                        "plain_rel": ((part - ref.ghost_norm_ref(
                            xl, gl, kx, kg, None, ax, ag, mx, mg)).abs()
                            / part.abs().clamp(min=1e-30)).max().item(),
                        "shard": [list(xl.shape), list(gl.shape)]}
            del xq, gq
            if tap == "column":
                cx = ref.luq_quant_ref(xl.reshape(B, -1), kx, codes=True
                                       ).reshape(xl.shape)
                cg = ref.luq_round_ref(gl.reshape(B, -1), kg, ag, mg,
                                       codes=True).reshape(gl.shape)

                def grams():
                    xx = torch.bmm(cx, cx.transpose(1, 2),
                                   out_dtype=torch.float32)
                    gg = torch.bmm(cg, cg.transpose(1, 2),
                                   out_dtype=torch.float32)
                    return (xx * gg).sum(dim=(1, 2))

                args = (xl, gl, kx, kg)
                timed("ghost_norm_sq[tp_lm]", lambda: ops.ghost_norm_sq(
                    *args, alpha_g=ops.luq_row_max(gl.reshape(B, -1)),
                    map_g=mg), lambda: ref.ghost_norm_ref(
                    *args, None, None, ag, None, mg),
                    kernel_bound("ghost_norm_sq", batch=B, t=T, dx=D,
                                 dg=gl.shape[2], elem_x=2, elem_g=2),
                    grams, res[tap])
        out["ghost_norm_sq[tp_lm]"]["row_parallel"] = res["row"]
    _free(torch)
    return out


def _tp_workload(torch, ops, wl, mesh, name, argv, cut, variants) -> dict:
    """22a / 22b on one rank: the workload of ``argv`` at ``cut`` on the
    (1, ``TP_RANKS``) mesh, each rank holding its blocks of every layer.
    For each ``(dtype, fmt)`` of ``variants`` the sharded step's clipped
    sums (``TrainSetup.grad_fn``, timed, its launches and model-group
    all-reduces counted) and, at luq_fp4, a control with rank 1's
    quantizers keyed from another seed; then one DP step of the workload's
    own config (noise included) through ``build_train_setup`` on the
    mesh, after which the replicated leaves must be the same bits on both
    ranks.  Every result is kept on the host, the card emptied, and then
    each rank in turn, alone on the card, runs the one-process step of
    each variant and holds its own blocks against it: float32 at fmt none
    at rtol 2e-4 / atol 2e-5, the others within ``TP_SUM_LIMITS`` (the
    relative L2 over both ranks' blocks), the metrics at rtol 2e-4 / atol
    2e-5; each control must lie beyond its limit."""
    import dataclasses
    import numpy as np
    import torch.distributed as dist
    from repro_torch.config import QuantConfig
    from repro_torch.launch.steps import build_train_setup
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import axes as pax
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import partitioner as pt

    m = mesh.model_group()
    run, ds, _ = wl.setup(argv, **cut)
    cfg = run.model
    dev = TP_DEVICE
    batch = {"tokens": ds.get(np.arange(run.global_batch))["tokens"].to(dev)}
    flags = torch.ones(cfg.policy_len(), device=dev)
    lr = torch.tensor(run.optim.lr, device=dev)
    out, stash = {"variants": {}}, {}

    def setup_of(dtype, fmt, mp):
        r = dataclasses.replace(
            run, model=dataclasses.replace(cfg, compute_dtype=dtype),
            quant=QuantConfig(fmt=fmt, backend="cuda"), model_parallel=mp)
        model = build_model(r.model, r.quant, device=dev)
        return model, build_train_setup(model, r, mesh if mp > 1 else None)

    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    for dtype, fmt in variants:
        label = f"{name} {dtype} {fmt}"
        model, setup = setup_of(dtype, fmt, m.size)
        params = setup.shard(model.init(run.seed))
        _free(torch)
        held = sum(t.numel() * t.element_size() for t in params.values())
        want_held = sum(math.prod(pt.local_shape(
            setup.param_specs[k], setup.param_shapes[k], mesh))
            * params[k].element_size() for k in params)
        if held != want_held:
            raise AssertionError(f"{label}: {held} bytes held, want "
                                 f"{want_held}")
        res = {"param_bytes": held}
        ops.reset_launch_counts()
        coll.reset_model_reduces()
        (grads, metrics), res["wall_ms"] = _timed(
            torch, lambda: setup.grad_fn(params, batch, flags))
        res["launches"] = ops.launch_counts()
        res["model_reduces"] = dict(coll.MODEL_REDUCES)
        if cfg.family == "moe_lm":
            # the dropped (token, slot) pairs of the sharded forward
            with torch.no_grad(), pax.partitioning_context(m), \
                    _moe_drops() as shares:
                model.loss_fn(params, batch, flags)
            res["dropped_share"] = shares
        stash[label] = ({k: v.cpu() for k, v in grads.items()},
                        {k: float(v) for k, v in metrics.items()})
        del grads
        if fmt == "luq_fp4":
            with _other_key_on_rank(m.index):
                grads, _ = setup.grad_fn(params, batch, flags)
            stash[label + " control"] = ({k: v.cpu() for k, v in
                                          grads.items()}, None)
            del grads
        out["variants"][label] = res
        specs = setup.param_specs
        del params, model, setup
        _free(torch)
    # one DP step of the workload's config on the mesh (noise included)
    model, setup = setup_of(cfg.compute_dtype, run.quant.fmt, m.size)
    params = setup.shard(model.init(run.seed))
    opt = setup.opt_init_fn(params)
    (p1, _, _), out["dp_step_ms"] = _timed(
        torch, lambda: setup.step_fn(params, opt, batch, 1, flags, lr))
    rep = [p1[k] for k, s in specs.items() if not pt.split_dims(s)]
    if not coll.replicas_agree(rep, m):
        raise AssertionError(f"{name}: the replicated leaves differ after a "
                             f"step")
    stash["step"] = ({k: (p1[k].float() - params[k].float()).cpu()
                      for k in p1}, None)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["sharded_wall_s"] = time.perf_counter() - t_phase
    del p1, params, opt, model, setup, rep
    _free(torch)
    dist.barrier()

    # each rank alone on the card: the one-process steps, its own blocks
    stats = {}
    for r in range(m.size):
        if m.index == r:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for dtype, fmt in variants:
                label = f"{name} {dtype} {fmt}"
                model, setup = setup_of(dtype, fmt, 1)
                want, wmetrics = setup.grad_fn(model.init(run.seed), batch,
                                               flags)
                want = pt.shard_tree(want, specs, mesh)
                got, metrics = stash[label]
                if fmt == "none" and dtype == "float32":
                    for k in want:
                        torch.testing.assert_close(
                            got[k].to(dev), want[k], rtol=2e-4, atol=2e-5,
                            msg=lambda msg, k=k: f"{label} {k}: {msg}")
                # the metrics at the float32 tolerances, or, where the
                # sums have a limit (bf16: the row-parallel partials are
                # rounded before they are summed), within it
                limit = TP_SUM_LIMITS.get(label)
                for k, v in wmetrics.items():
                    torch.testing.assert_close(
                        metrics[k], float(v), rtol=limit or 2e-4,
                        atol=2e-5 if limit is None else 0.0,
                        msg=lambda msg, k=k: f"{label} metric {k}: {msg}")
                stats[label] = _tp_stats(torch, got, want)
                if label + " control" in stash:
                    stats[label + " control"] = _tp_stats(
                        torch, stash[label + " control"][0], want)
                out["variants"][label]["one_process_metrics"] = {
                    k: float(v) for k, v in wmetrics.items()}
                if cfg.family == "moe_lm":
                    # at fmt none in float32 the router's input is the
                    # same bits; under LUQ a code that the row-parallel
                    # sums' order flips moves it (printed, not held)
                    with torch.no_grad(), _moe_drops() as shares:
                        model.loss_fn(model.init(run.seed), batch, flags)
                    sharded = out["variants"][label]["dropped_share"]
                    out["variants"][label]["one_process_dropped_share"] = \
                        shares
                    exact = dtype == "float32" and fmt == "none"
                    if exact and shares != sharded:
                        raise AssertionError(
                            f"{label}: dropped shares {shares} one process, "
                            f"{sharded} sharded")
                del want, model, setup
                _free(torch)
            model, setup = setup_of(cfg.compute_dtype, run.quant.fmt, 1)
            params = model.init(run.seed)
            p1, _, _ = setup.step_fn(params, setup.opt_init_fn(params),
                                     batch, 1, flags, lr)
            step = pt.shard_tree({k: p1[k].float() - params[k].float()
                                  for k in p1}, specs, mesh)
            stats["step"] = _tp_stats(torch, stash["step"][0], step)
            del p1, params, model, setup, step
            out["one_process_peak_gib"] = (torch.cuda.max_memory_allocated()
                                           / 2 ** 30)
            out["one_process_wall_s"] = time.perf_counter() - t0
            _free(torch)
        dist.barrier()
    # both ranks' blocks: the relative L2 over every entry
    labels = sorted(stats)
    sums = torch.tensor([stats[k][i] for k in labels for i in (0, 1)],
                        dtype=torch.float64)
    dist.all_reduce(sums, group=m.group)
    maxes = torch.tensor([stats[k][2] for k in labels], dtype=torch.float64)
    dist.all_reduce(maxes, op=dist.ReduceOp.MAX, group=m.group)
    rel = {k: (sums[2 * i] / sums[2 * i + 1]).sqrt().item() if
           sums[2 * i + 1] > 0 else sums[2 * i].sqrt().item()
           for i, k in enumerate(labels)}
    out["rel_l2"] = rel
    out["max_abs"] = {k: maxes[i].item() for i, k in enumerate(labels)}
    _hold_tp_limits(name, rel)
    return out


def _hold_tp_limits(name: str, rel: dict) -> None:
    """Each relative L2 of 22a / 22b (``name``) within its limit of
    ``TP_SUM_LIMITS``; each control beyond its variant's."""
    for label, value in rel.items():
        key = f"{name} step" if label == "step" else label.replace(
            " control", "")
        limit = TP_SUM_LIMITS.get(key)
        if label.endswith(" control"):
            if not value > limit:
                raise AssertionError(f"{label}: {value} within the limit "
                                     f"{limit}: a rank-dependent key passes")
        elif limit is not None and not value <= limit:
            raise AssertionError(f"{label}: relative L2 {value} beyond the "
                                 f"limit {limit}")


# Phase 23 (serving on the model axis, in phase 22's ranks).  23b serves
# yi-6b at full width cut to TP_SERVE_LAYERS layers: whole, over gloo on
# the one card, eager, the engine took 25-40 s a run (400-640 ms a tick,
# prefills included; 173 s for the phase's five runs), and at 8 layers
# 36-79 s for the five runs, beyond the script's time.
TP_SERVE_LAYERS = 4
# 23b's limits: the first prompt's prefill logits through the sharded
# model against the one-process model's (relative L2, at most), and the
# share of the 8 requests' 256 greedy tokens equal to the one-process
# engine's (at least), each KV format and cache split; each control (rank
# 1's logits head keyed from another seed) must fail both.  Readings on
# an H100 80GB HBM3 at 700 W, 4 layers: logits 0.0809 (split by heads)
# and 0.0519 (by rows), the same for both KV formats; token shares 0.086 /
# 0.230 (heads, int8 / luq_fp4) and 0.098 / 0.297 (rows); the control
# 0.391 and 0.016.  (8 layers: 0.0695 and 0.0622, shares 0.086-0.156,
# control 0.390 and 0.023; whole, 32 layers: 0.097-0.099 and
# 0.098-0.137, control 0.387 and 0.031.)  A bf16 trunk of other GEMM
# widths and float32 row-parallel sums moves the last hidden row by bf16
# roundings, which flip LUQ codes of the head's operand (ROADMAP.md
# section 3), and the greedy tokens of the random-init model follow the
# flips.
TP_SERVE_LIMITS = {"logits_rel_l2": 0.2, "token_share": 0.06}
# 23c: arctic-480b at phase 22b's cut, float32, oneshot: 2 prompts of 64
# tokens, 8 decode steps
TP_MOE_SERVE = {"batch": 2, "prompt": 64, "steps": 8}


def _tp_timed(torch, m, out, name, fn, plain, bound, library=None,
              extra=None, plain_reps=5):
    """``out[name]``: rank 0's times of ``fn`` (its kernels), ``plain``
    and ``library`` and ``bound``, with ``extra``; the other ranks wait."""
    import torch.distributed as dist
    dist.barrier()
    res = {}
    if m.index == 0:
        res = {"ms": time_ms(torch, fn, 20),
               "plain_ms": time_ms(torch, plain, plain_reps), **bound,
               "library_ms": None if library is None
               else time_ms(torch, library, 20)}
    dist.barrier()
    res.update(extra or {})
    out[name] = res


def _tp_serve_kernels(torch, ops, ref, mesh, sm_clock_mhz) -> dict:
    """23a on one rank: the three serving kernels on this rank's shard at
    yi-6b's shapes, each against the kernel's call on the whole operand
    (the same inputs on every rank) and its plain version: ``luq_matmul``
    on the rank's 4096 x 32000 of the 64000-column head, given the whole
    head's scale (one all-reduce MAX) and its column offset, 4 rows with a
    device key each (a decode tick) and 1 row (a prefill), the whole
    head's columns bit for bit; ``decode_attn`` over the rank's 512 of
    1024 rows (4 slots x 4 KV heads x 8 query heads, head_dim 128), its
    first pass on its rows, the ranks' partials gathered in rank order,
    the merge over all, the whole cache's output bit for bit (int8 and
    luq_fp4; slots whose rows lie on one rank only among them);
    ``kv_quant_write`` of a tick's rows (4 slots, one past the end) and of
    a 700-token prompt's 32 layers into the rank's rows, the held rows
    the whole cache's slice bit for bit, the others untouched.  Rank 0
    times each (the merge on the gathered partials; the collective
    outside the time)."""
    from repro_torch.parallel import axes as pax

    m = mesh.model_group()
    with pax.partitioning_context(m):
        return _tp_serve_kernel_checks(torch, ops, ref, m, sm_clock_mhz)


def _tp_serve_kernel_checks(torch, ops, ref, m, sm_clock_mhz) -> dict:
    """:func:`_tp_serve_kernels` inside the model group's context."""
    from repro_torch.models.common import logits_keys
    from repro_torch.parallel.collectives import (gather_from_model,
                                                  model_reduce_)
    from repro_torch.quant import kv_cache as kvc
    from repro_torch.quant import philox
    from repro_torch.quant.formats import luq_fp4, luq_fp4_codes

    dev = TP_DEVICE
    out = {}
    # the logits head: yi-6b's (4096, 64000), this rank's half
    K, N = 4096, 64_000
    n = N // m.size
    c0 = m.index * n
    for name, folds in (("luq_matmul[tp_decode]",
                         [2 * p + 1 for p in (100, 300, 700, 1023)]),
                        ("luq_matmul[tp_prefill]", [2 * 512])):
        R = len(folds)
        gen = torch.Generator(device=dev).manual_seed(SEED + 30 + R)
        a = torch.randn(R, K, device=dev, generator=gen)
        b = torch.randn(K, N, device=dev, generator=gen) / 64
        keys = logits_keys(torch.tensor(folds, dtype=torch.int32,
                                        device=dev))
        alpha_a = a.abs().amax(dim=1)
        whole = ops.luq_matmul(a, b, keys, alpha_a, b.abs().amax())
        shard = b[:, c0:c0 + n].contiguous()
        del b
        alpha_b = model_reduce_(shard.abs().amax().reshape(1).clone(),
                                "max")[0]
        args = (a, shard, keys, alpha_a, alpha_b)
        got = ops.luq_matmul(*args, cols=(c0, N))
        if not torch.equal(got, whole[:, c0:c0 + n]):
            raise AssertionError(f"23a {name}: the shard's logits are not "
                                 f"the whole head's columns")
        del whole
        if not torch.equal(got, ops.luq_matmul(*args, cols=(c0, N))):
            raise AssertionError(f"23a {name}: two runs differ")
        want = ref.luq_matmul_keys_ref(*args, cols=(c0, N))
        # the tolerance from the quantized operands, and the yardstick's
        # codes: each key's draw of the shard's columns
        key_list = [(int(f), 17) for f in folds]
        ua = torch.stack([philox.uniforms(k, 0, K, dev) for k in key_list])
        aq = luq_fp4(a, ua, alpha_a.reshape(-1, 1))
        ca = luq_fp4_codes(a, ua, alpha_a.reshape(-1, 1))
        cb, err = [], 0.0
        for i, k in enumerate(key_list):
            ub = philox.uniforms_2d(k, 1, K, n, N, c0, dev)
            tol = 1e-5 * (aq[i].abs() @ luq_fp4(shard, ub, alpha_b).abs()) \
                + 1e-6
            diff = (got[i] - want[i]).abs()
            if not (diff <= tol).all():
                raise AssertionError(f"23a {name} row {i}: max abs err "
                                     f"{diff.max().item()}")
            err = max(err, diff.max().item())
            cb.append(luq_fp4_codes(shard, ub, alpha_b))
            del ub, tol
        cb = torch.stack(cb)
        scale = (alpha_a * alpha_b).reshape(-1, 1, 1)
        _tp_timed(torch, m, out, name,
                  lambda: ops.luq_matmul(*args, cols=(c0, N)),
                  lambda: ref.luq_matmul_keys_ref(*args, cols=(c0, N)),
                  kernel_bound("luq_matmul", sm_clock_mhz=sm_clock_mhz,
                               rows=R, k=K, n=n, keys=R),
                  lambda: scale * torch.bmm(ca[:, None, :], cb,
                                            out_dtype=torch.float32),
                  {"max_abs_err": err, "shard": [K, n], "columns": c0},
                  plain_reps=2)
        del a, shard, got, want, cb, args
        _free(torch)

    # decode attention over a sequence shard: 4 slots x 4 KV heads x 8
    # query heads, 1024 rows, 512 a rank
    B, KV, g, hd, S = 4, 4, 8, 128, 1024
    rows = S // m.size
    r0 = m.index * rows
    sl = slice(r0, r0 + rows)
    pos_list = [63, 300, 700, S - 1]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for fmt in ("int8", "luq_fp4"):
        name = f"decode_attn_fused[tp_seq/{fmt}]"
        gen = torch.Generator(device=dev).manual_seed(SEED + 40)
        kc, ks = kvc.kv_quant(fmt, torch.randn(B, KV, S, hd, device=dev,
                                               generator=gen))
        vc, vs = kvc.kv_quant(fmt, torch.randn(B, KV, S, hd, device=dev,
                                               generator=gen))
        q = torch.randn(B, KV * g, hd, device=dev, generator=gen)
        kw = dict(fmt=fmt, n_kv=KV, scale=hd ** -0.5)
        whole = ops.decode_attn_fused(q, kc, vc, ks, vs, pos, **kw)
        mine = [t[:, :, sl].contiguous() for t in (kc, vc, ks, vs)]
        part = ops.decode_attn_split(q, *mine, pos, row0=r0, seq_len=S,
                                     **kw)
        parts = gather_from_model(part[None], 0)
        merge = dict(batch=B, n_kv=KV, group=g, head_dim=hd, rows=rows,
                     seq_len=S)
        got = ops.decode_attn_merge(parts, pos, **merge)
        if not torch.equal(got, whole):
            raise AssertionError(f"23a {name}: the merged shards are not "
                                 f"the whole cache's output")
        plain_part = ref.decode_attn_partial_ref(q, *mine, pos, row0=r0,
                                                 **kw)
        plain = ref.decode_attn_merge_ref(gather_from_model(
            plain_part[None], 0))
        err = (got - plain).abs().max().item()
        torch.testing.assert_close(got, plain, atol=1e-5, rtol=1e-5)
        kd = kvc.kv_dequant(fmt, mine[0], mine[2])
        vd = kvc.kv_dequant(fmt, mine[1], mine[3])
        mask = (torch.arange(r0, r0 + rows, device=dev)[None, :]
                <= pos[:, None])[:, None, None, :]
        qd = q.reshape(B, KV, g, hd)
        live = sum(min(rows, max(0, min(p, S - 1) + 1 - r0))
                   for p in pos_list)
        # the two passes (the merge on the gathered partials; the
        # collective between them not timed)
        _tp_timed(
            torch, m, out, name,
            lambda: (ops.decode_attn_split(q, *mine, pos, row0=r0,
                                           seq_len=S, **kw),
                     ops.decode_attn_merge(parts, pos, **merge)),
            lambda: ref.decode_attn_partial_ref(q, *mine, pos, row0=r0,
                                                **kw),
            kernel_bound("decode_attn_fused", batch=B, kv_heads=KV,
                         group=g, head_dim=hd, code_dim=mine[0].shape[-1],
                         live_rows=live),
            lambda: sdpa(qd, kd, vd, attn_mask=mask, scale=hd ** -0.5),
            {"max_abs_err": err, "rows": [r0, r0 + rows],
             "live_rows": live})
        del kc, vc, ks, vs, mine, whole, got, kd, vd
        _free(torch)

    # the KV write into a sequence shard: a tick's rows and a prompt's
    for fmt in ("int8", "luq_fp4"):
        for branch, (n0, n1, T, wpos) in (
                ("decode", (4, 4, 1, [63, 700, S - 1, S + 5])),
                ("prefill", (32, 4, 700, None))):
            name = f"kv_quant_write[tp_seq/{fmt}/{branch}]"
            gen = torch.Generator(device=dev).manual_seed(SEED + 50)
            k = (torch.randn(n0, n1, T, hd, device=dev, generator=gen)
                 * 3).bfloat16()
            v = torch.randn(n0, n1, T, hd, device=dev, generator=gen
                            ).bfloat16()
            w = (None if wpos is None else
                 torch.tensor(wpos, device=dev).clamp(max=S - 1))
            stale = _stale_kv_cache(torch, kvc, fmt, n0, n1, S, hd, gen)
            whole = [c.clone() for c in stale]
            ops.kv_quant_write(k, v, *whole, fmt, w)
            mine = [c[:, :, sl].clone() for c in stale]
            ops.kv_quant_write(k, v, *mine, fmt, w, r0, S)
            if not all(torch.equal(a, b[:, :, sl])
                       for a, b in zip(mine, whole)):
                raise AssertionError(f"23a {name}: the shard's rows are not "
                                     f"the whole cache's slice")
            plain = [c[:, :, sl].clone() for c in stale]
            ref.kv_quant_write_ref(k, v, *plain, fmt, w, r0, S)
            if not all(torch.equal(a, b) for a, b in zip(mine, plain)):
                raise AssertionError(f"23a {name}: the kernel and its plain "
                                     f"version differ")
            held = (sum(1 for p in wpos if r0 <= min(p, S - 1) < r0 + rows)
                    if wpos is not None else max(0, min(rows, T - r0)))
            per = 1 if wpos is not None else n0
            _tp_timed(torch, m, out, name,
                      lambda: ops.kv_quant_write(k, v, *mine, fmt, w, r0, S),
                      lambda: ref.kv_quant_write_ref(k, v, *plain, fmt, w,
                                                     r0, S),
                      kernel_bound("kv_quant_write",
                                   rows=2 * per * n1 * held, head_dim=hd,
                                   code_dim=mine[0].shape[-1], elem=2,
                                   slots=0 if wpos is None else n0),
                      extra={"max_abs_err": 0.0, "held_rows": held,
                             "rows": [r0, r0 + rows]})
            del stale, whole, mine, plain, k, v
    _free(torch)
    return out


@contextlib.contextmanager
def _other_logits_key_on_rank(rank: int):
    """On a rank other than 0, the logits head keyed from another seed
    (a control of 23b)."""
    from repro_torch.models import common as cm
    seed = cm.LOGITS_SEED
    if rank != 0:
        cm.LOGITS_SEED = seed + 7919
    try:
        yield
    finally:
        cm.LOGITS_SEED = seed


def _serve_reference(torch, model, params, wl, prompts) -> dict:
    """One process's engine (graphed) of 23b's workload for each KV
    format: its tokens, and the first prompt's prefill logits."""
    from repro_torch.config import ServeConfig
    from repro_torch.serve import ContinuousEngine

    first = torch.from_numpy(prompts[0][None].astype("int64")).to(
        TP_DEVICE)
    out = {"tokens": {}, "logits": {}}
    for kv_fmt in ("int8", "luq_fp4"):
        engine = ContinuousEngine(model, params, ServeConfig(
            max_slots=wl.SLOTS, max_seq=wl.MAX_SEQ,
            max_new_tokens=wl.NEW_TOKENS, kv_fmt=kv_fmt))
        for p in prompts:
            engine.submit(p)
        out["tokens"][kv_fmt] = {str(r): v.tokens.tolist()
                                 for r, v in sorted(engine.run().items())}
        out["logits"][kv_fmt] = model.prefill(params, {"tokens": first},
                                              kv_fmt=kv_fmt)[0]
        del engine
        _free(torch)
    return out


def _tp_serve_engine(torch, ops, wl, mesh) -> dict:
    """23b on one rank: yi-6b at full width, ``TP_SERVE_LAYERS`` layers,
    through ``ContinuousEngine`` on the (1, ``TP_RANKS``) mesh, eager
    (gloo), the luq_fp4 head on the ``cuda`` backend: the workload's 8
    greedy requests on 4 slots of 1024 positions with an int8 and a
    luq_fp4 KV cache, the cache split by heads (the rules' choice) and
    then by rows (``kv_seq``, forced by a ``sharding_overrides`` rule; the
    widths untouched).  Each run's tokens, the launch counts and the model
    group's collectives of the run, its tick wall; rank 0 first runs one
    process's engine of the same cut (graphed) and holds each run's
    tokens (their share equal) and the first prompt's prefill logits
    through the same layout (their relative L2) against it; a control
    run keys rank 1's logits head from another seed."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.config import QuantConfig, ServeConfig
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import collectives as coll
    from repro_torch.serve import ContinuousEngine
    from repro_torch.serve.oneshot import build_oneshot_fns

    m = mesh.model_group()
    dev = TP_DEVICE
    cfg = dataclasses.replace(get_config(wl.ARCH), n_layers=TP_SERVE_LAYERS)
    quant = QuantConfig(fmt=wl.QUANT_FMT, backend="cuda")
    models = {"kv_heads": build_model(cfg, quant, device=dev),
              "kv_seq": build_model(dataclasses.replace(
                  cfg, sharding_overrides=(("kv_heads", ()),)), quant,
                  device=dev)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = models["kv_heads"].prepare(models["kv_heads"].init(wl.SEED))
    prompts = wl.prompts(cfg.vocab_size)
    want = (_serve_reference(torch, models["kv_heads"], params, wl, prompts)
            if m.index == 0 else None)
    dist.barrier()
    out = {"layers": TP_SERVE_LAYERS, "reference_s": time.perf_counter() - t0,
           "runs": {}}
    first = torch.from_numpy(prompts[0][None].astype("int64")).to(dev)

    def serve(model, kv_fmt, control=False):
        engine = ContinuousEngine(model, params, ServeConfig(
            max_slots=wl.SLOTS, max_seq=wl.MAX_SEQ,
            max_new_tokens=wl.NEW_TOKENS, kv_fmt=kv_fmt), mesh=mesh)
        for p in prompts:
            engine.submit(p)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        coll.reset_model_reduces()
        t0 = time.perf_counter()
        with _other_logits_key_on_rank(m.index if control else 0):
            results = engine.run()
        torch.cuda.synchronize()
        res = {"wall_s": time.perf_counter() - t0,
               "launches": ops.launch_counts(),
               "model_collectives": dict(coll.MODEL_REDUCES)}
        summary = engine.metrics.summary()
        res["ticks"] = summary["decode_ticks"]
        res["tick_wall_ms"] = summary["run_wall_s"] / res["ticks"] * 1e3
        res["tokens"] = {str(r): v.tokens.tolist()
                         for r, v in sorted(results.items())}
        # the first prompt's prefill logits through the same layout
        prefill, _ = build_oneshot_fns(model, wl.MAX_SEQ, kv_fmt,
                                       layout=engine.layout)
        with _other_logits_key_on_rank(m.index if control else 0):
            logits, _ = prefill(engine.params, {"tokens": first})
        if want is not None:
            ref_tokens = want["tokens"][kv_fmt]
            same = sum(int(a == b) for r, toks in res["tokens"].items()
                       for a, b in zip(toks, ref_tokens[r]))
            res["token_share"] = same / sum(len(t) for t in
                                            ref_tokens.values())
            w = want["logits"][kv_fmt]
            res["logits_rel_l2"] = ((logits - w).norm() / w.norm()).item()
        res.update(eager=engine._eager, kv_split=engine.layout.kv_split,
                   decode_replays=engine.decode_replays,
                   prefill_replays=engine.prefill_replays)
        del engine, logits
        _free(torch)
        return res

    for split, model in models.items():
        for kv_fmt in ("int8", "luq_fp4"):
            res = serve(model, kv_fmt)
            if not (res["eager"] and res["kv_split"] == split
                    and res["decode_replays"] == res["prefill_replays"]
                    == 0):
                raise AssertionError(f"23b {split} {kv_fmt}: eager "
                                     f"{res['eager']}, split "
                                     f"{res['kv_split']}, replays "
                                     f"{res['decode_replays']} / "
                                     f"{res['prefill_replays']}")
            out["runs"][f"{split} {kv_fmt}"] = res
    out["runs"]["kv_heads int8 control"] = serve(models["kv_heads"], "int8",
                                                 control=True)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, models, want
    _free(torch)
    return out


def _hold_tp_serve(ranks: list) -> None:
    """23b: every rank's tokens the same in each run, each run within
    ``TP_SERVE_LIMITS``, the control beyond both."""
    runs = ranks[0]["serve"]["engine"]["runs"]
    for label, res in runs.items():
        for r in ranks[1:]:
            if r["serve"]["engine"]["runs"][label]["tokens"] != res["tokens"]:
                raise AssertionError(f"23b {label}: the ranks' tokens differ")
        rel, share = res["logits_rel_l2"], res["token_share"]
        within = (rel <= TP_SERVE_LIMITS["logits_rel_l2"]
                  and share >= TP_SERVE_LIMITS["token_share"])
        beyond = (rel > TP_SERVE_LIMITS["logits_rel_l2"]
                  and share < TP_SERVE_LIMITS["token_share"])
        if label.endswith("control") and not beyond:
            raise AssertionError(f"23b {label}: {rel}, {share} within a "
                                 f"limit of {TP_SERVE_LIMITS}")
        if not label.endswith("control") and not within:
            raise AssertionError(f"23b {label}: {rel}, {share} beyond "
                                 f"{TP_SERVE_LIMITS}")


def _tp_serve_moe(torch, mesh) -> dict:
    """23c on one rank: arctic-480b at phase 22b's cut (2 layers of 8
    experts, 4 a rank), float32, oneshot: the prefill of ``TP_MOE_SERVE``'s
    prompts and its greedy decode steps on the (1, ``TP_RANKS``) mesh
    (the experts split, the attention split by heads, the float32 head
    split over the vocab and gathered); then rank 0 alone runs one
    process's prefill and decode on the sharded run's tokens and holds
    every step's logits at rtol 2e-4 / atol 2e-5."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.config import QuantConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import workload as wl
    from repro_torch.models.registry import build_model
    from repro_torch.serve.layout import serve_layout
    from repro_torch.serve.oneshot import build_oneshot_fns

    m = mesh.model_group()
    dev = TP_DEVICE
    cfg = dataclasses.replace(get_config("arctic-480b"), **wl.TRAIN_MOE_CUT,
                              compute_dtype="float32",
                              param_dtype="float32")
    model = build_model(cfg, QuantConfig(fmt="none"), device=dev)
    Bm, P, steps = (TP_MOE_SERVE[k] for k in ("batch", "prompt", "steps"))
    cache = P + steps
    params = model.init(wl.SEED)
    layout = serve_layout(model, mesh, {k: tuple(t.shape) for k, t in
                                        params.items()}, Bm, cache, "none")
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    tokens = torch.randint(0, cfg.vocab_size, (Bm, P), device=dev,
                           generator=gen)
    local = model.prepare(layout.shard(params))

    def run(fns, p, feed=None):
        prefill, decode = fns
        logits, c = prefill(p, {"tokens": tokens})
        out, fed = [logits], []
        for i in range(steps):
            tok = (logits.argmax(-1) if feed is None else feed[i])
            fed.append(tok)
            logits, c = decode(p, c, tok)
            out.append(logits)
        return torch.stack(out), fed

    t0 = time.perf_counter()
    sharded, fed = run(build_oneshot_fns(model, cache, "none", layout=layout),
                       local)
    torch.cuda.synchronize()
    res = {"sharded_wall_s": time.perf_counter() - t0,
           "kv_split": layout.kv_split,
           "experts_a_rank": local["blocks.e_gate"].shape[1]}
    del local
    _free(torch)
    dist.barrier()
    if m.index == 0:
        want, _ = run(build_oneshot_fns(model, cache, "none"),
                      model.prepare(params), fed)
        torch.testing.assert_close(sharded, want, rtol=2e-4, atol=2e-5)
        res["max_abs_err"] = (sharded - want).abs().max().item()
        res["max_abs_logit"] = want.abs().max().item()
        del want
    del params, sharded
    _free(torch)
    dist.barrier()
    return res


def tp_rank_main(argv) -> int:
    """One rank of phase 22: ``chip_smoke.py --tp-rank RANK PORT OUT``
    (started by :func:`model_parallel`): joins a gloo group of
    ``TP_RANKS`` ranks on this card as a (1, ``TP_RANKS``) mesh over
    ``("data", "model")``, runs 22c, 22a and 22b, and writes its results
    to ``OUT.RANK`` as JSON."""
    import torch
    import torch.distributed as dist

    rank, port, path, clock = (int(argv[0]), int(argv[1]), argv[2],
                               float(argv[3]))
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch import workload as wl
    from repro_torch.launch.mesh import init_distributed, make_compat_mesh

    build.load_library()
    init_distributed("cuda", share_device=True,
                     init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                     world_size=TP_RANKS)
    try:
        mesh = make_compat_mesh((1, TP_RANKS), ("data", "model"))
        out = {"backend": dist.get_backend()}
        t0 = time.perf_counter()
        out["kernels"] = _tp_kernels(torch, ops, ref, mesh, clock)
        out["kernels_wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["lm"] = _tp_workload(
            torch, ops, wl, mesh, "22a", wl.TRAIN_LM_ARGV, {"n_layers": 2},
            (("float32", "none"), ("float32", "luq_fp4"),
             ("bfloat16", "none"), ("bfloat16", "luq_fp4")))
        out["lm"]["wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["moe"] = _tp_workload(
            torch, ops, wl, mesh, "22b", wl.TRAIN_MOE_ARGV, wl.TRAIN_MOE_CUT,
            (("float32", "none"), ("bfloat16", "luq_fp4")))
        out["moe"]["wall_s"] = time.perf_counter() - t0
        # 23: serving on the model axis, in the same ranks
        t0 = time.perf_counter()
        serve = {"kernels": _tp_serve_kernels(torch, ops, ref, mesh, clock)}
        serve["kernels_wall_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        serve["engine"] = _tp_serve_engine(torch, ops, wl, mesh)
        serve["engine"]["wall_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        serve["moe"] = _tp_serve_moe(torch, mesh)
        serve["moe"]["wall_s"] = time.perf_counter() - t1
        serve["wall_s"] = time.perf_counter() - t0
        out["serve"] = serve
        Path(f"{path}.{rank}").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def model_parallel(torch, card: str, sm_clock_mhz: float) -> dict:
    """Phase 22: ``TP_RANKS`` ranks on this card over gloo, each holding
    its blocks of every layer (:func:`tp_rank_main`); prints and returns
    rank 0's results, both ranks' peaks and walls."""
    out_dir = ROOT / "build" / "chip_smoke_tp"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "ranks.json"
    port = _free_port()
    t0 = time.perf_counter()
    _spawn([["--tp-rank", r, port, path, sm_clock_mhz]
            for r in range(TP_RANKS)], 900)
    ranks = [json.loads(Path(f"{path}.{r}").read_text())
             for r in range(TP_RANKS)]
    _hold_tp_serve(ranks)
    result = ranks[0]
    result["per_rank"] = [{w: {k: r[w][k] for k in (
        "peak_gib", "one_process_peak_gib", "sharded_wall_s",
        "one_process_wall_s")} for w in ("lm", "moe")} for r in ranks]
    result["wall_s"] = time.perf_counter() - t0
    peaks = [r["serve"]["engine"]["peak_gib"] for r in ranks]
    serve = result.pop("serve")
    print(f"model parallel, {TP_RANKS} ranks on one card ({card}): "
          f"{json.dumps(result)}", flush=True)
    runs = serve["engine"]["runs"]
    print(f"serving on the model axis, {TP_RANKS} ranks on one card "
          f"({card}): " + json.dumps({
              "kernels": serve["kernels"], "kernels_wall_s":
              serve["kernels_wall_s"],
              "engine": {**{k: v for k, v in serve["engine"].items()
                            if k != "runs"},
                         "runs": {label: {k: v for k, v in res.items()
                                          if k != "tokens"}
                                  for label, res in runs.items()}},
              "peak_gib_by_rank": peaks,
              "moe": serve["moe"], "wall_s": serve["wall_s"]}), flush=True)
    result["serve"] = serve
    return result


def serve_launches(ops) -> dict:
    """The launch counts of a serving run, the matmul's and the KV
    write's also by the step that made them."""
    launches = dict(ops.LAUNCHES)
    for step in ("decode", "prefill"):
        launches[f"luq_matmul[{step}]"] = ops.LUQ_MATMUL_LAUNCHES[step]
        launches[f"kv_quant_write[{step}]"] = ops.KV_WRITE_LAUNCHES[step]
    return launches


def _phase_done(walls: dict, name: str) -> None:
    """Records and prints the wall of the phase ``name`` that just ended
    and starts the next one's clock (``walls["start"]``)."""
    now = time.perf_counter()
    walls[name] = now - walls["start"]
    walls["start"] = now
    print(f"phase {name}: wall {walls[name]!r} s", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    walls = {"start": time.perf_counter()}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60,
                           check=True)
    sm_clock_mhz = float(clock.stdout.strip().splitlines()[0])
    print(f"max SM clock {sm_clock_mhz} MHz")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    _phase_done(walls, "1 card")

    # 2. build
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch import workload as wl
    from repro_torch.quant import kv_cache as kvc
    t0 = time.perf_counter()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.BUILD_INFO.get('seconds', 0.0):.1f} s)")
    for line in build.BUILD_INFO.get("log", "").splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    _phase_done(walls, "2 build")

    # 3. each kernel against its plain version at the path's shapes
    checks = {}
    for fmt in ("int8", "luq_fp4"):
        # yi-6b: a decode tick's K and V rows of 4 slots x 4 kv heads at
        # their clamped positions (one at S - 1, one past the end), and a
        # 512-token prefill's stack of 32 layers from row 0
        name = f"kv_quant_write[{fmt}/decode]"
        checks[name] = check_kv_write(
            torch, ops, ref, kvc, fmt, wl.SLOTS, 4, 1, wl.MAX_SEQ, 128,
            [63, 700, wl.MAX_SEQ - 1, wl.MAX_SEQ + 5][:wl.SLOTS])
        print(f"{name} {checks[name]}")
        name = f"kv_quant_write[{fmt}/prefill]"
        checks[name] = check_kv_write(torch, ops, ref, kvc, fmt, 32, 4, 512,
                                      512, 128, None)
        print(f"{name} (32 layers x 4 x 512 rows) {checks[name]}")
        attn = check_decode_attn(torch, ops, ref, kvc, fmt, wl.SLOTS,
                                 wl.MAX_SEQ)
        print(f"decode_attn_fused[{fmt}] {attn}")
        checks[f"decode_attn_fused[{fmt}]"] = attn
    # the decode tick's slots at their folds 2 pos + 1, and a 512-token
    # prompt's prefill row at 2 x 512
    for branch, folds in (("decode", [2 * p + 1 for p in
                                      (100, 300, 700, 1023)][:wl.SLOTS]),
                          ("prefill", [2 * 512])):
        name = f"luq_matmul[{branch}]"
        checks[name] = check_luq_matmul(torch, ops, ref, folds, sm_clock_mhz)
        print(f"{name} {checks[name]}")
    # InternVL2-1B's lockstep head: 8 rows x 896 x 151,680, one shared key
    # (the fold of the decode step at position 512)
    checks["luq_matmul[vlm]"] = check_luq_matmul(
        torch, ops, ref, [2 * 512 + 1] * 8, sm_clock_mhz, K=896, N=151_680,
        shared=True)
    print(f"luq_matmul[vlm] {checks['luq_matmul[vlm]']}")
    # the quantize op at its paths' shapes: ResNet-18's largest weight
    # (3x3x512x512) whole and largest activation under vmap (64 examples x
    # 32x32x64), float32; ResNet-50's (3x3x512x512; 64 x 32x32x256, a
    # stage-0 block's output) and DenseNet-121's (the third transition,
    # 1x1x1024x512; 64 x 32x32x256, the first transition's input), float32;
    # in ghost mode ResNet-18's and ResNet-50's largest weights and pass 2's
    # per-example rows of the whole batch (256 x 32x32x64, 256 x
    # 32x32x256; pass 1's chunks are the vmap microbatch's 64 rows);
    # a stablelm-3b MLP weight (2560 x 6912) whole and a pass-1 chunk's
    # per-example rows (4 x 256 tokens x 2560), bf16; BERT-SNLI's MLP
    # weight (768 x 3072) whole and a microbatch's per-example
    # activations (16 x 128 tokens x 768), float32; Mamba-2-130m's
    # in_proj weight (768 x 3352) whole, bf16, and the SSD's gate operand
    # of a microbatch (8 examples x 2 chunks x 24 heads x 256 x 256),
    # float32; RecurrentGemma-9B's MLP weight (4096 x 12288) whole and
    # one example's MLP hidden rows (256 tokens x 12288), InternVL2-1B's
    # (896 x 4864; 8 x 512 tokens x 4864), whisper-medium's (1024 x 4096; a
    # microbatch's 448 tokens x 4096), bf16; arctic-480b's expert stack of
    # the 8-expert cut (8 x 7168 x 4864) whole and one example's dispatch
    # buffer (8 experts x 80 slots x 7168), bf16
    for name, rows, n, dtype in (
            ("luq_quant[resnet_weight]", 1, 3 * 3 * 512 * 512, torch.float32),
            ("luq_quant[resnet_activation]", 64, 32 * 32 * 64, torch.float32),
            ("luq_quant[resnet50_weight]", 1, 3 * 3 * 512 * 512,
             torch.float32),
            ("luq_quant[resnet50_activation]", 64, 32 * 32 * 256,
             torch.float32),
            ("luq_quant[densenet121_weight]", 1, 1024 * 512, torch.float32),
            ("luq_quant[densenet121_activation]", 64, 32 * 32 * 256,
             torch.float32),
            ("luq_quant[resnet_ghost_weight]", 1, 3 * 3 * 512 * 512,
             torch.float32),
            ("luq_quant[resnet_ghost_rows]", 256, 32 * 32 * 64,
             torch.float32),
            ("luq_quant[resnet50_ghost_weight]", 1, 3 * 3 * 512 * 512,
             torch.float32),
            ("luq_quant[resnet50_ghost_rows]", 256, 32 * 32 * 256,
             torch.float32),
            ("luq_quant[lm_weight]", 1, 2560 * 6912, torch.bfloat16),
            ("luq_quant[lm_rows]", wl.TRAIN_LM_CHUNK,
             wl.TRAIN_LM_SEQ * 2560, torch.bfloat16),
            ("luq_quant[bert_weight]", 1, 768 * 3072, torch.float32),
            ("luq_quant[bert_activation]", wl.TRAIN_BERT_MICROBATCH,
             wl.TRAIN_BERT_SEQ * 768, torch.float32),
            ("luq_quant[mamba2_weight]", 1, 768 * 3352, torch.bfloat16),
            ("luq_quant[mamba2_gate]", wl.TRAIN_MAMBA2_MICROBATCH,
             2 * 24 * 256 * 256, torch.float32),
            ("luq_quant[griffin_weight]", 1, 4096 * 12288, torch.bfloat16),
            ("luq_quant[griffin_rows]", wl.TRAIN_GRIFFIN_MICROBATCH,
             wl.TRAIN_GRIFFIN_SEQ * 12288, torch.bfloat16),
            ("luq_quant[vlm_weight]", 1, 896 * 4864, torch.bfloat16),
            ("luq_quant[vlm_rows]", wl.TRAIN_VLM_MICROBATCH,
             wl.TRAIN_VLM_SEQ * 4864, torch.bfloat16),
            ("luq_quant[whisper_weight]", 1, 1024 * 4096, torch.bfloat16),
            ("luq_quant[whisper_rows]", wl.TRAIN_WHISPER_MICROBATCH,
             wl.TRAIN_WHISPER_SEQ * 4096, torch.bfloat16),
            ("luq_quant[moe_expert_weight]", 1, 8 * 7168 * 4864,
             torch.bfloat16),
            ("luq_quant[moe_dispatch_rows]", wl.TRAIN_MOE_MICROBATCH,
             8 * 80 * 7168, torch.bfloat16)):
        checks[name] = check_luq_quant(torch, ops, ref, rows, n, dtype,
                                       sm_clock_mhz)
        print(f"{name} ({rows} x {n}, {dtype}) {checks[name]}")
    # the clip of a microbatch's per-example gradients: ResNet-18's,
    # ResNet-50's, DenseNet-121's, BERT-SNLI's, the 6-layer Mamba-2's, the
    # 5-layer Griffin's (one row beyond 2^31 elements), the 6-layer
    # InternVL2-1B's, the 3 + 3-layer whisper-medium's and the arctic-480b
    # cut's (one row beyond 2^31) parameter counts
    for name, b, d in (("per_sample_clip", 64, 11_190_891),
                       ("per_sample_clip[resnet50]", 64, 23_588_459),
                       ("per_sample_clip[densenet121]", 64, 6_990_251),
                       ("per_sample_clip[bert]", wl.TRAIN_BERT_MICROBATCH,
                        BERT_PARAMS),
                       ("per_sample_clip[mamba2]",
                        wl.TRAIN_MAMBA2_MICROBATCH, MAMBA2_PARAMS),
                       ("per_sample_clip[griffin]",
                        wl.TRAIN_GRIFFIN_MICROBATCH, GRIFFIN_TRAIN_PARAMS),
                       ("per_sample_clip[vlm]", wl.TRAIN_VLM_MICROBATCH,
                        VLM_PARAMS),
                       ("per_sample_clip[whisper]",
                        wl.TRAIN_WHISPER_MICROBATCH, WHISPER_TRAIN_PARAMS),
                       ("per_sample_clip[moe]", wl.TRAIN_MOE_MICROBATCH,
                        MOE_TRAIN_PARAMS)):
        checks[name] = check_per_sample_clip(torch, ops, ref, b, d)
        print(f"{name} ({b} x {d}) {checks[name]}")
        torch.cuda.empty_cache()
    # stablelm-3b ghost pass 1: chunks of 4 sequences of 256 tokens; q/k/v/o
    # are 2560 wide on both sides, gate/up/down 2560 and 6912
    for dg in (2560, 6912):
        name = f"ghost_norm_sq[2560/{dg}]"
        checks[name] = check_ghost_norm(torch, ops, ref, wl.TRAIN_LM_CHUNK,
                                        wl.TRAIN_LM_SEQ, 2560, dg)
        print(f"{name} ({wl.TRAIN_LM_CHUNK} x {wl.TRAIN_LM_SEQ} x 2560 / "
              f"{dg}) {checks[name]}")
    torch.cuda.empty_cache()

    _phase_done(walls, "3 kernel checks")

    # 4. train ResNet-18 at full width under the DPQuant scheduler, scan:
    # 3 epochs, one graph of the step and one of the probe step
    train_launches, train_summary = train_cnn(torch, ops, wl, wl.TRAIN_ARGV,
                                              8, 11_190_891)
    policy_graphs = {"resnet18": train_summary}

    _phase_done(walls, "4 train resnet18")

    # 4b. the scan executor against the loop on ResNet-18 under DPQuant
    # (the probe graph against the eager probes, two policies), the noise
    # of successive replays, and a graph captured under one policy
    # replayed under another
    from repro_torch.config import OptimConfig
    loop_vs_scan(torch, wl.train_setup, "resnet18",
                 OptimConfig(name="momentum", lr=0.1, schedule="cosine"),
                 dpquant=dict(quant_fraction=0.5, beta=0.0))
    check_noise_replays(torch, 11_190_891)
    switch = check_policy_switch(torch, wl)

    _phase_done(walls, "4b resnet18 loop vs scan, noise, policy switch")

    # 4c. the paper's other two CNNs at full width and depth, scan
    cnn_runs = {
        "resnet50": train_cnn(torch, ops, wl, wl.TRAIN_RESNET50_ARGV, 15,
                              23_588_459),
        "densenet121": train_cnn(torch, ops, wl, wl.TRAIN_DENSENET121_ARGV,
                                 56, 6_990_251)}
    cnn_launches = {arch: run[0] for arch, run in cnn_runs.items()}
    policy_graphs.update({arch: run[1] for arch, run in cnn_runs.items()})

    _phase_done(walls, "4c train resnet50, densenet121")

    # 4d. preemption and a bit-identical resume of ResNet-50 on the card
    import shutil
    ckpt_root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    try:
        preempt_resume(torch, ops, wl, ckpt_root)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)

    _phase_done(walls, "4d resnet50 preemption and resume")

    # 4e. ghost mode against the vmap engine inside the three CNNs
    cnn_ghost_vs_vmap(torch, ops, wl)

    _phase_done(walls, "4e cnn ghost vs vmap")

    # 4f. ResNet-18 and ResNet-50 in ghost mode under DPQuant, scan,
    # beside their vmap runs of this call
    ghost_runs = {
        "resnet": train_cnn(torch, ops, wl, wl.TRAIN_RESNET_GHOST_ARGV, 8,
                            11_190_891),
        "resnet50": train_cnn(torch, ops, wl, wl.TRAIN_RESNET50_GHOST_ARGV,
                              15, 23_588_459)}
    for arch, vmap_summary in (("resnet", train_summary),
                               ("resnet50", cnn_runs["resnet50"][1])):
        ghost_summary = ghost_runs[arch][1]
        print(f"{arch} ghost / vmap: {json.dumps(ghost_summary)} / "
              f"{json.dumps(vmap_summary)}")
        if ghost_summary["eps"] != vmap_summary["eps"]:
            raise AssertionError(f"{arch}: ghost epsilon "
                                 f"{ghost_summary['eps']} != vmap "
                                 f"{vmap_summary['eps']}")

    _phase_done(walls, "4f train resnet18, resnet50 ghost")

    # 4g. the scan executor against the loop on the ResNet-18 ghost step
    loop_vs_scan(torch, lambda: wl.setup(wl.TRAIN_RESNET_GHOST_ARGV),
                 "resnet18 ghost",
                 OptimConfig(name="momentum", lr=0.1, schedule="cosine"))

    _phase_done(walls, "4g resnet18 ghost loop vs scan")

    # 5. train stablelm-3b at full size in ghost mode under DPQuant, scan
    lm_launches, policy_graphs["stablelm-3b"] = train_stablelm(torch, ops,
                                                               wl)
    keys = ("captures", "warmups", "distinct_policies", "capture_s",
            "probe_capture_s",
            "analysis_s", "median_step_ms_by_epoch", "peak_gib", "eps",
            "policies")
    print(f"policy graphs ({card}): " + json.dumps(
        {arch: {k: v[k] for k in keys} for arch, v in policy_graphs.items()}))
    print(f"policy switch ({card}): {json.dumps(switch)}")

    _phase_done(walls, "5 train stablelm-3b")

    # 5b. the scan executor against the loop on stablelm-3b
    loop_vs_scan(torch, wl.train_lm_setup, "stablelm-3b",
                 OptimConfig(name="sgd", lr=0.5, schedule="cosine"),
                 rtol=1e-3)

    _phase_done(walls, "5b stablelm-3b loop vs scan")

    # 5c. stablelm-3b's memory and step with remat on and off
    remat = lm_remat(torch, ops, wl)
    print(f"remat ({card}): {json.dumps(remat)}")

    _phase_done(walls, "5c stablelm-3b remat")

    # 6. ghost against per-example gradients inside stablelm-3b at full
    # width, 2 layers
    ghost_vs_vmap(torch, ops, wl)

    _phase_done(walls, "6 ghost vs per-example")

    # 7. serve yi-6b at full width and depth
    from repro_torch.config import QuantConfig
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    model = build_model(get_config(wl.ARCH), QuantConfig(fmt=wl.QUANT_FMT,
                                                         backend="cuda"))
    t0 = time.perf_counter()
    params = model.prepare(model.init(wl.SEED))
    torch.cuda.synchronize()
    print(f"yi-6b: init + bf16 cast {(time.perf_counter() - t0) * 1e3} ms, "
          f"{sum(t.numel() for t in params.values()) / 1e9:.3f} B params")
    tokens = torch.randint(0, model.config.vocab_size, (1, 512), device="cuda")
    logits, _ = model.prefill(params, {"tokens": tokens}, kv_fmt="int8")
    if logits.shape != (1, model.config.padded_vocab) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite")
    prefill_ms = time_ms(torch, lambda: model.prefill(
        params, {"tokens": tokens}, kv_fmt="int8"), 5)
    print(f"prefill (1 x 512 tokens, int8 cache): {prefill_ms} ms")
    torch.cuda.reset_peak_memory_stats()
    launches, yi6b_ticks = {}, {}
    for kv_fmt in ("int8", "luq_fp4"):
        summary, counts = serve_yi6b(torch, kv_fmt, model, params, ops, wl)
        yi6b_ticks[kv_fmt] = summary
        print(f"serve yi-6b kv={kv_fmt}: {summary['n_requests']} requests, "
              f"{summary['total_new_tokens']} tokens, "
              f"{summary['tokens_per_sec']} tok/s, "
              f"{summary['decode_ticks']} ticks, "
              f"ttft p50 {summary['ttft_p50_s'] * 1e3} ms, "
              f"latency p50 {summary['latency_p50_s'] * 1e3} ms, "
              f"run wall per tick (admissions included) "
              f"{summary['run_wall_s'] / summary['decode_ticks'] * 1e3} ms, "
              f"decode graph replays per tick "
              f"{summary['graph_replays_per_tick']}, host calls per tick "
              f"{summary['host_calls_per_tick']} (a profiled rerun, prefills "
              f"included), "
              f"prompts {summary['prompt_lengths']}, launches (replays "
              f"counted) {counts}")
        launches[kv_fmt] = counts
    yi6b_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"peak device memory {yi6b_peak} GiB")

    _phase_done(walls, "7 serve yi-6b")

    # 7b. serve yi-6b under faults: the chaos run and the oneshot drain
    # token-identical to the fault-free run, each bucket's prefill graph
    # bitwise the eager prefill
    for kv_fmt in ("int8", "luq_fp4"):
        summary, counts = serve_faults_yi6b(torch, kv_fmt, model, params,
                                            ops, wl)
        zero = [k for k in ("luq_matmul[decode]", "luq_matmul[prefill]",
                            "kv_quant_write[decode]",
                            "kv_quant_write[prefill]", "decode_attn_fused")
                if counts[k] == 0]
        if zero:
            raise AssertionError(f"kernels not launched in the chaos run: "
                                 f"{zero}")
        print(f"serve yi-6b under faults kv={kv_fmt} ({card}): "
              f"{json.dumps(summary)}; chaos run launches (replays "
              f"counted) {counts}")
        torch.cuda.empty_cache()

    _phase_done(walls, "7b serve yi-6b under faults")

    # 8. engine vs oneshot, one request, same shapes on both sides
    from repro_torch.config import ServeConfig
    from repro_torch.serve import (ContinuousEngine, build_oneshot_fns,
                                   oneshot_generate)
    plen, gen = 256, 8
    prompt = torch.randint(0, model.config.vocab_size, (1, plen),
                           generator=torch.Generator().manual_seed(SEED))
    prefill, decode = build_oneshot_fns(model, plen + gen, kv_fmt="int8")
    want, _ = oneshot_generate(prefill, decode, params,
                               {"tokens": prompt.to("cuda")}, gen)
    engine = ContinuousEngine(model, params, ServeConfig(
        max_slots=1, max_seq=plen + gen, kv_fmt="int8"))
    rid = engine.submit(prompt[0].numpy(), max_new_tokens=gen)
    got = engine.run()[rid].tokens.tolist()
    if got != want[0].tolist():
        raise AssertionError(f"engine {got} != oneshot {want[0].tolist()}")
    print(f"engine == oneshot for one yi-6b request: {got}")

    _phase_done(walls, "8 engine vs oneshot")
    del model, params, engine
    _free(torch)

    # 9. BERT-SNLI whole under DPQuant, DP-AdamW, scan
    bert_launches, bert_summary = train_vmap_lm(
        torch, ops, wl, wl.TRAIN_BERT_ARGV, 11, BERT_PARAMS, BERT_PER_PASS)

    _phase_done(walls, "9 train bert-snli")

    # 10. Mamba-2-130m at full width, CUT_LAYERS layers, under DPQuant, scan
    mamba_launches, mamba_summary = train_vmap_lm(
        torch, ops, wl, wl.TRAIN_MAMBA2_ARGV, 5, MAMBA2_PARAMS,
        MAMBA2_PER_PASS, n_layers=CUT_LAYERS)
    keys = ("captures", "warmups", "capture_s", "probe_capture_s",
            "analysis_s", "median_step_ms_by_epoch", "tokens_per_s",
            "peak_gib", "eps", "accuracy")
    print(f"token models ({card}): " + json.dumps(
        {arch: {k: v[k] for k in keys} for arch, v in
         (("bert-snli", bert_summary), ("mamba2-130m", mamba_summary))}))

    _phase_done(walls, "10 train mamba2-130m")

    # 11. Mamba-2-130m oneshot serving
    serve_mamba2(torch, ops, wl)

    _phase_done(walls, "11 serve mamba2-130m")

    # 12. RecurrentGemma-9B at full width, 5 layers, under DPQuant, scan
    griffin_launches, griffin_summary = train_vmap_lm(
        torch, ops, wl, wl.TRAIN_GRIFFIN_ARGV, 4, GRIFFIN_TRAIN_PARAMS,
        GRIFFIN_PER_PASS, n_layers=wl.TRAIN_GRIFFIN_LAYERS)

    _phase_done(walls, "12 train recurrentgemma-9b")

    # 13. RecurrentGemma-9B whole, oneshot serving
    serve_griffin(torch, ops, wl)

    _phase_done(walls, "13 serve recurrentgemma-9b")

    # 14. InternVL2-1B at full width, CUT_LAYERS layers, under DPQuant, scan
    vlm_launches, vlm_summary = train_vmap_lm(
        torch, ops, wl, wl.TRAIN_VLM_ARGV, 5, VLM_PARAMS, VLM_PER_PASS,
        n_layers=CUT_LAYERS, after=lambda tr: vlm_masked_prefix(torch, tr))
    print(f"hybrid and vlm training ({card}): " + json.dumps(
        {arch: {k: v[k] for k in keys + ("wall_s",)} for arch, v in
         (("recurrentgemma-9b", griffin_summary),
          ("internvl2-1b", vlm_summary))}))

    _phase_done(walls, "14 train internvl2-1b")

    # 15. InternVL2-1B oneshot serving, the luq_fp4 head
    _, vlm_serve_launches = serve_vlm(torch, ops, wl)

    _phase_done(walls, "15 serve internvl2-1b")

    # 16. whisper-medium at full width, WHISPER_CUT_LAYERS + as many layers,
    # under DPQuant, scan
    whisper_launches, whisper_summary = train_vmap_lm(
        torch, ops, wl, wl.TRAIN_WHISPER_ARGV, 5, WHISPER_TRAIN_PARAMS,
        WHISPER_PER_PASS, n_layers=WHISPER_CUT_LAYERS,
        after=whisper_input_host_ms)
    print(f"encdec training ({card}): " + json.dumps(
        {"whisper-medium": {k: whisper_summary[k]
                            for k in keys + ("wall_s", "after")}}))

    _phase_done(walls, "16 train whisper-medium")

    # 17. whisper-medium whole, oneshot serving
    serve_whisper(torch, ops, wl)

    _phase_done(walls, "17 serve whisper-medium")

    # 18. data parallelism: two ranks on this card over gloo, one under NCCL
    _free(torch)
    data_parallel(torch, card)

    _phase_done(walls, "18 data parallel")

    # 19. arctic-480b at full per-token width, 2 layers of 8 experts, under
    # DPQuant, scan; then float32 decode against prefill of the same cut
    moe_launches, moe_summary = train_vmap_lm(
        torch, ops, wl, wl.TRAIN_MOE_ARGV, 1, MOE_TRAIN_PARAMS, MOE_PER_PASS,
        cut=wl.TRAIN_MOE_CUT, after=lambda tr: moe_dropped_share(torch, tr))
    moe_summary["decode_vs_prefill_float32"] = moe_decode_vs_prefill(torch,
                                                                     wl)
    print(f"moe training ({card}): " + json.dumps(
        {"arctic-480b": {k: moe_summary[k] for k in
                         keys + ("wall_s", "after",
                                 "decode_vs_prefill_float32")}}))

    _phase_done(walls, "19 train arctic-480b")

    # 20. arctic-480b and kimi-k2-1t-a32b, one layer with every expert,
    # oneshot serving
    moe_serve = serve_moe(torch, ops, wl)
    print(f"moe serving ({card}): " + json.dumps(moe_serve))

    _phase_done(walls, "20 serve arctic-480b, kimi-k2-1t-a32b")

    # 21. each workload's step traced on the host and held against its
    # roofline on the card: its terms against the wall the phases measured
    train_runs = {
        "resnet18 vmap": (wl.TRAIN_ARGV, {}, train_summary),
        "resnet18 ghost": (wl.TRAIN_RESNET_GHOST_ARGV, {},
                           ghost_runs["resnet"][1]),
        "stablelm-3b ghost": (wl.TRAIN_LM_ARGV, {},
                              policy_graphs["stablelm-3b"]),
        "bert-snli": (wl.TRAIN_BERT_ARGV, {}, bert_summary),
        "mamba2-130m": (wl.TRAIN_MAMBA2_ARGV, {"n_layers": CUT_LAYERS},
                        mamba_summary),
        "recurrentgemma-9b": (wl.TRAIN_GRIFFIN_ARGV,
                              {"n_layers": wl.TRAIN_GRIFFIN_LAYERS},
                              griffin_summary),
        "internvl2-1b": (wl.TRAIN_VLM_ARGV, {"n_layers": CUT_LAYERS},
                         vlm_summary),
        "whisper-medium": (wl.TRAIN_WHISPER_ARGV,
                           {"n_layers": WHISPER_CUT_LAYERS},
                           whisper_summary),
        "arctic-480b": (wl.TRAIN_MOE_ARGV, wl.TRAIN_MOE_CUT, moe_summary)}
    _free(torch)
    shares = roofline_phase(torch, ops, wl, card, sm_clock_mhz, train_runs,
                            yi6b_ticks, yi6b_peak, moe_serve)
    print(f"roofline shares ({card}): " + json.dumps(shares))

    _phase_done(walls, "21 roofline")
    if walls["21 roofline"] > ROOFLINE_PHASE_S:
        raise AssertionError(f"phase 21 took {walls['21 roofline']} s, "
                             f"more than its {ROOFLINE_PHASE_S} s")

    # 22. the model axis: two ranks on this card over gloo, each holding its
    # blocks of every layer; the three kernels on the shards.  23. serving
    # on the model axis in the same ranks: the three serving kernels on a
    # vocab or sequence shard, yi-6b through the engine, arctic oneshot
    _free(torch)
    tp = model_parallel(torch, card, sm_clock_mhz)
    checks.update(tp["kernels"])
    checks.update(tp["serve"]["kernels"])

    _phase_done(walls, "22-23 model parallel, serving on the model axis")
    del walls["start"]
    print(f"phase walls (s): {json.dumps(walls)}")

    sources = {
        "kv_quant_write": ("src/repro_torch/kernels/csrc/kv_quant.cu",
                           "src/repro/kernels/decode_attn.py:52"),
        "decode_attn_fused": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                              "src/repro/kernels/decode_attn.py:114"),
        "luq_matmul": ("src/repro_torch/kernels/csrc/luq_matmul.cu",
                       "src/repro/kernels/quant_matmul.py:62"),
        "luq_quant": ("src/repro_torch/kernels/csrc/luq_quant.cu",
                      "src/repro/kernels/luq_quant.py:51"),
        "per_sample_clip": ("src/repro_torch/kernels/csrc/per_sample_clip.cu",
                            "src/repro/kernels/per_sample_clip.py:64"),
        "ghost_norm_sq": ("src/repro_torch/kernels/csrc/ghost_norm.cu",
                          "src/repro/kernels/ghost_norm.py:61"),
    }
    # launches of each row's kernel in its path's run: the training runs,
    # or the serving run of its KV format, or both serving runs
    counts = {"luq_quant[resnet_weight]": train_launches["luq_quant[whole]"],
              "luq_quant[resnet_activation]":
                  train_launches["luq_quant[per_example]"],
              "luq_quant[lm_weight]": lm_launches["luq_quant[whole]"],
              "luq_quant[lm_rows]": lm_launches["luq_quant[per_example]"],
              "per_sample_clip": train_launches["clip_and_sum"]}
    for arch, c in cnn_launches.items():
        counts[f"luq_quant[{arch}_weight]"] = c["luq_quant[whole]"]
        counts[f"luq_quant[{arch}_activation]"] = c["luq_quant[per_example]"]
        counts[f"per_sample_clip[{arch}]"] = c["clip_and_sum"]
    for arch, (c, _) in ghost_runs.items():
        counts[f"luq_quant[{arch}_ghost_weight]"] = c["luq_quant[whole]"]
        counts[f"luq_quant[{arch}_ghost_rows]"] = c["luq_quant[per_example]"]
    for dg in (2560, 6912):
        name = f"ghost_norm_sq[2560/{dg}]"
        counts[name] = lm_launches.get(name, 0)
    for arch, c, rows in (("bert", bert_launches, "activation"),
                          ("mamba2", mamba_launches, "gate"),
                          ("griffin", griffin_launches, "rows"),
                          ("vlm", vlm_launches, "rows"),
                          ("whisper", whisper_launches, "rows")):
        counts[f"luq_quant[{arch}_weight]"] = c["luq_quant[whole]"]
        counts[f"luq_quant[{arch}_{rows}]"] = c["luq_quant[per_example]"]
        counts[f"per_sample_clip[{arch}]"] = c["clip_and_sum"]
    counts["luq_quant[moe_expert_weight]"] = moe_launches["luq_quant[whole]"]
    counts["luq_quant[moe_dispatch_rows]"] = \
        moe_launches["luq_quant[per_example]"]
    counts["per_sample_clip[moe]"] = moe_launches["clip_and_sum"]
    # phase 22's sharded steps at luq_fp4: the split calls
    tp_lm = tp["lm"]["variants"]["22a bfloat16 luq_fp4"]["launches"]["split"]
    tp_moe = tp["moe"]["variants"]["22b bfloat16 luq_fp4"]["launches"][
        "split"]
    counts["luq_quant[tp_lm_weight]"] = tp_lm["luq_round"]
    counts["ghost_norm_sq[tp_lm]"] = tp_lm["ghost_norm_mapped"]
    counts["luq_quant[tp_moe_dispatch_rows]"] = tp_moe["luq_round"]
    counts["per_sample_clip[tp_moe]"] = tp_moe["clip_apply"]
    # phase 23b's sharded engine runs (the control left out): every
    # logits head on a vocab shard, every attention and KV write of the
    # row-split cache on a sequence shard
    runs = tp["serve"]["engine"]["runs"]
    for label, run in runs.items():
        c = run["launches"]
        if label.endswith("control"):
            continue
        if c["split"]["luq_matmul_cols"] != c["launches"]["luq_matmul"]:
            raise AssertionError(f"23b {label}: a logits head on the whole "
                                 f"head")
        if label.startswith("kv_seq") and not (
                c["split"]["kv_quant_rows"] == c["launches"]["kv_quant_write"]
                and c["split"]["decode_attn_split"]
                == c["split"]["decode_attn_merge"]
                == c["launches"]["decode_attn_fused"]):
            raise AssertionError(f"23b {label}: a KV write or an attention "
                                 f"on the whole cache: {c}")
    for branch in ("decode", "prefill"):
        counts[f"luq_matmul[tp_{branch}]"] = sum(
            run["launches"]["luq_matmul"][branch]
            for label, run in runs.items() if not label.endswith("control"))
    for fmt in ("int8", "luq_fp4"):
        c = runs[f"kv_seq {fmt}"]["launches"]
        counts[f"decode_attn_fused[tp_seq/{fmt}]"] = \
            c["split"]["decode_attn_split"]
        for branch in ("decode", "prefill"):
            counts[f"kv_quant_write[tp_seq/{fmt}/{branch}]"] = \
                c["kv_write"][branch]
    for fmt in ("int8", "luq_fp4"):
        for branch in ("decode", "prefill"):
            counts[f"kv_quant_write[{fmt}/{branch}]"] = \
                launches[fmt][f"kv_quant_write[{branch}]"]
        counts[f"decode_attn_fused[{fmt}]"] = launches[fmt]["decode_attn_fused"]
    for branch in ("decode", "prefill"):
        counts[f"luq_matmul[{branch}]"] = sum(
            c[f"luq_matmul[{branch}]"] for c in launches.values())
    counts["luq_matmul[vlm]"] = vlm_serve_launches["luq_matmul"]
    kernels = []
    for name, numbers in checks.items():
        src, replaces = sources[name.partition("[")[0]]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[name],
                        **numbers})
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels never launched on their paths: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--nccl-capture"]:
        sys.exit(nccl_capture_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--tp-rank"]:
        sys.exit(tp_rank_main(sys.argv[2:]))
    sys.exit(main())
