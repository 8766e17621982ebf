"""Where a training step's time goes: a torch.profiler breakdown on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_train [--workload resnet]
    PYTHONPATH=src python -m repro_torch.launch.profile_train --workload lm
    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --workload resnet50|densenet121
    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --workload resnet-ghost|resnet50-ghost
    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --workload bert|mamba2|griffin|vlm|whisper|moe
    PYTHONPATH=src python -m repro_torch.launch.profile_train --executor loop

``resnet`` (the default) builds the training workload of
``launch/workload.py`` (full-width ResNet-18, DP-SGD under DPQuant, 256
images in microbatches of 64, LUQ-FP4 convs, the fused clip) and runs
epoch 0 (analysis and 3 steps) to warm up.  ``resnet50`` and
``densenet121`` build the workloads of the paper's other two CNNs (the
same options, full width and depth), ``resnet-ghost`` and
``resnet50-ghost`` ResNet-18 and ResNet-50 in ghost mode (the same
options with the conv taps in place of per-example gradients, pass 1 in
chunks of 64 images), ``lm`` the LM workload (full-size stablelm-3b,
ghost-mode DP-SGD, 8 x 256 tokens, pass 1 in chunks of 4, LUQ-FP4
projections), ``bert`` BERT-SNLI whole (DP-AdamW, 256 x 128 tokens in
microbatches of 16, the fused clip), ``mamba2`` Mamba-2-130m whole
(DP-SGD, 32 x 512 tokens in microbatches of 8, the fused clip),
``griffin`` RecurrentGemma-9B at full width cut to 5 layers (8 x 256
tokens, one example a microbatch), ``vlm`` InternVL2-1B whole (32 x
512 tokens in microbatches of 8, the vision prefix masked) and
``whisper`` whisper-medium whole (32 x 448 tokens and 448 encoder frames
in microbatches of 4) and ``moe`` arctic-480b at full per-token width cut
to 2 layers of 8 experts (8 x 256 tokens, one example a microbatch,
quant_fraction 0.5); all but ``resnet`` warm up with an epoch's steps
under the scheduler's first selection (k = 8 of 9, 15 of 17, 56 of 62,
29 of 32, 11 of 12, 22 of 24, 4 of 5, 22 of 24, 43 of 48, 1 of 2 layers),
without the analysis's probe steps.  The
steps run through ``--executor`` (default
``scan``: replays of the step's CUDA graph, captured in the warm-up;
``loop``: one eager step after another).  Then it times the epoch's steps
unprofiled under that policy, profiles as many more and prints:

* the wall time per step of the unprofiled steps;
* from the profiled steps' trace alone: their span, the device's busy
  time within it (the union of its kernels and copies) and the idle
  share (the profiler slows the host, so this is at least the unprofiled
  share);
* host time under the ranges ``train.step`` (a whole step),
  ``per_example_grads`` (the vmapped forward and backward of a
  microbatch), ``quantize`` (one quantizer call: the kernel's wrapper),
  ``fused_clip`` (flatten, clip kernel, unflatten), ``ghost.pass1`` (the
  norm pass over every chunk), ``ghost.pass2`` (the reweighted forward
  and backward), ``ghost.fused_norm`` (one call of the ghost_norm op)
  and ``noise``, with the device time of the PyTorch operators inside
  each;
* the kernels with the most device time, the shares of the summed
  device time that the LUQ quantizer's kernels and the clip's kernels
  take, the device time of each of the port's own kernels
  (``kernels/csrc``), the host's kernel launch calls and the operators
  with the most host time.

Kernels launched through ``ctypes`` (``luq_quant``, ``per_sample_clip``,
``ghost_norm``) are not tied to a host range; they appear in the kernel
lists only.  Under ``scan`` the ranges inside the step were recorded at
capture, not at replay, so only ``train.steps`` is shown: the per-range
breakdown comes from ``--executor loop``; the kernels' device time, the
idle share and the host's launch calls (``cudaLaunchKernel``,
``cudaGraphLaunch``) come from either, CUPTI seeing each replay's kernels.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.dp import clip as dp_clip
from repro_torch.launch import steps as train_steps
from repro_torch.launch import workload as wl
from repro_torch.launch.profile_serve import (_device_us, _ranged,
                                              print_port_kernels, union_us)
from repro_torch.quant import fake_quant as fq
from repro_torch.train_loop import Trainer

RANGES = ("train.steps", "train.step", "per_example_grads", "quantize",
          "fused_clip", "ghost.pass1", "ghost.pass2", "ghost.fused_norm",
          "noise")
TOP = 20
# kernels of the port by the op they serve: the LUQ quantize op's two
# passes and the fused clip's two
SHARES = {"luq_quant": ("luq_row_max_kernel", "luq_round_kernel"),
          "per_sample_clip": ("row_sumsq_kernel", "column_sum_kernel")}


def _is_kernel(evt) -> bool:
    return evt.device_type == DeviceType.CUDA and evt.key not in RANGES


def _ranged_vmap(vmap):
    def wrapped(*args, **kwargs):
        return _ranged(vmap(*args, **kwargs), "per_example_grads")
    return wrapped


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="resnet",
                    choices=sorted(wl.TRAIN_WORKLOADS))
    ap.add_argument("--executor", default="scan", choices=["scan", "loop"])
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False         # float32, as the CLI
    torch.backends.cuda.matmul.allow_tf32 = False
    argv, cut = wl.TRAIN_WORKLOADS[args.workload]
    run, ds, _ = wl.setup(argv, **cut)
    run = dataclasses.replace(run, epoch_executor=args.executor)
    tr = Trainer(run, ds, mode="dpquant", device="cuda")
    steps = (tr._train_steps_scan if args.executor == "scan"
             else tr._train_steps_loop)
    if args.workload == "resnet":
        tr.train(1)                                 # warm-up, analysis
    else:
        steps(tr._set_flags(tr.scheduler.select(0).flags()))   # warm-up
    capture_s = tr.last_capture_s
    flags = tr._set_flags(tr.scheduler.current.flags())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(flags)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / run.steps_per_epoch

    if args.executor == "loop":
        tr.step_fn = _ranged(tr.step_fn, "train.step")
        dp_clip.vmap = _ranged_vmap(dp_clip.vmap)
        dp_clip._fused_clip_sum = _ranged(dp_clip._fused_clip_sum,
                                          "fused_clip")
        fq._quantize_rows = _ranged(fq._quantize_rows, "quantize")
        train_steps.add_gaussian_noise = _ranged(
            train_steps.add_gaussian_noise, "noise")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("train.steps"):
            steps(flags)
            torch.cuda.synchronize()
    print(f"{run.model.name} ({args.executor} executor, "
          f"{len(tr.epoch_fn.captured) if tr.epoch_fn else 0} captures, "
          f"graph warm-up and capture {capture_s} s in the warm-up): "
          f"{run.global_batch} examples a step "
          f"({run.dp.grad_mode} mode, microbatch {run.dp.microbatch_size}, "
          f"ghost microbatch {run.dp.ghost_microbatch}), quantized layers "
          f"{list(tr.scheduler.current.layers)} of "
          f"{run.model.policy_len()}, fmt {run.quant.fmt}, clip "
          f"{run.dp.clip_backend}; unprofiled {per_step * 1e3} ms per step "
          f"({run.global_batch / per_step} examples/s); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30} GiB")

    trace = prof.events()
    span = next(e.time_range for e in trace if e.key == "train.steps"
                and e.device_type == DeviceType.CPU)
    busy_us = union_us([(e.time_range.start, e.time_range.end)
                        for e in trace if _is_kernel(e)],
                       span.start, span.end)
    print(f"profiled {run.steps_per_epoch} steps: span "
          f"{span.elapsed_us() / 1e3} ms, device busy {busy_us / 1e3} ms "
          f"(union of its kernels and copies), idle share "
          f"{1 - busy_us / span.elapsed_us()}")

    events = prof.key_averages()
    for e in events:
        if e.key in RANGES and e.device_type == DeviceType.CPU:
            print(f"  {e.key}: {e.count} calls, host {e.cpu_time_total / 1e3} "
                  f"ms (under the profiler), device time of the PyTorch "
                  f"operators inside {_device_us(e, self_only=False) / 1e3} ms")
    kernels = [e for e in events if _is_kernel(e)]
    total_us = sum(_device_us(e) for e in kernels)
    print(f"summed device time of the kernels and copies "
          f"{total_us / 1e3} ms; the most:")
    for e in sorted(kernels, key=_device_us, reverse=True)[:TOP]:
        print(f"  {_device_us(e) / 1e3:12.3f} ms  {e.count:7d} calls  "
              f"{e.key[:100]}")
    for name, marks in SHARES.items():
        us = sum(_device_us(e) for e in kernels
                 if any(m in e.key for m in marks))
        print(f"{name} share of the summed device time: {us / total_us} "
              f"({us / 1e3} ms)")
    print_port_kernels(kernels, events)
    print("operators with the most host time (under the profiler):")
    print(events.table(sort_by="self_cpu_time_total", row_limit=TOP,
                       max_name_column_width=60))


if __name__ == "__main__":
    main()
