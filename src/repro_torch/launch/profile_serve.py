"""Where a serving run's time goes: a torch.profiler breakdown on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve --kv-fmt int8

Serves the workload of ``launch/workload.py`` (the one ``chip_smoke.py``
drives: yi-6b, 4 slots, 8 requests) once to warm up, times one unprofiled
run, then profiles one more run and prints:

* the wall time of the unprofiled run and per decode tick;
* from the profiled run's trace alone: the span of the run (its
  ``engine.run`` range), the device's busy time within it (the union of
  the intervals of its kernels and copies) and the idle share.  The
  profiler slows the host, so this idle share is at least the unprofiled
  run's;
* host time of the admissions (prefill), of the decode ticks and, within
  both, of the logits head (``qlogits``: scales, the float32 head and
  the quantized matmul, which draws its own uniforms);
* the kernels with the most device time, the device time of each of the
  port's own kernels (``kernels/csrc``, however little), the host's
  kernel launch calls (``cudaLaunchKernel``) and graph launch calls
  (``cudaGraphLaunch``, one a decode tick and one an admission: the
  engine replays its decode step's CUDA graph and each bucket's prefill
  graph) and the operators with the most host time.

Kernels launched through ``ctypes`` are not tied to a host range, so the
device time shown for a range covers PyTorch's operators only; the
decode and prefill steps' ranges were recorded at capture (in the
warm-up run), so their device time shows in the kernel lists, not under
``qlogits``.
"""
from __future__ import annotations

import argparse
import re
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.config import QuantConfig, ServeConfig
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.launch import workload as wl
from repro_torch.models import common as cm
from repro_torch.models.registry import build_model
from repro_torch.serve import ContinuousEngine

RANGES = ("engine.run", "engine.admit", "engine.tick", "qlogits")
TOP = 15


def port_kernels() -> re.Pattern:
    """A pattern that matches the profiler's name of any ``__global__``
    function of ``kernels/csrc``."""
    names = set()
    for src in sorted(build.CSRC.glob("*.cu")):
        text = re.sub(r"__launch_bounds__\([^)]*\)", "", src.read_text())
        names.update(re.findall(r"__global__\s+void\s+(\w+)\s*\(", text))
    return re.compile(r"::(%s)[(<]" % "|".join(sorted(names)))


def _device_us(evt, self_only=True) -> float:
    name = "self_device_time_total" if self_only else "device_time_total"
    return float(getattr(evt, name, 0.0))


def _is_kernel(evt) -> bool:
    # device-side events, without the device copies of the host ranges
    return evt.device_type == DeviceType.CUDA and evt.key not in RANGES


def _ranged(fn, name):
    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of the ``(start, end)`` intervals within
    ``[lo, hi]``."""
    busy, covered = 0.0, lo
    for start, end in sorted(intervals):
        start, end = max(start, covered), min(end, hi)
        if end > start:
            busy += end - start
            covered = end
    return busy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kv-fmt", default="int8",
                    choices=["none", "int8", "luq_fp4"])
    args = ap.parse_args(argv)

    cfg = get_config(wl.ARCH)
    model = build_model(cfg, QuantConfig(fmt=wl.QUANT_FMT, backend="cuda"))
    params = model.prepare(model.init(wl.SEED))
    engine = ContinuousEngine(model, params, ServeConfig(
        max_slots=wl.SLOTS, max_seq=wl.MAX_SEQ, max_new_tokens=wl.NEW_TOKENS,
        kv_fmt=args.kv_fmt))
    prompts = wl.prompts(cfg.vocab_size)

    def run():
        engine.reset()
        for p in prompts:
            engine.submit(p, max_new_tokens=wl.NEW_TOKENS)
        with record_function("engine.run"):
            engine.run()
            torch.cuda.synchronize()

    run()                                           # warm-up
    t0 = time.perf_counter()
    run()
    plain_wall = time.perf_counter() - t0
    engine._admit = _ranged(engine._admit, "engine.admit")
    engine._tick = _ranged(engine._tick, "engine.tick")
    cm.qlogits = _ranged(cm.qlogits, "qlogits")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    ticks = engine.metrics.decode_ticks
    print(f"{cfg.name} kv={args.kv_fmt} quant={wl.QUANT_FMT} backend=cuda: "
          f"{wl.REQUESTS} requests x {wl.NEW_TOKENS} tokens, prompts "
          f"{[p.size for p in prompts]}, {wl.SLOTS} slots, {ticks} decode "
          f"ticks ({engine.decode_replays} decode graph replays in all); "
          f"unprofiled wall {plain_wall * 1e3} ms "
          f"({plain_wall / ticks * 1e3} ms per decode tick, admissions "
          f"included)")

    trace = prof.events()
    span = next(e.time_range for e in trace if e.key == "engine.run"
                and e.device_type == DeviceType.CPU)
    busy_us = union_us([(e.time_range.start, e.time_range.end)
                        for e in trace if _is_kernel(e)],
                       span.start, span.end)
    print(f"profiled run: span {span.elapsed_us() / 1e3} ms, device busy "
          f"{busy_us / 1e3} ms (union of its kernels and copies), idle "
          f"share {1 - busy_us / span.elapsed_us()}")

    events = prof.key_averages()
    for e in events:
        if e.key in RANGES and e.device_type == DeviceType.CPU:
            print(f"  {e.key}: {e.count} calls, host {e.cpu_time_total / 1e3} "
                  f"ms (under the profiler), device time of the PyTorch "
                  f"operators inside {_device_us(e, self_only=False) / 1e3} ms")
    kernels = [e for e in events if _is_kernel(e)]
    print(f"summed device time of the kernels and copies "
          f"{sum(_device_us(e) for e in kernels) / 1e3} ms; the most:")
    for e in sorted(kernels, key=_device_us, reverse=True)[:TOP]:
        print(f"  {_device_us(e) / 1e3:12.3f} ms  {e.count:7d} calls  "
              f"{e.key[:90]}")
    print_port_kernels(kernels, events)
    print("operators with the most host time (under the profiler):")
    print(events.table(sort_by="self_cpu_time_total", row_limit=TOP,
                       max_name_column_width=60))


def print_port_kernels(kernels, events) -> None:
    """Print the device time of each of the port's own kernels among the
    trace's ``kernels``, however little, and the host's kernel and graph
    launch calls (``cudaLaunchKernel``, ``cudaGraphLaunch`` and their
    variants) among its ``events``."""
    print("the port's own kernels:")
    ours = port_kernels()
    for e in sorted(kernels, key=_device_us, reverse=True):
        if ours.search(e.key):
            print(f"  {_device_us(e) / 1e3:12.3f} ms  {e.count:7d} calls  "
                  f"{e.key[:90]}")
    launches = {e.key: e.count for e in events
                if e.device_type == DeviceType.CPU
                and e.key.startswith(("cudaLaunchKernel", "cudaGraphLaunch"))}
    print(f"host launch calls: {launches}")


if __name__ == "__main__":
    main()
