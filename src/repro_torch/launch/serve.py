"""Serving CLI: continuous-batching engine or the oneshot reference driver.

    # continuous batching on the GPU, quantized logits head and KV cache
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --quant-fmt luq_fp4 --kv-fmt int8 --slots 4 --requests 8

    # at smoke size on the CPU (the kernels' plain versions)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \
        --device cpu --quant-fmt luq_fp4 --kv-fmt luq_fp4

    # Mamba-2-130m through the oneshot engine (no KV cache: an O(1)
    # recurrent state a row; no continuous batching yet)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        --engine oneshot --batch 8 --prompt-len 512 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        --smoke --device cpu --engine oneshot

    # RecurrentGemma-9B whole (RG-LRU state and a ring KV cache of the
    # attention window) and InternVL2-1B (a Gaussian vision prefix of 256
    # embeddings, the luq_fp4 logits head), oneshot
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b --engine oneshot --batch 4 \
        --prompt-len 2560 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-1b \
        --engine oneshot --batch 8 --prompt-len 512 --gen 32 \
        --quant-fmt luq_fp4
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b --smoke --device cpu --engine oneshot

    # whisper-medium whole (the encoder-decoder: 384 Gaussian encoder
    # frames a prompt of 384 tokens, cross-attention K/V cached once),
    # oneshot; at smoke size on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-medium --engine oneshot --batch 8 --prompt-len 384 \
        --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-medium --smoke --device cpu --engine oneshot

    # the MoE LMs (arctic-480b, kimi-k2-1t-a32b), oneshot: an unquantized
    # KV cache and float32 logits; at smoke size on the CPU (on the card
    # launch/workload.py's SERVE_MOE_ARGV serves one full layer)
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch kimi-k2-1t-a32b --smoke --device cpu --engine oneshot

    # chaos mode: a seeded FaultPlan through the supervisor, the fired
    # events written to a JSON log
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \
        --device cpu --fault-seed 0 --fault-log /tmp/f.json

    # on a model group of 2 ranks (tensor parallel; the MoE LMs' experts
    # split over the ranks), gloo on the CPU: the same tokens as one
    # process, printed by rank 0
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc_per_node 2 -m repro_torch.launch.serve --arch yi-6b \
        --smoke --device cpu --model-parallel 2 --kv-fmt int8

The flags are those of ``repro.launch.serve`` (as there, a family
without per-slot decode, Mamba-2, the Griffin hybrid, the VLM, the
encoder-decoder or the MoE LMs, runs ``--engine continuous`` through the
oneshot engine,
with a note; the oneshot batch holds every input of the model's
``batch_spec``),
admission control
(``--deadline``, ``--max-queue``) and chaos mode (``--fault-seed``,
``--fault-log``) included, plus ``--device`` (default ``cuda``; without a
GPU the run raises unless ``--device cpu`` is given) and ``--backend
ref|cuda`` (default ``cuda``, the hand-written kernels;
``REPRO_QUANT_BACKEND`` overrides it).  ``--model-parallel N`` (under
``torch.distributed.run``, N the world: one model group) serves the dense
LMs and the MoE LMs split over the ranks' ``model`` axis, as ``launch.
train`` trains them: NCCL one card a rank (gloo on the CPU); the params
are made whole on every rank and sharded once; rank 0 alone prints.
Chaos mode does not run on a model group (the supervisor raises).
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config import QuantConfig, ServeConfig
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.launch.mesh import init_distributed, make_host_mesh
from repro_torch.models.registry import build_model
from repro_torch.runtime.faults import FaultPlan
from repro_torch.runtime.supervisor import ServeSupervisor, run_supervised
from repro_torch.serve import (ContinuousEngine, build_oneshot_fns,
                               oneshot_generate)
from repro_torch.serve.layout import serve_layout


def _random_prompt(rng: np.random.RandomState, length: int,
                   vocab: int) -> np.ndarray:
    return rng.randint(0, vocab, size=(length,)).astype(np.int32)


def oneshot_batch(args, model) -> dict:
    """The oneshot engine's batch, on the model's device: every key of the
    model's ``batch_spec`` (token ids only without one), ``--batch`` rows
    of ``--prompt-len`` positions from ``--seed``.  Integer inputs are
    random token ids; float inputs (the VLM's ``vision_embeds``, the
    encoder-decoder's ``enc_embeds``, as long as the prompt) are Gaussian
    in their dtype, from a torch generator seeded with ``--seed``."""
    cfg = model.config
    rng = np.random.RandomState(args.seed)
    tokens = np.stack([_random_prompt(rng, args.prompt_len, cfg.vocab_size)
                       for _ in range(args.batch)])
    batch = {"tokens": torch.from_numpy(tokens).to(model.device)}
    if model.batch_spec is not None:
        gen = torch.Generator().manual_seed(args.seed)
        for name, (shape, dtype) in model.batch_spec(
                args.batch, args.prompt_len).items():
            if not dtype.is_floating_point:
                continue
            batch[name] = torch.randn(shape, generator=gen).to(
                model.device, dtype)
    return batch


def _quiet(*args, **kwargs) -> None:
    """``print`` on a rank other than 0."""


def run_oneshot(model, params, args, mesh=None, print=print) -> None:
    """One fixed batch, prefill, lockstep decode; on ``mesh``'s model
    group, this rank's shard."""
    cache_len = args.prompt_len + args.gen
    layout = serve_layout(model, mesh, {k: tuple(t.shape) for k, t in
                                        params.items()},
                          args.batch, cache_len, args.kv_fmt)
    prefill, decode = build_oneshot_fns(model, cache_len,
                                        kv_fmt=args.kv_fmt, layout=layout)
    if layout is not None:
        params = layout.shard(params)
    batch = oneshot_batch(args, model)
    gen, timings = oneshot_generate(prefill, decode, model.prepare(params),
                                    batch, args.gen,
                                    temperature=args.temperature,
                                    seed=args.seed)
    print(f"prefill: {timings['prefill_s']*1e3:.1f} ms "
          f"for {args.batch}x{args.prompt_len}")
    print(f"decode:  {timings['decode_s']*1e3:.1f} ms for {args.gen-1} steps "
          f"({(args.gen-1)*args.batch/max(timings['decode_s'],1e-9):.1f} "
          f"tok/s)")
    print("generated token ids:\n", gen)


def run_continuous(model, params, args, mesh=None, print=print) -> None:
    """Slot-pool engine with FCFS admission (on ``mesh``'s model group,
    this rank's shard).

    With ``--fault-seed`` the run goes through the supervisor under a
    seeded ``FaultPlan`` (chaos mode): faults are injected at their
    scheduled counters, the recovery counters are printed, and the
    fired-event log is written to ``--fault-log``.
    """
    serve = ServeConfig(max_slots=args.slots,
                        max_seq=args.prompt_len + args.gen,
                        max_new_tokens=args.gen,
                        temperature=args.temperature, seed=args.seed,
                        kv_fmt=args.kv_fmt, deadline_s=args.deadline,
                        max_queue=args.max_queue)
    faults = None
    if args.fault_seed is not None:
        faults = FaultPlan.generate(
            args.fault_seed,
            kinds=("prefill_fail", "decode_fail", "slot_corrupt",
                   "clock_freeze"),
            horizon=max(2, args.gen), n_slots=args.slots)
    engine = ContinuousEngine(model, params, serve, device=model.device,
                              faults=faults, mesh=mesh)
    if faults is not None:
        ServeSupervisor(engine, faults=faults)
    rng = np.random.RandomState(args.seed)
    for _ in range(args.requests or args.slots):
        engine.submit(_random_prompt(rng, args.prompt_len,
                                     model.config.vocab_size),
                      max_new_tokens=args.gen)
    results = run_supervised(engine) if faults is not None else engine.run()
    summary = engine.metrics.summary()
    print(f"served {summary['n_requests']} requests / "
          f"{summary['total_new_tokens']} new tokens in "
          f"{summary['run_wall_s']*1e3:.1f} ms "
          f"({summary['tokens_per_sec']:.1f} tok/s, "
          f"{summary['decode_ticks']} decode ticks) on {model.device}")
    print(f"latency p50/p99: {summary['latency_p50_s']*1e3:.1f}/"
          f"{summary['latency_p99_s']*1e3:.1f} ms; "
          f"ttft p50: {summary['ttft_p50_s']*1e3:.1f} ms")
    if faults is not None or summary["shed"] or summary["deadline_missed"]:
        print(f"recovery: {summary['faults_injected']} faults injected, "
              f"{summary['retried']} retries, {summary['recovered']} "
              f"recovered, {summary['shed']} shed, "
              f"{summary['deadline_missed']} deadline-missed, "
              f"{summary['degraded_events']} degraded events")
    if faults is not None and args.fault_log:
        with open(args.fault_log, "w") as f:
            f.write(faults.log_json(extra={"summary": summary}))
        print(f"fault log written to {args.fault_log}")
    for rid in sorted(results):
        r = results[rid]
        tag = "" if r.status == "ok" else f" [{r.status}]"
        print(f"request {rid}{tag}: {r.tokens.tolist()}")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--engine", default="continuous",
                    choices=["continuous", "oneshot"])
    ap.add_argument("--batch", type=int, default=4,
                    help="oneshot: fixed batch size")
    ap.add_argument("--slots", type=int, default=4,
                    help="continuous: slot-pool size (decode batch width)")
    ap.add_argument("--requests", type=int, default=0,
                    help="continuous: number of requests (0 = --slots)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--quant-fmt", default="none",
                    help="logits-head quantization format (none | luq_fp4 | "
                         "int4 | fp8_e4m3 | fp8_e5m2 | bf16)")
    ap.add_argument("--backend", default="cuda", choices=["ref", "cuda"],
                    help="quantizer backend (REPRO_QUANT_BACKEND overrides)")
    ap.add_argument("--kv-fmt", default="none",
                    choices=["none", "int8", "luq_fp4"],
                    help="KV-cache storage format")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--deadline", type=float, default=None,
                    help="continuous: per-request deadline in seconds from "
                         "arrival (expired requests retire with partial "
                         "results, status timed_out)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="continuous: bound on waiting requests; overflow "
                         "is shed at submit (0 = unbounded)")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="continuous: run under a seeded FaultPlan through "
                         "the supervisor (chaos mode)")
    ap.add_argument("--fault-log", default=None,
                    help="chaos mode: write the fired-fault JSON log here")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks of the model axis, under "
                         "torch.distributed.run (tensor and expert "
                         "parallelism; the whole world: one model group)")
    return ap.parse_args(argv)


def build(args, **cut) -> tuple:
    """``(model, params)`` of the flags: the model on ``--device``, its
    config cut to the fields of ``cut`` if any (``n_layers=1``), its
    params from ``--seed``; raises SystemExit for a family without a
    decoder."""
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    if cut:
        cfg = dataclasses.replace(cfg, **cut)
    if not cfg.has_decoder:
        raise SystemExit(f"{args.arch} has no decoder; nothing to serve")
    quant = QuantConfig(fmt=args.quant_fmt, backend=args.backend)
    model = build_model(cfg, quant, device=args.device)
    return model, model.init(args.seed)


def main(argv=None):
    """Parse flags, build the model on its device, run the chosen engine
    (on a model group under ``torch.distributed.run``)."""
    args = parse_args(argv)
    mp = args.model_parallel
    if "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if world != mp:
            raise ValueError(f"--model-parallel {mp} must be the world of "
                             f"{world} ranks: serving runs one model group")
        args.device = str(init_distributed(args.device))
        mesh = make_host_mesh(mp)
    else:
        if mp != 1:
            raise ValueError("--model-parallel above 1 needs ranks: run "
                             "under python -m torch.distributed.run")
        mesh = None
    try:
        _serve(args, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _serve(args, mesh) -> None:
    out = print if mesh is None or mesh.rank == 0 else _quiet
    model, params = build(args)
    cfg = model.config
    engine = args.engine
    if engine == "continuous" and model.decode_slots is None:
        # only the dense transformer decodes per slot so far; the other
        # decoder families (Mamba-2, Griffin, the VLM, the encoder-decoder,
        # whose prompts need more than tokens, the MoE LMs) run through
        # the oneshot engine
        out(f"note: {cfg.family!r} has no continuous-batching support "
            "yet; falling back to --engine oneshot")
        engine = "oneshot"
    if engine == "oneshot":
        run_oneshot(model, params, args, mesh, out)
    else:
        run_continuous(model, params, args, mesh, out)


if __name__ == "__main__":
    main()
