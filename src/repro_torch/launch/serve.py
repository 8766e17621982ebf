"""Serving CLI: continuous-batching engine or the oneshot reference driver.

    # continuous batching on the GPU, quantized logits head and KV cache
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --quant-fmt luq_fp4 --kv-fmt int8 --slots 4 --requests 8

    # at smoke size on the CPU (the kernels' plain versions)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \
        --device cpu --quant-fmt luq_fp4 --kv-fmt luq_fp4

The flags are those of ``repro.launch.serve`` without the fault-injection
and admission-control ones (the port's runtime layer is not ported yet),
plus ``--device`` (default ``cuda``; without a GPU the run raises unless
``--device cpu`` is given) and ``--backend ref|cuda`` (default ``cuda``,
the hand-written kernels; ``REPRO_QUANT_BACKEND`` overrides it).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.config import QuantConfig, ServeConfig
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.models.registry import build_model
from repro_torch.serve import (ContinuousEngine, build_oneshot_fns,
                               oneshot_generate)


def _random_prompt(rng: np.random.RandomState, length: int,
                   vocab: int) -> np.ndarray:
    return rng.randint(0, vocab, size=(length,)).astype(np.int32)


def run_oneshot(model, params, args) -> None:
    """One fixed batch, prefill, lockstep decode."""
    prefill, decode = build_oneshot_fns(model, args.prompt_len + args.gen,
                                        kv_fmt=args.kv_fmt)
    rng = np.random.RandomState(args.seed)
    tokens = np.stack([_random_prompt(rng, args.prompt_len,
                                      model.config.vocab_size)
                       for _ in range(args.batch)])
    batch = {"tokens": torch.from_numpy(tokens).to(model.device)}
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


def run_continuous(model, params, args) -> None:
    """Slot-pool engine with FCFS admission."""
    serve = ServeConfig(max_slots=args.slots,
                        max_seq=args.prompt_len + args.gen,
                        max_new_tokens=args.gen,
                        temperature=args.temperature, seed=args.seed,
                        kv_fmt=args.kv_fmt)
    engine = ContinuousEngine(model, params, serve, device=model.device)
    rng = np.random.RandomState(args.seed)
    for _ in range(args.requests or args.slots):
        engine.submit(_random_prompt(rng, args.prompt_len,
                                     model.config.vocab_size),
                      max_new_tokens=args.gen)
    results = engine.run()
    summary = engine.metrics.summary()
    print(f"served {summary['n_requests']} requests / "
          f"{summary['total_new_tokens']} new tokens in "
          f"{summary['run_wall_s']*1e3:.1f} ms "
          f"({summary['tokens_per_sec']:.1f} tok/s, "
          f"{summary['decode_ticks']} decode ticks) on {model.device}")
    print(f"latency p50/p99: {summary['latency_p50_s']*1e3:.1f}/"
          f"{summary['latency_p99_s']*1e3:.1f} ms; "
          f"ttft p50: {summary['ttft_p50_s']*1e3:.1f} ms")
    for rid in sorted(results):
        r = results[rid]
        tag = "" if r.status == "ok" else f" [{r.status}]"
        print(f"request {rid}{tag}: {r.tokens.tolist()}")


def main(argv=None):
    """Parse flags, build the model on its device, run the chosen engine."""
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
    args = ap.parse_args(argv)

    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    quant = QuantConfig(fmt=args.quant_fmt, backend=args.backend)
    model = build_model(cfg, quant, device=args.device)
    params = model.init(args.seed)
    if args.engine == "oneshot":
        run_oneshot(model, params, args)
    else:
        run_continuous(model, params, args)


if __name__ == "__main__":
    main()
