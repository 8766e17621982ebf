#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one Hopper GPU and nvcc.
It imports the port (``src/repro_torch``) and nothing of JAX, and:

1. prints the card (``nvidia-smi`` name and power limit) and versions;
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. holds each kernel against its plain PyTorch version on the card at the
   yi-6b shapes of the serving path, and times kernel, plain version,
   the least time the card could take (``bound_ms``) and, where one
   PyTorch call computes the same function, that call (``library_ms``);
4. serves yi-6b at full width and depth (random weights from a seed)
   through ``ContinuousEngine`` with the workload of
   ``repro_torch/launch/workload.py``: 4 slots, 8 requests, prompts of
   64-512 tokens, 32 new tokens, greedy, luq_fp4 logits head, once with an
   int8 and once with a luq_fp4 KV cache, on the ``cuda`` backend; every
   request must finish with its 32 tokens and every kernel (both branches
   of the matmul) must have run;
5. checks the engine against the oneshot driver for one request.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, and the
script exits non-zero; without a GPU, or without the repository around
it, it exits non-zero before printing a result.

Tolerances: KV codes and scales bitwise; decode attention atol = rtol =
1e-5 (float32, summed in another order); the quantized matmul within
1e-5 of the sum of absolute products per output (the operands agree
bitwise, only the summation order differs).  TF32 is off for the plain
versions and the library calls.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path


ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): memory
# rate, and float32 outside the tensor cores (the kernels' arithmetic).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# float32 operations of one LUQ rounding (abs, two divisions, log2,
# floor, two exp2, clamps, compares, selects, sign, two products)
LUQ_OPS = 24

SEED = 0                  # of the kernel checks' inputs


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes / memory rate and
    operations / float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def check_kv_quant_rows(torch, ops, ref, fmt, shape, reps=50):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(shape, device="cuda", generator=gen) * 3
    x.reshape(-1, shape[-1])[0] = 0                       # an all-zero row
    codes, scales = ops.kv_quant_rows(x, fmt)
    rc, rs = ref.kv_quant_rows_ref(x, fmt)
    if not (torch.equal(codes, rc) and torch.equal(scales, rs)):
        raise AssertionError(f"kv_quant_rows[{fmt}] {shape}: codes or scales "
                             "differ from the plain version")
    rows, hd = x.numel() // shape[-1], shape[-1]
    nbytes = x.numel() * 4 + codes.numel() + rows * 2
    return {
        "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: ops.kv_quant_rows(x, fmt), reps),
        "plain_ms": time_ms(torch, lambda: ref.kv_quant_rows_ref(x, fmt), reps),
        **dict(zip(("bound_ms", "bound_by"), bound(nbytes, 8.0 * rows * hd))),
        "library_ms": None,
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
    live = sum(p + 1 for p in pos_list)
    nbytes = (q.numel() * 4 * 2 + B * 4
              + live * KV * (2 * kc.shape[-1] + 2 * 2))
    flops = live * KV * g * (4 * hd + 8)
    return {
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: ops.decode_attn_fused(*args, **kw), reps),
        "plain_ms": time_ms(torch, lambda: ref.decode_attn_ref(*args, **kw),
                            reps),
        **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))),
        "library_ms": time_ms(torch, lambda: sdpa(qd, kd, vd, attn_mask=mask,
                                                  scale=hd ** -0.5), reps),
    }


def check_luq_matmul(torch, ops, ref, per_row, rows, reps=10):
    """The logits head, (R, 4096) x (4096, 64000): at decode ``rows`` slot
    rows with one uniform draw and one scale each (``ub`` (R, K, N)); at
    prefill one row, a shared (K, N) draw and a scalar scale."""
    R, K, N = (rows if per_row else 1), 4096, 64000
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2 + per_row)
    a = torch.randn(R, K, device="cuda", generator=gen)
    b = torch.randn(K, N, device="cuda", generator=gen) / 64
    ua = torch.rand(R, K, device="cuda", generator=gen)
    ub = torch.rand(*((R,) if per_row else ()), K, N, device="cuda",
                    generator=gen)
    alpha_a = a.abs().amax(dim=1) if per_row else a.abs().amax()
    alpha_b = b.abs().amax()
    args = (a, b, ua, ub, alpha_a, alpha_b)
    out = ops.luq_matmul(*args)
    want = ref.luq_matmul_ref(*args)
    aq = ref.luq_fp4(a, ua, alpha_a.reshape(-1, 1))
    bq = torch.stack([ref.luq_fp4(b, ub[i] if per_row else ub, alpha_b)
                      for i in range(R)])
    err = (out - want).abs().max().item()
    for i in range(R):
        tol = 1e-5 * (aq[i].abs() @ bq[i].abs()) + 1e-6
        if not ((out[i] - want[i]).abs() <= tol).all():
            raise AssertionError(f"luq_matmul row {i} outside tolerance "
                                 f"(max abs err {err})")
    # the yardstick: one batched product of operands quantized beforehand
    aq3 = aq[:, None, :]
    nbytes = 4 * (2 * R * K + K * N + ub.numel() + alpha_a.numel() + 1
                  + R * N)
    flops = 2 * R * K * N + LUQ_OPS * (ub.numel() + R * K)
    result = {
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: ops.luq_matmul(*args), reps),
        "plain_ms": time_ms(torch, lambda: ref.luq_matmul_ref(*args), 3),
        **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))),
        "library_ms": time_ms(torch, lambda: torch.bmm(aq3, bq), reps),
    }
    del bq, ub
    return result


def serve_yi6b(torch, kv_fmt, model, params, ops, wl):
    """Serve the workload's requests through the engine; returns its
    summary and the launch counts of the run, the matmul's also by
    branch."""
    from repro_torch.config import ServeConfig
    from repro_torch.quant import backend as qbackend
    from repro_torch.serve import ContinuousEngine

    for get, fmt in ((qbackend.get_matmul, "luq_fp4"),
                     (qbackend.get_kv_quant, kv_fmt),
                     (qbackend.get_decode_attn, kv_fmt)):
        _, actual = get(fmt, "cuda")
        if actual != "cuda":
            raise AssertionError(f"{get.__name__}({fmt!r}) runs on {actual}")
    serve = ServeConfig(max_slots=wl.SLOTS, max_seq=wl.MAX_SEQ,
                        max_new_tokens=wl.NEW_TOKENS, kv_fmt=kv_fmt)
    engine = ContinuousEngine(model, params, serve)
    prompts = wl.prompts(model.config.vocab_size)
    engine.submit(prompts[0][:wl.PROMPT_MIN], max_new_tokens=2)   # warm-up
    engine.run()
    engine.reset()
    for p in prompts:
        engine.submit(p, max_new_tokens=wl.NEW_TOKENS)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    results = engine.run()
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    launches["luq_matmul[decode]"] = ops.LUQ_MATMUL_LAUNCHES["per_row"]
    launches["luq_matmul[prefill]"] = ops.LUQ_MATMUL_LAUNCHES["shared"]
    if sorted(results) != list(range(wl.REQUESTS)):
        raise AssertionError(f"served {sorted(results)}")
    for rid, r in results.items():
        if r.status != "ok" or r.tokens.size != wl.NEW_TOKENS:
            raise AssertionError(f"request {rid}: {r.status}, "
                                 f"{r.tokens.size} tokens")
        if not ((r.tokens >= 0) & (r.tokens < model.config.padded_vocab)).all():
            raise AssertionError(f"request {rid}: token ids out of range")
    zero = [k for k, n in launches.items() if n == 0]
    if zero:
        raise AssertionError(f"kernels not launched on the main path: {zero}")
    summary = engine.metrics.summary()
    summary["prompt_lengths"] = [p.size for p in prompts]
    return summary, launches


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

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

    # 3. each kernel against its plain version at the path's shapes
    checks = {}
    for fmt in ("int8", "luq_fp4"):
        decode = check_kv_quant_rows(torch, ops, ref, fmt, (wl.SLOTS, 4, 128))
        prefill = check_kv_quant_rows(torch, ops, ref, fmt, (32, 1, 4, 512, 128))
        print(f"kv_quant_rows[{fmt}] decode {decode}")
        print(f"kv_quant_rows[{fmt}] prefill (32x1x4x512 rows) {prefill}")
        checks[f"kv_quant_rows[{fmt}]"] = decode
        attn = check_decode_attn(torch, ops, ref, kvc, fmt, wl.SLOTS,
                                 wl.MAX_SEQ)
        print(f"decode_attn_fused[{fmt}] {attn}")
        checks[f"decode_attn_fused[{fmt}]"] = attn
    for branch, per_row in (("decode", True), ("prefill", False)):
        name = f"luq_matmul[{branch}]"
        checks[name] = check_luq_matmul(torch, ops, ref, per_row, wl.SLOTS)
        print(f"{name} {checks[name]}")
    torch.cuda.empty_cache()

    # 4. serve yi-6b at full width and depth
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
    launches = {}
    for kv_fmt in ("int8", "luq_fp4"):
        summary, counts = serve_yi6b(torch, kv_fmt, model, params, ops, wl)
        print(f"serve yi-6b kv={kv_fmt}: {summary['n_requests']} requests, "
              f"{summary['total_new_tokens']} tokens, "
              f"{summary['tokens_per_sec']} tok/s, "
              f"{summary['decode_ticks']} ticks, "
              f"ttft p50 {summary['ttft_p50_s'] * 1e3} ms, "
              f"latency p50 {summary['latency_p50_s'] * 1e3} ms, "
              f"prompts {summary['prompt_lengths']}, launches {counts}")
        launches[kv_fmt] = counts
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30} GiB")

    # 5. engine vs oneshot, one request, same shapes on both sides
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

    sources = {
        "kv_quant_rows": ("src/repro_torch/kernels/csrc/kv_quant.cu",
                          "src/repro/kernels/decode_attn.py:52"),
        "decode_attn_fused": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                              "src/repro/kernels/decode_attn.py:114"),
        "luq_matmul": ("src/repro_torch/kernels/csrc/luq_matmul.cu",
                       "src/repro/kernels/quant_matmul.py:62"),
    }
    kernels = []
    for name, numbers in checks.items():
        base, _, tag = name.rstrip("]").partition("[")
        n = (launches[tag][base] if tag in launches      # that KV format's run
             else sum(c[name] for c in launches.values()))     # both runs
        src, replaces = sources[base]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": n, **numbers})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
