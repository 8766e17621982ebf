#!/usr/bin/env python3
"""Drive the PyTorch port's training and serving paths on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one Hopper GPU and nvcc.
It imports the port (``src/repro_torch``) and nothing of JAX, and:

1. prints the card (``nvidia-smi`` name and power limit) and versions;
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes of its path (ResNet-18 training: ``luq_quant`` and
   ``per_sample_clip``; stablelm-3b ghost training: ``ghost_norm_sq``;
   yi-6b serving: the other three), and times kernel, plain version, the
   least time the card could take (``bound_ms``) and, where PyTorch
   computes the same function, that yardstick (``library_ms``; for the
   LUQ matmul and the ghost norm, ``torch.bmm`` of the bf16 LUQ codes
   with float32 output, the float32 values' time beside it as
   ``library_f32_ms``); for the two wrappers that launch two kernels
   each (decode attention's split and merge, the clip's two passes),
   also each kernel's own device time from a ``torch.profiler`` trace
   (``device_us``);
4. trains ResNet-18 at full width (random init from a seed, synthetic
   data) with DP-SGD under the DPQuant scheduler through
   ``repro_torch.train_loop.Trainer``, with the options of
   ``repro_torch.launch.train --arch resnet18 --mode dpquant --fmt
   luq_fp4 --backend cuda --clip-backend fused``: 2 epochs x 3 steps of
   256 images in microbatches of 64, analysis in epoch 0 (10 probe runs x
   2 reps at a probe batch of 64); every loss finite, k = 8 quantized
   layers each epoch, epsilon > 0, 44 clip launches, and quantizer
   launches that match the policies the scheduler chose;
5. trains stablelm-3b at full size (32 layers, random init from a seed,
   synthetic tokens) with ghost-mode DP-SGD under the DPQuant scheduler,
   with the options of ``repro_torch.launch.train --arch stablelm-3b
   --mode dpquant --fmt luq_fp4 --backend cuda --grad-mode ghost
   --clip-backend ref --ghost-microbatch 4 --batch 8 --seq-len 256``: 2
   epochs x 2 steps, analysis in epoch 0 (33 probe runs x 2 reps at a
   probe batch of 8); every loss finite, k = 29 each epoch, epsilon > 0,
   ``ghost_norm_sq`` launches that match the policies the scheduler
   chose, and no clip launch (ghost mode forms no (B, D) matrix);
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
   int8 and once with a luq_fp4 KV cache, on the ``cuda`` backend; every
   request must finish with its 32 tokens and every kernel (both branches
   of the matmul) must have run;
8. checks the engine against the oneshot driver for one request.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, and the
script exits non-zero; without a GPU, or without the repository around
it, it exits non-zero before printing a result.

Tolerances: KV codes and scales bitwise; LUQ codes bitwise; decode
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

import json
import math
import subprocess
import sys
import time
from pathlib import Path


ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit):
# memory rate, float32 outside the tensor cores (most kernels'
# arithmetic), and bf16 on the tensor cores (products of values that bf16
# holds exactly, summed in float32).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12
# float32 operations of one LUQ rounding (abs, two divisions, log2,
# floor, two exp2, clamps, compares, selects, sign, two products)
LUQ_OPS = 24
# 32-bit integer operations of one Philox4x32-10 call, at the least: 10
# rounds of two 32 x 32 -> 64 multiplies (one IMAD.WIDE.U32 each gives
# both words) and two three-input XORs (one LOP3 each), and one shift a
# word for the uniforms: 10 * 4 + 4 = 44.  The key bumps are the same for
# every call of a key and the float conversions are not int32 work; not
# counted.  They run on the SMs' int32 lanes, 64 an SM a clock on Hopper:
# 132 SMs x 64 x the SM clock (the card's maximum, from nvidia-smi) is
# the int32 rate.
PHILOX_INT_OPS = 44
INT32_LANES = 132 * 64
SEED = 0                  # of the kernel checks' inputs


def bound(nbytes: float, flops: float, tc_flops: float = 0.0,
          int_ops: float = 0.0, sm_clock_mhz: float = 0.0):
    """(bound_ms, bound_by): the larger of bytes / memory rate and the
    operations' time: ``flops`` at the float32 rate, ``tc_flops`` (work
    the bf16 tensor cores could do exactly) at theirs, ``int_ops`` at the
    int32 rate of ``sm_clock_mhz``, whichever is longest."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_int = (int_ops / (INT32_LANES * sm_clock_mhz * 1e6)
             if int_ops else 0.0)
    t_ops = max(flops / F32_FLOPS_PER_S, tc_flops / BF16_TC_FLOPS_PER_S,
                t_int) * 1e3
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
        "device_us": device_us(
            torch, lambda: ops.decode_attn_fused(*args, **kw),
            ("decode_attn_split_kernel", "decode_attn_merge_kernel"), reps),
    }


def check_luq_matmul(torch, ops, ref, per_row, rows, sm_clock_mhz, reps=10):
    """The logits head, (R, 4096) x (4096, 64000), drawing its uniforms
    with Philox from the logits head's keys: at decode ``rows`` slot rows
    with one key and one scale each, at prefill one row, one key and a
    scalar scale.  The plain version draws the same stream in PyTorch, b
    in column chunks; the kernel must agree within the tolerance and give
    the same bits twice."""
    from repro_torch.models.common import logits_key
    from repro_torch.quant import philox
    from repro_torch.quant.formats import luq_fp4, luq_fp4_codes

    R, K, N = (rows if per_row else 1), 4096, 64000
    keys = ([logits_key(2 * p + 1) for p in (100, 300, 700, 1023)][:R]
            if per_row else logits_key(2 * 512))
    key_list = keys if per_row else [keys]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2 + per_row)
    a = torch.randn(R, K, device="cuda", generator=gen)
    b = torch.randn(K, N, device="cuda", generator=gen) / 64
    alpha_a = a.abs().amax(dim=1) if per_row else a.abs().amax()
    alpha_b = b.abs().amax()
    args = (a, b, keys, alpha_a, alpha_b)
    out = ops.luq_matmul(*args)
    if not torch.equal(out, ops.luq_matmul(*args)):
        raise AssertionError(f"luq_matmul (R = {R}): two runs differ")
    want = ref.luq_matmul_keys_ref(*args)
    if per_row:
        ua = torch.stack([philox.uniforms(k, 0, K, "cuda") for k in key_list])
    else:
        ua = philox.uniforms(keys, 0, R * K, "cuda").reshape(R, K)
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
    # the end (products of codes are exact), and the float32 values
    aq3, ca3 = aq[:, None, :], ca[:, None, :]
    bq3 = bq if per_row else bq.expand(R, K, N)
    cb3 = cb if per_row else cb.expand(R, K, N)
    scale = (alpha_a.reshape(-1).expand(R) * alpha_b)[:, None, None]

    def codes_bmm():
        return scale * torch.bmm(ca3, cb3, out_dtype=torch.float32)

    err = (out - want).abs().max().item()
    lib, lib32 = codes_bmm()[:, 0], torch.bmm(aq3, bq3)[:, 0]
    for i in range(R):
        tol = 1e-5 * (aq[i].abs() @ bq[i if per_row else 0].abs()) + 1e-6
        for what, got in (("luq_matmul", out), ("the bf16 codes' bmm", lib),
                          ("the float32 bmm", lib32)):
            if not ((got[i] - want[i]).abs() <= tol).all():
                raise AssertionError(
                    f"{what} row {i} outside tolerance (max abs err "
                    f"{(got[i] - want[i]).abs().max().item()})")
    del lib, lib32
    nbytes = 4 * (2 * R * K + K * N + alpha_a.numel() + 1 + R * N)
    # Philox calls: a's elements one a call; b's 4 a call, for each key
    calls = R * K + len(key_list) * K * N // 4
    flops = 2 * R * K * N + LUQ_OPS * (K * N + R * K)
    result = {
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: ops.luq_matmul(*args), reps),
        "plain_ms": time_ms(torch, lambda: ref.luq_matmul_keys_ref(*args), 3),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(nbytes, flops, int_ops=PHILOX_INT_OPS * calls,
                         sm_clock_mhz=sm_clock_mhz))),
        # the previous design's convention: its uniforms read from memory
        "bound_uniforms_from_memory_ms": bound(
            nbytes + 4 * (R * K + len(key_list) * K * N), flops)[0],
        "library_ms": time_ms(torch, codes_bmm, reps),
        "library_f32_ms": time_ms(torch, lambda: torch.bmm(aq3, bq3), reps),
    }
    del bq, bq3, cb, cb3
    return result


def check_luq_quant(torch, ops, ref, rows, n, reps=50):
    """LUQ-FP4 of (rows, n) against one shared (n,) draw and per-row
    scales, with the rounding's edge values mixed in: exact powers of two
    times alpha, one ulp below them, zeros, and (with several rows) a row
    that is all zero (alpha = 0)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = torch.randn(rows, n, device="cuda", generator=gen).clamp(-3.5, 3.5)
    u = torch.rand(n, device="cuda", generator=gen)
    alpha0 = 4.0
    x[:, 0] = alpha0
    levels = alpha0 * 2.0 ** -torch.arange(0, 9, device="cuda")
    below = torch.nextafter(levels, torch.zeros_like(levels))
    edges = torch.cat([levels, -levels, below, -below,
                       torch.zeros(4, device="cuda")])
    x[:, 1:1 + edges.numel()] = edges
    if rows > 1:
        x[1] = 0.0
    alpha = x.abs().amax(dim=1)
    out = ops.luq_quant(x, u, alpha)
    want = ref.luq_quant_ref(x, u, alpha)
    if not torch.equal(out, want):
        bad = (out != want).sum().item()
        raise AssertionError(f"luq_quant ({rows} x {n}): {bad} codes differ "
                             "from the plain version")
    nbytes = 4 * (2 * x.numel() + u.numel() + rows)
    return {
        "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: ops.luq_quant(x, u, alpha), reps),
        "plain_ms": time_ms(torch, lambda: ref.luq_quant_ref(x, u, alpha), reps),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(nbytes, LUQ_OPS * x.numel()))),
        "library_ms": None,
    }


def check_per_sample_clip(torch, ops, ref, B, D, reps=10):
    """Per-example clip and sum of (B, D) rows, with a zero row and a row
    whose norm is below C; the yardstick is two PyTorch calls:
    ``torch.linalg.vector_norm(g, dim=1)``, then ``scale @ g``."""
    C = 1.0
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    g = torch.randn(B, D, device="cuda", generator=gen) * 1e-3
    g[0] = 0.0
    g[1] *= 0.1 / g[1].norm()
    out, norms = ops.clip_and_sum(g, C)
    want, want_norms = ref.per_sample_clip_ref(g, C)
    torch.testing.assert_close(norms, want_norms, rtol=1e-5, atol=0.0)
    scale = torch.clamp(C / torch.clamp(want_norms, min=1e-12), max=1.0)
    err = (out - want).abs()
    tol = 1e-5 * (scale @ g.abs()) + 1e-12
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
        return torch.clamp(C / torch.clamp(n, min=1e-12), max=1.0) @ g

    lib = two_calls()
    torch.testing.assert_close(lib, want, rtol=1e-4, atol=1e-6)
    nbytes = 4 * (B * D + D + B)
    return {
        "max_abs_err": max_err,
        "ms": time_ms(torch, lambda: ops.clip_and_sum(g, C), reps),
        "plain_ms": time_ms(torch, lambda: ref.per_sample_clip_ref(g, C), reps),
        **dict(zip(("bound_ms", "bound_by"), bound(nbytes, 4.0 * B * D))),
        # the floor of any kernel taking a (B, D) matrix from device
        # memory: each clip factor needs its whole row's norm before a
        # column can be summed, and the matrix is far beyond the L2, so it
        # is read twice
        "bound_two_reads_ms": bound(nbytes + 4 * B * D, 4.0 * B * D)[0],
        "library_ms": time_ms(torch, two_calls, reps),
        "device_us": device_us(torch, lambda: ops.clip_and_sum(g, C),
                               ("row_sumsq_kernel", "column_sum_kernel"),
                               reps),
    }


def check_ghost_norm(torch, ops, ref, B, T, Dx, Dg, reps=20):
    """The ghost norm of B examples' (T, Dx) / (T, Dg) operands, with the
    rounding's edge values mixed in and an all-zero example (alpha = 0);
    the yardstick is two ``torch.bmm`` Grams of the bf16 LUQ codes
    computed beforehand, with float32 sums and output (the kernel's
    arithmetic), then ``(alpha_x alpha_g)^2 (XX * GG).sum((1, 2))``; the
    same two Grams over float32 codes are timed beside it."""
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
    ux = torch.rand(T * Dx, device="cuda", generator=gen)
    ug = torch.rand(T * Dg, device="cuda", generator=gen)
    ax = x.abs().amax(dim=(1, 2))
    ag = g.abs().amax(dim=(1, 2))
    args = (x, g, ux, ug, ax, ag)
    out = ops.ghost_norm_sq(*args)
    again = ops.ghost_norm_sq(*args)
    if not torch.equal(out, again):
        raise AssertionError(f"ghost_norm_sq ({B}, {T}, {Dx}, {Dg}): two runs "
                             "differ")
    want = ref.ghost_norm_ref(*args)
    xq = ref.luq_fp4(x.reshape(B, -1), ux, ax[:, None]).reshape(x.shape)
    gq = ref.luq_fp4(g.reshape(B, -1), ug, ag[:, None]).reshape(g.shape)
    # the yardsticks' operands: the codes Q(v) / alpha, exact in bf16,
    # whose Grams cuBLAS sums exactly; the scales come in at the end
    cx = ref.luq_quant_ref(x.reshape(B, -1), ux, ax,
                           codes=True).reshape(x.shape)
    cg = ref.luq_quant_ref(g.reshape(B, -1), ug, ag,
                           codes=True).reshape(g.shape)
    cx32, cg32 = cx.float(), cg.float()
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
    nbytes = 4 * (x.numel() + g.numel() + ux.numel() + ug.numel() + 3 * B)
    # the least work: the LUQ rounding in float32, and each symmetric Gram's
    # upper triangle with its diagonal, T (T + 1) / 2 dot products of D,
    # on the bf16 tensor cores (Q(v) / alpha = +-2^-k is exact in bf16),
    # then the T (T + 1) / 2 products XX o GG and their sum in float32
    luq = LUQ_OPS * B * T * (Dx + Dg)
    grams = B * T * (T + 1) * (Dx + Dg)
    # the convention of the other rows: both whole Grams in float32
    full_f32 = 2 * B * T * T * (Dx + Dg) + 2 * B * T * T + luq
    return {
        "max_abs_err": err.max().item(),
        "f32_values_err": f32_err,
        "ms": time_ms(torch, lambda: ops.ghost_norm_sq(*args), reps),
        "plain_ms": time_ms(torch, lambda: ref.ghost_norm_ref(*args), reps),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(nbytes, luq + B * T * (T + 1), grams))),
        "bound_f32_full_grams_ms": bound(nbytes, full_f32)[0],
        "library_ms": time_ms(torch, grams_bmm, reps),
        "library_f32_ms": time_ms(torch, grams_bmm_f32, reps),
    }


def train_resnet18(torch, ops, wl):
    """DP-SGD on ResNet-18 under the DPQuant scheduler, the training
    workload of ``repro_torch/launch/workload.py`` (section 4 of the
    module docstring); returns the launch counts of the run."""
    from repro_torch.models.resnet import conv_layers
    from repro_torch.quant import backend as qbackend
    from repro_torch.train_loop import Trainer

    if (qbackend.get_quantizer("luq_fp4", "cuda")[1] != "cuda"
            or qbackend.get_clip_sum("fused")[1] != "cuda"):
        raise AssertionError("the quantizer or the fused clip does not run "
                             "on the cuda backend")
    run, ds, ev = wl.train_setup()
    cfg = run.model
    batch, micro = run.global_batch, run.dp.microbatch_size
    steps, epochs = run.steps_per_epoch, wl.TRAIN_EPOCHS
    tr = Trainer(run, ds, eval_dataset=ev, mode="dpquant", device="cuda")
    print(f"resnet18: {sum(t.numel() for t in tr.params.values())} params; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    policies, analysis_s = [], []
    t0 = time.perf_counter()
    for _ in range(epochs):
        (stats,) = tr.train(1)[-1:]
        policies.append(tr.scheduler.current.layers)
        analysis_s.append(tr.last_analysis_s)
        print(f"epoch {stats.epoch}: loss={stats.loss:.4f} "
              f"eps={stats.eps:.3f} k={stats.quantized_layers} "
              f"acc={stats.accuracy} (loss {stats.loss!r}, eps "
              f"{stats.eps!r}, wall {stats.wall_s!r} s, analysis "
              f"{tr.last_analysis_s!r} s, layers {list(policies[-1])})")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    launches.update({f"luq_quant[{k}]": v
                     for k, v in ops.LUQ_QUANT_LAUNCHES.items()})
    steps_ms = sorted(t * 1e3 for t in tr.step_wall_s[1:])
    med = steps_ms[len(steps_ms) // 2]
    print(f"train resnet18: {epochs} epochs x {steps} steps of {batch} "
          f"images: median step {med!r} ms (steps after the first: "
          f"{steps_ms}), {batch / med * 1e3!r} images/s, analysis by "
          f"epoch {analysis_s!r} s, wall {wall!r} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30!r} GiB, launches "
          f"{launches}")

    for s in tr.history:
        if not math.isfinite(s.loss):
            raise AssertionError(f"epoch {s.epoch}: loss {s.loss}")
        if s.quantized_layers != 8:
            raise AssertionError(f"epoch {s.epoch}: k = {s.quantized_layers}")
        if not s.eps > 0:
            raise AssertionError(f"epoch {s.epoch}: eps = {s.eps}")
    n_micro = batch // micro
    # a probe step runs one probe batch of max(micro, min(32, batch))
    # examples: here one microbatch; 10 probe runs (the baseline and one
    # per layer) x reps
    probe_micro = max(micro, min(run.dp.analysis_batch_size, batch)) // micro
    reps = run.dp.analysis_reps
    probe_runs = len(tr.scheduler.policies) + 1
    want_clip = (epochs * steps * n_micro + probe_runs * reps * probe_micro)
    if launches["clip_and_sum"] != want_clip:
        raise AssertionError(f"clip_and_sum launched "
                             f"{launches['clip_and_sum']} times, want "
                             f"{want_clip}")
    convs = conv_layers(cfg)
    # quantized convs summed over every microbatch: the probes (each
    # singleton policy x reps; the baseline probe and evaluate quantize
    # nothing) and the train steps
    q_convs = reps * probe_micro * sum(convs)
    q_convs += sum(steps * n_micro * sum(convs[i] for i in layers)
                   for layers in policies)
    want_q = {"luq_quant": 6 * q_convs, "luq_quant[one_row]": 2 * q_convs,
              "luq_quant[rows]": 4 * q_convs}
    for name, n in want_q.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"want {n} (policies {policies})")
    del tr
    torch.cuda.empty_cache()
    return launches


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
    identity = {("quantize", "identity", "ref"): lambda rows, u: rows.clone(),
                ("ghost_norm", "identity", "ref"):
                    lambda x, g, ux, ug: ghost._matpair_sq_norm(x, g)}
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
        cfg = dataclasses.replace(get_config(wl.TRAIN_LM_ARCH), n_layers=2,
                                  compute_dtype=dtype)
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


def train_stablelm(torch, ops, wl):
    """Ghost-mode DP-SGD on stablelm-3b under the DPQuant scheduler, the
    LM workload of ``repro_torch/launch/workload.py``; returns the launch
    counts of the run."""
    from repro_torch.dp.ghost import per_example_state_bytes
    from repro_torch.quant import backend as qbackend
    from repro_torch.train_loop import Trainer

    if (qbackend.get_quantizer("luq_fp4", "cuda")[1] != "cuda"
            or qbackend.get_ghost_norm("luq_fp4", "cuda")[1] != "cuda"):
        raise AssertionError("the quantizer or the ghost norm does not run "
                             "on the cuda backend")
    run, ds, ev = wl.train_lm_setup()
    cfg = run.model
    batch, chunk, seq = run.global_batch, run.dp.ghost_microbatch, run.seq_len
    steps, epochs = run.steps_per_epoch, wl.TRAIN_LM_EPOCHS
    t0 = time.perf_counter()
    tr = Trainer(run, ds, eval_dataset=ev, mode="dpquant", device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tr.params.values())
    state = per_example_state_bytes(
        tr.params, tr.model.ghost_mask(tr.params), batch,
        aux=tr.model.ghost_aux((True,) * cfg.n_layers))
    print(f"stablelm-3b: {n_params} params, init {time.perf_counter() - t0} "
          f"s; per_example_state_bytes at batch {batch}: {state}")
    if state["ghost_bytes"] != 0:
        raise AssertionError(f"ghost mode keeps per-example state: {state}")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    policies, analysis_s = [], []
    t0 = time.perf_counter()
    for _ in range(epochs):
        (stats,) = tr.train(1)[-1:]
        policies.append(tr.scheduler.current.layers)
        analysis_s.append(tr.last_analysis_s)
        print(f"epoch {stats.epoch}: loss={stats.loss:.4f} "
              f"eps={stats.eps:.3f} k={stats.quantized_layers} "
              f"acc={stats.accuracy} (loss {stats.loss!r}, eps "
              f"{stats.eps!r}, wall {stats.wall_s!r} s, analysis "
              f"{tr.last_analysis_s!r} s, layers {list(policies[-1])})")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    launches.update({f"ghost_norm_sq[{k}]": v
                     for k, v in ops.GHOST_NORM_LAUNCHES.items()})
    steps_ms = sorted(t * 1e3 for t in tr.step_wall_s[1:])
    med = steps_ms[len(steps_ms) // 2]
    print(f"train stablelm-3b (ghost): {epochs} epochs x {steps} steps of "
          f"{batch} x {seq} tokens: median step {med!r} ms (steps after the "
          f"first: {steps_ms}), {batch * seq / med * 1e3!r} tokens/s, "
          f"analysis by epoch {analysis_s!r} s, wall {wall!r} s, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30!r} GiB, "
          f"launches {launches}")

    for s in tr.history:
        if not math.isfinite(s.loss):
            raise AssertionError(f"epoch {s.epoch}: loss {s.loss}")
        if s.quantized_layers != 29:
            raise AssertionError(f"epoch {s.epoch}: k = {s.quantized_layers}")
        if not s.eps > 0:
            raise AssertionError(f"epoch {s.epoch}: eps = {s.eps}")
    # a step launches the kernel once per pass-1 chunk and hooked
    # projection (7 a layer) of every quantized layer: the probes (each
    # singleton policy x reps; the baseline probe quantizes nothing) and
    # the train steps
    n_chunks = batch // chunk
    probe_chunks = max(run.dp.microbatch_size,
                       min(run.dp.analysis_batch_size, batch)) // chunk
    reps = run.dp.analysis_reps
    want = 7 * reps * probe_chunks * len(tr.scheduler.policies)
    want += sum(7 * steps * n_chunks * len(layers) for layers in policies)
    if launches["ghost_norm_sq"] != want:
        raise AssertionError(f"ghost_norm_sq launched "
                             f"{launches['ghost_norm_sq']} times, want {want} "
                             f"(policies {policies})")
    if launches["clip_and_sum"] != 0:
        raise AssertionError(f"ghost training launched clip_and_sum "
                             f"{launches['clip_and_sum']} times")
    del tr
    _free(torch)
    return launches


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
    zero = [k for k, n in launches.items()
            if n == 0 and k not in ("luq_quant", "clip_and_sum",
                                    "ghost_norm_sq")]
    if zero:
        raise AssertionError(f"kernels not launched on the serving path: "
                             f"{zero}")
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
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60,
                           check=True)
    sm_clock_mhz = float(clock.stdout.strip().splitlines()[0])
    print(f"max SM clock {sm_clock_mhz} MHz")
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
        checks[name] = check_luq_matmul(torch, ops, ref, per_row, wl.SLOTS,
                                        sm_clock_mhz)
        print(f"{name} {checks[name]}")
    # ResNet-18 training shapes: the largest weight (3x3x512x512) whole,
    # and the largest activation under vmap (64 examples x 32x32x64)
    for name, rows, n in (("luq_quant[weight]", 1, 3 * 3 * 512 * 512),
                          ("luq_quant[activation]", 64, 32 * 32 * 64)):
        checks[name] = check_luq_quant(torch, ops, ref, rows, n)
        print(f"{name} ({rows} x {n}) {checks[name]}")
    checks["per_sample_clip"] = check_per_sample_clip(torch, ops, ref, 64,
                                                      11_190_891)
    print(f"per_sample_clip (64 x 11190891) {checks['per_sample_clip']}")
    # stablelm-3b ghost pass 1: chunks of 4 sequences of 256 tokens; q/k/v/o
    # are 2560 wide on both sides, gate/up/down 2560 and 6912
    for dg in (2560, 6912):
        name = f"ghost_norm_sq[2560/{dg}]"
        checks[name] = check_ghost_norm(torch, ops, ref, wl.TRAIN_LM_CHUNK,
                                        wl.TRAIN_LM_SEQ, 2560, dg)
        print(f"{name} ({wl.TRAIN_LM_CHUNK} x {wl.TRAIN_LM_SEQ} x 2560 / "
              f"{dg}) {checks[name]}")
    torch.cuda.empty_cache()

    # 4. train ResNet-18 at full width under the DPQuant scheduler
    train_launches = train_resnet18(torch, ops, wl)

    # 5. train stablelm-3b at full size in ghost mode under DPQuant
    lm_launches = train_stablelm(torch, ops, wl)

    # 6. ghost against per-example gradients inside stablelm-3b at full
    # width, 2 layers
    ghost_vs_vmap(torch, ops, wl)

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

    sources = {
        "kv_quant_rows": ("src/repro_torch/kernels/csrc/kv_quant.cu",
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
    train_counts = {"luq_quant[weight]": train_launches["luq_quant[one_row]"],
                    "luq_quant[activation]": train_launches["luq_quant[rows]"],
                    "per_sample_clip": train_launches["clip_and_sum"]}
    for dg in (2560, 6912):
        name = f"ghost_norm_sq[2560/{dg}]"
        train_counts[name] = lm_launches.get(name, 0)
    kernels = []
    for name, numbers in checks.items():
        base, _, tag = name.rstrip("]").partition("[")
        if name in train_counts:                          # the training run
            n = train_counts[name]
        elif tag in launches:                             # that KV format's run
            n = launches[tag][base]
        else:                                             # both serving runs
            n = sum(c[name] for c in launches.values())
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
