"""Wrappers of the CUDA kernels: checks, outputs, launch, launch counts.

Each wrapper takes tensors and:

* on CPU tensors, returns its kernel's plain version (``kernels.ref``);
* on CUDA tensors, checks device, dtype, shape and contiguity, allocates
  the outputs with ``torch.empty``, launches the kernel on the current
  stream, raises if the launch returned an error, and adds one to its
  entry of :data:`LAUNCHES`.  There is no fallback: a CUDA tensor either
  goes through the kernel or the call raises.

The kernels (``csrc/*.cu``) are built at first use by ``kernels.build``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import load_library
from repro_torch.quant import kv_cache as kvc
from repro_torch.quant import philox

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`.
#: Only launches of a kernel count; CPU calls of the plain versions do not.
LAUNCHES = {"luq_matmul": 0, "kv_quant_rows": 0, "decode_attn_fused": 0,
            "luq_quant": 0, "clip_and_sum": 0, "ghost_norm_sq": 0}
#: The ``luq_matmul`` launches of :data:`LAUNCHES` by the kernel's branch:
#: one Philox key ``shared`` by all rows (prefill), or one key ``per_row``
#: (the decode tick's per-slot logits head).
LUQ_MATMUL_LAUNCHES = {"shared": 0, "per_row": 0}
#: The ``luq_quant`` launches of :data:`LAUNCHES` by the number of rows: a
#: tensor quantized whole (``one_row``: a weight, or anything outside
#: vmap) or one row per example (``rows``: activations and cotangents
#: under the DP engine's vmap).
LUQ_QUANT_LAUNCHES = {"one_row": 0, "rows": 0}
#: The ``ghost_norm_sq`` launches of :data:`LAUNCHES` by shape class, the
#: operands' widths ``"{min(Dx, Dg)}/{max(Dx, Dg)}"`` (keys appear at the
#: first launch of a class).
GHOST_NORM_LAUNCHES: dict = {}

_KV_FMT_CODE = {"int8": 0, "luq_fp4": 1}


def reset_launch_counts() -> None:
    GHOST_NORM_LAUNCHES.clear()
    for counts in (LAUNCHES, LUQ_MATMUL_LAUNCHES, LUQ_QUANT_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _on_cpu(*tensors) -> bool:
    """True when every tensor is on the CPU; raises on mixed or other
    devices so a CUDA tensor can never reach a plain version."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return True
    if types != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"kernel inputs must all be CPU tensors or all on one CUDA "
            f"device, got {sorted(str(t.device) for t in tensors)}")
    return False


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_on_error(lib, err: int, kernel: str) -> None:
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} (cudaError {err})")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# --------------------------------------------------------------------------- #
# luq_matmul  (csrc/luq_matmul.cu, replaces the TPU kernel quant_matmul)
# --------------------------------------------------------------------------- #
def luq_matmul(a, b, keys, alpha_a, alpha_b) -> torch.Tensor:
    """LUQ-FP4 quantize-both-operands matmul: (R, K) x (K, N) -> float32,
    the uniforms drawn inside the kernel with Philox4x32-10.

    ``keys``: one ``(k0, k1)`` pair of 32-bit ints, the draw shared by all
    rows (prefill: ``a`` quantized as one matrix), or R pairs, one draw
    per row (the decode tick's per-slot logits head); the stream's layout
    is ``repro_torch.quant.philox``'s.  ``alpha_a``: () or (R,) scales of
    ``a`` (per row: each row quantized on its own); ``alpha_b``: () scale
    of ``b``.  ``a``, ``b`` and the scales float32.  The kernel sums in a
    fixed order: the same inputs and keys give the same bits every run.
    """
    R, K = a.shape
    N = b.shape[1]
    key_list, per_row = philox.split_keys(keys, R)
    if _on_cpu(a, b):
        return ref.luq_matmul_keys_ref(a, b, keys, alpha_a, alpha_b)
    alpha_a = alpha_a.reshape(-1).expand(R).contiguous()
    alpha_b = alpha_b.reshape(())
    _check("a", a, torch.float32, (R, K))
    _check("b", b, torch.float32, (K, N))
    _check("alpha_a", alpha_a, torch.float32, (R,))
    _check("alpha_b", alpha_b, torch.float32, ())
    _on_cpu(a, alpha_a, alpha_b)
    lib = load_library()
    out = torch.empty((R, N), dtype=torch.float32, device=a.device)
    step = lib.repro_luq_matmul_max_rows()
    splits = lib.repro_luq_matmul_splits(K, N)
    # scratch: Q(a), and the K splits' partial sums
    aq = torch.empty((R, K), dtype=torch.float32, device=a.device)
    partial = torch.empty((splits * min(R, step) * N if splits > 1 else 1,),
                          dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = _stream(a.device)
        for r0 in range(0, R, step):
            r1 = min(R, r0 + step)
            words = [w for k in (key_list[r0:r1] if per_row else key_list)
                     for w in k]
            err = lib.repro_luq_matmul(
                _ptr(a[r0:r1]), _ptr(b), _ptr(alpha_a[r0:r1]), _ptr(alpha_b),
                (ctypes.c_uint32 * len(words))(*words), int(per_row), r0,
                _ptr(aq[r0:r1]), _ptr(partial), _ptr(out[r0:r1]), r1 - r0, K,
                N, stream)
            _raise_on_error(lib, err, "luq_matmul")
            LAUNCHES["luq_matmul"] += 1
            LUQ_MATMUL_LAUNCHES["per_row" if per_row else "shared"] += 1
    return out


# --------------------------------------------------------------------------- #
# kv_quant_rows  (csrc/kv_quant.cu, replaces the TPU kernel kv_rowquant_2d)
# --------------------------------------------------------------------------- #
def kv_quant_rows(x: torch.Tensor, fmt: str):
    """Quantize K/V rows ``(..., head_dim)`` -> ``(codes, scales)``.

    Same result as ``kv_cache.kv_quant``: codes ``(..., code_dim)`` (int8,
    or nibble-packed uint8 for luq_fp4) and per-row bf16 scales ``(...,)``.
    """
    if fmt not in _KV_FMT_CODE:
        raise ValueError(f"kv_quant_rows has no kernel for fmt {fmt!r}")
    hd = x.shape[-1]
    code_dtype, code_dim = kvc.code_spec(fmt, hd)
    if _on_cpu(x):
        return ref.kv_quant_rows_ref(x, fmt)
    rows = x.reshape(-1, hd).float().contiguous()
    R = rows.shape[0]
    codes = torch.empty((R, code_dim), dtype=code_dtype, device=x.device)
    scales = torch.empty((R,), dtype=kvc.SCALE_DTYPE, device=x.device)
    if R:
        lib = load_library()
        with torch.cuda.device(x.device):
            err = lib.repro_kv_quant_rows(_ptr(rows), _ptr(codes), _ptr(scales),
                                          R, hd, _KV_FMT_CODE[fmt],
                                          _stream(x.device))
        _raise_on_error(lib, err, "kv_quant_rows")
        LAUNCHES["kv_quant_rows"] += 1
    return (codes.reshape(*x.shape[:-1], code_dim),
            scales.reshape(x.shape[:-1]))


# --------------------------------------------------------------------------- #
# decode_attn_fused  (csrc/decode_attn.cu, replaces decode_attn_call)
# --------------------------------------------------------------------------- #
def decode_attn_fused(q, k_codes, v_codes, k_scale, v_scale, pos, *,
                      fmt: str, n_kv: int, scale: float) -> torch.Tensor:
    """Fused decode attention over a quantized slot-pool cache.

    Same signature and result as ``kv_cache.ref_decode_attn`` for the
    quantized formats: ``q`` (B, H, hd); codes (B, KV, S, code_dim); bf16
    scales (B, KV, S); ``pos`` (B,) int tensor of per-slot positions (on
    the device of ``q``), row ``s`` attended when ``s <= pos``.  Returns
    (B, H, hd) float32.

    The kernel splits each slot's rows into fixed ranges of 64 and merges
    the splits in order (no atomics): the same inputs give the same bits
    on every run, and a slot's output does not depend on the other slots.
    """
    if fmt not in _KV_FMT_CODE:
        raise ValueError(f"decode_attn_fused has no kernel for fmt {fmt!r}")
    B, hp, hd = q.shape
    g = hp // n_kv
    if hp != g * n_kv:
        raise ValueError(f"{hp} query heads do not split over {n_kv} kv heads")
    if _on_cpu(q, k_codes, v_codes, k_scale, v_scale):
        return ref.decode_attn_ref(q, k_codes, v_codes, k_scale, v_scale, pos,
                                   fmt=fmt, n_kv=n_kv, scale=scale)
    S = k_codes.shape[2]
    code_dtype, code_dim = kvc.code_spec(fmt, hd)
    lib = load_library()
    max_g, max_hd = ctypes.c_int(), ctypes.c_int()
    lib.repro_decode_attn_limits(ctypes.byref(max_g), ctypes.byref(max_hd))
    if g > max_g.value or hd > max_hd.value or hd % 4:
        raise ValueError(
            f"decode_attn_fused takes g <= {max_g.value} and head_dim a "
            f"multiple of 4 up to {max_hd.value}; got g={g}, head_dim={hd}")
    qf = q.float().contiguous()
    pos_b = torch.as_tensor(pos, device=q.device).to(torch.int32).expand(B)
    pos_b = pos_b.contiguous()
    _check("k_codes", k_codes, code_dtype, (B, n_kv, S, code_dim))
    _check("v_codes", v_codes, code_dtype, (B, n_kv, S, code_dim))
    _check("k_scale", k_scale, kvc.SCALE_DTYPE, (B, n_kv, S))
    _check("v_scale", v_scale, kvc.SCALE_DTYPE, (B, n_kv, S))
    _on_cpu(qf, pos_b, k_codes)
    out = torch.empty((B, n_kv, g, hd), dtype=torch.float32, device=q.device)
    # scratch: each split's partial output and its softmax (max, sum)
    scratch = torch.empty((lib.repro_decode_attn_scratch(B, n_kv, g, S, hd),),
                          dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.repro_decode_attn(
            _ptr(qf), _ptr(k_codes), _ptr(v_codes), _ptr(k_scale),
            _ptr(v_scale), _ptr(pos_b), _ptr(out), _ptr(scratch), B, n_kv, g,
            S, hd, float(scale), _KV_FMT_CODE[fmt], _stream(q.device))
    _raise_on_error(lib, err, "decode_attn_fused")
    LAUNCHES["decode_attn_fused"] += 1
    return out.reshape(B, hp, hd)


# --------------------------------------------------------------------------- #
# luq_quant  (csrc/luq_quant.cu, replaces the TPU kernel luq_quant_2d)
# --------------------------------------------------------------------------- #
def luq_quant(x: torch.Tensor, u: torch.Tensor, alpha: torch.Tensor,
              codes: bool = False) -> torch.Tensor:
    """LUQ-FP4 stochastic quantization of the rows of ``x`` (R, N).

    ``u``: (N,) uniforms shared by every row, or (R, N), one draw per row;
    ``alpha``: (R,) per-row scales (``max|x[r]|``, computed by the caller).
    All float32.  Returns (R, N) float32 values, or with ``codes`` the
    bf16 codes ``Q(x) / alpha = sign * 2^-k`` (exact in bf16).
    """
    if _on_cpu(x, u, alpha):
        return ref.luq_quant_ref(x, u, alpha, codes)
    R, N = x.shape
    per_row = u.dim() == 2
    _check("x", x, torch.float32, (R, N))
    _check("u", u, torch.float32, (R, N) if per_row else (N,))
    _check("alpha", alpha, torch.float32, (R,))
    out = torch.empty_like(x, dtype=torch.bfloat16 if codes else x.dtype)
    if x.numel() == 0:
        return out
    vec = (N % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, u))
           and out.data_ptr() % (8 if codes else 16) == 0)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.repro_luq_quant(_ptr(x), _ptr(u), _ptr(alpha), _ptr(out), R,
                                  N, int(per_row), int(vec), int(codes),
                                  _stream(x.device))
    _raise_on_error(lib, err, "luq_quant")
    LAUNCHES["luq_quant"] += 1
    LUQ_QUANT_LAUNCHES["one_row" if R == 1 else "rows"] += 1
    return out


# --------------------------------------------------------------------------- #
# clip_and_sum  (csrc/per_sample_clip.cu, replaces per_sample_clip)
# --------------------------------------------------------------------------- #
def clip_and_sum(grads: torch.Tensor, clip_norm: float):
    """Fused DP per-example clip and batch sum of (B, D) float32 rows.

    Returns ``(clipped_sum (D,), norms (B,))``, both float32:
    ``clipped_sum = sum_b min(1, C / max(||g_b||, 1e-12)) * g_b``.  The
    kernel sums in a fixed order (no atomics): the same input gives the
    same bits on every run.
    """
    if _on_cpu(grads):
        return ref.per_sample_clip_ref(grads, clip_norm)
    B, D = grads.shape
    _check("grads", grads, torch.float32, (B, D))
    lib = load_library()
    P = lib.repro_per_sample_clip_chunks(D)
    out = torch.empty((D,), dtype=torch.float32, device=grads.device)
    norms = torch.empty((B,), dtype=torch.float32, device=grads.device)
    partial = torch.empty((B * P,), dtype=torch.float32, device=grads.device)
    with torch.cuda.device(grads.device):
        err = lib.repro_per_sample_clip(
            _ptr(grads), _ptr(out), _ptr(norms), _ptr(partial), B, D,
            float(clip_norm), _stream(grads.device))
    _raise_on_error(lib, err, "clip_and_sum")
    LAUNCHES["clip_and_sum"] += 1
    return out, norms


# --------------------------------------------------------------------------- #
# ghost_norm_sq  (csrc/ghost_norm.cu, replaces the TPU kernel ghost_norm_gram)
# --------------------------------------------------------------------------- #
def ghost_norm_sq(x, g, ux, ug, alpha_x, alpha_g) -> torch.Tensor:
    """LUQ-FP4 quantize + Grams + reduce in one call, per example:
    ``out[b] = ||Q(x_b)^T Q(g_b)||_F^2 = <Q(x_b)Q(x_b)^T, Q(g_b)Q(g_b)^T>``.

    ``x``: (B, T, Dx) wgrad-GEMM input rows of B examples; ``g``: (B, T,
    Dg) their cotangent rows; ``ux`` (T * Dx,) and ``ug`` (T * Dg,): the
    uniforms shared by the examples (the draws fake-quant's folds 4 and 5
    make for one example, so fused and unfused routes agree); ``alpha_x``,
    ``alpha_g``: (B,) per-example scales (``max|x_b|``, ``max|g_b|``).
    All float32.  Returns (B,) float32.

    The kernel quantizes both operands once into bf16 codes (``Q(v) /
    alpha``, exact), runs the upper triangles of the (T, T) Grams of the
    codes on the tensor cores in tiles, and scales each example by
    ``(alpha_x alpha_g)^2`` at the end, so any T is taken: the JAX
    wrapper's ``T <= 512`` cap (``GHOST_NORM_MAX_T``) sized its two whole
    Grams for a TPU core's VMEM, and above it that wrapper computes the
    same value unfused.  Partials are summed in a fixed order (no
    atomics): the same input gives the same bits on every run.
    """
    if _on_cpu(x, g, ux, ug, alpha_x, alpha_g):
        return ref.ghost_norm_ref(x, g, ux, ug, alpha_x, alpha_g)
    B, T, Dx = x.shape
    Dg = g.shape[2]
    _check("x", x, torch.float32, (B, T, Dx))
    _check("g", g, torch.float32, (B, T, Dg))
    _check("ux", ux, torch.float32, (T * Dx,))
    _check("ug", ug, torch.float32, (T * Dg,))
    _check("alpha_x", alpha_x, torch.float32, (B,))
    _check("alpha_g", alpha_g, torch.float32, (B,))
    out = torch.empty((B,), dtype=torch.float32, device=x.device)
    if out.numel() == 0 or T == 0 or Dx == 0 or Dg == 0:
        return out.zero_()
    lib = load_library()
    P = lib.repro_ghost_norm_partials(T)
    # scratch: the bf16 codes of both operands, the per-tile partials
    cx = torch.empty((B * T * Dx,), dtype=torch.bfloat16, device=x.device)
    cg = torch.empty((B * T * Dg,), dtype=torch.bfloat16, device=x.device)
    partial = torch.empty((B * P,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.repro_ghost_norm(
            _ptr(x), _ptr(ux), _ptr(alpha_x), _ptr(g), _ptr(ug),
            _ptr(alpha_g), _ptr(cx), _ptr(cg), _ptr(partial), _ptr(out), B,
            T, Dx, Dg, _stream(x.device))
    _raise_on_error(lib, err, "ghost_norm_sq")
    LAUNCHES["ghost_norm_sq"] += 1
    shape_class = f"{min(Dx, Dg)}/{max(Dx, Dg)}"
    GHOST_NORM_LAUNCHES[shape_class] = GHOST_NORM_LAUNCHES.get(shape_class,
                                                               0) + 1
    return out
