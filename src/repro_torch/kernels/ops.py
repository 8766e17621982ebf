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

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`.
#: Only launches of a kernel count; CPU calls of the plain versions do not.
LAUNCHES = {"luq_matmul": 0, "kv_quant_rows": 0, "decode_attn_fused": 0}
#: The ``luq_matmul`` launches of :data:`LAUNCHES` by the kernel's branch:
#: ``shared`` uniforms ``ub`` (K, N) for all rows (prefill), or ``per_row``
#: uniforms (R, K, N) (the decode tick's per-slot logits head).
LUQ_MATMUL_LAUNCHES = {"shared": 0, "per_row": 0}

_KV_FMT_CODE = {"int8": 0, "luq_fp4": 1}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, LUQ_MATMUL_LAUNCHES):
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
def luq_matmul(a, b, ua, ub, alpha_a, alpha_b) -> torch.Tensor:
    """LUQ-FP4 quantize-both-operands matmul: (R, K) x (K, N) -> float32.

    ``ua``: (R, K) uniforms for ``a``; ``ub``: (K, N) uniforms shared by all
    rows, or (R, K, N) with one draw per row (the per-slot logits head);
    ``alpha_a``: () or (R,) scales of ``a`` (per row: each row quantized
    on its own); ``alpha_b``: () scale of ``b``.  All float32.
    """
    R, K = a.shape
    N = b.shape[1]
    if _on_cpu(a, b, ua, ub):
        return ref.luq_matmul_ref(a, b, ua, ub, alpha_a, alpha_b)
    per_row = ub.dim() == 3
    alpha_a = alpha_a.reshape(-1).expand(R).contiguous()
    alpha_b = alpha_b.reshape(())
    _check("a", a, torch.float32, (R, K))
    _check("b", b, torch.float32, (K, N))
    _check("ua", ua, torch.float32, (R, K))
    _check("ub", ub, torch.float32, (R, K, N) if per_row else (K, N))
    _check("alpha_a", alpha_a, torch.float32, (R,))
    _check("alpha_b", alpha_b, torch.float32, ())
    _on_cpu(a, alpha_a, alpha_b)
    lib = load_library()
    out = torch.empty((R, N), dtype=torch.float32, device=a.device)
    step = lib.repro_luq_matmul_max_rows()
    with torch.cuda.device(a.device):
        stream = _stream(a.device)
        for r0 in range(0, R, step):
            r1 = min(R, r0 + step)
            err = lib.repro_luq_matmul(
                _ptr(a[r0:r1]), _ptr(b), _ptr(ua[r0:r1]),
                _ptr(ub[r0:r1] if per_row else ub), _ptr(alpha_a[r0:r1]),
                _ptr(alpha_b), _ptr(out[r0:r1]), r1 - r0, K, N, int(per_row),
                stream)
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
    for name, t in (("k_codes", k_codes), ("v_codes", v_codes)):
        if t.data_ptr() % 4:
            raise ValueError(f"{name} must be 4-byte aligned")
    out = torch.empty((B, n_kv, g, hd), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.repro_decode_attn(
            _ptr(qf), _ptr(k_codes), _ptr(v_codes), _ptr(k_scale),
            _ptr(v_scale), _ptr(pos_b), _ptr(out), B, n_kv, g, S, hd,
            float(scale), _KV_FMT_CODE[fmt], _stream(q.device))
    _raise_on_error(lib, err, "decode_attn_fused")
    LAUNCHES["decode_attn_fused"] += 1
    return out.reshape(B, hp, hd)
