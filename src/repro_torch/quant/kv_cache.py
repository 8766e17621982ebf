"""KV-cache storage quantization: per-row codes + bfloat16 scales.

The counterpart of ``repro.quant.kv_cache``: the storage formats of the
serving cache (``ServeConfig.kv_fmt``) and plain PyTorch versions of the
two dispatched ops, ``kv_quant`` (rows -> codes, scales) and
``decode_attn`` (one-token GQA attention over the quantized cache).

``none``      the cache keeps the compute dtype, no scales.
``int8``      round-half-to-even of ``x / scale`` clipped to [-127, 127],
              ``scale = bf16(amax / 127)``.
``luq_fp4``   nearest level of {0} U {+-2^-k, k = 0..6} times
              ``scale = bf16(amax)``, ties up, underflow below 2^-7 to 0;
              two codes per uint8 along head_dim, even index = low nibble.

Scales are stored in bfloat16 and the encoders divide by the rounded
scale, so a cache round trip is deterministic on every backend.  The
CUDA kernels in ``repro_torch/kernels/csrc`` repeat these float32
operations one for one, so their codes are bitwise equal to these.
"""
from __future__ import annotations

import torch

from repro_torch.config import KV_CACHE_FORMATS

SCALE_DTYPE = torch.bfloat16
INT8_QMAX = 127.0
# luq_fp4 magnitude grid: code m in 1..7 decodes to 2^(m-7), m = 0 to 0.
FP4_LEVELS = 7


def code_spec(fmt: str, head_dim: int):
    """``(code_dtype, code_dim)`` of one cached row; dtype None = native."""
    if fmt == "none":
        return None, head_dim
    if fmt == "int8":
        return torch.int8, head_dim
    if fmt == "luq_fp4":
        if head_dim % 2:
            raise ValueError(
                f"kv_fmt='luq_fp4' packs two codes per byte along head_dim "
                f"and needs an even head_dim, got {head_dim}")
        return torch.uint8, head_dim // 2
    raise ValueError(f"unknown kv cache format {fmt!r} "
                     f"(expected one of {KV_CACHE_FORMATS})")


def _div(x: torch.Tensor, value: float) -> torch.Tensor:
    # Divide by a tensor, not a Python number: on CUDA PyTorch turns
    # division by a host scalar into multiplication by its reciprocal,
    # which rounds differently from the IEEE division the kernels and the
    # JAX package do.
    return x / torch.full_like(x, value)


def int8_row_scale(amax: torch.Tensor) -> torch.Tensor:
    """Per-row scale: the float32 value of the stored bf16 scale."""
    return _div(amax, INT8_QMAX).to(SCALE_DTYPE).float()


def int8_encode(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round-half-to-even int8 codes (float32 domain); a zero scale
    (all-zero row) encodes to zero codes."""
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.clamp(torch.round(x / safe[..., None]), -INT8_QMAX, INT8_QMAX)


def fp4_row_scale(amax: torch.Tensor) -> torch.Tensor:
    """luq_fp4 per-row scale = bf16(amax) (the grid's top level is 1.0)."""
    return amax.to(SCALE_DTYPE).float()


def fp4_encode(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Nearest-level luq_fp4 codes 0..15 (float32 domain): sign bit 3,
    magnitude m in bits 0..2 decoding to ``2^(m-7)`` (m = 0 is zero)."""
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    y = x.abs() / safe[..., None]
    k = torch.clamp(torch.floor(torch.log2(torch.clamp(y, min=2.0 ** -FP4_LEVELS))),
                    -float(FP4_LEVELS - 1), 0.0)
    low = torch.exp2(k)
    high = torch.clamp(2.0 * low, max=1.0)
    m = k + 7.0 + ((y - low) >= (high - y)).float()
    m = torch.where(y < 2.0 ** -FP4_LEVELS, 0.0, torch.clamp(m, 1.0, 7.0))
    return m + 8.0 * ((x < 0) & (m > 0)).float()


def fp4_decode_unit(codes: torch.Tensor) -> torch.Tensor:
    """Unpacked integer codes 0..15 -> float32 grid values in [-1, 1]."""
    m = (codes & 7).float()
    sgn = 1.0 - 2.0 * ((codes >> 3) & 1).float()
    return torch.where(m > 0, torch.exp2(m - 7.0), 0.0) * sgn


def fp4_pack(codes: torch.Tensor) -> torch.Tensor:
    """Pack (..., head_dim) uint8 codes two per byte; even index = low
    nibble."""
    lo = codes[..., 0::2].to(torch.uint8)
    hi = codes[..., 1::2].to(torch.uint8)
    return lo | (hi << 4)


def fp4_unpack(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`fp4_pack`: (..., D/2) uint8 -> (..., D) int32."""
    lo = (packed & 0xF).to(torch.int32)
    hi = ((packed >> 4) & 0xF).to(torch.int32)
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)


def kv_quant(fmt: str, x: torch.Tensor):
    """Quantize K/V rows ``(..., head_dim)`` -> ``(codes, scales)``.

    ``scales`` is ``(...,)`` bfloat16, one per row; ``fmt == "none"``
    returns ``(x, None)``.  Deterministic: no random draws.
    """
    if fmt == "none":
        return x, None
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    if fmt == "int8":
        scale = int8_row_scale(amax)
        codes = int8_encode(xf, scale).to(torch.int8)
    elif fmt == "luq_fp4":
        scale = fp4_row_scale(amax)
        codes = fp4_pack(fp4_encode(xf, scale).to(torch.uint8))
    else:
        raise ValueError(f"unknown kv cache format {fmt!r}")
    return codes, scale.to(SCALE_DTYPE)


def kv_dequant(fmt: str, codes: torch.Tensor, scales) -> torch.Tensor:
    """Decode stored rows to float32 (identity for ``"none"``).

    A zero scale decodes the whole row to exactly zero whatever the codes,
    which is why the engine zeroes a retired slot's scale rows.
    """
    if fmt == "none":
        return codes
    s = scales.float()[..., None]
    if fmt == "int8":
        return codes.float() * s
    if fmt == "luq_fp4":
        return fp4_decode_unit(fp4_unpack(codes)) * s
    raise ValueError(f"unknown kv cache format {fmt!r}")


def ref_decode_attn(fmt: str, q, k_codes, v_codes, k_scale, v_scale, pos, *,
                    n_kv: int, scale: float):
    """One-token GQA attention over the (quantized) cache: the reference.

    ``q``: (B, H, hd); ``k_codes``/``v_codes``: (B, KV, S, code_dim);
    ``k_scale``/``v_scale``: (B, KV, S) bf16 (None for ``"none"``);
    ``pos``: int or (B,) per-row positions, row ``s`` is attended when
    ``s <= pos``; ``scale``: the softmax scale.  Returns (B, H, hd).
    Dequantizes the cache, then runs the plain contraction, as the JAX
    package's ``ref_decode_attn`` does.
    """
    B, hp, hd = q.shape
    g = hp // n_kv
    qg = q.reshape(B, n_kv, g, hd)
    k = kv_dequant(fmt, k_codes, k_scale)
    v = kv_dequant(fmt, v_codes, v_scale)
    scores = torch.einsum("bkgd,bksd->bkgs", qg.float(), k.float()) * scale
    pos_b = torch.as_tensor(pos, device=q.device).expand(B)
    valid = (torch.arange(k.shape[2], device=q.device)[None, None, None, :]
             <= pos_b[:, None, None, None])
    scores = torch.where(valid, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgs,bksd->bkgd", probs.to(v.dtype), v)
    return ctx.reshape(B, hp, hd)
