"""Low-precision quantizer formats (plain PyTorch).

The counterpart of ``repro.quant.formats``.  Stochastic formats take their
uniform draws ``u`` as an explicit argument, as the JAX package's
``kernels/ref.luq_quant_ref`` does: a caller draws them from the Philox
stream of ``quant.philox`` (or a test hands in numpy draws shared with
the JAX package), so the quantizer itself is a pure function.

``luq_fp4``   LUQ-FP4: per-tensor power-of-two grid {0} U {alpha * 2^-k,
              k = 0..6} anchored at alpha = max|x|, stochastic rounding
              between adjacent levels and stochastic underflow below
              2^-6.  Unbiased: E[q(x) | x] = x.
``int4``      15 symmetric levels {-7..7} * max|x|/7, stochastic rounding.
``fp8_e4m3`` / ``fp8_e5m2`` / ``bf16``: deterministic round-trip casts.
``none``      identity.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

LUQ_EXP_LEVELS = 7   # 3 exponent bits -> 8 codes; one reserved for zero


def luq_fp4(x: torch.Tensor, u: torch.Tensor,
            alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LUQ-FP4 stochastic quantizer given uniforms ``u`` (same shape as
    ``x``) and the per-tensor scale ``alpha`` (default ``max|x|``).

    Operation for operation the JAX package's ``luq_quant_ref``: the level
    is ``floor(log2(max(y, 2^-6)))`` and the comparisons are strict
    ``u < p``, so a kernel that repeats these float32 operations agrees
    bitwise.  Written as its two halves, :func:`luq_fp4_prep` (what does
    not depend on ``u``) and :func:`luq_fp4_value`, the split the kernels
    make (``kernels/csrc/luq.cuh``).
    """
    xf = x.float()
    if alpha is None:
        alpha = xf.abs().amax()
    return luq_fp4_value(luq_fp4_prep(xf, alpha), u).to(x.dtype)


def luq_fp4_prep(x: torch.Tensor, alpha) -> dict:
    """The part of :func:`luq_fp4` that does not depend on the uniforms,
    as ``kernels/csrc/luq.cuh``'s ``luq_prep`` splits it: an element
    rounded against several draws (one per row of the logits head) is
    prepared once.  ``alpha`` broadcasts against ``x``."""
    xf = x.float()
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=x.device)
    safe_alpha = torch.where(alpha > 0, alpha, torch.ones_like(alpha))
    y = xf.abs() / safe_alpha
    min_level = 2.0 ** (-(LUQ_EXP_LEVELS - 1))
    ylog = torch.log2(torch.clamp(y, min=min_level))
    k = torch.clamp(torch.floor(ylog), -(LUQ_EXP_LEVELS - 1), 0.0)
    low = torch.exp2(k)
    high = torch.clamp(torch.exp2(k + 1.0), max=1.0)
    return {"thr": y / min_level,
            "p_up": (y - low) / torch.clamp(high - low, min=1e-30),
            "low": low, "high": high, "small": y < min_level,
            "sign": torch.sign(xf), "alpha": alpha, "safe_alpha": safe_alpha}


def luq_fp4_level(prep: dict, u: torch.Tensor) -> torch.Tensor:
    """The unsigned level in {0, 2^-6, ..., 1} that ``u`` picks."""
    under = torch.where(u < prep["thr"], 2.0 ** (-(LUQ_EXP_LEVELS - 1)), 0.0)
    rounded = torch.where(u < prep["p_up"], prep["high"], prep["low"])
    return torch.where(prep["small"], under, rounded)


def luq_fp4_value(prep: dict, u: torch.Tensor) -> torch.Tensor:
    """The float32 value ``sign * level * alpha`` (0 where alpha <= 0)."""
    out = prep["sign"] * luq_fp4_level(prep, u) * prep["safe_alpha"]
    return torch.where(prep["alpha"] > 0, out, 0.0)


def luq_fp4_codes(x: torch.Tensor, u: torch.Tensor, alpha) -> torch.Tensor:
    """The LUQ codes ``Q(x) / alpha = sign * 2^-k`` (or 0) as bf16, which
    holds them exactly: ``codes.float() * alpha`` is :func:`luq_fp4`'s
    value bit for bit.  All zero where ``alpha <= 0``.  The plain version
    of the ``luq_quant`` kernel's code output."""
    prep = luq_fp4_prep(x, alpha)
    codes = prep["sign"] * luq_fp4_level(prep, u)
    return torch.where(prep["alpha"] > 0, codes, 0.0).to(torch.bfloat16)


def int4_uniform(x: torch.Tensor, u: torch.Tensor,
                 alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniform symmetric INT4, grid {-7..7} * alpha/7 (default alpha =
    max|x|), stochastic rounding."""
    xf = x.float()
    if alpha is None:
        alpha = xf.abs().amax()
    safe_alpha = torch.where(alpha > 0, alpha, torch.ones_like(alpha))
    delta = safe_alpha / 7.0
    y = xf / delta
    lo = torch.floor(y)
    q = lo + (u < (y - lo)).float()
    q = torch.clamp(q, -7.0, 7.0)
    out = torch.where(alpha > 0, q * delta, 0.0)
    return out.to(x.dtype)


def _cast_roundtrip(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).to(x.dtype)


def fp8_e4m3(x: torch.Tensor, u=None) -> torch.Tensor:
    del u
    return _cast_roundtrip(x, torch.float8_e4m3fn)


def fp8_e5m2(x: torch.Tensor, u=None) -> torch.Tensor:
    del u
    return _cast_roundtrip(x, torch.float8_e5m2)


def bf16(x: torch.Tensor, u=None) -> torch.Tensor:
    del u
    return _cast_roundtrip(x, torch.bfloat16)


def identity(x: torch.Tensor, u=None) -> torch.Tensor:
    del u
    return x


_FORMATS = {
    "luq_fp4": luq_fp4,
    "int4": int4_uniform,
    "fp8_e4m3": fp8_e4m3,
    "fp8_e5m2": fp8_e5m2,
    "bf16": bf16,
    "none": identity,
}

STOCHASTIC_FORMATS = ("luq_fp4", "int4")


def make_quantizer(fmt: str) -> Callable[[torch.Tensor, Optional[torch.Tensor]],
                                         torch.Tensor]:
    """Return ``q(x, u) -> x_q``; ``u`` is ignored by deterministic formats.
    Raises KeyError for unknown formats."""
    return _FORMATS[fmt]

