"""Quantizer-backend dispatch: (op, format, backend) -> implementation.

The counterpart of ``repro.quant.backend`` for the serving ops:

``"matmul"``      ``mm(a, b, gen) -> (R, N) float32``: quantize both
                  operands, then multiply.  ``gen`` is one
                  ``torch.Generator`` (the whole matrix is quantized at once,
                  as the JAX op does with one key) or a list of R generators
                  (each row of ``a`` quantizes ``b`` with its own stream, as
                  the JAX package's per-slot vmap does).  From each
                  generator the uniforms for ``a`` are drawn first, then
                  those for ``b``.
``"kv_quant"``    ``kvq(x) -> (codes, scales)`` for the KV storage formats.
``"decode_attn"`` ``attn(q, kc, vc, ks, vs, pos, *, n_kv, scale) -> ctx``.

Backends: ``"ref"`` (plain PyTorch, every format) and ``"cuda"`` (the
hand-written kernels of ``repro_torch.kernels``; on CPU tensors their plain
versions).  ``REPRO_QUANT_BACKEND`` overrides the request.  A format a
backend does not implement falls back to ``"ref"`` explicitly, and
``get_*`` returns ``(impl, actual_backend)`` so callers can see where an
op runs.  That fallback is about formats only: a CUDA tensor given to a
kernel wrapper goes through the kernel or raises.

``quantize``, ``clip_sum`` and ``ghost_norm`` wait for the training slice.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Tuple

import torch

from repro_torch.quant import formats

ENV_VAR = "REPRO_QUANT_BACKEND"
DEFAULT_BACKEND = "ref"
BACKENDS = ("ref", "cuda")
OPS = ("matmul", "kv_quant", "decode_attn")

_REGISTRY: Dict[Tuple[str, str, str], Callable] = {}


def register(op: str, fmt: str, backend: str, impl: Callable) -> None:
    if op not in OPS:
        raise ValueError(f"unknown op {op!r} (expected one of {OPS})")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    _REGISTRY[(op, fmt, backend)] = impl


def resolve_backend(requested: str | None = None) -> str:
    """Concrete backend name: env override > request > default."""
    backend = os.environ.get(ENV_VAR) or requested or DEFAULT_BACKEND
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown quant backend {backend!r} (expected one of {BACKENDS}; "
            f"check {ENV_VAR} / QuantConfig.backend)")
    return backend


def get_impl(op: str, fmt: str, backend: str | None = None):
    """Resolve (op, fmt) on ``backend`` with explicit ref fallback.

    Returns ``(impl, actual_backend)``; ``actual_backend`` is ``"ref"``
    when the requested backend lacks the format.
    """
    be = resolve_backend(backend)
    impl = _REGISTRY.get((op, fmt, be))
    if impl is None and be != DEFAULT_BACKEND:
        impl, be = _REGISTRY.get((op, fmt, DEFAULT_BACKEND)), DEFAULT_BACKEND
    if impl is None:
        raise KeyError(f"no implementation for op={op!r} fmt={fmt!r} "
                       f"on any backend")
    return impl, be


def get_matmul(fmt: str, backend: str | None = None):
    """``(mm(a, b, gen) -> (R, N) float32, actual_backend)``."""
    return get_impl("matmul", fmt, backend)


def get_kv_quant(fmt: str, backend: str | None = None):
    """``(kvq(x) -> (codes, scales), actual_backend)``; ``fmt`` is a KV
    storage format (``repro_torch.config.KV_CACHE_FORMATS``)."""
    return get_impl("kv_quant", fmt, backend)


def get_decode_attn(fmt: str, backend: str | None = None):
    """``(attn(q, kc, vc, ks, vs, pos, *, n_kv, scale), actual_backend)``."""
    return get_impl("decode_attn", fmt, backend)


def capability_table() -> Dict[str, Dict[str, Tuple[str, ...]]]:
    """{op: {backend: (natively supported formats...)}}."""
    table: Dict[str, Dict[str, list]] = {op: {b: [] for b in BACKENDS}
                                         for op in OPS}
    for (op, fmt, backend) in _REGISTRY:
        table[op][backend].append(fmt)
    return {op: {b: tuple(sorted(fmts)) for b, fmts in row.items()}
            for op, row in table.items()}


def _draws(gens, a: torch.Tensor, b: torch.Tensor):
    """Uniforms for ``a`` and ``b``: per generator, ``a``'s rows first,
    then all of ``b``.  One generator gives ``ua`` (R, K) and ``ub``
    (K, N); a list of R gives ``ua`` (R, K) and ``ub`` (R, K, N)."""
    R, K = a.shape
    if isinstance(gens, torch.Generator):
        return (torch.rand(a.shape, generator=gens, device=a.device),
                torch.rand(b.shape, generator=gens, device=b.device))
    if len(gens) != R:
        raise ValueError(f"{len(gens)} generators for {R} rows")
    ua = torch.empty((R, K), device=a.device)
    ub = torch.empty((R,) + tuple(b.shape), device=b.device)
    for i, gen in enumerate(gens):
        ua[i].uniform_(generator=gen)
        ub[i].uniform_(generator=gen)
    return ua, ub


# --------------------------------------------------------------------------- #
# ref backend: plain PyTorch, every format
# --------------------------------------------------------------------------- #
def _ref_matmul(fmt: str) -> Callable:
    q = formats.make_quantizer(fmt)
    stochastic = fmt in formats.STOCHASTIC_FORMATS

    def mm(a, b, gen):
        if not stochastic:
            return q(a, None).float() @ q(b, None).float()
        ua, ub = _draws(gen, a, b)
        if ub.dim() == 2:
            return q(a, ua).float() @ q(b, ub).float()
        return torch.cat([q(a[i:i + 1], ua[i:i + 1]).float()
                          @ q(b, ub[i]).float() for i in range(a.shape[0])])

    return mm


def _ref_kv_quant(fmt: str) -> Callable:
    def kvq(x):
        from repro_torch.quant import kv_cache
        return kv_cache.kv_quant(fmt, x)

    return kvq


def _ref_decode_attn(fmt: str) -> Callable:
    def attn(q, kc, vc, ks, vs, pos, *, n_kv, scale):
        from repro_torch.quant import kv_cache
        return kv_cache.ref_decode_attn(fmt, q, kc, vc, ks, vs, pos,
                                        n_kv=n_kv, scale=scale)

    return attn


for _fmt in formats._FORMATS:
    register("matmul", _fmt, "ref", _ref_matmul(_fmt))
for _fmt in ("none", "int8", "luq_fp4"):
    register("kv_quant", _fmt, "ref", _ref_kv_quant(_fmt))
    register("decode_attn", _fmt, "ref", _ref_decode_attn(_fmt))


# --------------------------------------------------------------------------- #
# cuda backend: the kernels of repro_torch.kernels (LUQ-FP4 matmul; the two
# quantized KV formats).  Wrappers are imported lazily so that importing
# this module builds and loads nothing.
# --------------------------------------------------------------------------- #
def _cuda_matmul(a, b, gen):
    from repro_torch.kernels.ops import luq_matmul
    a = a.float().contiguous()
    b = b.float().contiguous()
    ua, ub = _draws(gen, a, b)
    if ub.dim() == 3:
        alpha_a = a.abs().amax(dim=1)
    else:
        alpha_a = a.abs().amax()
    return luq_matmul(a, b, ua, ub, alpha_a, b.abs().amax())


def _cuda_kv_quant(fmt: str) -> Callable:
    def kvq(x):
        from repro_torch.kernels.ops import kv_quant_rows
        return kv_quant_rows(x, fmt)

    return kvq


def _cuda_decode_attn(fmt: str) -> Callable:
    def attn(q, kc, vc, ks, vs, pos, *, n_kv, scale):
        from repro_torch.kernels.ops import decode_attn_fused
        return decode_attn_fused(q, kc, vc, ks, vs, pos, fmt=fmt, n_kv=n_kv,
                                 scale=scale)

    return attn


register("matmul", "luq_fp4", "cuda", _cuda_matmul)
# kv_fmt="none" has no kernel (there is nothing to dequantize); it falls
# back to ref explicitly through get_impl, like every missing format
for _fmt in ("int8", "luq_fp4"):
    register("kv_quant", _fmt, "cuda", _cuda_kv_quant(_fmt))
    register("decode_attn", _fmt, "cuda", _cuda_decode_attn(_fmt))
