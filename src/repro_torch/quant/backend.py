"""Quantizer-backend dispatch: (op, format, backend) -> implementation.

The counterpart of ``repro.quant.backend``:

``"quantize"``    ``q(rows, key) -> rows_q``: fake-quantize each row of a
                  (R, N) matrix on its own scale (``max|row|``), in its
                  own dtype, all rows against one draw: element n takes
                  uniform n of the Philox stream of ``key`` (operand 0,
                  ``repro_torch.quant.philox``; ``None`` for the
                  deterministic formats).  Both backends draw that
                  stream, the ``cuda`` kernel itself, so they give the
                  same bits on CPU tensors.  The primitive behind
                  ``fake_quant``: a tensor quantized whole is one row, a
                  microbatch of per-example tensors one row each.
``"matmul"``      ``mm(a, b, keys, cols=None, alpha_b=None) -> (R, N)
                  float32``: quantize both
                  operands, then multiply.  ``keys`` is one Philox key
                  ``(k0, k1)`` (the whole matrix is quantized at once, as
                  the JAX op does with one key) or a list of R keys (each
                  row of ``a`` quantizes ``b`` with its own stream, as the
                  JAX package's per-slot vmap does).  The uniforms are the
                  ``repro_torch.quant.philox`` stream of each key (operand
                  0 for ``a``, 1 for ``b``), the same on CPU and card, and
                  the ``cuda`` kernel draws them itself.  ``cols``
                  ``(col0, n_whole)`` and ``alpha_b``: ``b`` is a vocab
                  shard, the columns ``col0 ..`` of a head ``n_whole``
                  wide whose scale is ``alpha_b``; its product is the
                  whole head's columns (``kernels.ops.luq_matmul``).
``"kv_write"``    ``kvw(k, v, kc, vc, ks, vs, wpos)``: quantize the K and V
                  rows (N0, N1, T, hd) of one call into the cache codes
                  (N0, N1, S, code_dim) and bf16 scales (N0, N1, S), in
                  place, row t of (i, j) at cache row ``wpos[i] + t``
                  (from row 0 when ``wpos`` is None), for the KV storage
                  formats (``"none"`` copies the rows, no scales).
                  A sequence shard (``row0``, ``seq_len``): the cache's
                  rows ``row0 ..`` of ``seq_len``, the rows it holds
                  written alone.
``"decode_attn"`` ``attn(q, kc, vc, ks, vs, pos, *, n_kv, scale, rows=None,
                  gather=None) -> ctx``.  A sequence shard (``rows``
                  ``(row0, seq_len)``, ``q`` every query head): this
                  rank's partials over its rows, ``gather(partials, 0)``
                  of every rank's in rank order, then their merge.
``"clip_sum"``    ``cs(grads, clip_norm) -> (clipped_sum, norms)``: the DP
                  per-example clip and batch sum of (B, D) rows; format-
                  agnostic (registered under fmt ``"*"``) and selected by
                  its own knob (:func:`get_clip_sum`).
``"ghost_norm"``  ``gn(x, g, kx, kg) -> (B,) float32``: the ghost-clipping
                  tap ``||Q(x_b)^T Q(g_b)||_F^2`` of B examples from their
                  (B, T, Dx) / (B, T, Dg) wgrad-GEMM matrix views, each
                  example quantized on its own scale against the draws of
                  the keys ``kx`` / ``kg`` shared by the examples (the
                  ``quantize`` op's stream; ``None`` for the
                  deterministic formats), by the Gram identity
                  ``<Q(x_b)Q(x_b)^T, Q(g_b)Q(g_b)^T>``.
                  The ref impl quantizes per example, then two ``bmm``
                  Grams; the cuda impl is the ``ghost_norm`` kernel.

The DPQuant policy flag (a one-element float32 device tensor, the
layer's entry of the trainer's flags tensor) is applied around the
``quantize`` and ``ghost_norm`` ops by their callers
(``quant.fake_quant``, ``dp.ghost``): ``torch.where(flag > 0.5, op(...),
unquantized)``, except for an impl marked :func:`reads_flag`, which takes
it as a last argument and passes the operand through itself when it is 0
(the ``cuda`` luq_fp4 kernels: no extra pass over the operand).

Backends: ``"ref"`` (plain PyTorch, every format) and ``"cuda"`` (the
hand-written kernels of ``repro_torch.kernels``; on CPU tensors their plain
versions).  ``REPRO_QUANT_BACKEND`` overrides the request.  A format a
backend does not implement falls back to ``"ref"`` explicitly, and
``get_*`` returns ``(impl, actual_backend)`` so callers can see where an
op runs.  That fallback is about formats only: a CUDA tensor given to a
kernel wrapper goes through the kernel or raises.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Tuple

import torch

from repro_torch.quant import formats, philox

ENV_VAR = "REPRO_QUANT_BACKEND"
DEFAULT_BACKEND = "ref"
BACKENDS = ("ref", "cuda")
OPS = ("quantize", "matmul", "clip_sum", "ghost_norm", "kv_write",
       "decode_attn")

# fmt sentinel for format-agnostic ops (clip_sum)
ANY_FORMAT = "*"

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


def get_quantizer(fmt: str, backend: str | None = None):
    """``(q(rows, key) -> rows_q, actual_backend)``."""
    return get_impl("quantize", fmt, backend)


def get_clip_sum(backend: str | None = None):
    """``(cs(grads, clip_norm) -> (clipped_sum, norms), actual_backend)``.

    ``backend`` is ``DPConfig.clip_backend``: ``"ref"`` or ``"fused"``
    (the ``per_sample_clip`` kernel; ``"cuda"`` is accepted too).  Unlike
    the quantizer ops, ``REPRO_QUANT_BACKEND`` does NOT apply: the clip
    has its own knob, and an explicit ``"fused"`` request must not be
    downgraded by a variable meant to pin the quantizers.
    """
    be = "cuda" if backend == "fused" else (backend or DEFAULT_BACKEND)
    if be not in BACKENDS:
        raise ValueError(f"unknown clip backend {backend!r} "
                         f"(expected 'ref' or 'fused')")
    return _REGISTRY[("clip_sum", ANY_FORMAT, be)], be


def get_matmul(fmt: str, backend: str | None = None):
    """``(mm(a, b, keys) -> (R, N) float32, actual_backend)``."""
    return get_impl("matmul", fmt, backend)


def get_ghost_norm(fmt: str, backend: str | None = None):
    """``(gn(x, g, kx, kg) -> (B,) float32, actual_backend)``."""
    return get_impl("ghost_norm", fmt, backend)


def get_kv_write(fmt: str, backend: str | None = None):
    """``(kvw(k, v, kc, vc, ks, vs, wpos) -> None, actual_backend)``;
    ``fmt`` is a KV storage format (``repro_torch.config.KV_CACHE_FORMATS``)."""
    return get_impl("kv_write", fmt, backend)


def get_decode_attn(fmt: str, backend: str | None = None):
    """``(attn(q, kc, vc, ks, vs, pos, *, n_kv, scale), actual_backend)``."""
    return get_impl("decode_attn", fmt, backend)


def reads_flag(impl: Callable) -> bool:
    """True when ``impl`` takes the policy flag as its last argument."""
    return getattr(impl, "reads_flag", False)


def quantize_split(rows, fmt: str, backend: str | None, key, index_map,
                   reduce_max, flag=None):
    """The ``quantize`` op on a shard of each row of ``rows`` (R, N), for
    a stochastic format: the rows' scales ``reduce_max((R,) local
    maxima)`` (the max over the ranks that hold the other shards), and
    element n drawing the uniform of its index in the whole row under
    ``index_map`` (``philox.global_index``); the slice of the whole rows'
    quantization, bit for bit.  On the ``cuda`` backend for luq_fp4 the
    ``luq_row_max`` and ``luq_round`` kernels (their plain versions on CPU
    tensors), else in PyTorch.  ``flag``: the layer's device flag; at 0,
    ``rows`` unchanged."""
    impl, be = get_quantizer(fmt, backend)
    if reads_flag(impl):
        from repro_torch.kernels.ops import luq_round, luq_row_max
        x = rows.contiguous()
        return luq_round(x, key, reduce_max(luq_row_max(x)), index_map,
                         flag=flag)
    q = formats.make_quantizer(fmt)
    xf = rows.float()
    alpha = reduce_max(xf.abs().amax(dim=1))
    u = philox.mapped_uniforms(key, rows.shape[1], index_map, rows.device)
    out = q(xf, u, alpha[:, None]).to(rows.dtype)
    return out if flag is None else torch.where(flag > 0.5, out, rows)


def capability_table() -> Dict[str, Dict[str, Tuple[str, ...]]]:
    """{op: {backend: (natively supported formats...)}}."""
    table: Dict[str, Dict[str, list]] = {op: {b: [] for b in BACKENDS}
                                         for op in OPS}
    for (op, fmt, backend) in _REGISTRY:
        table[op][backend].append(fmt)
    return {op: {b: tuple(sorted(fmts)) for b, fmts in row.items()}
            for op, row in table.items()}


# --------------------------------------------------------------------------- #
# ref backend: plain PyTorch, every format
# --------------------------------------------------------------------------- #
def _ref_quantize(fmt: str) -> Callable:
    q = formats.make_quantizer(fmt)
    if fmt not in formats.STOCHASTIC_FORMATS:
        return lambda rows, key: q(rows.float(), None).to(rows.dtype)

    def quantize(rows, key):
        xf = rows.float()
        u = philox.row_uniforms(key, rows.shape[1], rows.device)
        return q(xf, u, xf.abs().amax(dim=1, keepdim=True)).to(rows.dtype)

    return quantize


def _ref_clip_sum(grads, clip_norm):
    from repro_torch.kernels.ref import per_sample_clip_ref
    return per_sample_clip_ref(grads, clip_norm)


def _ref_matmul(fmt: str) -> Callable:
    q = formats.make_quantizer(fmt)
    if fmt not in formats.STOCHASTIC_FORMATS:
        # elementwise: a vocab shard's product is the whole one's columns
        return lambda a, b, keys, cols=None, alpha_b=None: (
            q(a, None).float() @ q(b, None).float())
    # the keyed plain matmul splits LUQ-FP4 itself; another format is
    # quantized whole against each draw
    split = {} if fmt == "luq_fp4" else {
        "prep": lambda x, alpha: (x, alpha),
        "value": lambda prepared, u: q(prepared[0], u, prepared[1])}

    def mm(a, b, keys, cols=None, alpha_b=None):
        from repro_torch.kernels.ref import luq_matmul_keys_ref
        a, b = a.float(), b.float()
        _, per_row = philox.split_keys(keys, a.shape[0])
        alpha_a = a.abs().amax(dim=1) if per_row else a.abs().amax()
        if alpha_b is None:
            alpha_b = b.abs().amax()
        return luq_matmul_keys_ref(a, b, keys, alpha_a, alpha_b, cols=cols,
                                   **split)

    return mm


def _ref_ghost_norm(fmt: str) -> Callable:
    q = _ref_quantize(fmt)

    def gn(x, g, kx, kg):
        B = x.shape[0]
        xq = q(x.reshape(B, -1), kx).reshape(x.shape).float()
        gq = q(g.reshape(B, -1), kg).reshape(g.shape).float()
        xx = xq @ xq.transpose(1, 2)
        gg = gq @ gq.transpose(1, 2)
        return (xx * gg).sum(dim=(1, 2))

    return gn


def _ref_kv_write(fmt: str) -> Callable:
    def kvw(k, v, kc, vc, ks, vs, wpos, row0=0, seq_len=None):
        from repro_torch.quant import kv_cache
        kv_cache.kv_write(fmt, k, v, kc, vc, ks, vs, wpos, row0, seq_len)

    return kvw


def _ref_decode_attn(fmt: str) -> Callable:
    def attn(q, kc, vc, ks, vs, pos, *, n_kv, scale, rows=None,
             gather=None):
        from repro_torch.quant import kv_cache
        if rows is None:
            return kv_cache.ref_decode_attn(fmt, q, kc, vc, ks, vs, pos,
                                            n_kv=n_kv, scale=scale)
        part = kv_cache.ref_decode_attn_partial(
            fmt, q, kc, vc, ks, vs, pos, n_kv=n_kv, scale=scale,
            row0=rows[0])
        return kv_cache.attn_merge(gather(part[None], 0)).reshape(q.shape)

    return attn


for _fmt in formats._FORMATS:
    register("quantize", _fmt, "ref", _ref_quantize(_fmt))
    register("matmul", _fmt, "ref", _ref_matmul(_fmt))
    register("ghost_norm", _fmt, "ref", _ref_ghost_norm(_fmt))
register("clip_sum", ANY_FORMAT, "ref", _ref_clip_sum)
for _fmt in ("none", "int8", "luq_fp4"):
    register("kv_write", _fmt, "ref", _ref_kv_write(_fmt))
    register("decode_attn", _fmt, "ref", _ref_decode_attn(_fmt))


# --------------------------------------------------------------------------- #
# cuda backend: the kernels of repro_torch.kernels (LUQ-FP4 quantize,
# matmul and ghost norm; the clip, any format; the two quantized KV
# formats).  Wrappers
# are imported lazily so that importing this module builds and loads
# nothing.
# --------------------------------------------------------------------------- #
def _cuda_quantize(rows, key, flag=None):
    from repro_torch.kernels.ops import luq_quant
    return luq_quant(rows.contiguous(), key, flag=flag)


def _cuda_clip_sum(grads, clip_norm):
    from repro_torch.kernels.ops import clip_and_sum
    return clip_and_sum(grads, float(clip_norm))


def _cuda_matmul(a, b, keys, cols=None, alpha_b=None):
    from repro_torch.kernels.ops import luq_matmul
    a = a.float().contiguous()
    b = b.float().contiguous()
    _, per_row = philox.split_keys(keys, a.shape[0])
    alpha_a = a.abs().amax(dim=1) if per_row else a.abs().amax()
    if alpha_b is None:
        alpha_b = b.abs().amax()
    return luq_matmul(a, b, keys, alpha_a, alpha_b.float(), cols=cols)


def _cuda_ghost_norm(x, g, kx, kg, flag=None, **split):
    """``split``: a shard's scales and index maps (``ghost_norm_sq``'s
    ``alpha_x``, ``alpha_g``, ``map_x``, ``map_g``)."""
    from repro_torch.kernels.ops import ghost_norm_sq
    return ghost_norm_sq(x.contiguous(), g.contiguous(), kx, kg, flag,
                         **split)


_cuda_quantize.reads_flag = True
_cuda_ghost_norm.reads_flag = True


def _cuda_kv_write(fmt: str) -> Callable:
    def kvw(k, v, kc, vc, ks, vs, wpos, row0=0, seq_len=None):
        from repro_torch.kernels.ops import kv_quant_write
        kv_quant_write(k, v, kc, vc, ks, vs, fmt, wpos, row0, seq_len)

    return kvw


def _cuda_decode_attn(fmt: str) -> Callable:
    def attn(q, kc, vc, ks, vs, pos, *, n_kv, scale, rows=None,
             gather=None):
        from repro_torch.kernels import ops
        if rows is None:
            return ops.decode_attn_fused(q, kc, vc, ks, vs, pos, fmt=fmt,
                                         n_kv=n_kv, scale=scale)
        part = ops.decode_attn_split(q, kc, vc, ks, vs, pos, fmt=fmt,
                                     n_kv=n_kv, scale=scale, row0=rows[0],
                                     seq_len=rows[1])
        B, hp, hd = q.shape
        return ops.decode_attn_merge(gather(part[None], 0), pos, batch=B,
                                     n_kv=n_kv, group=hp // n_kv,
                                     head_dim=hd, rows=kc.shape[2],
                                     seq_len=rows[1])

    return attn


register("quantize", "luq_fp4", "cuda", _cuda_quantize)
register("matmul", "luq_fp4", "cuda", _cuda_matmul)
register("clip_sum", ANY_FORMAT, "cuda", _cuda_clip_sum)
register("ghost_norm", "luq_fp4", "cuda", _cuda_ghost_norm)
# kv_fmt="none" has no kernel (there is nothing to dequantize); it falls
# back to ref explicitly through get_impl, like every missing format
for _fmt in ("int8", "luq_fp4"):
    register("kv_write", _fmt, "cuda", _cuda_kv_write(_fmt))
    register("decode_attn", _fmt, "cuda", _cuda_decode_attn(_fmt))
