"""Plain PyTorch versions of the CUDA kernels, one per kernel.

Each computes the same function as its kernel with the same float32
operations wherever the kernel's result must agree bitwise (the LUQ
rounding, the KV codes and scales).  The wrappers in ``kernels.ops`` run
these for CPU tensors; ``chip_smoke.py`` holds each kernel against them on
the card.
"""
from __future__ import annotations

import torch

from repro_torch.quant import kv_cache as kvc
from repro_torch.quant import philox
from repro_torch.quant.formats import (luq_fp4, luq_fp4_codes, luq_fp4_prep,
                                       luq_fp4_value)


def luq_quant_ref(x, key, codes: bool = False, flag=None) -> torch.Tensor:
    """Plain version of ``luq_quant``: LUQ-FP4 of each row of ``x`` (R, N)
    on its own scale ``max|x[r]|``, every row against the one draw of the
    Philox ``key`` (``quant.philox.row_uniforms``: element n takes uniform
    n), in float32 and returned in ``x``'s dtype; with ``codes``, the bf16
    codes ``Q(x) / alpha`` instead of the values.  ``flag`` (a one-element
    tensor, or None for on): at 0, ``x`` itself (codes: ``x`` in bf16)."""
    xf = x.float()
    u = philox.row_uniforms(key, x.shape[1], x.device)
    alpha = xf.abs().amax(dim=1, keepdim=True)
    if codes:
        out, plain = luq_fp4_codes(xf, u, alpha), x.bfloat16()
    else:
        out, plain = luq_fp4(xf, u, alpha).to(x.dtype), x
    if flag is None:
        return out
    return torch.where(flag.reshape(()) > 0.5, out, plain)


def luq_row_max_ref(x) -> torch.Tensor:
    """Plain version of ``luq_row_max``: (R,) float32 ``max|x[r]|``."""
    return x.float().abs().amax(dim=1)


def luq_round_ref(x, key, alpha, index_map=None, codes: bool = False,
                  flag=None) -> torch.Tensor:
    """Plain version of ``luq_round``: :func:`luq_quant_ref` with each
    row's scale given (``alpha`` (R,)) and, with ``index_map``, each
    element drawing the uniform of its index in the whole row
    (``quant.philox.global_index``): a shard of a row quantized as the
    whole row's slice."""
    xf = x.float()
    n = x.shape[1]
    u = (philox.mapped_uniforms(key, n, index_map, x.device)
         if index_map is not None else philox.row_uniforms(key, n, x.device))
    a = alpha.float().reshape(-1, 1)
    if codes:
        out, plain = luq_fp4_codes(xf, u, a), x.bfloat16()
    else:
        out, plain = luq_fp4(xf, u, a).to(x.dtype), x
    if flag is None:
        return out
    return torch.where(flag.reshape(()) > 0.5, out, plain)


def clip_sumsq_ref(grads: torch.Tensor, cols=None) -> torch.Tensor:
    """Plain version of ``clip_sumsq``: (B,) float32 sums of the squares
    of each row's first ``cols`` columns (all of them by default)."""
    g = grads.float() if cols is None else grads[:, :cols].float()
    return torch.sum(g * g, dim=1)


def clip_apply_ref(grads: torch.Tensor, sumsq: torch.Tensor,
                   clip_norm: float):
    """Plain version of ``clip_apply``: the clipped sum and the norms of
    (B, D) rows whose squared norms ``sumsq`` (B,) are given."""
    g = grads.float()
    norms = torch.sqrt(sumsq.float())
    scale = torch.clamp(clip_norm / torch.clamp(norms, min=1e-12), max=1.0)
    return (g * scale[:, None]).sum(dim=0), norms


def per_sample_clip_ref(grads: torch.Tensor, clip_norm: float):
    """Plain version of ``clip_and_sum``: (B, D) per-example rows ->
    (sum_b min(1, C / max(||g_b||, 1e-12)) * g_b, norms (B,))."""
    g = grads.float()
    norms = torch.sqrt(torch.sum(g * g, dim=1))
    scale = torch.clamp(clip_norm / torch.clamp(norms, min=1e-12), max=1.0)
    return (g * scale[:, None]).sum(dim=0), norms


def ghost_norm_ref(x, g, key_x, key_g, flag=None, alpha_x=None,
                   alpha_g=None, map_x=None, map_g=None) -> torch.Tensor:
    """Plain version of ``ghost_norm_sq``: per example b,
    ``<Q(x_b) Q(x_b)^T, Q(g_b) Q(g_b)^T>`` with x (B, T, Dx), g (B, T, Dg),
    each example quantized on its own scale against the draws of the keys
    ``key_x`` / ``key_g`` shared by the examples (:func:`luq_quant_ref`).
    Returns (B,) float32.  ``flag`` (a one-element tensor, or None for
    on): at 0, the kernel's pass-through, the operands in bf16 unquantized.

    The Grams and their inner product are taken in float64: every value of
    Q(v) is a power of two times alpha, so float32 sums of their products
    all carry alpha's mantissa and round with a bias (2.7e-5 of a Gram
    element from cuBLAS on an H100 at D = 6912, above the kernel's
    tolerance; the kernel, summing the exact codes, is within 1e-7)."""
    B = x.shape[0]

    def q(v, key, alpha, index_map):
        rows = v.reshape(B, -1)
        out = (luq_quant_ref(rows, key) if alpha is None
               else luq_round_ref(rows, key, alpha, index_map))
        if flag is not None:
            out = torch.where(flag.reshape(()) > 0.5, out.float(),
                              rows.bfloat16().float())
        return out.reshape(v.shape).double()

    xq, gq = q(x, key_x, alpha_x, map_x), q(g, key_g, alpha_g, map_g)
    xx = xq @ xq.transpose(1, 2)
    gg = gq @ gq.transpose(1, 2)
    return (xx * gg).sum(dim=(1, 2)).float()


def luq_matmul_ref(a, b, ua, ub, alpha_a, alpha_b) -> torch.Tensor:
    """LUQ-FP4 quantize-both-operands matmul against explicit uniforms, the
    function of the JAX package's ``quant_matmul``: (R, K) x (K, N) ->
    (R, N) float32.

    ``ub`` is (K, N) (one draw shared by all rows) or (R, K, N) (one draw
    per row); ``alpha_a`` is () or (R,), ``alpha_b`` ().
    """
    aq = luq_fp4(a.float(), ua,
                 torch.as_tensor(alpha_a, device=a.device).reshape(-1, 1))
    if ub.dim() == 2:
        return aq @ luq_fp4(b.float(), ub, alpha_b)
    return torch.cat([aq[i:i + 1] @ luq_fp4(b.float(), ub[i], alpha_b)
                      for i in range(a.shape[0])])


def luq_matmul_keys_ref(a, b, keys, alpha_a, alpha_b, *,
                        prep=luq_fp4_prep, value=luq_fp4_value, cols=None
                        ) -> torch.Tensor:
    """Plain version of ``luq_matmul``: :func:`luq_matmul_ref` fed the
    Philox draws of ``keys`` (``repro_torch.quant.philox``'s layout), as
    the kernel draws them.  ``keys``: one ``(k0, k1)`` pair (``a`` one
    matrix, its element ``r * K + k``) or one key a row (row r quantizes
    ``a[r]`` and ``b`` with its own stream): R pairs or the kernel's (R, 2)
    key tensor, whose words are read on its device without a host sync.  ``b`` goes in column chunks,
    so the serving head fits in memory at full size, and each chunk's
    row-independent part is prepared once for every key's draw.

    ``prep(x, alpha)`` and ``value(prepared, u)`` split the quantizer as
    :func:`luq_fp4_prep` and :func:`luq_fp4_value` (the default) split
    LUQ-FP4; the ``ref`` backend passes another stochastic format's.

    ``cols`` ``(col0, n_whole)``: ``b`` is the columns ``col0 ..`` of a
    head ``n_whole`` wide (a vocab shard), its element (k, n) drawn at
    the whole head's index ``k n_whole + col0 + n``; ``alpha_b`` is then
    the whole head's scale.  The shard's quantized operand is the whole
    one's slice, bit for bit.
    """
    R, K = a.shape
    N = b.shape[1]
    col0, n_whole = (0, N) if cols is None else (int(cols[0]), int(cols[1]))
    key_list, per_row = philox.split_keys(keys, R)
    dev = a.device
    alpha_a = torch.as_tensor(alpha_a, dtype=torch.float32,
                              device=dev).reshape(-1).expand(R)
    if per_row:
        ua = torch.stack([philox.uniforms(k, 0, K, dev) for k in key_list])
    else:
        ua = philox.uniforms(key_list[0], 0, R * K, dev).reshape(R, K)
    aq = value(prep(a.float(), alpha_a.reshape(-1, 1)), ua)
    out = torch.empty((R, N), dtype=torch.float32, device=dev)
    for n0, n1 in philox.column_chunks(K, N):
        prepared = prep(b[:, n0:n1].float(), alpha_b)
        for i, key in enumerate(key_list):
            ub = philox.uniforms_2d(key, 1, K, n1 - n0, n_whole,
                                    col0 + n0, dev)
            rows = slice(i, i + 1) if per_row else slice(0, R)
            out[rows, n0:n1] = aq[rows] @ value(prepared, ub)
    return out


def kv_quant_write_ref(k, v, k_codes, v_codes, k_scales, v_scales, fmt: str,
                       wpos=None, row0: int = 0, seq_len=None) -> None:
    """Plain version of ``kv_quant_write``: ``kv_cache.kv_quant`` of the K
    and V rows, written at each row's cache position
    (``kv_cache.kv_write``; a sequence shard's rows alone with ``row0``
    and ``seq_len``)."""
    kvc.kv_write(fmt, k, v, k_codes, v_codes, k_scales, v_scales, wpos,
                 row0, seq_len)


def _kernel_scores(q, k_codes, v_codes, k_scale, fmt: str, n_kv: int,
                   scale: float):
    """The kernel's scores ``(q . k_unit) * (k_scale * scale)`` (B, KV, g,
    S) and the unit V rows."""
    B, hp, hd = q.shape
    qg = q.reshape(B, n_kv, hp // n_kv, hd).float()
    if fmt == "int8":
        kunit, vunit = k_codes.float(), v_codes.float()
    else:
        kunit = kvc.fp4_decode_unit(kvc.fp4_unpack(k_codes))
        vunit = kvc.fp4_decode_unit(kvc.fp4_unpack(v_codes))
    scores = torch.einsum("bkgd,bksd->bkgs", qg, kunit)
    return scores * (k_scale.float() * scale)[:, :, None, :], vunit


def decode_attn_partial_ref(q, k_codes, v_codes, k_scale, v_scale, pos, *,
                            fmt: str, n_kv: int, scale: float,
                            row0: int = 0) -> torch.Tensor:
    """Plain version of ``decode_attn_split``: the kernel's form of one
    sequence shard's part (the rows ``row0 ..`` of the cache), as
    ``kv_cache.attn_partial``'s (B, KV, g, hd + 2)."""
    scores, vunit = _kernel_scores(q, k_codes, v_codes, k_scale, fmt, n_kv,
                                   scale)
    valid = kvc.shard_valid(pos, q.shape[0], k_codes.shape[2], row0,
                            q.device)
    return kvc.attn_partial(scores, valid, vunit, v_scale)


def decode_attn_merge_ref(parts) -> torch.Tensor:
    """Plain version of ``decode_attn_merge``: ``kv_cache.attn_merge`` of
    the ranks' (R, B, KV, g, hd + 2) parts, (B, H, hd)."""
    out = kvc.attn_merge(parts)
    B, n_kv, g, hd = out.shape
    return out.reshape(B, n_kv * g, hd)


def decode_attn_ref(q, k_codes, v_codes, k_scale, v_scale, pos, *, fmt: str,
                    n_kv: int, scale: float) -> torch.Tensor:
    """Plain version of ``decode_attn_fused``, in the kernel's form.

    Scores are ``(q . k_unit) * (k_scale * scale)`` and the V scales are
    folded into the probabilities, as the kernel (and the TPU kernel it
    replaces) does; ``kv_cache.ref_decode_attn`` dequantizes first.  The
    two agree to float32 rounding.
    """
    B, hp, hd = q.shape
    scores, vunit = _kernel_scores(q, k_codes, v_codes, k_scale, fmt, n_kv,
                                   scale)
    valid = kvc.shard_valid(pos, B, k_codes.shape[2], 0, q.device)
    scores = torch.where(valid, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgs,bksd->bkgd",
                       probs * v_scale.float()[:, :, None, :], vunit)
    return ctx.reshape(B, hp, hd)
