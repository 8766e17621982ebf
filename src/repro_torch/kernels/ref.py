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
from repro_torch.quant.formats import luq_fp4


def luq_matmul_ref(a, b, ua, ub, alpha_a, alpha_b) -> torch.Tensor:
    """Plain version of ``luq_matmul``: (R, K) x (K, N) -> (R, N) float32.

    ``ub`` is (K, N) (one draw shared by all rows) or (R, K, N) (one draw
    per row); ``alpha_a`` is () or (R,), ``alpha_b`` ().
    """
    aq = luq_fp4(a.float(), ua,
                 torch.as_tensor(alpha_a, device=a.device).reshape(-1, 1))
    if ub.dim() == 2:
        return aq @ luq_fp4(b.float(), ub, alpha_b)
    return torch.cat([aq[i:i + 1] @ luq_fp4(b.float(), ub[i], alpha_b)
                      for i in range(a.shape[0])])


def kv_quant_rows_ref(x: torch.Tensor, fmt: str):
    """Plain version of ``kv_quant_rows``: the ``kv_cache.kv_quant`` math."""
    return kvc.kv_quant(fmt, x)


def decode_attn_ref(q, k_codes, v_codes, k_scale, v_scale, pos, *, fmt: str,
                    n_kv: int, scale: float) -> torch.Tensor:
    """Plain version of ``decode_attn_fused``, in the kernel's form.

    Scores are ``(q . k_unit) * (k_scale * scale)`` and the V scales are
    folded into the probabilities, as the kernel (and the TPU kernel it
    replaces) does; ``kv_cache.ref_decode_attn`` dequantizes first.  The
    two agree to float32 rounding.
    """
    B, hp, hd = q.shape
    g = hp // n_kv
    qg = q.reshape(B, n_kv, g, hd).float()
    if fmt == "int8":
        kunit, vunit = k_codes.float(), v_codes.float()
    else:
        kunit = kvc.fp4_decode_unit(kvc.fp4_unpack(k_codes))
        vunit = kvc.fp4_decode_unit(kvc.fp4_unpack(v_codes))
    scores = torch.einsum("bkgd,bksd->bkgs", qg, kunit)
    scores = scores * (k_scale.float() * scale)[:, :, None, :]
    pos_b = torch.as_tensor(pos, device=q.device).expand(B)
    valid = (torch.arange(k_codes.shape[2], device=q.device)[None, None, None, :]
             <= pos_b[:, None, None, None])
    scores = torch.where(valid, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgs,bksd->bkgd",
                       probs * v_scale.float()[:, :, None, :], vunit)
    return ctx.reshape(B, hp, hd)
