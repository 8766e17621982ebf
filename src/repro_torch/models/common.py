"""Shared model components for serving: init, norm, RoPE, attention, logits.

The serving part of ``repro.models.common``, as plain PyTorch functions on
tensors.  Layouts follow the JAX package: activations (B, S, H, D).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

# Base of the logits head's uniform streams.  A draw at fold f (prefill:
# 2 * prompt_len; decode at position p: 2p + 1) comes from a generator
# seeded LOGITS_SEED * 2**32 + f, the counterpart of the JAX package's
# fold_in(PRNGKey(17), f): prefill and decode never share a stream, and
# the engine and the oneshot driver draw the same bits for the same
# (position, row).
LOGITS_SEED = 17


# --------------------------------------------------------------------------- #
# init helpers
# --------------------------------------------------------------------------- #
def dense_init(shape, in_axis_size, *, generator, device, dtype=torch.float32):
    std = 1.0 / math.sqrt(max(in_axis_size, 1))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.normal_(0.0, std, generator=generator).to(dtype)


def embed_init(shape, *, generator, device, dtype=torch.float32):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.normal_(0.0, 0.02, generator=generator).to(dtype)


# --------------------------------------------------------------------------- #
# norm, rope, attention
# --------------------------------------------------------------------------- #
def rmsnorm(x, scale, eps=1e-6):
    """RMSNorm in the ``1 + scale`` form, computed in float32."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def rope(x, positions, theta=10_000.0):
    """Rotary embedding. x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32, device=x.device)
                      / half)
    ang = positions[..., :, None].float() * freqs
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _softmax_attend(q, k, v, mask, scale):
    """q: (B,Tq,H,D); k,v: (B,Tk,H,D); mask broadcastable (B,H,Tq,Tk)."""
    # float32 scores: the product of two bf16 values is exact in float32,
    # which is what the JAX package's preferred_element_type=f32 computes
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def chunked_causal_attention(q, k, v, *, chunk_q: int,
                             scale: Optional[float] = None):
    """Causal attention in query chunks, each against its band of keys.

    Chunk ``[q0, q1)`` reads only keys ``[0, q1)``, so the work is the
    causal work and the peak memory one (B, H, chunk_q, q1) score block.
    Plain einsum and softmax, as in the JAX package.
    """
    b, s, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    cq = min(chunk_q, s)
    outs = []
    for q0 in range(0, s, cq):
        q1 = min(q0 + cq, s)
        k1 = min(q1, k.shape[1])
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(0, k1, device=q.device)[None, :]
        outs.append(_softmax_attend(q[:, q0:q1], k[:, :k1], v[:, :k1],
                                    (kpos <= qpos)[None, None], scale))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def repeat_kv(x, n_rep: int):
    """(B, S, KV, D) -> (B, S, KV*n_rep, D)."""
    if n_rep == 1:
        return x
    b, s, kv, d = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, d).reshape(
        b, s, kv * n_rep, d)


# --------------------------------------------------------------------------- #
# logits head
# --------------------------------------------------------------------------- #
def logits_generator(fold: int, device) -> torch.Generator:
    """The logits head's uniform stream for one fold (see LOGITS_SEED)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(LOGITS_SEED * 2 ** 32 + int(fold))
    return gen


def qlogits(h, head_t, *, quant_cfg, folds: Union[int, Sequence[int]]):
    """Serving logits through the quantizer-backend dispatcher.

    ``h``: (B, d) final hidden states; ``head_t``: (d, V) output projection
    (``lm_head``, or ``embed.T`` when tied).  With ``fmt="none"`` this is
    the exact float32 product.  Otherwise both operands are quantized by
    the dispatched ``matmul`` op: with one ``folds`` value the whole (B, d)
    block draws from one stream (prefill, lockstep decode); with a list,
    row i quantizes on its own with stream ``folds[i]`` (per-slot decode).
    """
    h32 = h.float()
    if quant_cfg is None or quant_cfg.fmt == "none":
        return h32 @ head_t.float()
    from repro_torch.quant import backend as qbackend
    mm, _ = qbackend.get_matmul(quant_cfg.fmt, quant_cfg.backend)
    if isinstance(folds, int):
        gens = logits_generator(folds, h.device)
    else:
        gens = [logits_generator(f, h.device) for f in folds]
    return mm(h32, head_t.float(), gens)
