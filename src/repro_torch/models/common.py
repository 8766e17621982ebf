"""Shared model components: init, norms, RoPE, attention, projections,
logits, losses.

The counterpart of ``repro.models.common``, as plain PyTorch functions on
tensors: what serving, CNN training (``groupnorm``, ``dense_head``,
``softmax_xent``; the first two also take a ghost pass's per-example
copies), dense-LM, BERT and Mamba-2 training (``qproj``,
``chunked_lm_loss``, ``softmax_xent``, the ghost hook of ``rmsnorm``)
use, the Griffin hybrid's windowed attention, the VLM's masked loss and
the encoder-decoder's sinusoidal positions.  Layouts follow the JAX
package (activations (B, S, H, D)), except ``groupnorm``, which takes the
NCHW activations of the port's convolutions.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

# The logits head's uniform streams.  A draw at fold f (prefill:
# 2 * prompt_len; decode at position p: 2p + 1) is the Philox4x32-10
# stream (repro_torch.quant.philox) of key (f, LOGITS_SEED), the
# counterpart of the JAX package's fold_in(PRNGKey(17), f): prefill and
# decode never share a stream, the engine and the oneshot driver draw the
# same bits for the same (position, row), and so do CPU and card (the
# luq_matmul kernel draws them itself).
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
def rmsnorm(x, scale, eps=1e-6, hooks=None):
    """RMSNorm in the ``1 + scale`` form, computed in float32.  ``hooks``:
    a ghost pass's ``repro_torch.dp.ghost.GhostHooks``, which may swap
    ``scale`` for a per-example copy whose gradient norms it taps; the
    output is the same."""
    if hooks is not None:
        scale = hooks.rmsnorm_scale(scale, x)
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def groupnorm(x, scale, bias, groups=8, eps=1e-5):
    """GroupNorm over the channels of NCHW ``x``, in float32, with
    ``gcd(groups, C)`` groups (the JAX package's rule).  ``scale`` and
    ``bias`` are (C,), or (B, C) per example (a ghost pass's copies,
    ``GhostHooks.leaf``).

    The affine is applied after the normalization, a product and then a
    sum, as functorch's batching rule applies it under ``vmap``: the
    batched ghost passes and the vmap engine then compute the same bits,
    and no ReLU input near 0 takes another side in one of them (a
    fused affine rounds otherwise).

    BatchNorm leaks cross-example statistics and is incompatible with
    per-example DP gradients (Opacus imposes the same replacement).
    """
    g = math.gcd(groups, x.shape[1])
    y = F.group_norm(x.float(), g, None, None, eps)
    return (y * scale[..., None, None] + bias[..., None, None]).to(x.dtype)


def dense_head(x, w, b):
    """``x @ w + b`` of (B, C) features; ``w`` (C, K), or (B, C, K) and
    ``b`` (B, K) per example (a ghost pass's copies)."""
    y = x @ w if w.dim() == 2 else torch.bmm(x[:, None], w)[:, 0]
    return y + b


def softmax_xent(logits, labels, per_example: bool = False):
    """Cross-entropy of integer ``labels``: mean, or (B,) per example."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - tgt
    return nll if per_example else nll.mean()


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


def sinusoidal_positions(seq_len: int, d_model: int, offset: int = 0,
                         device=None):
    """(seq_len, d_model) float32 sinusoidal embeddings of positions
    ``offset .. offset + seq_len - 1``: the sines of the angles
    ``pos / 10000^(2i / d_model)``, then their cosines (the encoder-decoder's
    positions, as in the JAX package)."""
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32,
                       device=device)[:, None]
    dim = torch.arange(d_model // 2, dtype=torch.float32,
                       device=device)[None, :]
    ang = pos / torch.pow(10_000.0, 2 * dim / d_model)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _softmax_attend(q, k, v, mask, scale):
    """q: (B,Tq,H,D); k,v: (B,Tk,H,D); mask broadcastable (B,H,Tq,Tk), or
    None: every key."""
    # float32 scores: the product of two bf16 values is exact in float32,
    # which is what the JAX package's preferred_element_type=f32 computes
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def chunked_causal_attention(q, k, v, *, chunk_q: int, causal: bool = True,
                             window: Optional[int] = None,
                             scale: Optional[float] = None):
    """Attention in query chunks, each against its band of keys.

    Causal: chunk ``[q0, q1)`` reads only keys ``[k0, q1)``, so the work is
    the causal work and the peak memory one (B, H, chunk_q, q1 - k0) score
    block; ``k0`` is 0, or ``max(0, q0 - window)`` with a sliding
    ``window`` (the Griffin hybrid's local attention: query ``p`` sees
    keys ``p - window < kpos <= p``).  ``causal=False`` (the BERT
    encoder): every chunk reads every key, unmasked (the reference's
    all-true mask).  Plain einsum and softmax, as in the JAX package.
    """
    b, s, h, d = q.shape
    tk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    cq = min(chunk_q, s)
    outs = []
    for q0 in range(0, s, cq):
        q1 = min(q0 + cq, s)
        k1 = min(q1, tk) if causal else tk
        k0 = 0 if window is None else max(0, q0 - window)
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(k0, k1, device=q.device)[None, :]
        mask = (kpos <= qpos) if causal else None
        if window is not None:
            band = kpos > qpos - window
            mask = band if mask is None else mask & band
        if mask is not None:
            mask = mask[None, None]
        outs.append(_softmax_attend(q[:, q0:q1], k[:, k0:k1], v[:, k0:k1],
                                    mask, scale))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def repeat_kv(x, n_rep: int):
    """(B, S, KV, D) -> (B, S, KV*n_rep, D)."""
    if n_rep == 1:
        return x
    b, s, kv, d = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, d).reshape(
        b, s, kv * n_rep, d)


# --------------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------------- #
def chunked_lm_loss(h, targets, embed, *, real_vocab: int, ce_chunk: int,
                    mask=None, per_example: bool = False, logits_tap=None,
                    vocab_split=None):
    """Mean next-token cross-entropy without materializing (B, S, V).

    ``h``: (B, S, d) hidden states aligned with ``targets`` (B, S) ints;
    ``embed``: (V_pad, d), logits = h @ embed.T in float32, one sequence
    chunk of ``ce_chunk`` at a time; padded vocab entries are masked.
    ``mask``: an optional (B, S) 0/1 loss mask (the VLM's vision prefix);
    the loss is then the masked NLL sum over the mask's sum (at least 1),
    per example with ``per_example``, as the JAX package normalizes it.
    ``per_example=True`` returns the (B,) per-example mean NLLs (each the
    loss of that example alone: the ghost engine's reweighting target).
    ``logits_tap``: the ghost pass-1 hook, a (B, S, V_pad) zero tensor
    added to the raw logits (its gradient is the logits cotangent the head
    wgrad consumes); it forces ONE chunk and makes the return ``(loss,
    hc)``, ``hc`` the float32 hidden rows that entered the logits GEMM.

    ``vocab_split`` ``(offset, whole)``: ``embed`` holds rows ``offset ..``
    of the ``whole`` padded vocabulary, this rank's shard over the model
    group (vocab parallel): the local logits, the log-sum-exp from the
    group's max and its summed exponentials, and the target's logit from
    the rank that holds its row (a ``logits_tap`` is the local logits').
    """
    from repro_torch.parallel.collectives import (copy_to_model,
                                                  max_over_model,
                                                  reduce_from_model)
    b, s, _ = h.shape
    cc = s if logits_tap is not None else min(ce_chunk, s)
    reduce = (lambda t: t.sum(dim=1)) if per_example else (lambda t: t.sum())
    total = denom = 0.0
    off = 0 if vocab_split is None else vocab_split[0]
    n_loc = embed.shape[0]
    vocab_ok = torch.arange(off, off + n_loc, device=h.device) < real_vocab
    emb32 = embed.float()
    hc_out = None
    for s0 in range(0, s, cc):
        s1 = min(s0 + cc, s)
        hc = h[:, s0:s1].float()
        if vocab_split is not None:
            hc = copy_to_model(hc)
        logits = torch.einsum("bsd,vd->bsv", hc, emb32)
        if logits_tap is not None:
            logits = logits + logits_tap
            hc_out = hc
        logits = torch.where(vocab_ok, logits, -1e30)
        tok = targets[:, s0:s1].long()
        if vocab_split is None:
            lse = torch.logsumexp(logits, dim=-1)
            tgt = torch.gather(logits, -1, tok[..., None])[..., 0]
        else:
            top = max_over_model(logits.amax(dim=-1))
            lse = top + torch.log(reduce_from_model(
                torch.exp(logits - top[..., None]).sum(dim=-1)))
            local = tok - off
            inside = (local >= 0) & (local < n_loc)
            tgt = torch.gather(logits, -1, local.clamp(0, n_loc - 1)[..., None])
            tgt = reduce_from_model(torch.where(inside, tgt[..., 0], 0.0))
        nll = lse - tgt
        if mask is not None:
            mc = mask[:, s0:s1].float()
            nll = nll * mc
            denom = denom + reduce(mc)
        total = total + reduce(nll)
    if mask is not None:
        loss = total / torch.clamp(denom, min=1.0)
    else:
        loss = total / (s if per_example else b * s)
    if logits_tap is not None:
        return loss, hc_out
    return loss


def tp_split(local: int, whole: int, *dims):
    """``qeinsum``'s ``split`` for a projection whose weight holds
    ``local`` of the ``whole`` entries of a dim sharded over the model
    group, ``dims`` that dim's index in x, w and the output (None: the
    operand is whole), or None when nothing is split (one process, or a
    replicated weight)."""
    from repro_torch.parallel.axes import split_of
    s = split_of(local, whole)
    if s is None:
        return None
    return tuple(None if d is None else (d, s[0], s[1]) for d in dims)


def row_parallel(x, w, cd, row):
    """The operands of a projection in the compute dtype ``cd``; for a
    row-parallel one (``row``, its ``split``) in float32, holding the
    same values: its output is then this rank's partial sum in float32,
    rounded to ``cd`` once, after the group's sum (:func:`reduce_partial`),
    as one process's GEMM rounds its float32 sum once."""
    w = w.to(cd)
    if row is None:
        return x, w
    return x.float(), w.float()


def reduce_partial(y, cd):
    """The model group's sum of the float32 partials ``y``, in ``cd``."""
    from repro_torch.parallel.collectives import reduce_from_model
    return reduce_from_model(y).to(cd)


# --------------------------------------------------------------------------- #
# quantized projections and the logits head
# --------------------------------------------------------------------------- #
def qproj(spec, x, w, *, seed: int, flag, quant_cfg, hooks=None,
          per_example: bool = False, split=None):
    """Policy-gated quantized einsum (``repro_torch.quant.fake_quant``);
    without a quant config (serving), the plain einsum.  Operands of two
    dtypes are promoted to one, as ``jnp.einsum`` promotes them.  ``hooks``: a
    ghost pass's ``repro_torch.dp.ghost.GhostHooks``, whose ``qeinsum``
    then runs in its place.  ``per_example``: ``x`` and its cotangent are
    quantized one row per example (the leading axis), the grain of a
    projection that the JAX package runs inside a ``vmap`` over the batch
    (the MoE expert GEMMs).  ``split``: ``qeinsum``'s, the operands'
    dims this rank holds a shard of over the model group."""
    from repro_torch.quant.fake_quant import einsum, qeinsum
    if quant_cfg is None:
        return einsum(spec, x, w)
    kw = {"per_example": True} if per_example else {}
    if split is not None:
        kw["split"] = split
    einsum = qeinsum if hooks is None else hooks.qeinsum
    return einsum(spec, x, w, seed=seed, flag=flag, fmt=quant_cfg.fmt,
                  q_fwd=quant_cfg.quantize_fwd,
                  q_dgrad=quant_cfg.quantize_dgrad,
                  q_wgrad=quant_cfg.quantize_wgrad,
                  backend=quant_cfg.backend, **kw)


def logits_key(fold: int):
    """The logits head's Philox key for one fold (see LOGITS_SEED)."""
    return (int(fold), LOGITS_SEED)


def logits_keys(folds: torch.Tensor) -> torch.Tensor:
    """The (R, 2) int32 key tensor of :func:`logits_key` of each of the (R,)
    ``folds``, built on their device."""
    folds = folds.to(torch.int32)
    return torch.stack([folds, torch.full_like(folds, LOGITS_SEED)], dim=1)


def qlogits(h, head_t, *, quant_cfg,
            folds: Union[int, Sequence[int], torch.Tensor],
            vocab: Optional[int] = None):
    """Serving logits through the quantizer-backend dispatcher.

    ``h``: (B, d) final hidden states; ``head_t``: (d, V) output projection
    (``lm_head``, or ``embed.T`` when tied).  With ``fmt="none"`` this is
    the exact float32 product.  Otherwise both operands are quantized by
    the dispatched ``matmul`` op: with one ``folds`` value the whole (B, d)
    block draws from one stream (prefill, lockstep decode); with a list or
    a (B,) tensor, row i quantizes on its own with stream ``folds[i]``
    (per-slot decode; a tensor's keys are built and read on its device, so
    nothing of them goes through the host).

    Vocab parallel (``vocab``, the whole head's width, and ``head_t``
    this rank's (d, V / m) columns of it over the model group): ``h`` is
    whole on every rank and draws from the same keys, the head's scale is
    the group's max of the shards' (``max_over_model``), each column
    draws at its index in the whole head (the ``matmul`` op's ``cols``),
    and the (B, V / m) logits are gathered to (B, V) in rank order
    (``gather_from_model``): every rank holds the whole head's logits,
    bit for bit those of one process's ``cuda`` backend.  At ``none``
    the local float32 product, gathered.
    """
    from repro_torch.parallel.axes import split_of
    from repro_torch.parallel.collectives import (gather_from_model,
                                                  max_over_model)
    split = None if vocab is None else split_of(head_t.shape[1], vocab)
    h32 = h.float()
    head = head_t.float()
    if quant_cfg is None or quant_cfg.fmt == "none":
        out = h32 @ head
    else:
        from repro_torch.quant import backend as qbackend
        mm, _ = qbackend.get_matmul(quant_cfg.fmt, quant_cfg.backend)
        if isinstance(folds, torch.Tensor):
            keys = logits_keys(folds)
        elif isinstance(folds, int):
            keys = logits_key(folds)
        else:
            keys = [logits_key(f) for f in folds]
        kw = {}
        if split is not None:
            kw = {"cols": split,
                  "alpha_b": max_over_model(head.abs().amax().reshape(1))[0]}
        out = mm(h32, head, keys, **kw)
    return out if split is None else gather_from_model(out, -1)
