"""Per-example gradient clipping for DP-SGD.

The counterpart of ``repro.dp.clip``.  The batch is split into
microbatches; within a microbatch the per-example gradients come from
``torch.func.vmap(grad_and_value(...))``, and a Python loop over the
microbatches accumulates the *sum of clipped* gradients.  Peak live state
is one gradient accumulator plus one microbatch of per-example gradients.

Two clip paths with the same metrics: ``"ref"`` takes per-leaf norms and
a scaled sum in PyTorch; ``"fused"`` flattens the microbatch's
per-example gradients to one (B, D) matrix and runs the ``clip_sum`` op,
on CUDA the ``per_sample_clip`` kernel (``repro_torch.kernels``).

Data parallel (``shard``, the ``AxisGroup`` of the ranks that split each
microbatch): rank r computes its block of every microbatch, as the
reference's ``micro_constrain`` shards the microbatch's example axis
over the data axes.  Without ``partial_accum`` the ranks sum each
microbatch's clipped sum (one all-reduce a microbatch, where the
reference's sharded einsum reduces); with it each rank keeps its own sum
and the ranks reduce once, at the end.  The norms and losses are
gathered once, in batch order.

Model parallel (a model group in ``repro_torch.parallel.axes``): each
rank holds only its shards of the split leaves, so its per-example rows
hold only its columns.  Each rank takes its rows' squared norms, the
group sums them (one all-reduce of (B,) a microbatch), and the clipped
sum follows from the norms.  A leaf replicated over the group
(``replicated``: the norm scales, a replicated KV projection, the
router) is the same on every rank and counted once, by the group's
first rank.  The fused path lays the replicated leaves after the split
ones and runs the kernel's two passes apart (``clip_sumsq`` over the
split columns, or every column on the first rank, then ``clip_apply``).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import grad_and_value, vmap

from repro_torch.parallel import axes
from repro_torch.parallel.collectives import (all_reduce_sum, gather_rows,
                                              model_reduce_)


def _fused_clip_sum(grads: dict, mb: int, clip_norm: float,
                    replicated: frozenset = frozenset()):
    """Flatten per-example grads to (B, D), clip and sum them in the
    ``clip_sum`` op, unflatten the summed row.  On a model group the
    split leaves come first, the norms are summed over the group
    (module docstring)."""
    from repro_torch.quant import backend as qbackend
    split = axes.model_axis() is not None
    order = (sorted(grads, key=lambda k: k in replicated) if split
             else list(grads))
    flat = torch.cat([grads[k].reshape(mb, -1).float() for k in order],
                     dim=1)
    if split:
        from repro_torch.kernels import ops
        cols = (flat.shape[1] if axes.model_index() == 0 else
                sum(grads[k][0].numel() for k in order
                    if k not in replicated))
        sumsq = model_reduce_(ops.clip_sumsq(flat, cols), "sum")
        clipped_flat, norms = ops.clip_apply(flat, sumsq, clip_norm)
    else:
        clip_impl, _ = qbackend.get_clip_sum("fused")
        clipped_flat, norms = clip_impl(flat, clip_norm)
    del flat
    clipped, start = {}, 0
    for name in order:
        g = grads[name]
        size = g[0].numel()
        clipped[name] = clipped_flat[start:start + size].reshape(g.shape[1:])
        start += size
    return {k: clipped[k] for k in grads}, norms


def per_example_clipped_grad_sum(
    loss_fn: Callable,
    params: dict,
    batch: dict,
    *,
    clip_norm: float,
    microbatch_size: int,
    clip_backend: str = "ref",
    accum_dtype: torch.dtype = torch.float32,
    shard=None,
    partial_accum: bool = False,
    replicated: frozenset = frozenset(),
) -> Tuple[dict, dict]:
    """Sum over the batch of per-example clipped gradients.

    ``loss_fn(params, example)`` returns the scalar loss of ONE example
    (leading batch dim already stripped).  Returns ``(grad_sum, metrics)``:
    the sums in ``accum_dtype``; ``metrics`` holds the mean loss, the mean
    and max per-example gradient norm and the fraction of examples
    clipped, as 0-dim tensors on the params' device (no host sync).
    ``shard``: a ``repro_torch.launch.mesh.AxisGroup`` over which each
    microbatch (``microbatch_size`` examples, the global microbatch) is
    split, or None; ``partial_accum``: one reduction a step instead of
    one a microbatch (module docstring).  ``replicated``: the leaves
    the model group holds whole (counted once; module docstring).
    """
    if clip_backend not in ("ref", "fused"):
        raise ValueError(f"clip_backend must be 'ref' or 'fused', "
                         f"got {clip_backend!r}")
    if partial_accum and clip_backend == "fused":
        raise ValueError("clip_backend='fused' sums the whole microbatch in "
                         "the kernel and cannot keep per-shard partial "
                         "sums; disable partial_accum or use 'ref'")
    n = next(iter(batch.values())).shape[0]
    mb = microbatch_size
    if n % mb != 0:
        raise ValueError(f"batch {n} not divisible by microbatch {mb}")
    parts = 1 if shard is None else shard.size
    if mb % parts != 0:
        raise ValueError(f"microbatch {mb} not divisible over {parts} ranks")
    local = mb // parts
    lo = 0 if shard is None else shard.index * local
    # randomness="same": the quantizers draw inside the vmapped function,
    # one draw shared by every example (as the JAX package's unbatched key)
    per_example = vmap(grad_and_value(loss_fn), in_dims=(None, 0),
                       randomness="same")

    acc = {k: torch.zeros_like(p, dtype=accum_dtype)
           for k, p in params.items()}
    device = next(iter(params.values())).device
    loss_sum = torch.zeros((), dtype=torch.float32, device=device)
    all_norms = []
    for i in range(n // mb):
        start = i * mb + lo
        micro = {k: v[start:start + local] for k, v in batch.items()}
        grads, losses = per_example(params, micro)
        if clip_backend == "fused":
            clipped, norms = _fused_clip_sum(grads, local, clip_norm,
                                             replicated)
        else:
            once = axes.model_index() == 0
            sq = sum(g.float().square().sum(dim=tuple(range(1, g.dim())))
                     for k, g in grads.items()
                     if once or k not in replicated)
            if axes.model_axis() is not None:
                sq = model_reduce_(sq.contiguous(), "sum")
            norms = torch.sqrt(sq)
            scale = torch.clamp(clip_norm / torch.clamp(norms, min=1e-12),
                                max=1.0)
            clipped = {k: torch.einsum("b...,b->...", g.float(), scale)
                       for k, g in grads.items()}
        del grads
        if shard is not None and not partial_accum:
            clipped = all_reduce_sum(clipped, shard)
        for k in acc:
            acc[k] += clipped[k].to(accum_dtype)
        loss_sum += losses.sum()
        all_norms.append(norms)

    norms = torch.cat(all_norms)
    if shard is not None:
        if partial_accum:
            acc = {k: v.to(accum_dtype) for k, v in all_reduce_sum(
                {k: v.float() for k, v in acc.items()}, shard).items()}
        # (ranks, microbatches x local norms + the loss sum), in batch order
        rows = gather_rows(torch.cat([norms, loss_sum.reshape(1)])[None],
                           shard)
        loss_sum = rows[:, -1].sum()
        norms = rows[:, :-1].reshape(parts, n // mb, local).transpose(
            0, 1).reshape(-1)
    metrics = {
        "loss": loss_sum / n,
        "grad_norm_mean": norms.mean(),
        "grad_norm_max": norms.max(),
        "clip_fraction": (norms > clip_norm).float().mean(),
    }
    return acc, metrics
