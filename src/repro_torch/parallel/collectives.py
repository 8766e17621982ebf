"""Collectives of the data-parallel step, over ``torch.distributed``.

The counterpart of ``repro.parallel.collectives``.  Each takes the
:class:`~repro_torch.launch.mesh.AxisGroup` of the ranks it reduces over
and does nothing for a group of one (``group`` None).  The reference's
``compat_shard_map`` has no counterpart: a rank already runs its own
block of the batch, so the rank-local body of the sharded ghost driver
(``repro_torch.dp.ghost.sharded_ghost_clipped_grad_sum``) takes its
place, with these calls where the reference's body has ``psum`` and
``all_gather``.

Every collective of training is an ``all_reduce`` (SUM or MAX), which
both backends have for CUDA tensors: gloo on CUDA tensors has only
``broadcast`` and ``all_reduce``.  :func:`gather_rows` is therefore a SUM
of a zero-filled buffer that each rank fills at its own offset; adding
zeros is exact.  :func:`gather_from_model` takes an ``all_gather`` where
the backend has one for the tensor.

The model group's collectives (``model_all_reduce``, :func:`copy_to_model`,
:func:`reduce_from_model`, :func:`max_over_model`, and serving's
:func:`gather_from_model`) run inside the model
code of a rank that holds a shard of each layer (``repro_torch.parallel.
axes``), also under the vmap engine's ``vmap(grad_and_value(...))``: the
reduction is the custom op ``repro_torch::model_all_reduce``, whose vmap
rule reduces the whole batched tensor at once (elementwise, so the batch
dim passes through), and the two differentiable ones are autograd
functions around it (Megatron's ``f`` and ``g``).  Each reduces in
float32 (gloo has no bf16 sum on every build; a sum of one rank's value
and zeros is exact) and is counted in :data:`MODEL_REDUCES`.

``compressed_psum_pods``: int8-compressed all-reduce over the ``pod``
axis.  Cross-pod links are the scarcest bandwidth at multi-pod scale,
and DP-SGD gradients are unusually compressible because injected
Gaussian noise dominates them.  Each leaf is quantized to int8 against
one pod-wide max-abs scale with stochastic rounding (unbiased), summed
as int32 over the pods, and multiplied back by the scale.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from repro_torch.parallel import axes

#: Collectives over the model group since :func:`reset_model_reduces`
#: (all-reduces, and serving's gathers, :func:`gather_from_model`): their
#: number and the bytes each rank sent into them.
MODEL_REDUCES = {"count": 0, "bytes": 0}

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reset_model_reduces() -> None:
    MODEL_REDUCES["count"] = MODEL_REDUCES["bytes"] = 0


def model_reduce_(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``x`` (float32, contiguous) reduced in place over this rank's model
    group (nothing without one); returns it."""
    axis = axes.model_axis()
    if axis is not None:
        dist.all_reduce(x, op=_REDUCE_OPS[op], group=axis.group)
        MODEL_REDUCES["count"] += 1
        MODEL_REDUCES["bytes"] += x.numel() * x.element_size()
    return x


@torch.library.custom_op("repro_torch::model_all_reduce", mutates_args=())
def model_all_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """A float32 copy of ``x`` reduced (``op``: "sum" or "max") over the
    model group."""
    return model_reduce_(x.float().contiguous().clone(), op)


@model_all_reduce.register_fake
def _(x, op):
    return torch.empty_like(x, dtype=torch.float32)


def _model_all_reduce_vmap(info, in_dims, x, op):
    """Batched: the whole batched tensor in one reduction."""
    return model_all_reduce(x, op), in_dims[0]


model_all_reduce.register_vmap(_model_all_reduce_vmap)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the cotangent summed over the model group."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        # through the autograd function: a bare custom op call here, under
        # torch.func's grad, would take the op's generated autograd
        # function, which torch.func refuses
        return _ReduceFromModel.apply(g)


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model group forward; identity backward."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return model_all_reduce(x, "sum").to(x.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g


class _MaxOverModel(torch.autograd.Function):
    """The max over the model group forward; no gradient.  (A bare call
    of the custom op inside ``grad_and_value`` would take the op's
    generated autograd function, which torch.func refuses.)"""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return model_all_reduce(x, "max").to(x.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Before a column-parallel projection: ``x`` itself, its cotangent
    (each rank's part) summed over the model group."""
    return x if axes.model_axis() is None else _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """After a row-parallel projection: the ranks' partial ``x`` summed
    (in float32, returned in ``x``'s dtype); the cotangent passes."""
    return x if axes.model_axis() is None else _ReduceFromModel.apply(x)


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the model group, with no
    gradient (a log-sum-exp's shift)."""
    if axes.model_axis() is None:
        return x.detach()
    return _MaxOverModel.apply(x.detach())


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's ``x`` concatenated along ``dim`` in rank order
    (the group's index), on every rank; ``x`` itself without a group.
    Serving's gather (the vocab shards of the logits, the query heads, the
    split attention's partials), under ``no_grad``: no autograd rule.
    An ``all_gather``, except under gloo on CUDA tensors, which has only
    ``broadcast`` and ``all_reduce``: there an ``all_reduce`` SUM of a
    float32 zero buffer that each rank fills at its own block (adding
    zeros keeps every value but a -0, which becomes +0).  Counted in
    :data:`MODEL_REDUCES` with the bytes this rank sent."""
    axis = axes.model_axis()
    if axis is None:
        return x
    x = x.contiguous()
    dim = dim % x.dim()
    if x.is_cuda and dist.get_backend(axis.group) == "gloo":
        # in float32 (gloo has no bf16 sum on every build; the round trip
        # of a bf16 value and the sum with zeros are exact)
        buf = x.new_zeros((axis.size,) + tuple(x.shape), dtype=torch.float32)
        buf[axis.index] = x
        dist.all_reduce(buf, group=axis.group)
        parts = buf.to(x.dtype).unbind(0)
    else:
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x, group=axis.group)
    MODEL_REDUCES["count"] += 1
    MODEL_REDUCES["bytes"] += x.numel() * x.element_size()
    return torch.cat(parts, dim=dim)


def all_reduce_sum(tree: Dict[str, torch.Tensor],
                   axis) -> Dict[str, torch.Tensor]:
    """The sum over ``axis``'s ranks of a dict of float32 tensors: ONE
    ``all_reduce`` of their concatenation; returns views of it."""
    if axis.group is None:
        return tree
    flat = torch.cat([t.reshape(-1) for t in tree.values()])
    dist.all_reduce(flat, group=axis.group)
    out, start = {}, 0
    for name, t in tree.items():
        out[name] = flat[start:start + t.numel()].view(t.shape)
        start += t.numel()
    return out


def gather_rows(x: torch.Tensor, axis) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 in rank order (the
    group's index), on every rank: an ``all_reduce`` SUM of a zero
    (size, *x.shape) buffer that each rank fills at its own row."""
    if axis.group is None:
        return x
    buf = x.new_zeros((axis.size,) + tuple(x.shape))
    buf[axis.index] = x
    dist.all_reduce(buf, group=axis.group)
    return buf.reshape((-1,) + tuple(x.shape[1:]))


def all_reduce_max(x: torch.Tensor, axis) -> torch.Tensor:
    """The elementwise max over ``axis``'s ranks, in place."""
    if axis.group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=axis.group)
    return x


def compressed_psum_pods(partials: Dict[str, torch.Tensor], mesh,
                         seed: int) -> Dict[str, torch.Tensor]:
    """Reduce this pod's partial gradients over the ``pod`` axis.

    ``partials``: ``{name: this rank's pod partial}`` (the reference's
    leaves carry a leading pods dim sharded over "pod"; here a rank holds
    its pod's slice).  Per leaf ``i``: the scale is the pod-wide max of
    ``|x|`` over 127 (one MAX all-reduce; 1 where that is 0), the codes
    ``clip(floor(x / scale) + (u < frac), -127, 127)`` with ``u`` drawn
    from a generator seeded ``seed * 2**16 + i``, their int32 sum over the
    pods multiplied back by the scale.  ``seed`` must be below 2**15 (a
    CPU generator keeps 32 bits of its seed); the same on every rank.
    """
    if not 0 <= seed < 2 ** 15:
        raise ValueError(f"seed must be in [0, 2**15), got {seed}")
    axis = mesh.axis_group(("pod",))
    out = {}
    for i, (name, part) in enumerate(partials.items()):
        x = part.float()
        scale = all_reduce_max(x.abs().max() / 127.0, axis)
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        y = x / scale
        lo = torch.floor(y)
        gen = torch.Generator(device=x.device).manual_seed(seed * 2 ** 16 + i)
        u = torch.rand(x.shape, generator=gen, device=x.device)
        q = torch.clamp(lo + (u < (y - lo)).float(), -127, 127)
        q = q.to(torch.int8).to(torch.int32)
        if axis.group is not None:
            dist.all_reduce(q, group=axis.group)
        out[name] = q.float() * scale
    return out


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_CHUNK = 1 << 24        # elements a step: 128 MB of int64 temporaries


def fingerprint(tensors) -> torch.Tensor:
    """Two int64 words per tensor that change with any bit of it: the sum
    of its elements' bit patterns and their sum weighted by position (both
    wrapping), computed ``_CHUNK`` elements at a time."""
    out = []
    for t in tensors:
        bits = t.detach().reshape(-1).view(_BITS[t.element_size()])
        acc = torch.zeros(2, dtype=torch.int64, device=t.device)
        for s in range(0, bits.numel(), _CHUNK):
            c = bits[s:s + _CHUNK].to(torch.int64)
            pos = torch.arange(s + 1, s + 1 + c.numel(), device=t.device)
            acc[0] += c.sum()
            acc[1] += (c * pos).sum()
        out.append(acc)
    return torch.cat(out)


def replicas_agree(tensors, axis) -> bool:
    """Whether every rank of ``axis`` holds the same bits in ``tensors``:
    ONE all-reduce MAX of their fingerprints and the fingerprints negated
    (the max and the min at once)."""
    fp = fingerprint(tensors)
    both = all_reduce_max(torch.cat([fp, -fp]), axis)
    hi, neg_lo = both.chunk(2)
    return bool(torch.equal(hi, -neg_lo))
