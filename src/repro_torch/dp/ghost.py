"""Ghost-norm two-pass DP-SGD gradient engine (``DPConfig.grad_mode="ghost"``).

The counterpart of ``repro.dp.ghost``, with its data-parallel driver
(:func:`sharded_ghost_clipped_grad_sum`: both passes on each rank's block
of the batch, one all-reduce of the clipped sums).  The vmap path
(``repro_torch.dp.clip``) materializes every per-example gradient: O(B
x params) live memory.  Ghost clipping computes the same clipped sum
without it:

pass 1 -- norms
    One batched forward and backward per chunk of ``ghost_microbatch``
    examples.  Every hooked layer (each projection, through
    :meth:`GhostHooks.qeinsum`, and each convolution, through
    :meth:`GhostHooks.qconv2d`) is tapped by the pass's (B,) tap tensor,
    whose gradient is defined as the per-example squared weight-gradient
    norm, without forming the per-example gradient:

        || x_b^T g_b ||_F^2  =  < x_b x_b^T , g_b g_b^T >     (Gram identity)

    from two (T, T) Grams when T^2 <= |w|, else from the direct (din,
    dout) product squared and summed (mixed ghost norm).  With a quantized
    wgrad on a backend that implements the ``ghost_norm`` op natively
    (``cuda``: luq_fp4) the Gram route is ONE call of the ``ghost_norm``
    kernel per layer and chunk: quantize, Grams and reduce for all B
    examples.  A convolution's wgrad is the same product over its
    patches: ``F.unfold``'s columns of the padded input give one (Cin kh
    kw) row per output position, aligned with the (Ho Wo, Cout) cotangent
    rows (:func:`_conv_tap_sq_norm`; its Grams and products are plain
    ``torch`` matmuls, as the JAX package's are plain XLA).  A dilated or
    grouped convolution is outside that identity and takes, for that
    layer only, the squared norm of each example's own wgrad.
    The rmsnorm scales are tapped by :func:`tap_scale` and the embedding
    and LM head by the model's :class:`GhostAux`: the token-equality
    masked Gram of the gather cotangents, the head's mixed ghost norm and,
    for tied embeddings, their cross term.  The JAX package runs pass 1
    under ``vmap``, one example per lane; here the batch stays batched and
    the quantizers run per example.  Pass 1 needs no weight gradients: the
    params go in detached.

    Leaves that no hook covers (the CNNs' GroupNorm scales and biases and
    their dense head) take the norm-only fallback: in pass 1 the model
    asks :meth:`GhostHooks.leaf` for each of them and gets a per-example
    copy, (B, *shape), whose gradient is that example's own and whose
    squared norm goes to the tap (:func:`tap_leaf`).  The JAX package
    vmaps pass 1 over the examples and differentiates these leaves in
    each lane; here the pass stays batched, so the per-example state is
    B copies of the fallback leaves, what ``per_example_state_bytes``
    counts, and the step stays one CUDA graph.

pass 2 -- grads
    The gradient of ``sum_b scale_b * loss_b`` over the batched model,
    whose quantizers also quantize the batched operands per example: one
    standard backward whose weight gradients are the clipped gradient SUM.
    LUQ's per-tensor max scaling is positively scale-invariant, ``Q(s g) =
    s Q(g)``, exactly when ``s g`` is exact (``s`` a power of two, or no
    clipping); then this is the vmap path's sum of clipped quantized
    per-example gradients.

The engine hands the model's loss a :class:`GhostHooks` for each pass
(``per_example_loss_fn(params, batch, hooks)``); the model threads it to
its projections (``common.qproj``), convolutions, norms
(``common.rmsnorm``) and fallback leaves.  The quantizer layer knows
nothing of the engine.

Floating point.  Both passes equal the vmap path in exact arithmetic, and
to float32 tolerance when nothing rounds to a grid (fmt ``none``, the
tests' identity format).  Under LUQ they agree only as far as the GEMMs
sum in the same order: the rounding is a step function of its input and
of the operand's max, so another batch shape (a chunk of 4 examples
against one), or an inexact ``s g``, moves the odd value across a step,
and the flipped code changes everything downstream.  On an H100 at
stablelm-3b's full width (2 layers, ``chip_smoke.py``, PERF.md section
7), pass-1 norms of a chunk of 4 and of one-example chunks differ by
8.5e-6 relative in bf16 and 2.5e-6 in float32 at fmt none, and by 2.1e-4
and 1.2e-3 at luq_fp4.  In bf16 the forward operands are bitwise the
same; the float32 logits head's backward differs in ulps, which flips 6
LUQ codes of the last projection's cotangent and, layer by layer, up to a
third of them.  In float32 the batched GEMMs' ulps survive in the forward
too, so codes flip from the first attention output on.

Model parallel (a model group in ``repro_torch.parallel.axes``; the
dense LMs).  The Gram identity adds over a split dim: a column-parallel
projection's tap is ``sum(X X^T o G_s G_s^T)``, a row-parallel one's
``sum(X_s X_s^T o G G^T)``, each rank's part of the norm; the vocab-
parallel embedding and head give parts too (the model's ``GhostAux``).
Pass 1 sums the (B,) parts over the group once a chunk.  A leaf the
group holds whole (the norm scales, a replicated KV projection) has its
whole norm on every rank and is counted by the group's first rank
alone; the others compute it too and count it zero, so every rank runs
the same ops and collectives.  A split operand's quantization takes its
global scales and index map, in the fused kernel too.  Pass 2's scales
are then the same on every rank, and pass 2 needs no collective of its
own beyond the model's.

The dense LMs have no fallback leaves (``per_example_state_bytes`` shows
0); a leaf that no hook covers and the model's loss does not pass to
:meth:`GhostHooks.leaf` raises.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.parallel import axes
from repro_torch.parallel.collectives import (all_reduce_sum, gather_rows,
                                              model_reduce_)
from repro_torch.parallel.partitioner import axis_sizes, local_slice
from repro_torch.quant import backend as qbackend
from repro_torch.quant import fake_quant
from repro_torch.quant.formats import STOCHASTIC_FORMATS


# --------------------------------------------------------------------------- #
# the hooks a ghost pass hands the model
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class GhostHooks:
    """What the hooked ops of a model do in one ghost pass.  The engine
    passes it to the model's loss (``hooks=``), which threads it to
    ``common.qproj``, its convolutions, ``common.rmsnorm`` and the leaves
    no hook covers; without it they run as usual.

    Both passes quantize the batched operands per example.  With a ``tap``
    ((B,) float32, pass 1) every projection and convolution also adds its
    per-example squared weight-gradient norms into the tap's gradient,
    and so do, with ``norm_scales``, every rmsnorm scale and every leaf
    named in ``fallback``; without one (pass 2) nothing is tapped.
    ``tapped`` collects the fallback leaves the model passed to
    :meth:`leaf` (the engine checks that none was left out)."""
    tap: Optional[torch.Tensor] = None
    norm_scales: bool = False
    fallback: frozenset = frozenset()
    tapped: set = dataclasses.field(default_factory=set, compare=False)

    def qeinsum(self, spec: str, x: torch.Tensor, w: torch.Tensor, **kw):
        """``fake_quant.qeinsum`` in per-example mode; in pass 1 tapped by
        :func:`_tap_sq_norm` (quantized or not: every projection's weight
        has a norm)."""
        return fake_quant.qeinsum(spec, x, w, per_example=True, tap=self.tap,
                                  tap_norm=_tap_sq_norm, **kw)

    def qconv2d(self, x: torch.Tensor, w: torch.Tensor, **kw):
        """``fake_quant.qconv2d`` in per-example mode; in pass 1 tapped by
        :func:`_conv_tap_sq_norm`."""
        return fake_quant.qconv2d(x, w, per_example=True, tap=self.tap,
                                  tap_norm=_conv_tap_sq_norm, **kw)

    def rmsnorm_scale(self, scale: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
        """``scale``, or in pass 1 with ``norm_scales`` its per-example
        copy (:func:`tap_scale`), counted once on a model group."""
        if self.tap is None or not self.norm_scales:
            return scale
        return tap_scale(scale, self.tap, x, count=_once())

    def leaf(self, name: str, value: torch.Tensor, n: int) -> torch.Tensor:
        """The param ``name``: ``value`` itself, or in pass 1, when no hook
        covers it, its per-example copy for the ``n`` examples, (n,
        *value.shape) (:func:`tap_leaf`).  A model calls it once per leaf
        and pass."""
        if self.tap is None or name not in self.fallback:
            return value
        if name in self.tapped:
            raise ValueError(f"ghost fallback leaf {name!r} taken twice in "
                             f"one pass: its copies' norms would not add up")
        self.tapped.add(name)
        return tap_leaf(value, self.tap, n)


# --------------------------------------------------------------------------- #
# model-supplied auxiliary hooks (embedding / LM head)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class GhostAux:
    """Pass-1 hooks for leaves whose per-example norm needs more than a
    per-op tap (the gather-scattered embedding, the loss-side head and,
    tied, their cross term).

    ``make_taps(batch) -> {name: zero tensor}``
        added into the model's dataflow; their gradients are what the
        norms need.
    ``tapped_loss(params, batch, taps, hooks) -> ((B,) losses, fwd_aux)``
        the per-example losses with the taps added, under the pass's
        :class:`GhostHooks`.
    ``combine(tap_grads, fwd_aux, batch) -> (B,)``
        the aux-covered leaves' per-example squared norms.
    ``covers(params) -> {name: bool}``
        the leaves covered by the aux hooks (and the norm-scale hooks when
        ``hook_norm_scales``).
    """
    make_taps: Callable
    tapped_loss: Callable
    combine: Callable
    covers: Callable
    hook_norm_scales: bool = False


def effective_hooked_mask(params, hooked_mask: dict,
                          aux: Optional[GhostAux]) -> dict:
    """The op-level hook mask OR the aux-covered leaves."""
    if aux is None:
        return dict(hooked_mask)
    covered = aux.covers(params)
    return {k: bool(m) or bool(covered[k]) for k, m in hooked_mask.items()}


def _check_mask(params, hooked_mask: dict) -> None:
    if set(hooked_mask) != set(params):
        raise ValueError("ghost hooked_mask names do not match the params "
                         f"({sorted(set(hooked_mask) ^ set(params))})")


# --------------------------------------------------------------------------- #
# per-example squared weight-gradient norms
# --------------------------------------------------------------------------- #
def gram_route_wins(t: int, din: int, dout: int) -> bool:
    """The mixed-ghost-norm rule, in one place: Gram when T^2 is no larger
    than the weight (direct-product) size."""
    return t * t <= din * dout


def _matpair_sq_norm(xmat: torch.Tensor, gmat: torch.Tensor) -> torch.Tensor:
    """Per example b, ``||xmat_b^T gmat_b||_F^2`` of (B, T, Din) and (B, T,
    Dout) float views: two (T, T) Grams when they are cheaper, else the
    direct (Din, Dout) product squared and summed.  Returns (B,)."""
    x = xmat.float()
    g = gmat.float()
    if gram_route_wins(x.shape[1], x.shape[2], g.shape[2]):
        xx = x @ x.transpose(1, 2)
        gg = g @ g.transpose(1, 2)
        return (xx * gg).sum(dim=(1, 2))
    dw = x.transpose(1, 2) @ g
    return dw.square().sum(dim=(1, 2))


@functools.lru_cache(maxsize=None)
def _spec_axes(spec: str) -> Tuple[str, str, str, str, str, str]:
    """Split an einsum spec into (x_term, w_term, out_term, T, din, dout):
    T = x axes not contracted into w (batch, sequence), din = x axes shared
    with w, dout = w axes kept in the output."""
    lhs, out_term = spec.replace(" ", "").split("->")
    x_term, w_term = lhs.split(",")
    t_ax = "".join(c for c in x_term if c not in w_term)
    din = "".join(c for c in x_term if c in w_term)
    dout = "".join(c for c in w_term if c not in x_term)
    if set(t_ax) - set(out_term) or set(dout) - set(out_term):
        raise ValueError(f"einsum spec {spec!r} is not a ghost-hookable "
                         f"projection (x-batch or w-out axes missing from "
                         f"the output)")
    return x_term, w_term, out_term, t_ax, din, dout


def _einsum_matviews(spec: str, x: torch.Tensor, g: torch.Tensor):
    """``(xmat (B, T, Din), gmat (B, T, Dout), contiguous)``: per-example
    matrix views of the wgrad GEMM's operands, whose leading axis (the
    first of x and of the output) is the examples'.  ``contiguous`` is
    True when both views are pure reshapes (no axis moved): the condition
    under which uniforms drawn over a matrix view match the draws over the
    tensor element for element."""
    x_term, _, out_term, t_ax, din, dout = _spec_axes(spec)
    if not (x_term[0] == t_ax[0] == out_term[0]):
        raise ValueError(f"einsum spec {spec!r}: the leading axis of x and "
                         f"of the output must be the examples'")
    sizes = {**dict(zip(x_term, x.shape)), **dict(zip(out_term, g.shape))}
    B = x.shape[0]
    T = math.prod(sizes[c] for c in t_ax[1:])
    xmat = torch.einsum(f"{x_term}->{t_ax}{din}", x).reshape(
        B, T, math.prod(sizes[c] for c in din))
    gmat = torch.einsum(f"{out_term}->{t_ax}{dout}", g).reshape(
        B, T, math.prod(sizes[c] for c in dout))
    contiguous = (x_term == t_ax + din) and (out_term == t_ax + dout)
    return xmat, gmat, contiguous


def _einsum_sq_norm(spec: str, xq, gq) -> torch.Tensor:
    """(B,) squared norms of ``dw`` for ``out = einsum(spec, x, w)`` from
    the wgrad GEMM's inputs (already quantized when the wgrad is)."""
    xmat, gmat, _ = _einsum_matviews(spec, xq, gq)
    return _matpair_sq_norm(xmat, gmat)


def _once() -> float:
    """The weight of a norm every rank of the model group computes whole:
    1 on its first rank (or without a group), 0 on the others."""
    return float(axes.model_index() == 0)


def _tap_sq_norm(spec, x: torch.Tensor, g: torch.Tensor,
                 flag: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (B,) per-example squared wgrad norms a ghost einsum emits: this
    rank's part for a weight split over the model group, the whole norm
    counted once for a replicated one (:func:`_once`); see
    :func:`_tap_sq_norm_whole`."""
    sq = _tap_sq_norm_whole(spec, x, g, flag)
    if axes.model_axis() is not None and (spec.split is None
                                          or spec.split[1] is None):
        sq = sq * _once()
    return sq


def _split_operand(spec, which: int, t: torch.Tensor):
    """``(index map, (B,) scales over the model group)`` of the per-example
    rows of a split operand of a tapped einsum (``which``: 0 x, 2 the
    output's cotangent), or (None, None)."""
    split = None if spec.split is None else spec.split[which]
    if split is None:
        return None, None
    from repro_torch.kernels import ops
    rows = t.reshape(t.shape[0], -1).contiguous()
    return (fake_quant._index_map(t.shape, split),
            model_reduce_(ops.luq_row_max(rows), "max"))


def _tap_sq_norm_whole(spec, x: torch.Tensor, g: torch.Tensor,
                       flag: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (B,) per-example squared wgrad norms a ghost einsum emits.

    ``spec`` is the einsum's ``fake_quant._ESpec``.  The quantization is
    the wgrad GEMM's (folds 4 and 5, per example).  When the backend
    implements the ``ghost_norm`` op natively for the format (``cuda``:
    luq_fp4), the matrix views are contiguous and the Gram route wins,
    quantize + Grams + reduce is one fused op, given the keys of folds 4
    and 5, whose draws over a per-example row are those the unfused
    quantizer makes; otherwise quantize, then ``_matpair_sq_norm``.

    ``flag``: the layer's device policy flag (``fake_quant``), at 0 the
    norms of the unquantized operands.  Both norms are taken and
    ``torch.where`` picks one: the fused op's for a layer that is on, and
    for one that is off :func:`_matpair_sq_norm`'s, the very operations
    a host-bool policy runs, so a policy's norms keep their bits.  (The
    ``cuda`` kernel can give the off layer's norm itself, from the bf16
    operands' Grams on the tensor cores; on an H100 that changed
    stablelm-3b's norms in their last bits, and LUQ's rounding of pass
    2's clipped cotangents turned that into other probe losses and
    another epoch-0 policy.)  The kernel still reads the flag: a layer
    that is off skips its LUQ rounding.
    """
    xmat, gmat, contiguous = _einsum_matviews(spec.spec, x, g)
    _, t, din = xmat.shape
    dout = gmat.shape[2]
    if not (spec.quantized and spec.q_wgrad):
        return _matpair_sq_norm(xmat, gmat)
    impl, actual = qbackend.get_ghost_norm(spec.fmt, spec.backend)
    if actual != "ref" and contiguous and gram_route_wins(t, din, dout):
        draws = spec.fmt in STOCHASTIC_FORMATS
        kx = fake_quant.stream_key(spec.seed, 4) if draws else None
        kg = fake_quant.stream_key(spec.seed, 5) if draws else None
        map_x, alpha_x = _split_operand(spec, 0, x) if draws else (None,
                                                                   None)
        map_g, alpha_g = _split_operand(spec, 2, g) if draws else (None,
                                                                   None)
        kw = {} if map_x is None and map_g is None else dict(
            alpha_x=alpha_x, alpha_g=alpha_g, map_x=map_x, map_g=map_g)
        with record_function("ghost.fused_norm"):
            if flag is None:
                return impl(xmat, gmat, kx, kg, **kw)
            fused = impl(xmat, gmat, kx, kg,
                         *((flag,) if qbackend.reads_flag(impl) else ()),
                         **kw)
            return torch.where(flag > 0.5, fused,
                               _matpair_sq_norm(xmat, gmat))
    splits = spec.split or (None, None, None)
    xq = fake_quant._quantize_per_example(
        x, spec.fmt, spec.backend, spec.seed, 4, flag,
        fake_quant._index_map(x.shape, splits[0]))
    gq = fake_quant._quantize_per_example(
        g, spec.fmt, spec.backend, spec.seed, 5, flag,
        fake_quant._index_map(g.shape, splits[2]))
    return _einsum_sq_norm(spec.spec, xq, gq)


def _conv_patches(x: torch.Tensor, geo) -> torch.Tensor:
    """(B, T, Cin kh kw): one row per output position of the (undilated)
    conv of geometry ``geo``, the input pixels its kernel reads, from the
    "SAME"-padded input: ``F.unfold``'s columns, taken as strided views
    of the whole batch and copied once (``F.unfold`` on CUDA launches one
    kernel per example).  The column order (channel-major) is not the JAX
    package's patches', and neither route of ``_matpair_sq_norm`` depends
    on it."""
    t, b, l, r = geo.pads
    kh, kw = geo.kernel
    xp = F.pad(x, (l, r, t, b))
    cols = xp.unfold(2, kh, geo.stride).unfold(3, kw, geo.stride)
    n, c, ho, wo = cols.shape[:4]
    return cols.permute(0, 2, 3, 1, 4, 5).reshape(n, ho * wo, c * kh * kw)


def _per_example_conv_weight(x: torch.Tensor, g: torch.Tensor,
                             geo) -> torch.Tensor:
    """(B, Cout, Cin / groups, kh, kw): each example's own wgrad of the
    conv of geometry ``geo``, as one wgrad with the batch folded into the
    groups."""
    b, cin = x.shape[:2]
    cout = g.shape[1]
    folded = geo._replace(groups=b * geo.groups)
    dw = fake_quant._conv_weight(
        x.reshape(1, b * cin, *x.shape[2:]),
        (b * cout, cin // geo.groups, *geo.kernel),
        g.reshape(1, b * cout, *g.shape[2:]), folded)
    return dw.reshape(b, cout, cin // geo.groups, *geo.kernel)


def _conv_tap_sq_norm(spec, x: torch.Tensor, g: torch.Tensor,
                      flag: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (B,) per-example squared wgrad norms a ghost conv emits.

    ``spec`` is the conv's ``fake_quant._QSpec``.  The quantization is the
    wgrad GEMM's (folds 4 and 5, per example; passed through where the
    device ``flag`` is 0).  A dense, undilated conv
    takes ``_matpair_sq_norm`` of its patches and the (T, Cout) cotangent
    rows (Grams or the direct product, by ``gram_route_wins(T, kh kw Cin,
    Cout)``); a dilated or grouped one, the squared norm of each
    example's own wgrad (the JAX package's per-layer fallback)."""
    geo = spec.geo
    if spec.quantized and spec.q_wgrad:
        x = fake_quant._quantize_per_example(x, spec.fmt, spec.backend,
                                             spec.seed, 4, flag)
        g = fake_quant._quantize_per_example(g, spec.fmt, spec.backend,
                                             spec.seed, 5, flag)
    if geo.dilation == 1 and geo.groups == 1:
        gmat = g.reshape(g.shape[0], g.shape[1], -1).transpose(1, 2)
        return _matpair_sq_norm(_conv_patches(x, geo), gmat)
    dw = _per_example_conv_weight(x, g, geo)
    return dw.float().square().sum(dim=(1, 2, 3, 4))


# --------------------------------------------------------------------------- #
# per-example copies: the norm-scale hook and the norm-only fallback
# --------------------------------------------------------------------------- #
class _TapCopy(torch.autograd.Function):
    """Forward: ``value`` repeated for each of B examples, ``shape`` (B
    first).  Backward: the per-example gradients sum to the value's, and
    their squared norms, times ``count``, are the tap's gradient."""

    @staticmethod
    def forward(value, tap, shape, count):
        return value.expand(shape).clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.value_shape = inputs[0].shape
        ctx.count = inputs[3]

    @staticmethod
    def backward(ctx, d_per_example):
        d = d_per_example.float()
        dtap = d.square().reshape(d.shape[0], -1).sum(dim=1)
        if ctx.count != 1.0:
            dtap = dtap * ctx.count
        dvalue = None
        if ctx.needs_input_grad[0]:
            dvalue = d_per_example.sum(dim=0).reshape(ctx.value_shape)
        return dvalue, dtap, None, None


def tap_scale(scale: torch.Tensor, tap: torch.Tensor,
              x: torch.Tensor, count: float = 1.0) -> torch.Tensor:
    """``scale`` (d,) as one copy per example of ``x`` (B, ..., d), shaped
    to broadcast against it; under a norm pass its per-example squared
    gradient norms, times ``count``, reach ``tap``."""
    shape = (x.shape[0],) + (1,) * (x.dim() - 1 - scale.dim()) + tuple(
        scale.shape)
    return _TapCopy.apply(scale, tap, shape, count)


def tap_leaf(value: torch.Tensor, tap: torch.Tensor, n: int) -> torch.Tensor:
    """``value`` as ``n`` per-example copies, (n, *value.shape); under a
    norm pass their squared gradient norms reach ``tap``."""
    return _TapCopy.apply(value, tap, (n, *value.shape), 1.0)


# --------------------------------------------------------------------------- #
# per-example gradient state
# --------------------------------------------------------------------------- #
def per_example_state_bytes(params: dict, hooked_mask: dict, batch_size: int,
                            itemsize: int = 4,
                            aux: Optional[GhostAux] = None) -> dict:
    """Per-example gradient state (the memory term that grows with the
    batch) of the two grad modes: vmap materializes every parameter per
    example; ghost only the leaves no hook covers, as pass 1's
    per-example copies (none for dense LMs; the CNNs' GroupNorm
    parameters and head)."""
    hooked = effective_hooked_mask(params, hooked_mask, aux)
    _check_mask(params, hooked)
    total = sum(t.numel() for t in params.values())
    nonhooked = sum(t.numel() for k, t in params.items() if not hooked[k])
    return {
        "params_total": total,
        "params_nonhooked": nonhooked,
        "vmap_bytes": batch_size * total * itemsize,
        "ghost_bytes": batch_size * nonhooked * itemsize,
    }


# --------------------------------------------------------------------------- #
# the two-pass driver
# --------------------------------------------------------------------------- #
def _chunk_norms(per_example_loss_fn, params, chunk: dict,
                 aux: Optional[GhostAux], fallback: frozenset):
    """Pass 1 on one chunk: ((B,) losses, (B,) squared norms)."""
    n = next(iter(chunk.values())).shape[0]
    device = next(iter(params.values())).device
    tap = torch.zeros((n,), dtype=torch.float32, device=device,
                      requires_grad=True)
    taps = aux.make_taps(chunk) if aux is not None else {}
    for t in taps.values():
        t.requires_grad_(True)
    hooks = GhostHooks(tap=tap,
                       norm_scales=aux is not None and aux.hook_norm_scales,
                       fallback=fallback)
    with torch.enable_grad():
        if aux is None:
            losses, fwd = per_example_loss_fn(params, chunk, hooks), None
        else:
            losses, fwd = aux.tapped_loss(params, chunk, taps, hooks)
        if hooks.tapped != fallback:
            raise NotImplementedError(
                f"ghost mode: leaves {sorted(fallback - hooks.tapped)} are "
                f"covered by no hook, and the model's loss does not take "
                f"their norm-only fallback (GhostHooks.leaf)")
        grads = torch.autograd.grad(losses.sum(), [tap, *taps.values()],
                                    allow_unused=True)
    dtap, *dtaps = (torch.zeros_like(t) if d is None else d
                    for d, t in zip(grads, [tap, *taps.values()]))
    sq = dtap
    if aux is not None:
        with torch.no_grad():       # frees the pass's graph with ``fwd``
            sq = sq + aux.combine(dict(zip(taps, dtaps)), fwd, chunk)
    if axes.model_axis() is not None:
        # the ranks' parts of the norms, once a chunk
        sq = model_reduce_(sq.float().contiguous(), "sum")
    return losses.detach(), sq


def ghost_per_example_norms(per_example_loss_fn: Callable, params: dict,
                            batch: dict, *, hooked_mask: dict,
                            aux: Optional[GhostAux] = None,
                            microbatch: int = 0):
    """Pass 1 alone: ``((B,) losses, (B,) norms)``.

    ``per_example_loss_fn(params, batch, hooks) -> (B,)`` is the batched
    per-example loss under the pass's :class:`GhostHooks` (used when there
    is no ``aux``; with one, ``aux.tapped_loss``).  The norms are the
    global l2 norms of the vmap path's (quantized) per-example gradients,
    to float32 tolerance as far as the module docstring's "Floating
    point" allows.  ``microbatch > 0`` runs chunks of that many examples
    one after another, bounding pass-1 memory by one chunk of
    activations; the examples are independent, so only the GEMMs'
    summation order changes with the chunk (the same note).
    """
    hooked = effective_hooked_mask(params, hooked_mask, aux)
    _check_mask(params, hooked)
    fallback = frozenset(k for k, m in hooked.items() if not m)
    detached = {k: v.detach() for k, v in params.items()}
    n = next(iter(batch.values())).shape[0]
    mb = microbatch if microbatch and 0 < microbatch < n else n
    if n % mb:
        raise ValueError(f"batch {n} not divisible by ghost_microbatch {mb}")
    losses, sqs = [], []
    with record_function("ghost.pass1"):
        for i in range(0, n, mb):
            chunk = {k: v[i:i + mb] for k, v in batch.items()}
            loss, sq = _chunk_norms(per_example_loss_fn, detached, chunk,
                                    aux, fallback)
            losses.append(loss)
            sqs.append(sq)
    return torch.cat(losses), torch.sqrt(torch.cat(sqs))


def _clip_metrics(losses, norms, clip_norm: float) -> dict:
    n = losses.shape[0]
    return {
        "loss": losses.float().sum() / n,
        "grad_norm_mean": norms.mean(),
        "grad_norm_max": norms.max(),
        "clip_fraction": (norms > clip_norm).float().mean(),
    }


def _two_pass(per_example_loss_fn, params, batch, *, clip_norm, hooked_mask,
              aux, ghost_microbatch):
    """Both passes over ``batch``: ((float32) clipped-grad sums, (B,)
    losses, (B,) norms)."""
    losses, norms = ghost_per_example_norms(
        per_example_loss_fn, params, batch, hooked_mask=hooked_mask,
        aux=aux, microbatch=ghost_microbatch)
    scale = torch.clamp(clip_norm / torch.clamp(norms, min=1e-12), max=1.0)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with record_function("ghost.pass2"), torch.enable_grad():
        pel = per_example_loss_fn(leaves, batch, GhostHooks())
        weighted = (scale * pel.float()).sum()
        grads = torch.autograd.grad(weighted, list(leaves.values()),
                                    allow_unused=True)
    grad_sum = {k: (torch.zeros_like(v, dtype=torch.float32) if g is None
                    else g.float())
                for (k, v), g in zip(leaves.items(), grads)}
    return grad_sum, losses, norms


def ghost_clipped_grad_sum(per_example_loss_fn: Callable, params: dict,
                           batch: dict, *, clip_norm: float,
                           hooked_mask: dict, aux: Optional[GhostAux] = None,
                           ghost_microbatch: int = 0,
                           accum_dtype: torch.dtype = torch.float32
                           ) -> Tuple[dict, dict]:
    """Sum over the batch of per-example clipped gradients, ghost style.

    ``per_example_loss_fn(params, batch, hooks) -> (B,)``: the batched
    per-example losses under a :class:`GhostHooks` (pass 2's reweighted
    backward; pass 1's too without ``aux``).  ``hooked_mask``: {name:
    bool}, True for leaves a hook covers.  ``aux``: the model's
    :class:`GhostAux`; ``ghost_microbatch``: pass-1 chunk size (0 = the
    whole batch).  Returns ``(grad_sum, metrics)``: the sums in
    ``accum_dtype`` (summed in float32), the metrics of
    ``repro_torch.dp.clip.per_example_clipped_grad_sum``.
    """
    grad_sum, losses, norms = _two_pass(
        per_example_loss_fn, params, batch, clip_norm=clip_norm,
        hooked_mask=hooked_mask, aux=aux, ghost_microbatch=ghost_microbatch)
    grad_sum = {k: g.to(accum_dtype) for k, g in grad_sum.items()}
    return grad_sum, _clip_metrics(losses, norms, clip_norm)


def sharded_ghost_clipped_grad_sum(
        per_example_loss_fn: Callable, params: dict, batch: dict, *,
        clip_norm: float, hooked_mask: dict, mesh,
        data_axes: Tuple[str, ...] = ("pod", "data"),
        accum_dtype: torch.dtype = torch.float32,
        aux: Optional[GhostAux] = None,
        ghost_microbatch: int = 0) -> Tuple[dict, dict]:
    """Data-parallel ghost driver: each rank runs both passes on its
    contiguous block of the global ``batch``.

    The counterpart of the reference's ``shard_map`` over the mesh's data
    axes (``mesh``: a ``repro_torch.launch.mesh.CompatMesh``; every rank
    holds the whole batch and the whole params).  A rank's pass-2 scales
    are exactly its own examples', so its pass 2 gives the clipped sum of
    its block; the ranks then combine those with ONE ``all_reduce``, no
    per-chunk reduction.  Losses and norms are gathered in shard order
    (= batch order), and the metrics are computed over the whole batch,
    the unsharded driver's contract up to float32 summation order.
    Axes of degree 1 are dropped; with none left this IS
    :func:`ghost_clipped_grad_sum`.  A batch that does not divide over the
    shards raises.
    """
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in data_axes if sizes.get(a, 1) > 1)
    if not axes:
        return ghost_clipped_grad_sum(
            per_example_loss_fn, params, batch, clip_norm=clip_norm,
            hooked_mask=hooked_mask, aux=aux,
            ghost_microbatch=ghost_microbatch, accum_dtype=accum_dtype)
    n = next(iter(batch.values())).shape[0]
    axis = mesh.axis_group(axes)
    if n % axis.size != 0:
        raise ValueError(f"global batch {n} not divisible by the "
                         f"{axis.size}-way data sharding {axes}")
    block = local_slice(axes, n, mesh)
    local = {k: v[block] for k, v in batch.items()}
    grad_sum, losses, norms = _two_pass(
        per_example_loss_fn, params, local, clip_norm=clip_norm,
        hooked_mask=hooked_mask, aux=aux, ghost_microbatch=ghost_microbatch)
    grad_sum = all_reduce_sum(grad_sum, axis)          # the one collective
    rows = gather_rows(torch.stack([losses.float(), norms]).T, axis)
    grad_sum = {k: g.to(accum_dtype) for k, g in grad_sum.items()}
    return grad_sum, _clip_metrics(rows[:, 0], rows[:, 1], clip_norm)
