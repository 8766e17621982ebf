"""Fake-quantized GEMM and convolution (paper A.12, Fig. 7).

The counterpart of ``repro.quant.fake_quant`` (``qeinsum``, ``qconv2d``).
The paper's simulation quantizes the inputs of all three GEMMs of a layer:

    forward :  y  = Q(x)  * Q(w)
    dgrad   :  dx = Q(g)  * Q(w)^T
    wgrad   :  dw = Q(x)^T * Q(g)

``qeinsum`` and ``qconv2d`` are ``torch.autograd.Function``s whose
backward runs the two transposed products (the einsum's transposes;
``torch.nn.grad.conv2d_input`` / ``conv2d_weight``) on freshly quantized
operands.  The six quantize points carry the JAX package's fold numbers:
forward Q(x) 0, Q(w) 1; dgrad Q(w) 2, Q(g) 3; wgrad Q(x) 4, Q(g) 5.

Randomness: each (seed, fold) pair has its own uniform stream, the
Philox4x32-10 stream (``quant.philox``) of the key :func:`stream_key`
gives it, seed and fold kept in separate words (a combined ``seed + fold``
would make (s, f + 1) collide with (s + 1, f)).  Element n of a quantized
row takes that stream's uniform n; the ``cuda`` backend's kernel draws it
itself and the ``ref`` backend in PyTorch, the same bits.  The seed is the
layer's static seed, so, as in the JAX package, the draws are the same at
every step and for every example.

Per-example quantization: the quantizer is the custom op
``repro_torch::fake_quant`` with a vmap rule.  Under ``torch.func.vmap``
(the DP engine's per-example gradients) an operand batched over examples
becomes the rows of one kernel call, each row scaled by its own
``max|x|`` and all rows against one shared draw: what the JAX package
computes when ``vmap`` hands each lane one example and an unbatched key.
A weight is not batched and is quantized whole, as one row; an
activation in the weight's slot of ``qeinsum`` is batched like ``x``.

``qeinsum`` and ``qconv2d`` also have an explicit per-example mode
(``per_example=True``), which the ghost engine's hooks
(``repro_torch.dp.ghost.GhostHooks``) ask for in their batched passes,
and the MoE expert GEMMs everywhere (the reference runs them inside a
``vmap`` over the batch): the batched operands (x, g) are quantized one
row per example with one shared draw, exactly what the vmap rule
computes, and the weight whole.  That is the custom op
``repro_torch::fake_quant_rows``, whose vmap rule makes the rows of every
lane the rows of one call, so the grain holds inside the vmap engine too.
In the norm pass the hooks also hand them a tap tensor and the function
whose value on (x, g) is the tap's gradient.  Both arrive as arguments:
this module imports nothing of the engine.

Operands split over the model group.  On a mesh whose ``model`` axis has
degree > 1 a column- or row-parallel projection (``qeinsum(split=...)``)
holds a shard of its weight and of one activation: the input of a
row-parallel projection, the output's cotangent of a column-parallel
one.  Each quantize point of such an operand rounds as the slice of the
whole operand's quantization: the rows' scales are the max over the
model group (one all-reduce MAX of the (R,) row maxima a call) and each
element draws at its index in the whole row
(``qbackend.quantize_split``).  A replicated operand is quantized as on
one process, the same bits on every rank.

Policy flags.  On the training path a layer's ``flag`` is a one-element
float32 device tensor, a view into the trainer's (policy_len,) flags
tensor, as the reference's flags are traced scalars: the layer always
takes the quantized autograd function, and each of its six quantize
points returns its operand unchanged when the flag is 0, the reference's
``lax.cond(flag > 0.5, quantize, identity)``.  The ``cuda`` luq_fp4
kernels read the flag from device memory and copy the operand through
themselves; every other quantizer is wrapped in ``torch.where(flag > 0.5,
q(x), x)``.  Nothing reads the flag on the host, so one CUDA graph of a
step serves every policy: the trainer fills the flags tensor between
replays.  A host-side bool ``flag`` (callers whose flags never vary
within a graph: evaluation, serving, tests of one policy) keeps the plain
op for a layer that is off and launches no quantizer for it.  The
backward forms only the gradients its inputs need: no dgrad for the
stem's images, no wgrad for the detached weights of the ghost norm pass.
"""
from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.quant import backend as qbackend
from repro_torch.quant.formats import STOCHASTIC_FORMATS

# The quantizers' Philox keys are (seed, STREAM_WORD + fold): one-to-one in
# (seed, fold) for folds 0..7, and the second word is never the logits
# head's (models.common.LOGITS_SEED = 17), so no quantizer stream is a
# logits stream.
STREAM_WORD = 0x4C550000
_N_FOLDS = 8


def stream_key(seed: int, fold: int):
    """The Philox key ``(k0, k1)`` of quantizer stream (seed, fold)."""
    if not (0 <= seed < 2 ** 32 and 0 <= fold < _N_FOLDS):
        raise ValueError(f"quantizer seed {seed} / fold {fold} out of range")
    return (int(seed), STREAM_WORD + int(fold))


def _index_map(shape, split):
    """The index map (``quant.philox.global_index``) of the rows of a
    tensor of ``shape`` (one row: the whole tensor; or one row per entry
    of its leading axis) whose dim ``split[0]`` is entries ``split[1] ..``
    of ``split[2]``; None for an unsplit tensor."""
    if split is None:
        return None
    dim, offset, whole = (int(v) for v in split)
    inner = 1
    for n in shape[dim + 1:]:
        inner *= int(n)
    return shape[dim] * inner, whole * inner, offset * inner


def _reduce_max(alpha):
    """The rows' scales over the model group: one all-reduce MAX."""
    from repro_torch.parallel.collectives import model_reduce_
    return model_reduce_(alpha.float().contiguous(), "max")


def _quantize_rows(rows, fmt: str, backend: str, seed: int, fold: int,
                   flag: Optional[torch.Tensor] = None):
    """Each row of ``rows`` (R, N) quantized on its own scale against the
    one draw of stream (seed, fold), in ``rows``' dtype; with a device
    ``flag`` at 0, ``rows`` unchanged."""
    q, _ = qbackend.get_quantizer(fmt, backend)
    key = stream_key(seed, fold) if fmt in STOCHASTIC_FORMATS else None
    if flag is None:
        return q(rows, key)
    if qbackend.reads_flag(q):
        return q(rows, key, flag)
    return torch.where(flag > 0.5, q(rows, key), rows)


def _quantize_shard(rows, fmt: str, backend: str, seed: int, fold: int,
                    flag: Optional[torch.Tensor] = None, index_map=None):
    """:func:`_quantize_rows`; with an ``index_map``, of rows that are a
    shard of the model group's (module docstring; a deterministic format
    is elementwise and needs nothing of the other shards)."""
    if index_map is None or fmt not in STOCHASTIC_FORMATS:
        return _quantize_rows(rows, fmt, backend, seed, fold, flag)
    return qbackend.quantize_split(rows, fmt, backend, stream_key(seed, fold),
                                   index_map, _reduce_max, flag)


def _quantize_per_example(x, fmt: str, backend: str, seed: int, fold: int,
                          flag: Optional[torch.Tensor] = None,
                          index_map=None):
    """One row per example (the leading axis), one shared draw."""
    rows = x.reshape(x.shape[0], -1)
    with ops.per_example_launches():
        return _quantize_shard(rows, fmt, backend, seed, fold, flag,
                               index_map).reshape(x.shape)


@torch.library.custom_op("repro_torch::fake_quant", mutates_args=())
def fake_quant(x: torch.Tensor, fmt: str, backend: str, seed: int,
               fold: int, flag: Optional[torch.Tensor] = None,
               split: Optional[List[int]] = None) -> torch.Tensor:
    """Quantize ``x`` as one tensor (one scale, one draw of its size);
    with a device ``flag`` at 0, a copy of ``x``.  ``split`` ``(dim,
    offset, whole)``: ``x`` holds entries ``offset ..`` of the ``whole``
    of its dim ``dim`` (module docstring)."""
    return _quantize_shard(x.reshape(1, -1), fmt, backend, seed, fold, flag,
                           _index_map(x.shape, split)).reshape(x.shape)


@fake_quant.register_fake
def _(x, fmt, backend, seed, fold, flag=None, split=None):
    return torch.empty_like(x)


def _fake_quant_vmap(info, in_dims, x, fmt, backend, seed, fold, flag=None,
                     split=None):
    """Batched over examples: one row per example, one shared draw.  The
    flag is the layer's, never batched."""
    if len(in_dims) > 5 and in_dims[5] is not None:
        raise ValueError("fake_quant: the policy flag cannot be batched")
    bdim = in_dims[0]
    if bdim is None:
        return fake_quant(x, fmt, backend, seed, fold, flag, split), None
    xb = x.movedim(bdim, 0)
    return _quantize_per_example(xb, fmt, backend, seed, fold, flag,
                                 _index_map(xb.shape[1:], split)), 0


fake_quant.register_vmap(_fake_quant_vmap)


@torch.library.custom_op("repro_torch::fake_quant_rows", mutates_args=())
def fake_quant_rows(x: torch.Tensor, fmt: str, backend: str, seed: int,
                    fold: int, flag: Optional[torch.Tensor] = None,
                    split: Optional[List[int]] = None) -> torch.Tensor:
    """Quantize each ``x[i]`` (the leading axis: the examples) on its own
    scale, all against one draw; with a device ``flag`` at 0, a copy of
    ``x``.  The op behind ``per_example=True``: under ``vmap`` each lane's
    rows stay rows of one call, so per-example operands quantize alike
    inside and outside the vmap engine.  ``split``: as :func:`fake_quant`
    takes it, ``dim`` >= 1 (a dim of each example's row)."""
    return _quantize_per_example(x, fmt, backend, seed, fold, flag,
                                 _index_map(x.shape, split))


@fake_quant_rows.register_fake
def _(x, fmt, backend, seed, fold, flag=None, split=None):
    return torch.empty_like(x)


def _fake_quant_rows_vmap(info, in_dims, x, fmt, backend, seed, fold,
                          flag=None, split=None):
    """Batched: the lanes' rows, lane-major, are the rows of one call."""
    if len(in_dims) > 5 and in_dims[5] is not None:
        raise ValueError("fake_quant_rows: the policy flag cannot be "
                         "batched")
    bdim = in_dims[0]
    if bdim is None:
        return fake_quant_rows(x, fmt, backend, seed, fold, flag,
                               split), None
    xb = x.movedim(bdim, 0)
    rows = xb.reshape(xb.shape[0] * xb.shape[1], *xb.shape[2:])
    return fake_quant_rows(rows, fmt, backend, seed, fold, flag,
                           split).reshape(xb.shape), 0


fake_quant_rows.register_vmap(_fake_quant_rows_vmap)


# --------------------------------------------------------------------------- #
# convolution with the JAX package's "SAME" padding
# --------------------------------------------------------------------------- #
def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of XLA's "SAME" rule: output ceil(n / s),
    the odd pixel after.  A stride-2 3x3 conv on an even input pads
    (0, 1), which ``F.conv2d(padding=1)`` would not.  ``kernel`` is the
    effective size, ``(k - 1) * dilation + 1`` for a dilated kernel."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class _Geometry(NamedTuple):
    stride: int
    pads: Tuple[int, int, int, int]       # top, bottom, left, right
    kernel: Tuple[int, int]               # kh, kw (undilated)
    dilation: int = 1
    groups: int = 1

    @property
    def symmetric(self) -> bool:
        t, b, l, r = self.pads
        return t == b and l == r


def _geometry(x, w_oihw, stride: int, dilation: int = 1,
              groups: int = 1) -> _Geometry:
    kh, kw = w_oihw.shape[2:]
    eff_h, eff_w = (kh - 1) * dilation + 1, (kw - 1) * dilation + 1
    return _Geometry(stride, same_pads(x.shape[-2], eff_h, stride)
                     + same_pads(x.shape[-1], eff_w, stride), (kh, kw),
                     dilation, groups)


def _pad(x, geo: _Geometry):
    t, b, l, r = geo.pads
    return x if geo.symmetric else F.pad(x, (l, r, t, b))


def _sym_padding(geo: _Geometry):
    return (geo.pads[0], geo.pads[2]) if geo.symmetric else (0, 0)


def _conv(x, w_oihw, geo: _Geometry):
    return F.conv2d(_pad(x, geo), w_oihw, stride=geo.stride,
                    padding=_sym_padding(geo), dilation=geo.dilation,
                    groups=geo.groups)


def _conv_weight(x, w_shape, g, geo: _Geometry):
    """The wgrad ``dw`` (OIHW) of ``_conv`` for input ``x`` and output
    cotangent ``g``."""
    return torch.nn.grad.conv2d_weight(_pad(x, geo), w_shape, g, geo.stride,
                                       _sym_padding(geo), geo.dilation,
                                       geo.groups)


class _QSpec(NamedTuple):
    fmt: str
    backend: str
    seed: int
    quantized: bool       # fmt != "none" (and a host flag, if one, on)
    q_fwd: bool
    q_dgrad: bool
    q_wgrad: bool
    per_example: bool     # batched operands quantized one row per example
    geo: _Geometry
    tap_norm: Optional[Callable] = None   # (spec, x, g, flag) -> tap's grad


# the operand each fold quantizes: x (0, 4), w (1, 2), the output's
# cotangent (3, 5), as indices into an _ESpec's ``split``
_FOLD_OPERAND = (0, 1, 1, 2, 0, 2)


def _q(t, spec, fold: int, on: bool, batched: bool, flag=None):
    """Fold ``fold`` of a ``_QSpec`` or ``_ESpec`` layer applied to ``t``
    when ``on`` and the layer is quantized: one row per example for a
    batched operand in per-example mode, else the whole tensor; ``t``
    itself where the device ``flag`` is 0.  A shard of a split operand
    (an ``_ESpec``'s ``split``) rounds as the whole operand's slice."""
    if not (on and spec.quantized):
        return t
    splits = getattr(spec, "split", None)
    split = (list(splits[_FOLD_OPERAND[fold]])
             if splits is not None and splits[_FOLD_OPERAND[fold]]
             is not None else None)
    if batched and spec.per_example:
        return fake_quant_rows(t, spec.fmt, spec.backend, spec.seed, fold,
                               flag, split)
    return fake_quant(t, spec.fmt, spec.backend, spec.seed, fold, flag,
                      split)


def _device_flag(flag, fmt: str):
    """``(device flag or None, the layer may quantize)`` of a layer's
    ``flag``: a tensor is read on the device (the layer always takes the
    quantized function); a host bool decides here."""
    if isinstance(flag, torch.Tensor):
        return flag, fmt != "none"
    return None, bool(flag) and fmt != "none"


class _QConv2d(torch.autograd.Function):
    """NCHW x, OIHW w; quantized fwd / dgrad / wgrad GEMM inputs, and,
    with a ``tap``, ``spec.tap_norm(spec, x, g, flag)`` as the tap's
    gradient."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, tap, flag, spec: _QSpec):
        with torch.no_grad():
            xq = _q(x, spec, 0, spec.q_fwd, True, flag)
            wq = _q(w, spec, 1, spec.q_fwd, False, flag)
            return _conv(xq, wq, spec.geo)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, tap, flag, spec = inputs
        ctx.save_for_backward(x, w, flag)
        ctx.spec = spec
        ctx.tapped = tap is not None

    @staticmethod
    def backward(ctx, g):
        x, w, flag = ctx.saved_tensors
        spec = ctx.spec
        geo = spec.geo
        dx = dw = dtap = None
        with torch.no_grad():
            if ctx.needs_input_grad[0]:
                # dgrad: dx = conv^T(Q(g), Q(w)), on the padded input,
                # cropped
                t, b, l, r = geo.pads
                wq = _q(w, spec, 2, spec.q_dgrad, False, flag)
                gq = _q(g, spec, 3, spec.q_dgrad, True, flag)
                n, c, h, wd = x.shape
                padded = ((n, c, h, wd) if geo.symmetric
                          else (n, c, h + t + b, wd + l + r))
                dx = torch.nn.grad.conv2d_input(
                    padded, wq, gq, geo.stride, _sym_padding(geo),
                    geo.dilation, geo.groups)
                if not geo.symmetric:
                    dx = dx[..., t:t + h, l:l + wd]
            if ctx.needs_input_grad[1]:
                # wgrad: dw = Q(x)^T Q(g)
                xq = _q(x, spec, 4, spec.q_wgrad, True, flag)
                gq = _q(g, spec, 5, spec.q_wgrad, True, flag)
                dw = _conv_weight(xq, w.shape, gq, geo)
            if ctx.tapped:
                dtap = spec.tap_norm(spec, x, g, flag)
        return dx, dw, dtap, None, None


def qconv2d(x: torch.Tensor, w: torch.Tensor, *, seed: int, flag,
            stride: int = 1, dilation: int = 1, groups: int = 1,
            fmt: str = "luq_fp4", q_fwd: bool = True, q_dgrad: bool = True,
            q_wgrad: bool = True, backend: str = None,
            per_example: bool = False, tap: Optional[torch.Tensor] = None,
            tap_norm: Optional[Callable] = None) -> torch.Tensor:
    """Quantization-aware conv2d with "SAME" padding.

    ``x`` is NCHW; ``w`` is HWIO, the JAX package's weight layout (the
    port keeps its parameter shapes), permuted to OIHW here; a grouped
    conv's I is ``C_in / groups``.  ``dilation`` and ``groups`` are the
    JAX package's ``rhs_dilation`` (the same in both axes) and
    ``feature_groups``.  ``seed`` is host-side.  ``flag``: the layer's
    policy flag, a one-element float32 device tensor read on the device
    (the quantize points pass their operands through when it is 0), or a
    host bool, with which a layer that is off runs the plain convolution
    unless it is tapped; ``fmt="none"`` runs the plain convolution.

    ``per_example`` and ``tap`` / ``tap_norm`` are ``qeinsum``'s: the
    batched operands (x and the cotangent) quantized one example at a
    time, and the tap's gradient the value of ``tap_norm(spec, x, g,
    flag)`` (``flag`` the device flag, or None) on
    this conv's ``_QSpec``, input and output cotangent.
    """
    w_oihw = w.permute(3, 2, 0, 1)
    geo = _geometry(x, w_oihw, stride, dilation, groups)
    dflag, quantized = _device_flag(flag, fmt)
    if tap is None and not quantized:
        return _conv(x, w_oihw, geo)
    if tap is not None and tap_norm is None:
        raise ValueError("qconv2d: a tap needs its tap_norm")
    spec = _QSpec(fmt, qbackend.resolve_backend(backend), int(seed),
                  quantized, bool(q_fwd), bool(q_dgrad), bool(q_wgrad),
                  bool(per_example), geo, tap_norm)
    return _QConv2d.apply(x, w_oihw, tap, dflag, spec)


# --------------------------------------------------------------------------- #
# einsum
# --------------------------------------------------------------------------- #
class _ESpec(NamedTuple):
    spec: str
    fmt: str
    backend: str
    seed: int
    quantized: bool       # fmt != "none" (and a host flag, if one, on)
    q_fwd: bool
    q_dgrad: bool
    q_wgrad: bool
    per_example: bool     # batched operands quantized one row per example
    tap_norm: Optional[Callable] = None   # (spec, x, g, flag) -> tap's grad
    # (x, w, out): each None or the (dim, offset, whole) of the operand's
    # dim split over the model group; None: nothing split
    split: Optional[Tuple] = None


def einsum(spec: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of operands promoted to one dtype, as ``jnp.einsum``
    promotes them (the Griffin hybrid's float32 conv output against its
    bf16 gate weights gives a float32 product)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return torch.einsum(spec, x, w)


@functools.lru_cache(maxsize=None)
def _terms(spec: str):
    """(x_term, w_term, out_term) of ``spec``; its transposes (dgrad
    ``out,w->x``, wgrad ``x,out->w``) need every axis of an operand in
    the other operand or in the output."""
    lhs, out = spec.replace(" ", "").split("->")
    x_term, w_term = lhs.split(",")
    if (set(x_term) - set(w_term) - set(out)
            or set(w_term) - set(x_term) - set(out)):
        raise ValueError(f"einsum spec {spec!r}: every operand axis must be "
                         f"contracted with the other operand or kept")
    return x_term, w_term, out


class _QEinsum(torch.autograd.Function):
    """``einsum(spec, x, w)``; quantized fwd / dgrad / wgrad GEMM inputs,
    and, with a ``tap``, ``spec.tap_norm(spec, x, g, flag)`` as the tap's
    gradient."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, tap, flag, spec: _ESpec):
        with torch.no_grad():
            xq = _q(x, spec, 0, spec.q_fwd, True, flag)
            wq = _q(w, spec, 1, spec.q_fwd, False, flag)
            return einsum(spec.spec, xq, wq)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, tap, flag, spec = inputs
        ctx.save_for_backward(x, w, flag)
        ctx.spec = spec
        ctx.tapped = tap is not None

    @staticmethod
    def backward(ctx, g):
        x, w, flag = ctx.saved_tensors
        spec = ctx.spec
        x_term, w_term, out = _terms(spec.spec)
        dx = dw = dtap = None
        with torch.no_grad():
            if ctx.needs_input_grad[0]:
                wq = _q(w, spec, 2, spec.q_dgrad, False, flag)
                gq = _q(g, spec, 3, spec.q_dgrad, True, flag)
                dx = einsum(f"{out},{w_term}->{x_term}", gq, wq).to(x.dtype)
            if ctx.needs_input_grad[1]:
                xq = _q(x, spec, 4, spec.q_wgrad, True, flag)
                gq = _q(g, spec, 5, spec.q_wgrad, True, flag)
                dw = einsum(f"{x_term},{out}->{w_term}", xq, gq).to(w.dtype)
            if ctx.tapped:
                dtap = spec.tap_norm(spec, x, g, flag)
        return dx, dw, dtap, None, None


def qeinsum(spec: str, x: torch.Tensor, w: torch.Tensor, *, seed: int,
            flag, fmt: str = "luq_fp4", q_fwd: bool = True,
            q_dgrad: bool = True, q_wgrad: bool = True, backend: str = None,
            per_example: bool = False, tap: Optional[torch.Tensor] = None,
            tap_norm: Optional[Callable] = None,
            split: Optional[Tuple] = None) -> torch.Tensor:
    """Quantization-aware einsum of an activation ``x`` (leading axis: the
    examples) and a weight ``w``, or a second activation in ``w``'s slot
    (Mamba-2's SSD contractions, ``C B^T`` and ``gate @ (x dt)``): outside
    ``vmap`` each operand is quantized whole, and under ``vmap`` (the DP
    engine's per-example gradients) a batched ``w`` is quantized one row
    per example with the stream's one draw, as a batched ``x`` is, by the
    custom op's vmap rule.  ``seed`` is host-side; ``flag`` is the
    layer's policy flag, a device tensor or a host bool, as in
    :func:`qconv2d` (a host flag that is off, or ``fmt="none"``, runs the
    plain einsum unless it is tapped).

    ``per_example`` quantizes the batched operands (x and the cotangent,
    never the weight) one example at a time, as the vmap path does.
    ``tap`` ((B,) float32) with ``tap_norm(spec, x, g, flag) -> (B,)``: the
    backward gives the tap the value of ``tap_norm`` on this einsum's
    ``_ESpec``, input and output cotangent.  The ghost engine's hooks ask
    for both (its per-example weight-gradient norms); this module knows
    nothing else of that engine.

    ``split`` ``(x, w, out)``: on a model-parallel mesh, each None or the
    ``(dim, offset, whole)`` of that operand's dim this rank holds a
    shard of (module docstring); the output's entry is the cotangent's."""
    dflag, quantized = _device_flag(flag, fmt)
    if split is not None and all(s is None for s in split):
        split = None
    if tap is None and not quantized:
        return einsum(spec, x, w)
    if tap is not None and tap_norm is None:
        raise ValueError("qeinsum: a tap needs its tap_norm")
    _terms(spec)
    espec = _ESpec(spec, fmt, qbackend.resolve_backend(backend), int(seed),
                   quantized, bool(q_fwd), bool(q_dgrad), bool(q_wgrad),
                   bool(per_example), tap_norm,
                   None if split is None else tuple(
                       None if s is None else tuple(int(v) for v in s)
                       for s in split))
    return _QEinsum.apply(x, w, tap, dflag, espec)
