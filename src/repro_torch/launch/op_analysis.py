"""Op-level cost analysis of one step on shape-only tensors: the
counterpart of ``repro.launch.hlo_analysis``.

Eager PyTorch has no HLO.  The step's function runs once on tensors that
carry shapes and dtypes and no memory, inside :class:`OpAnalysis`, a
``TorchDispatchMode`` that sees every aten op and every kernel call, and
counts

    flops            matmuls, convolutions (forward and backward) and
                     attention by ``torch.utils.flop_counter``'s formulas
                     (a convolution's backward by the forward's, grouped
                     convs too),
                     by class: ``bf16`` (16-bit operands, tensor cores),
                     ``tf32`` (float32 where the step allowed TF32:
                     ``torch.backends.cuda.matmul.allow_tf32`` for
                     matmuls, ``torch.backends.cudnn.allow_tf32`` for
                     convolutions), ``f32`` (float32 without TF32, and
                     one operation an element of every elementwise op
                     and every reduction's input)
    bytes            each op's tensor inputs read once and its outputs
                     written once (eager PyTorch fuses nothing); views
                     and outputs that alias an input count nothing, an
                     updated buffer is read and written, an overwritten
                     one written; tensors on the CPU count nothing
    kernels          each call of a kernel of ``repro_torch.kernels.ops``
                     (the wrappers report their calls on fake tensors),
                     and each ``repro_torch::fake_quant`` /
                     ``fake_quant_rows`` op that the ``cuda`` backend runs
                     as ``luq_quant``, costed by
                     ``roofline.kernel_cost``: launches, bytes and
                     operations (bytes bound them at any policy: at flag
                     0 a kernel copies, at 1 it rounds, one read and one
                     write either way)
    collectives      ``torch.distributed`` ops by buffer bytes, and their
                     wire bytes by the reference's ring factors
    peak_bytes       the most bytes of device storage alive at once,
                     the step's inputs included
    warnings         ``{op: calls}`` of the ops with neither a FLOP
                     formula nor an elementwise (an output of an input's
                     shape), reduction or data-movement shape

The reference's analyzer exists for trip counts: XLA counts a ``while``
body once.  An eager trace sees every trip of a Python loop, so a loop of
10 products counts 10; tracing every microbatch of a large step is slow,
though, and a step's cost is affine in its trips (the microbatches of the
vmap engine, the pass-1 chunks of the ghost engine, whose pass 2 also
grows with the batch), so :func:`analyze_train` traces one trip and two
and extrapolates (:func:`extrapolate`).

The tensors are ``meta`` tensors by default, on any build: their shapes
come from torch's own C++ meta kernels, about five times faster than
``torch``'s ``FakeTensorMode``, which is what a full-size step needs.
``device="cuda"`` traces the same function under ``FakeTensorMode`` on
fake CUDA tensors instead, where torch is built with CUDA (a build
without it has no CUDA device guard: its autograd aborts on such a
tensor).  Both take the kernel wrappers' traced route, never their plain
versions, and count the same: the costs depend on shapes, dtypes and the
TF32 flags alone.  ``config.traced_device`` is the one named way past the
GPU check of ``resolve_device``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time
import weakref
from typing import Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.config import RunConfig, traced_device
from repro_torch.kernels import ops
from repro_torch.launch import roofline
from repro_torch.quant import backend as qbackend

_aten = torch.ops.aten

#: Ops that move no bytes: allocations without a fill, host queries.
_NO_TRAFFIC = {
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten.lift_fresh, _aten._local_scalar_dense,
    _aten.resize_, _aten.set_, _aten.sym_size, _aten.sym_stride,
    _aten.sym_numel, _aten.sym_storage_offset, _aten.is_same_size,
    _aten._unsafe_view, _aten.alias,
}
#: In-place ops that overwrite their destination without reading it.
_OVERWRITE = {
    _aten.copy_, _aten.fill_, _aten.zero_, _aten.normal_, _aten.uniform_,
    _aten.random_, _aten.bernoulli_, _aten.exponential_,
}
#: Ops that move data and compute nothing: no FLOPs, no warning.
_MOVES = {
    _aten.clone, _aten.copy_, _aten._to_copy, _aten.cat, _aten.stack,
    _aten.constant_pad_nd, _aten.index, _aten.index_select, _aten.gather,
    _aten.scatter, _aten.scatter_, _aten.scatter_add, _aten.scatter_add_,
    _aten.index_add, _aten.index_add_, _aten.index_put, _aten.index_put_,
    _aten._unsafe_index, _aten._unsafe_index_put, _aten.index_copy,
    _aten.index_copy_, _aten.embedding, _aten.embedding_dense_backward,
    _aten.repeat, _aten.flip, _aten.roll, _aten.zeros, _aten.zeros_like,
    _aten.ones, _aten.ones_like, _aten.full, _aten.full_like,
    _aten.new_zeros, _aten.new_ones, _aten.new_full, _aten.fill_,
    _aten.zero_, _aten.arange, _aten.scalar_tensor, _aten.randn,
    _aten.rand, _aten.randint, _aten.normal_, _aten.uniform_,
    _aten.random_, _aten.bernoulli_, _aten.normal, _aten.masked_scatter,
    _aten.slice_scatter, _aten.select_scatter, _aten.diagonal_scatter,
    _aten.as_strided_scatter, _aten.tril, _aten.triu, _aten.col2im,
    _aten.im2col, _aten.split_with_sizes_copy, _aten.unbind_copy,
    _aten.lift_fresh_copy, _aten.unfold_backward, _aten.eye,
    _aten.masked_select, _aten.sort, _aten.topk, _aten.argsort,
    _aten.cumsum, _aten.tensor_split, _aten.select_backward,
    _aten.slice_backward, _aten.index_select_backward, _aten.expand_copy,
    _aten.permute_copy, _aten.t_copy, _aten.transpose_copy, _aten.view_copy,
}

#: The collectives the port issues (``repro_torch.parallel.collectives``:
#: ``all_reduce``, and serving's ``all_gather``) by the reference's kinds;
#: each counts its result's bytes (an all-gather's whole output), as the
#: reference's analysis does.
_COLLECTIVES = {"allreduce_": "all-reduce", "allgather_": "all-gather",
                "_allgather_base_": "all-gather"}

_CONVS = {_aten.convolution, _aten._convolution, _aten.convolution_backward,
          _aten.cudnn_convolution, _aten.convolution_overrideable,
          _aten._slow_conv2d_forward}


@contextlib.contextmanager
def fake_device(device="meta"):
    """The device a trace names, yielded: ``"meta"``, or ``"cuda"`` under
    a ``FakeTensorMode`` (a build of torch with CUDA only)."""
    if torch.device(device).type == "cuda":
        if not torch.backends.cuda.is_built():
            raise RuntimeError("a trace on fake CUDA tensors needs a build "
                               "of torch with CUDA; trace on 'meta'")
        with FakeTensorMode(allow_non_fake_inputs=True), \
                traced_device(device) as dev:
            yield dev
    else:
        with traced_device(device) as dev:
            yield dev


def _tensors(x):
    """The tensors of ``x``: a tensor, or lists of them (an all-gather's
    outputs are a list of lists)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _tensor_bytes(t: torch.Tensor) -> float:
    """Bytes of the elements ``t`` addresses on the device (a broadcast
    dimension once), 0 on the CPU."""
    if t.device.type == "cpu":
        return 0.0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return float(n * t.element_size())


def _conv_backward_flops(grad_out, x, w, transposed, output_mask) -> float:
    """FLOPs of ``aten.convolution_backward``: each gradient asked for
    takes the forward's multiply-adds, ``N x prod(w) x prod(the output's
    positions)`` (a transposed conv's: the input's), two FLOPs each.
    ``torch.utils.flop_counter``'s formula prices a grouped conv's weight
    gradient as ungrouped, ``groups`` times too many (the vmap engine's
    per-example convs are grouped, a group an example)."""
    positions = (x.shape if transposed else grad_out.shape)[2:]
    macs = x.shape[0] * w.numel()
    for p in positions:
        macs *= p
    return 2.0 * macs * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def _flop_class(func, dtype) -> str:
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    allow = (torch.backends.cudnn.allow_tf32 if func.overloadpacket in _CONVS
             else torch.backends.cuda.matmul.allow_tf32)
    return "tf32" if dtype == torch.float32 and allow else "f32"


def _arg_values(func, args, kwargs):
    """``(schema argument, value)`` of every argument given."""
    for i, arg in enumerate(func._schema.arguments):
        if i < len(args):
            yield arg, args[i]
        elif arg.name in kwargs:
            yield arg, kwargs[arg.name]


class OpAnalysis(TorchDispatchMode):
    """Counts the ops of what runs inside it (see the module docstring);
    costs only inside :meth:`counting`, storages always."""

    def __init__(self):
        super().__init__()
        self.flops_by_class = collections.Counter()
        self.int_ops = 0.0
        self.bytes = 0.0
        self.collectives = collections.Counter()
        self.kernels = {}
        self.warnings = collections.Counter()
        self.n_ops = 0
        self.trace_s = 0.0
        self._on = False
        self._storages = {}          # storage key -> [nbytes, tensors]
        self.live_bytes = 0.0
        self.peak_bytes = 0.0
        self._sink = None

    # -- the mode's lifetime --------------------------------------------- #
    def __enter__(self):
        self._sink = ops.traced_launches(self._kernel)
        self._sink.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._sink.__exit__(*exc)
        return out

    @contextlib.contextmanager
    def counting(self):
        """Cost the ops inside; the peak restarts from the bytes alive."""
        self._on = True
        self.peak_bytes = self.live_bytes
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.trace_s += time.perf_counter() - t0
            self._on = False

    def hold(self, tree) -> None:
        """Count the device storages of ``tree``'s tensors as alive."""
        self._track(tree_leaves(tree))

    # -- storages ---------------------------------------------------------- #
    def _track(self, out) -> None:
        for t in _tensors(out):
            if t.device.type == "cpu":
                continue
            st = t.untyped_storage()
            key = st._cdata
            rec = self._storages.get(key)
            if rec is None:
                rec = self._storages[key] = [float(st.nbytes()), 0]
                self.live_bytes += rec[0]
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            rec[1] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        rec = self._storages.get(key)
        if rec is None:
            return
        rec[1] -= 1
        if rec[1] == 0:
            self.live_bytes -= rec[0]
            del self._storages[key]

    # -- costs ------------------------------------------------------------- #
    def _kernel(self, name: str, launches: int, **shape) -> None:
        if not self._on:
            return
        cost = roofline.kernel_cost(name, **shape)
        k = self.kernels.setdefault(name, dict.fromkeys(
            ("calls", "bytes", "flops", "tc_flops", "int_ops"), 0))
        k["calls"] += launches
        for field in ("bytes", "flops", "tc_flops", "int_ops"):
            k[field] += getattr(cost, field)
        self.bytes += cost.bytes
        self.flops_by_class["f32"] += cost.flops
        self.flops_by_class["bf16"] += cost.tc_flops
        self.int_ops += cost.int_ops

    def _fake_quant(self, func, args, kwargs) -> None:
        """``repro_torch::fake_quant`` (one row) or ``fake_quant_rows``
        (a row an example): ``luq_quant`` where the ``cuda`` backend runs
        the format, else its plain ops, which a trace does not see."""
        vals = dict((a.name, v) for a, v in _arg_values(func, args, kwargs))
        x = vals["x"]
        _, actual = qbackend.get_quantizer(vals["fmt"], vals["backend"])
        if actual == "cuda" and x.device.type != "cpu":
            if x.numel():
                rows = 1 if func._opname == "fake_quant" else x.shape[0]
                self._kernel("luq_quant", 1, rows=rows,
                             n=x.numel() // rows, elem=x.element_size())
            return
        self.bytes += 2 * _tensor_bytes(x)
        self.warnings[f"{func} on the {actual} backend (its plain ops "
                      "are not traced)"] += 1

    def _collective(self, func, args, kwargs) -> None:
        kind = _COLLECTIVES.get(func._opname)
        if kind is None:
            self.warnings[str(func)] += 1
            return
        first = args[0] if args else None
        self.collectives[kind] += sum(
            float(t.numel() * t.element_size()) for t in _tensors(first))

    def _cost(self, func, args, kwargs, out) -> None:
        self.n_ops += 1
        packet = func.overloadpacket
        if (func.is_view or packet in _NO_TRAFFIC
                or torch.Tag.inplace_view in func.tags):
            return
        tensors = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
        outs = _tensors(out)
        if not outs:
            return                        # a host query (promote_types)
        if packet is _aten.convolution_backward:
            self.flops_by_class[_flop_class(func, args[0].dtype)] += \
                _conv_backward_flops(args[0], args[1], args[2], args[7],
                                     args[10])
        elif packet in flop_registry:
            dtype = tensors[0].dtype if tensors else torch.float32
            self.flops_by_class[_flop_class(func, dtype)] += float(
                flop_registry[packet](*args, **kwargs, out_val=out))
        elif torch.Tag.reduction in func.tags:
            self.flops_by_class["f32"] += float(
                tensors[0].numel() if tensors else 0)
        elif packet in _MOVES:
            pass
        elif torch.Tag.pointwise in func.tags or any(
                o.shape == t.shape for o in outs for t in tensors):
            # elementwise, or elementwise in shape (a norm, its backward):
            # one operation an output element
            self.flops_by_class["f32"] += float(sum(t.numel() for t in outs))
        else:
            self.warnings[str(packet)] += 1
        if not any(t.device.type != "cpu" for t in tensors + outs):
            return
        overwrite = packet in _OVERWRITE
        nbytes = 0.0
        for arg, val in _arg_values(func, args, kwargs):
            written = arg.alias_info is not None and arg.alias_info.is_write
            for t in _tensors(val):
                b = _tensor_bytes(t)
                nbytes += b if not written else (b if overwrite else 2 * b)
        for ret, val in zip(func._schema.returns,
                            out if isinstance(out, (tuple, list))
                            and len(func._schema.returns) > 1 else (out,)):
            if ret.alias_info is None:
                nbytes += sum(_tensor_bytes(t) for t in _tensors(val))
        self.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._on and func.namespace not in ("prim", "profiler"):
            if func._schema.name == "repro_torch::model_all_reduce":
                # the model group's all-reduce of a float32 copy (the op's
                # own collective runs outside the mode)
                x = args[0]
                self.collectives["all-reduce"] += float(x.numel() * 4)
            elif func.namespace == "repro_torch":
                self._fake_quant(func, args, kwargs)
            elif func.namespace in ("c10d", "_c10d_functional"):
                self._collective(func, args, kwargs)
            else:
                self._cost(func, args, kwargs, out)
        self._track(out)
        return out

    def result(self) -> dict:
        colls = dict(self.collectives)
        return {
            "flops": float(sum(self.flops_by_class.values())),
            "flops_by_class": {k: float(v)
                               for k, v in sorted(self.flops_by_class.items())},
            "int_ops": float(self.int_ops),
            "bytes": float(self.bytes),
            "collectives": colls,
            "collective_bytes": float(sum(colls.values())),
            "collective_wire_bytes": float(sum(
                v * roofline.WIRE_FACTOR[k] for k, v in colls.items())),
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
            "peak_bytes": float(self.peak_bytes),
            "ops": self.n_ops,
            "warnings": dict(sorted(self.warnings.items())),
            "trace_s": self.trace_s,
        }


def trace(fn: Callable, *args, **kwargs) -> dict:
    """The analysis of ``fn(*args, **kwargs)``, called inside
    :func:`fake_device` on its tensors (which count as alive from the
    start)."""
    with OpAnalysis() as a:
        a.hold((args, kwargs))
        with a.counting():
            fn(*args, **kwargs)
    return a.result()


_AFFINE = ("flops", "int_ops", "bytes", "collective_bytes",
           "collective_wire_bytes", "peak_bytes", "ops")


def extrapolate(one: dict, two: dict, n: int, at: int = 1) -> dict:
    """The analysis of ``n`` trips from those of ``at`` trips (``one``)
    and ``at + 1`` (``two``): every count ``c(at) + (n - at) (c(at + 1) -
    c(at))``."""
    def line(a, b):
        return a + (n - at) * (b - a)

    out = dict(two)
    for key in _AFFINE:
        out[key] = line(one[key], two[key])
    for key in ("flops_by_class", "collectives"):
        out[key] = {k: line(one[key].get(k, 0.0), two[key].get(k, 0.0))
                    for k in sorted(set(one[key]) | set(two[key]))}
    out["kernels"] = {
        name: {f: line(one["kernels"].get(name, {}).get(f, 0),
                       two["kernels"][name][f]) for f in two["kernels"][name]}
        for name in two["kernels"]}
    out["warnings"] = {
        k: line(one["warnings"].get(k, 0), two["warnings"].get(k, 0))
        for k in sorted(set(one["warnings"]) | set(two["warnings"]))}
    out["trace_s"] = one["trace_s"] + two["trace_s"]
    out["trips"] = n
    return out


# --------------------------------------------------------------------------- #
# the port's steps
# --------------------------------------------------------------------------- #
def train_batch_spec(model, batch: int, seq: int) -> dict:
    """``{name: (shape, dtype)}`` of a training batch as the trainer puts
    it on the device: images and labels (CNNs), tokens and labels (BERT),
    the model's ``batch_spec`` (the encoder-decoder's tokens and frames),
    else token ids (the VLM's training batch carries no vision prefix,
    as the CLI's)."""
    cfg = model.config
    if cfg.family in ("resnet", "densenet"):
        s = cfg.image_size
        return {"image": ((batch, s, s, cfg.in_channels), torch.float32),
                "label": ((batch,), torch.int32)}
    if cfg.family == "bert":
        return {"tokens": ((batch, seq), torch.int32),
                "label": ((batch,), torch.int32)}
    if cfg.family == "encdec":
        return model.batch_spec(batch, seq)
    return {"tokens": ((batch, seq), torch.int32)}


@contextlib.contextmanager
def fake_world(shape, axis_names, rank: int = 0):
    """A world of ``prod(shape)`` ranks in which this process is ``rank``
    and every collective only counts: ``torch``'s fake process group
    (``torch.testing._internal.distributed.fake_pg``), whose collectives
    return at once, on ``meta`` tensors too.  Yields the
    ``launch.mesh.CompatMesh`` of ``shape`` over ``axis_names`` (its
    groups made in the fake world); the world is torn down after."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_compat_mesh

    if dist.is_initialized():
        raise RuntimeError("a fake world needs a process without one")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=int(math.prod(shape)))
    try:
        yield make_compat_mesh(tuple(shape), tuple(axis_names))
    finally:
        dist.destroy_process_group()


def train_trips(run: RunConfig, mesh=None):
    """``(trips, examples a trip)`` of the train step: the vmap engine's
    microbatches (the global ones on ``mesh``), or the ghost engine's
    pass-1 chunks."""
    from repro_torch.launch.steps import _microbatch

    B = run.global_batch
    if not run.dp.enabled:
        return 1, B
    if run.dp.grad_mode == "ghost":
        chunk = run.dp.ghost_microbatch or B
    else:
        chunk = _microbatch(run, mesh)
    if B % chunk:
        return 1, B
    return B // chunk, chunk


#: Trips from which the vmap engine's counts are affine: its peak too
#: (the first trip starts the clipped sum, later ones add to it).
_AFFINE_FROM = 2


def _trace_train(run: RunConfig, device="meta", mesh=None) -> dict:
    from repro_torch.launch.steps import build_train_setup
    from repro_torch.models.registry import build_model

    with fake_device(device) as dev, OpAnalysis() as a:
        model = build_model(run.model, run.quant, device=dev)
        setup = build_train_setup(model, run, mesh)
        whole = model.init(run.seed)
        # this rank's shard on a mesh's model axis (the whole batch: the
        # engines take their rank's examples of each microbatch)
        params = setup.shard(whole) if setup.model_parallel else whole
        opt_state = setup.opt_init_fn(params)
        batch = {name: torch.zeros(shape, dtype=dtype, device=dev)
                 for name, (shape, dtype) in train_batch_spec(
                     model, run.global_batch, run.seq_len).items()}
        qflags = torch.ones((run.model.policy_len(),), dtype=torch.float32,
                            device=dev)
        lr = torch.full((), run.optim.lr, dtype=torch.float32, device=dev)
        with a.counting():
            out = setup.step_fn(params, opt_state, batch, None, qflags, lr)
            del out
        res = a.result()
        res["n_params"] = roofline.count_params(whole)
        res["n_active_params"] = roofline.active_params(run.model, whole)
        if run.model.family in ("resnet", "densenet"):
            # a CNN has no tokens: 3x one image's forward FLOPs an image
            with torch.no_grad():
                one = trace(model.forward, params, batch["image"][:1],
                            [False] * run.model.policy_len())
            res["model_flops"] = 3.0 * one["flops"] * run.global_batch
        else:
            res["model_flops"] = roofline.model_flops(
                run.model, whole, "train", run.global_batch, run.seq_len,
                _devices(mesh))
    return res


def _devices(mesh) -> int:
    """The ranks of ``mesh`` (1 for none)."""
    return 1 if mesh is None else int(mesh.devices.size)


def analyze_train(run: RunConfig, *, device="meta", mesh=None) -> dict:
    """The analysis of one train step of ``run`` (its own batch); with
    ``n_params``, ``n_active_params`` and ``model_flops`` (a CNN's: 3x the
    forward's FLOPs of its images).  The vmap
    engine's microbatches (:func:`train_trips`) are extrapolated from
    two trips and three, unless there are no more than five (as many as
    those two traces take); the ghost engine is traced whole (its pass 2
    runs over the whole batch, so its peak is not affine in the
    chunks)."""
    trips, chunk = train_trips(run, mesh)
    at = _AFFINE_FROM
    if trips <= 2 * at + 1 or run.dp.grad_mode == "ghost":
        res = _trace_train(run, device, mesh)
        res["trips"] = trips
        return res
    one, two = (_trace_train(dataclasses.replace(run, global_batch=t * chunk),
                             device, mesh) for t in (at, at + 1))
    res = extrapolate(one, two, trips, at)
    # 6 N D and the attention term are linear in the batch
    res["model_flops"] = two["model_flops"] * trips / (at + 1)
    return res


def analyze_serve(model_cfg, quant, kind: str, batch: int, seq_len: int, *,
                  kv_fmt: str = "none", seed: int = 0,
                  device="meta", mesh=None) -> dict:
    """The analysis of one oneshot ``prefill`` of ``batch`` x ``seq_len``
    tokens, or one ``decode`` step over the cache of ``seq_len``
    positions that a prefill of ``seq_len - 1`` leaves
    (``steps.build_serve_setup``); with ``n_params``,
    ``n_active_params`` and ``model_flops``.  On ``mesh``: this rank's
    program, its shard of the params, its block of the batch and its
    shard of the cache (``model_flops`` a device's share)."""
    from repro_torch.launch.steps import build_serve_setup, materialize
    from repro_torch.models.registry import build_model

    if kind not in ("prefill", "decode"):
        raise ValueError(f"kind must be 'prefill' or 'decode', got {kind!r}")
    run = RunConfig(model=model_cfg, quant=quant, seed=seed,
                    global_batch=batch, seq_len=seq_len)
    with fake_device(device) as dev, OpAnalysis() as a:
        model = build_model(model_cfg, quant, device=dev)
        setup = build_serve_setup(model, run, mesh, batch, seq_len, kv_fmt)
        fn, spec = ((setup.prefill_fn, setup.prefill_abstract)
                    if kind == "prefill"
                    else (setup.decode_fn, setup.decode_abstract))
        args = materialize(spec, dev)
        with a.counting(), torch.no_grad():
            out = fn(*args)
            del out
        res = a.result()
        # on a mesh, the whole params' counts (the reference's)
        whole = model.init(seed) if mesh is not None else args[0]
        res["n_params"] = roofline.count_params(whole)
        res["n_active_params"] = roofline.active_params(model_cfg, whole)
        res["model_flops"] = roofline.model_flops(model_cfg, whole, kind,
                                                  batch, seq_len,
                                                  _devices(mesh))
    return res


def kernel_calls(result: dict) -> dict:
    """``{kernel: calls}`` of an analysis, every kernel named."""
    return {k: int(round(result["kernels"].get(k, {}).get("calls", 0)))
            for k in roofline.KERNELS}


def fits(result: dict) -> bool:
    return result["peak_bytes"] <= roofline.DEVICE_BYTES
