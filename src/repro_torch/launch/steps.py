"""The train step: DP-SGD / DP-Adam or plain, as one functional call, and
the ``scan`` executor's epoch program around it.

The counterpart of ``repro.launch.steps.build_train_setup``: the clipped
gradient sum of the vmap engine (``dp.clip``) or the ghost engine
(``dp.ghost``), noised, then the optimizer.  On a mesh
(``repro_torch.launch.mesh.CompatMesh``, one rank a device) the step is
data parallel over the ``pod`` and ``data`` axes with the parameters
replicated: every rank is given the same global batch and computes its
share of it (the sharded ghost driver a contiguous block, the vmap
engine its block of every microbatch), the ranks sum the clipped sums,
and every rank adds the same noise (its generator in the same state on
every rank, the reference's SPMD-consistent draw) divided by the global
batch, so the update, and then the params, are the same bits on every
rank.  The unsharded ghost driver (``ghost_sharded`` off, or a batch
that does not divide) and ``dp.enabled=False`` run the whole batch on
every rank.  A mesh whose ``model`` axis has degree > 1 (tensor and
expert parallelism) is not ported and raises.  ``step_fn(params, opt_state,
batch, seed, qflags, lr) -> (params, opt_state, metrics)`` returns new
params and optimizer state and writes neither argument in place, which
is what lets the DPQuant probes restore the model by keeping the old
ones.  It never synchronizes with the host: the metrics are 0-dim device
tensors, and ``lr`` may be a 0-dim device tensor.

The DP noise comes from one generator, ``TrainSetup.noise_gen``, that the
step re-seeds to ``NOISE_SEED_OFFSET + seed`` when given a ``seed`` (the
loop executor and the probes) and draws from as it stands when ``seed``
is None (the scan executor, which seeds it before each replay).

:class:`EpochRunner` is the counterpart of ``build_epoch_fn``: k steps
over static buffers, one CUDA graph of the step for every quantization
policy (the policy flags are one of its static inputs).

:func:`build_serve_setup` is the counterpart of the reference's: the
oneshot prefill and decode functions and their abstract inputs as
:class:`TensorSpec` trees, which :func:`eval_shape` derives (the
reference's ``jax.eval_shape``) from one run on fake tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import grad_and_value
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                 tree_unflatten)

from repro_torch.config import (RunConfig, generator, torch_dtype,
                                traced_device)
from repro_torch.dp.clip import per_example_clipped_grad_sum
from repro_torch.dp.engine import validate_grad_mode
from repro_torch.dp.ghost import (ghost_clipped_grad_sum,
                                  sharded_ghost_clipped_grad_sum)
from repro_torch.dp.noise import add_gaussian_noise
from repro_torch.graph import StepGraph
from repro_torch.kernels import ops
from repro_torch.launch.mesh import DATA_AXES, data_degree
from repro_torch.models.registry import Model
from repro_torch.optim import apply_updates, make_optimizer
from repro_torch.parallel import axes as pax
from repro_torch.parallel import partitioner as pt
from repro_torch.serve.oneshot import build_oneshot_fns

# Offset of the DP noise's generator seed from the step seed: each step
# draws its noise from its own stream, seeded from the step seed alone
# (the JAX package splits PRNGKey(seed) into clip, noise and loss keys).
# Below 2**31 with the step seed added, as PyTorch's CPU generator keeps
# only the low 32 bits of a seed.
NOISE_SEED_OFFSET = 2 ** 29


@dataclasses.dataclass
class TrainSetup:
    step_fn: Callable
    opt_init_fn: Callable
    noise_gen: torch.Generator
    mesh: Optional[object] = None
    #: whether the ghost step runs the sharded driver
    ghost_sharded: bool = False
    #: what a batch's size must be a multiple of: the vmap engine's
    #: global microbatch, or the sharded ghost driver's shard count
    batch_multiple: int = 1
    #: on a model-parallel mesh: each leaf's layout (``Spec``, the model
    #: axis only) and whole shape; empty otherwise
    param_specs: dict = dataclasses.field(default_factory=dict)
    param_shapes: dict = dataclasses.field(default_factory=dict)
    #: ``grad_fn(params, batch, qflags) -> (grads, metrics)``: the step's
    #: gradient alone, the clipped sum before the noise under DP (this
    #: rank's blocks of it on a model-parallel mesh)
    grad_fn: Optional[Callable] = None

    @property
    def model_parallel(self) -> bool:
        return any(pt.split_dims(s) for s in self.param_specs.values())

    def _map(self, tree, fn):
        """``fn`` applied to each dict of leaves keyed like the params in
        ``tree`` (the params, an optimizer state's dicts)."""
        if isinstance(tree, dict) and set(tree) == set(self.param_specs):
            return fn(tree)
        if isinstance(tree, tuple):
            out = [self._map(t, fn) for t in tree]
            return type(tree)(*out) if hasattr(tree, "_fields") else tuple(
                out)
        return tree

    def shard(self, tree):
        """This rank's blocks of a whole tree (params or optimizer
        state); the tree itself off a model-parallel mesh."""
        if not self.model_parallel:
            return tree
        return self._map(tree, lambda d: pt.shard_tree(
            d, self.param_specs, self.mesh))

    def unshard(self, tree):
        """The whole tree from every rank's blocks, on every rank (a
        collective: every rank of the mesh calls it)."""
        if not self.model_parallel:
            return tree
        return self._map(tree, lambda d: pt.unshard_tree(
            d, self.param_specs, self.param_shapes, self.mesh))

    def whole_like(self, tree):
        """Empty tensors of the whole tree's shapes (a restore's
        template)."""
        if not self.model_parallel:
            return tree
        return self._map(tree, lambda d: {
            k: torch.empty(self.param_shapes[k], dtype=t.dtype,
                           device=t.device) for k, t in d.items()})


def _microbatch(run: RunConfig, mesh) -> int:
    """The global microbatch: ``microbatch_size`` examples per data
    shard, or 1 under ``microbatch_mode="single"`` (the reference's)."""
    if run.dp.microbatch_mode == "single":
        return 1
    if run.dp.microbatch_mode != "data_parallel":
        raise ValueError(f"dp.microbatch_mode must be 'data_parallel' or "
                         f"'single', got {run.dp.microbatch_mode!r}")
    mb = run.dp.microbatch_size * data_degree(mesh)
    return max(1, min(mb, run.global_batch))


def build_train_setup(model: Model, run: RunConfig, mesh=None) -> TrainSetup:
    if model.loss_fn is None:
        raise ValueError(f"model family {model.config.family!r} has no "
                         "training hooks in repro_torch yet")
    if run.dp.enabled:
        validate_grad_mode(run.dp, model)
    opt = make_optimizer(run.optim)
    mb = _microbatch(run, mesh)
    accum_dtype = torch_dtype(run.dp.grad_accum_dtype)
    ghost = run.dp.enabled and run.dp.grad_mode == "ghost"
    noise_gen = generator(model.device)

    # ---- the data-parallel strategy (the reference's, data axes only) ----
    sizes = pt.axis_sizes(mesh) if mesh is not None else {}
    model_degree = sizes.get("model", 1)
    dp_shards = data_degree(mesh)
    gs = run.dp.ghost_sharded
    if ghost and gs == "on" and model_degree > 1:
        raise ValueError("dp.ghost_sharded='on' requires params replicated "
                         "over the data axes (model axis degree 1); use "
                         "'auto'/'off' on model-parallel meshes")
    if model_degree > 1 and model.param_axes is None:
        raise NotImplementedError(
            f"training the {model.config.family!r} family on a mesh whose "
            f"model axis has degree {model_degree} is not ported yet: the "
            f"family has no param_axes (ROADMAP.md section 1); the dense "
            f"LMs and the MoE LMs train there")
    if gs == "on":
        ghost_sharded = ghost and mesh is not None
    else:
        ghost_sharded = (gs == "auto" and ghost and dp_shards > 1
                         and model_degree == 1
                         and run.global_batch % dp_shards == 0)
    rules = pt.merge_rules(pt.DEFAULT_RULES, model.config.sharding_overrides)
    specs, shapes, layout, replicated = {}, {}, {}, frozenset()
    model_axis = None
    if model_degree > 1:
        shapes = {k: tuple(v.shape) for k, v in eval_shape(
            lambda: model.init(run.seed), device=model.device).items()}
        specs = {k: pt.param_spec(v) for k, v in pt.tree_specs(
            model.param_axes(), shapes, mesh, rules).items()}
        replicated = frozenset(k for k, v in specs.items()
                               if not pt.split_dims(v))
        layout = {k: (shapes[k], tuple(
            pt.local_slice(e, d, mesh) if e is not None else slice(None)
            for e, d in zip(specs[k], shapes[k])))
            for k in specs if k not in replicated}
        model_axis = mesh.model_group()
    shard, partial = None, False
    if dp_shards > 1:
        # the microbatch's example axis, laid out as the reference's
        # micro_constrain lays it, under the arch's rule overrides (the MoE
        # configs shard the batch over "data" alone: the ranks of one data
        # coordinate compute the same examples, and the clipped sums are
        # reduced over the data group, not the world)
        entry = pt.assign_spec(("batch",), (mb,), mesh, rules)[0]
        shard = mesh.axis_group(pt.entry_axes(entry))
        partial = run.dp.partial_accum and mb % dp_shards == 0
        if shard.group is None:
            shard = None

    def train_step(params, opt_state, batch, seed, qflags, lr):
        with pax.partitioning_context(model_axis):
            return _train_step(params, opt_state, batch, seed, qflags, lr)

    def grad_fn(params, batch, qflags):
        with pax.partitioning_context(model_axis):
            return _grads(params, batch, qflags)

    def _grads(params, batch, qflags):
        if ghost:
            kw = dict(clip_norm=run.dp.clip_norm,
                      hooked_mask=model.ghost_mask(params),
                      aux=(model.ghost_aux(qflags)
                           if model.ghost_aux is not None else None),
                      ghost_microbatch=run.dp.ghost_microbatch,
                      accum_dtype=accum_dtype)
            pel = lambda p, b, hooks: model.per_example_loss(  # noqa: E731
                p, b, qflags, hooks=hooks)
            if ghost_sharded:
                grad_sum, metrics = sharded_ghost_clipped_grad_sum(
                    pel, params, batch, mesh=mesh, data_axes=DATA_AXES, **kw)
            else:
                grad_sum, metrics = ghost_clipped_grad_sum(
                    pel, params, batch, **kw)
        elif run.dp.enabled:
            def loss_one(p, ex):
                return model.loss_fn(p, {k: v[None] for k, v in ex.items()},
                                     qflags)

            grad_sum, metrics = per_example_clipped_grad_sum(
                loss_one, params, batch, clip_norm=run.dp.clip_norm,
                microbatch_size=mb, clip_backend=run.dp.clip_backend,
                accum_dtype=accum_dtype, shard=shard, partial_accum=partial,
                replicated=replicated)
        else:
            grad_sum, loss = grad_and_value(
                lambda p: model.loss_fn(p, batch, qflags))(params)
            metrics = {"loss": loss}
        return grad_sum, metrics

    def _train_step(params, opt_state, batch, seed, qflags, lr):
        grads, metrics = _grads(params, batch, qflags)
        if run.dp.enabled:
            if seed is not None:
                noise_gen.manual_seed(NOISE_SEED_OFFSET + int(seed))
            # the expected batch size, as in the JAX package (a probe
            # batch of another size is divided by it too)
            grads = add_gaussian_noise(
                grads, clip_norm=run.dp.clip_norm,
                noise_multiplier=run.dp.noise_multiplier,
                batch_size=run.global_batch, generator=noise_gen,
                layout=layout)
        updates, new_opt = opt.update(grads, opt_state, params, lr)
        del grads
        return apply_updates(params, updates), new_opt, metrics

    return TrainSetup(step_fn=train_step, opt_init_fn=opt.init,
                      noise_gen=noise_gen, mesh=mesh, grad_fn=grad_fn,
                      ghost_sharded=ghost_sharded,
                      batch_multiple=(dp_shards if ghost_sharded else
                                      mb if run.dp.enabled and not ghost
                                      else 1),
                      param_specs=specs, param_shapes=shapes)


class EpochRunner:
    """The ``scan`` executor's program: ``k`` train steps of
    ``setup.step_fn`` over static buffers, with a host sync only where the
    caller reads the metrics.

    ``runner(params, opt_state, batches, seeds, qflags, lrs) -> (params,
    opt_state, metrics)``: ``batches`` holds the chunk's batches stacked on
    a leading step axis on the device; ``seeds`` are the k step seeds
    (host ints); ``qflags`` the DPQuant policy, a (policy_len,) float32
    tensor (or host bools); ``lrs`` a (k,) float32 device tensor;
    ``metrics`` every metric of the step as a (k,) device tensor.

    Static buffers: the params and optimizer state are the runner's own
    tensors, and so is the flags tensor.  With ``adopt`` (the epoch) they
    are the first ones it is given (adopted, not copied), and the params
    it returns; with ``adopt=False`` (the DPQuant probes, which must leave
    the model as it was) copies of them.  State from elsewhere (a loop
    epoch, the snapshot a probe restores) is copied into them, one copy a
    call.  One step reads them, the step's batch and lr from fixed
    addresses and copies its new params and optimizer state back into
    them, the counterpart of the reference's donated buffers.  Step i
    copies batch i and lr i into the static inputs and re-seeds
    ``setup.noise_gen`` to ``NOISE_SEED_OFFSET + seeds[i]``, as the loop
    does.

    On CUDA that step is a ``repro_torch.graph.StepGraph``, captured once
    for each set of batch shapes (after an eager warm-up step) and
    replayed k times; the noise generator is registered with it.  The
    policy is not part of the graph: the quantizers read the static flags
    tensor on the device, so a new policy is one copy into it, as the
    reference's traced flags never recompile.  The graph's intermediates
    live in ``pool`` (its own ``torch.cuda.graph_pool_handle()`` when
    None).  ``warmed``: a set shared by the runners of one pool, of the
    graph keys an eager warm-up step has run for; a key found there is
    captured without one (``StepGraph(warm=False)``), so that the eager
    step's temporaries never need memory beside the pool's.  On the CPU
    the same step runs directly.

    On a mesh of several ranks the step's collectives are captured with
    it, which NCCL allows and gloo does not: on CUDA under gloo (ranks
    sharing a card) the runner raises when it is made, and under NCCL the
    warm-up first runs one collective on every group of the mesh, so that
    each communicator exists before the capture.
    """

    def __init__(self, setup: TrainSetup, device, *, adopt: bool = True,
                 pool=None, warmed: Optional[set] = None):
        self.device = torch.device(device)
        mesh = setup.mesh
        self._mesh = (mesh if mesh is not None and mesh.devices.size > 1
                      else None)
        if (self._mesh is not None and self.device.type == "cuda"
                and dist.get_backend() == "gloo"):
            raise RuntimeError(
                "the scan executor captures the step in a CUDA graph, and "
                "gloo's collectives (ranks that share a card) cannot be "
                "captured: use the loop executor")
        self.setup = setup
        self.adopt = adopt
        self._leaves = None          # static params + opt state, flattened
        self._spec = None
        self._flags = None           # static policy flags
        self._graph = None
        self._key = None             # (batch shapes, flags shape) of the graph
        self._batch = None
        self._lr = None
        self._pool = pool
        if pool is None and self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
        self._warmed = set() if warmed is None else warmed
        #: One entry per capture, in order: its (batch shapes, flags shape).
        self.captured = []
        #: Captures that ran an eager warm-up step first.
        self.warmups = 0
        #: Seconds spent on warm-up and capture in the last call.
        self.last_capture_s = 0.0

    def _bind(self, params, opt_state) -> None:
        leaves, spec = tree_flatten((params, opt_state))
        if self._leaves is None or spec != self._spec or any(
                a.shape != b.shape or a.dtype != b.dtype
                for a, b in zip(leaves, self._leaves)):
            self.close()
            self._leaves = (leaves if self.adopt
                            else [t.detach().clone() for t in leaves])
            self._spec = spec
            return
        pairs = [(dst, src) for dst, src in zip(self._leaves, leaves)
                 if dst is not src]
        if pairs:
            torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])

    def _bind_flags(self, qflags) -> None:
        flags = (qflags if isinstance(qflags, torch.Tensor)
                 else torch.tensor(qflags, dtype=torch.float32))
        if self._flags is None or self._flags.shape != flags.shape:
            flags = flags.to(self.device, torch.float32)
            self._flags = (flags if self.adopt and flags is qflags
                           else flags.clone())
        elif flags is not self._flags:
            self._flags.copy_(flags)

    def _step(self, write_back: bool):
        params, opt_state = tree_unflatten(self._leaves, self._spec)
        new_p, new_o, metrics = self.setup.step_fn(
            params, opt_state, self._batch, None, self._flags, self._lr)
        if write_back:
            torch._foreach_copy_(self._leaves, tree_leaves((new_p, new_o)))
        return metrics

    def _capture(self, key, batches: dict) -> None:
        self.close()
        self._batch = {k: v[0].clone() for k, v in batches.items()}
        self._lr = torch.zeros((), dtype=torch.float32, device=self.device)
        warm = key not in self._warmed

        def warmup():
            if self._mesh is not None:
                self._mesh.warm_collectives(self.device)
            return self._step(False)

        self._graph = StepGraph(
            lambda: self._step(True), self.device,
            warmup=warmup, warm=warm,
            generators=(self.setup.noise_gen,), pool=self._pool)
        if warm and self.device.type == "cuda":
            self._warmed.add(key)
            self.warmups += 1
        self.captured.append(key)
        self.last_capture_s += self._graph.capture_s

    def close(self) -> None:
        """Free the graph (the static params stay)."""
        if self._graph is not None:
            self._graph.close()
            self._graph = None
            self._key = None
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    def __call__(self, params, opt_state, batches: dict, seeds, qflags,
                 lrs: torch.Tensor):
        self.last_capture_s = 0.0
        self._bind(params, opt_state)
        self._bind_flags(qflags)
        key = (tuple((k, tuple(v.shape[1:])) for k, v in batches.items()),
               tuple(self._flags.shape))
        if key != self._key:
            self._capture(key, batches)
            self._key = key
        k = len(seeds)
        out = None
        for i in range(k):
            for name, t in self._batch.items():
                t.copy_(batches[name][i])
            self._lr.copy_(lrs[i])
            seed = NOISE_SEED_OFFSET + int(seeds[i])
            self.setup.noise_gen.manual_seed(seed)
            metrics = self._graph()
            if out is None:
                out = {n: torch.empty((k,), dtype=m.dtype, device=m.device)
                       for n, m in metrics.items()}
            for n, m in metrics.items():
                out[n][i].copy_(m)
        params, opt_state = tree_unflatten(self._leaves, self._spec)
        return params, opt_state, out


# --------------------------------------------------------------------------- #
# serving, and abstract inputs
# --------------------------------------------------------------------------- #
class TensorSpec(NamedTuple):
    """A tensor's shape and dtype: an abstract input (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _is_spec(x) -> bool:
    return isinstance(x, TensorSpec)


def spec_of(tree):
    """``tree`` with every tensor replaced by its :class:`TensorSpec`."""
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype)
                    if isinstance(t, torch.Tensor) else t, tree)


def materialize(tree, device):
    """``tree`` with every :class:`TensorSpec` replaced by zeros of its
    shape and dtype on ``device`` (fake tensors under a fake mode)."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device)
                    if _is_spec(s) else s, tree, is_leaf=_is_spec)


def eval_shape(fn, *args, device):
    """The :class:`TensorSpec` tree of ``fn(*args)``, from one run on
    shape-only tensors on ``device`` (a spec in ``args`` becomes one):
    ``meta`` tensors, or fake ones of ``torch``'s ``FakeTensorMode`` on
    another device (the mode already active, if one is).  Nothing is
    allocated, and a kernel call launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dev = torch.device(device)
    with contextlib.ExitStack() as stack:
        if dev.type != "meta" and torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is None:
            stack.enter_context(FakeTensorMode(allow_non_fake_inputs=True))
        if dev.type != "cpu":
            stack.enter_context(traced_device(dev))
        stack.enter_context(ops.traced_launches(lambda *a, **k: None))
        return spec_of(fn(*materialize(args, dev)))


def _serve_batch_spec(model: Model, batch_size: int, seq_len: int) -> dict:
    """The :class:`TensorSpec` of a serving batch: every input of the
    model's ``batch_spec``, or the token ids alone."""
    spec = (model.batch_spec(batch_size, seq_len)
            if model.batch_spec is not None
            else {"tokens": ((batch_size, seq_len), torch.int32)})
    return {name: TensorSpec(tuple(shape), dtype)
            for name, (shape, dtype) in spec.items()}


@dataclasses.dataclass
class ServeSetup:
    prefill_fn: Callable
    decode_fn: Callable
    prefill_abstract: Tuple
    decode_abstract: Tuple
    mesh: Optional[object] = None
    #: this rank's layout on a mesh whose model axis has degree above 1
    #: (``serve.layout.ServeLayout``), else None
    layout: Optional[object] = None
    #: the sequences this rank serves: the batch's block over the data
    #: axes, as the rules lay it out
    local_batch: int = 0

    def shard(self, params):
        """This rank's block of whole params (the params themselves
        without a layout); ``model.prepare`` it before serving."""
        return params if self.layout is None else self.layout.shard(params)


def build_serve_setup(model: Model, run: RunConfig, mesh, batch_size: int,
                      seq_len: int, kv_fmt: str = "none") -> ServeSetup:
    """The oneshot serving functions for ``batch_size`` sequences and a
    cache of ``seq_len`` positions (``serve.oneshot.build_oneshot_fns``,
    with its ``kv_fmt`` check), and their abstract inputs: the prepared
    params and a batch of ``seq_len`` tokens for ``prefill_fn(params,
    batch)``; the params, the cache a prefill of ``seq_len - 1`` tokens
    leaves and one token a sequence for ``decode_fn(params, cache,
    token)``.

    On a mesh (the reference's ``NamedSharding`` of the params, the batch
    and the cache): the inputs are this rank's, its shard of the params
    over the model axis (``serve.layout``), its block of the batch over
    the data axes (``batch`` under the rules), and its shard of that
    batch's cache, and the functions run under its model group's
    context; ``shard`` gives this rank's params of whole ones.  A data
    rank serves its own sequences: nothing is reduced over the data
    axes."""
    from repro_torch.serve.layout import serve_layout

    dev = model.device
    layout, local_batch = None, batch_size
    if mesh is not None:
        rules = pt.merge_rules(pt.DEFAULT_RULES,
                               model.config.sharding_overrides)
        entry = pt.assign_spec(("batch",), (batch_size,), mesh, rules)[0]
        local_batch = batch_size // max(1, int(np.prod(
            [pt.axis_sizes(mesh)[a] for a in pt.entry_axes(entry)])))
        shapes = {k: tuple(v.shape) for k, v in eval_shape(
            lambda: model.init(run.seed), device=dev).items()}
        layout = serve_layout(model, mesh, shapes, local_batch, seq_len,
                              kv_fmt)
    prefill_fn, decode_fn = build_oneshot_fns(model, seq_len, kv_fmt,
                                              layout=layout)
    shard = (lambda p: p) if layout is None else layout.shard
    params = eval_shape(lambda: model.prepare(shard(model.init(run.seed))),
                        device=dev)
    batch = _serve_batch_spec(model, local_batch, seq_len)
    if layout is None:
        cache = eval_shape(lambda p, b: prefill_fn(p, b)[1], params,
                           _serve_batch_spec(model, local_batch,
                                             max(1, seq_len - 1)),
                           device=dev)
    else:
        # this rank's shard of the cache, from its spec (a traced prefill
        # would run the model group's collectives)
        from repro_torch.models.transformer import kv_cache_spec
        with layout.context():
            spec = kv_cache_spec(model.config, local_batch, seq_len, kv_fmt)
        cache = {name: TensorSpec(tuple(shape), dtype)
                 for name, (shape, dtype) in spec.items() if name != "pos"}
        cache["pos"] = max(1, seq_len - 1)
    return ServeSetup(
        prefill_fn=prefill_fn, decode_fn=decode_fn,
        prefill_abstract=(params, batch),
        decode_abstract=(params, cache,
                         TensorSpec((local_batch,), torch.int32)),
        mesh=mesh, layout=layout, local_batch=local_batch)
