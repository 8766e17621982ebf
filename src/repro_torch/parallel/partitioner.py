"""Logical-axis partitioner with divisibility fallback.

The counterpart of ``repro.parallel.partitioner``, as pure Python.  Every
tensor carries a tuple of logical axis names.  A *rule table* maps each
name to an ordered list of mesh-axis candidates; per tensor, dims are
assigned greedily in order:

  * a candidate is a tuple of mesh axes (e.g. ``("pod", "data")``);
  * it is taken iff all its axes exist in the mesh, none is already used
    by this tensor, and their size product divides the dim;
  * otherwise the next candidate is tried; no candidate -> dim unsharded.

A mesh is any object with ``axis_names`` and a shape: ``devices.shape``
(the reference's meshes, ``repro_torch.launch.mesh.CompatMesh``) or
``shape``.  :class:`Spec` stands in for ``PartitionSpec``.

The reference's ``tree_shardings`` becomes :func:`tree_specs`: the specs
of a flat parameter dict.  Where GSPMD lays a parameter out by its
``NamedSharding``, here :func:`shard_tree` gives each rank its
:func:`local_slice` of every leaf, and :func:`unshard_tree` gathers the
whole leaves back (a checkpoint is written unsharded, as the
reference's are).  The port lays parameters out over the ``model`` axis
only (:func:`param_spec`): a rule that names a data axis for a
parameter (arctic's and kimi-k2's ``expert_mlp`` over ``data``, the
``pod`` part of their ``experts`` rule) leaves that dim replicated over
that axis.  The numbers are the same; each data rank holds the whole
dim.  The reference's activation builders (``activation_resolver``,
``apply_spec_tree``) have no counterpart: the model code itself runs on
its shards (``repro_torch.parallel.axes``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Candidate = Tuple[str, ...]
Rules = Dict[str, Tuple[Candidate, ...]]

# ordered candidates per logical axis name
DEFAULT_RULES: Rules = {
    "batch": (("pod", "data"), ("data",)),
    "vocab": (("model",),),
    "embed": (),
    "mlp": (("model",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "head_dim": (),
    "experts": (("model",),),
    "expert_mlp": (),
    "layers": (),
    "seq": (),
    "kv_seq": (("model",),),       # fallback after kv_heads (greedy order)
    "state": (),
    "conv": (),
}


class Spec(tuple):
    """One entry per tensor dim: None (unsharded), a mesh axis name, or a
    tuple of names (the dim split over their product, the first the
    slowest), as ``jax.sharding.PartitionSpec`` holds them."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a mesh (module docstring)."""
    devices = getattr(mesh, "devices", None)
    shape = devices.shape if devices is not None else mesh.shape
    if isinstance(shape, Mapping):
        return {k: int(v) for k, v in shape.items()}
    return dict(zip(mesh.axis_names, (int(s) for s in shape)))


def entry_axes(entry) -> Candidate:
    """The mesh axes of one :class:`Spec` entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def merge_rules(base: Rules, overrides: Sequence[
        Tuple[str, Tuple[Candidate, ...]]]) -> Rules:
    rules = dict(base)
    for name, cands in overrides:
        rules[name] = tuple(tuple(c) for c in cands)
    return rules


def assign_spec(logical: Sequence[Optional[str]], shape: Sequence[int],
                mesh, rules: Rules) -> Spec:
    """Greedy mesh-axis assignment for one tensor."""
    sizes = axis_sizes(mesh)
    used = set()
    entries = []
    if len(logical) != len(shape):
        raise ValueError(f"logical axes {logical} rank != shape {shape}")
    for name, dim in zip(logical, shape):
        chosen = None
        for cand in rules.get(name, ()) if name else ():
            if not cand:
                continue
            if any(a not in sizes for a in cand):
                continue
            if any(a in used for a in cand):
                continue
            prod = 1
            for a in cand:
                prod *= sizes[a]
            if prod == 0 or dim % prod != 0:
                continue
            chosen = cand
            break
        if chosen is None:
            entries.append(None)
        else:
            used.update(chosen)
            entries.append(chosen if len(chosen) > 1 else chosen[0])
    return Spec(*entries)


def local_slice(entry, dim: int, mesh) -> slice:
    """The block of a dim of size ``dim`` that this rank holds under the
    spec entry ``entry``: block ``i`` of ``n`` equal blocks, ``n`` the
    product of the entry's axis sizes and ``i`` the rank's mesh
    coordinates over those axes, row-major (the first axis slowest), as
    a ``NamedSharding`` lays the dim over the devices."""
    axes = entry_axes(entry)
    sizes = axis_sizes(mesh)
    n, i = 1, 0
    for a in axes:
        n *= sizes[a]
        i = i * sizes[a] + mesh.coords[a]
    if dim % n:
        raise ValueError(f"dim {dim} does not divide over {axes} ({n})")
    step = dim // n
    return slice(i * step, (i + 1) * step)


def tree_specs(axes: Mapping[str, Optional[Tuple]], shapes: Mapping[str, Tuple],
               mesh, rules: Rules) -> Dict[str, Spec]:
    """``{name: Spec}`` of a flat parameter dict from its logical axes and
    shapes (the reference's ``tree_shardings``): a leaf with no axes, or
    0-dim, is replicated."""
    out = {}
    for name, shape in shapes.items():
        logical = axes.get(name)
        if logical is None or len(shape) == 0:
            out[name] = Spec(*([None] * len(shape)))
        else:
            out[name] = assign_spec(logical, tuple(shape), mesh, rules)
    return out


def param_spec(spec: Spec, axis: str = "model") -> Spec:
    """The layout the port gives a parameter of ``spec``: only ``axis``
    kept in each entry, every other mesh axis replicated (module
    docstring)."""
    return Spec(*(axis if axis in entry_axes(e) else None for e in spec))


def split_dims(spec: Spec) -> Tuple[int, ...]:
    """The dims a :func:`param_spec` splits."""
    return tuple(i for i, e in enumerate(spec) if e is not None)


def local_shape(spec: Spec, shape: Sequence[int], mesh) -> Tuple[int, ...]:
    """The shape of this rank's block of a tensor of ``shape``."""
    return tuple(len(range(*local_slice(e, d, mesh).indices(d)))
                 if e is not None else d for e, d in zip(spec, shape))


def shard_tree(params: Mapping[str, torch.Tensor], specs: Mapping[str, Spec],
               mesh) -> Dict[str, torch.Tensor]:
    """This rank's block of every leaf (a contiguous copy of a split leaf,
    the leaf itself otherwise)."""
    out = {}
    for name, t in params.items():
        spec = specs[name]
        if not split_dims(spec):
            out[name] = t
            continue
        index = tuple(local_slice(e, d, mesh) if e is not None
                      else slice(None) for e, d in zip(spec, t.shape))
        out[name] = t[index].contiguous()
    return out


def unshard_tree(params: Mapping[str, torch.Tensor],
                 specs: Mapping[str, Spec], shapes: Mapping[str, Tuple],
                 mesh) -> Dict[str, torch.Tensor]:
    """The whole leaves of ``shapes`` from every rank's block, on every
    rank: for each split leaf one all-reduce SUM of a zero float32
    buffer that each rank fills at its block (gloo on CUDA tensors has
    no all-gather; adding zeros is exact)."""
    out = {}
    for name, t in params.items():
        spec = specs[name]
        dims = split_dims(spec)
        if not dims:
            out[name] = t
            continue
        axes = tuple(dict.fromkeys(a for i in dims
                                   for a in entry_axes(spec[i])))
        group = mesh.axis_group(axes)
        buf = torch.zeros(tuple(shapes[name]), dtype=torch.float32,
                          device=t.device)
        index = tuple(local_slice(e, d, mesh) if e is not None
                      else slice(None) for e, d in zip(spec, buf.shape))
        buf[index] = t.float()
        if group.group is not None:
            dist.all_reduce(buf, group=group.group)
        out[name] = buf.to(t.dtype)
    return out
