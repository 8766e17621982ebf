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
``shape``.  :class:`Spec` stands in for ``PartitionSpec``; the reference's
``NamedSharding`` builders (``named_sharding``, ``tree_shardings``,
``activation_resolver``, ``apply_spec_tree``) have no use while the port
trains on the data axes alone, where each rank holds whole parameters and
:func:`local_slice` gives it its block of the batch.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

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
