"""A served model's layout over a mesh's ``model`` axis.

The reference's serving entry points (``ContinuousEngine(mesh=)``,
``build_serve_setup``) take a mesh and lay the params, the batch and the
KV cache out by the rule table (``param_axes``, ``kv_cache_axes``, the
config's ``sharding_overrides``), and GSPMD runs each device's part.
Here each rank holds its shard of every parameter (the partitioner's
``local_slice``, the model axis only, as training lays it out) and runs
the model code under ``axes.partitioning_context`` of its model group,
with the KV cache's split the rules give the cache: its KV heads where
they divide the group, else its sequence rows (``kv_seq``), else whole.

:func:`serve_layout` is None for a mesh without a model axis of degree
above 1: the model code then runs unsharded.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.parallel import axes as pax
from repro_torch.parallel import partitioner as pt


@dataclasses.dataclass
class ServeLayout:
    """``param_specs`` (model axis only, ``partitioner.param_spec``),
    ``kv_split`` (the cache dim the model group splits, or None),
    ``model_axis`` (this rank's model group: an ``AxisGroup``, or None
    for a mesh without process groups, a ``MeshLayout``)."""

    mesh: object
    rules: pt.Rules
    param_specs: Dict[str, pt.Spec]
    kv_split: Optional[str]
    model_axis: Optional[object]

    def shard(self, params: Mapping) -> dict:
        """This rank's block of every leaf of whole ``params``."""
        return pt.shard_tree(params, self.param_specs, self.mesh)

    def context(self):
        """The model code's context on this rank (``axes``)."""
        if self.model_axis is None:
            return contextlib.nullcontext()
        return pax.partitioning_context(self.model_axis, self.kv_split)


def model_degree(mesh) -> int:
    """The size of a mesh's ``model`` axis (1 for no mesh or none)."""
    return 1 if mesh is None else pt.axis_sizes(mesh).get("model", 1)


def cache_split(model, mesh, rules: pt.Rules, batch: int,
                seq_len: int, kv_fmt: str = "none") -> Optional[str]:
    """The dim of a (layers, batch, KV, seq_len, head_dim) cache that the
    rules put on the ``model`` axis: ``"kv_heads"``, ``"kv_seq"`` or
    None."""
    cfg = model.config
    logical = model.cache_axes(kv_fmt)["k"]
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq_len, cfg.head_dim)
    spec = pt.assign_spec(logical, shape, mesh, rules)
    for name, entry in zip(logical, spec):
        if "model" in pt.entry_axes(entry):
            return name
    return None


def serve_layout(model, mesh, shapes: Mapping[str, Tuple[int, ...]],
                 batch: int, seq_len: int,
                 kv_fmt: str = "none") -> Optional[ServeLayout]:
    """The layout of ``model`` (whole params of ``shapes``) serving
    ``batch`` sequences in a cache of ``seq_len`` rows on ``mesh``, or
    None where the mesh's model axis has degree 1.  Raises for a family
    that has no ``param_axes`` or ``cache_axes`` (ROADMAP.md section 1)."""
    degree = model_degree(mesh)
    if degree == 1:
        return None
    cfg = model.config
    if model.param_axes is None or model.cache_axes is None:
        raise NotImplementedError(
            f"serving the {cfg.family!r} family on a mesh whose model axis "
            f"has degree {degree} is not ported yet: the family has no "
            f"param_axes or cache_axes (ROADMAP.md section 1); the dense "
            f"LMs and the MoE LMs serve there")
    rules = pt.merge_rules(pt.DEFAULT_RULES, cfg.sharding_overrides)
    specs = {k: pt.param_spec(v) for k, v in pt.tree_specs(
        model.param_axes(), shapes, mesh, rules).items()}
    split = cache_split(model, mesh, rules, batch, seq_len, kv_fmt)
    kv_held = pt.split_dims(specs["blocks.wk"])
    if (split == pax.KV_HEADS) != bool(kv_held):
        raise ValueError(f"the rules split the cache by {split} but wk "
                         f"over dims {kv_held}")
    axis = mesh.model_group() if hasattr(mesh, "model_group") else None
    return ServeLayout(mesh=mesh, rules=rules, param_specs=specs,
                       kv_split=split, model_axis=axis)
