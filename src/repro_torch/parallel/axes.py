"""Logical axis names, and the model group the model code runs under.

The counterpart of ``repro.parallel.axes``.  Parameters carry tuples of
these logical names (``Model.param_axes``); the partitioner's rule table
maps them to mesh axes (``repro_torch.parallel.partitioner``).

The reference's ``partitioning_context`` hands the model code a resolver
for its ``logical_constraint`` marks, and GSPMD inserts the collectives.
Here a rank runs its own shard of each layer, so the context carries what
the model code needs for that: this rank's :class:`~repro_torch.launch.
mesh.AxisGroup` over the ``model`` axis (the ranks that split every
layer).  With no context, or a model group of one, the model code is the
unsharded code.  The context is process-wide, not thread-local: one
process is one rank, and the autograd engine runs a CUDA backward (and
the recomputation of a checkpointed block) on a thread of its own, which
must see the same group.

Serving also needs the KV cache's layout, which the rules decide from the
cache's shape (``kv_cache_axes``), not from a parameter's: ``kv_split``
names the cache dim the model group splits, ``"kv_heads"`` (each rank
the KV heads its ``wk`` and ``wv`` hold) or ``"kv_seq"`` (each rank the
rows ``[r S / m, (r + 1) S / m)`` of every KV head: the reference's
fallback where the KV heads do not divide the group), or None (every
rank the whole cache).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

# canonical logical axes
BATCH = "batch"
SEQ = "seq"
EMBED = "embed"
HEADS = "heads"
KV_HEADS = "kv_heads"
HEAD_DIM = "head_dim"
MLP = "mlp"
VOCAB = "vocab"
EXPERTS = "experts"
EXPERT_MLP = "expert_mlp"
LAYERS = "layers"
KV_SEQ = "kv_seq"
STATE = "state"
CONV = "conv"
POD_CHUNK = "pod_chunk"

_CTX = {"model": None, "kv_split": None}
KV_SPLITS = (None, KV_HEADS, KV_SEQ)


@contextlib.contextmanager
def partitioning_context(model_axis, kv_split: Optional[str] = None):
    """Run the model code as this rank's shard of the ``model`` group
    ``model_axis`` (an ``AxisGroup``; None or a group of one: unsharded);
    ``kv_split``: the KV cache dim the group splits (module docstring)."""
    if kv_split not in KV_SPLITS:
        raise ValueError(f"kv_split must be one of {KV_SPLITS}, got "
                         f"{kv_split!r}")
    prev = dict(_CTX)
    _CTX["model"] = (model_axis if model_axis is not None
                     and model_axis.size > 1 else None)
    _CTX["kv_split"] = kv_split if _CTX["model"] is not None else None
    try:
        yield
    finally:
        _CTX.update(prev)


def model_axis():
    """This rank's model group, or None when the model code runs
    unsharded."""
    return _CTX["model"]


def kv_split() -> Optional[str]:
    """The KV cache dim the model group splits: ``"kv_heads"``,
    ``"kv_seq"`` or None (module docstring)."""
    return _CTX["kv_split"]


def model_index() -> int:
    """This rank's index in its model group (0 unsharded)."""
    axis = _CTX["model"]
    return 0 if axis is None else axis.index


def split_of(local: int, whole: int) -> Optional[Tuple[int, int]]:
    """``(offset, whole)`` of a dim of size ``whole`` of which this rank
    holds the ``local`` entries of its block (block ``index`` of the
    model group's equal blocks, as ``partitioner.local_slice`` lays it
    out), or None when it holds the whole dim."""
    if local == whole:
        return None
    axis = _CTX["model"]
    if axis is None or local * axis.size != whole:
        raise ValueError(f"a dim of {whole} held as {local} does not split "
                         f"over the model group "
                         f"({None if axis is None else axis.size})")
    return axis.index * local, whole
