"""Weights carried between the JAX package and the port.

The JAX package keeps params as a nested tree of dicts and lists of
arrays; the port as a flat dict of tensors whose names join the nesting
with dots, a list position by its index (``params["blocks"]["wq"]`` ->
``"blocks.wq"``, ``params["stages"][1][0]["conv1"]`` ->
``"stages.1.0.conv1"``), same shapes and layouts.
Arrays cross as numpy (on the JAX side ``jax.tree.map(np.asarray,
params)``), so this module needs neither JAX nor the JAX package.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.config import resolve_device


def _flatten(tree, prefix: str = ""):
    items = (tree.items() if isinstance(tree, Mapping)
             else enumerate(tree))
    for name, value in items:
        key = f"{prefix}{name}"
        if isinstance(value, (Mapping, list, tuple)):
            yield from _flatten(value, key + ".")
        else:
            yield key, value


def _lists(node):
    """Nested dicts whose keys are 0..n-1 back to lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and set(node) == {str(i) for i in range(len(node))}:
        return [node[str(i)] for i in range(len(node))]
    return node


def params_from_numpy(tree, device=None) -> Dict[str, torch.Tensor]:
    """Nested dicts and lists of numpy arrays -> the port's flat dict of
    tensors on ``device`` (default CUDA, as every entry point).  bfloat16
    arrays (numpy has no native bfloat16) arrive as float32 and are cast
    back exactly."""
    dev = resolve_device(device)
    out = {}
    for key, arr in _flatten(tree):
        arr = np.asarray(arr)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, copy=True))
        out[key] = t.to(dev)
    return out


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of :func:`params_from_numpy`: flat tensors -> nested dicts
    (and lists, where the names hold list positions) of numpy arrays
    (bfloat16 tensors come back as float32)."""
    tree: dict = {}
    for key, t in params.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.numpy()
    return _lists(tree)
