"""Weights carried between the JAX package and the port.

The JAX package keeps params as a nested dict of arrays; the port as a
flat dict of tensors whose names join the nesting with dots
(``params["blocks"]["wq"]`` -> ``"blocks.wq"``), same shapes and layouts.
Arrays cross as numpy (on the JAX side ``jax.tree.map(np.asarray,
params)``), so this module needs neither JAX nor the JAX package.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.config import resolve_device


def _flatten(tree: Mapping, prefix: str = ""):
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, Mapping):
            yield from _flatten(value, key + ".")
        else:
            yield key, value


def params_from_numpy(tree: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> the port's flat dict of tensors on
    ``device`` (default CUDA, as every entry point).  bfloat16 arrays (numpy
    has no native bfloat16) arrive as float32 and are cast back exactly."""
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
    """Inverse of :func:`params_from_numpy`: flat tensors -> nested dict of
    numpy arrays (bfloat16 tensors come back as float32)."""
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
    return tree
