"""Tree of tensors <-> on-disk checkpoint (npz + JSON), CRC-checked.

The counterpart of ``repro.checkpoint.serialization``, same layout:

  <dir>/step_<N>.ckpt/
    arrays.npz        flat arrays keyed by index
    meta.json         leaf paths, aux state (accountant, scheduler, data
                      cursor), crc32 of arrays.npz

A tree is anything ``torch.utils._pytree`` flattens: the port's flat
params dict and its optimizer states (``()``, a dict, ``AdamState``).
Leaves are tensors or numpy arrays; bfloat16 crosses as float32, as in
``repro_torch.convert``.  Writes are atomic: serialize into
``<name>.tmp``, then ``os.replace``; a failed write removes its staging
directory.  Restore validates the CRC and rebuilds the tree of ``like``
in ``like``'s dtypes, on ``like``'s devices; a corrupted or partial
checkpoint raises, and the manager skips it.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import (keystr, tree_flatten, tree_flatten_with_path,
                                 tree_unflatten)


def to_numpy(leaf) -> np.ndarray:
    """A host copy of ``leaf`` as numpy (bfloat16 as float32), never a view
    of a tensor's storage: the caller may overwrite the tensor at once."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.array(leaf, copy=True)


def host_copy(tree: Any) -> Any:
    """``tree`` with every leaf replaced by its :func:`to_numpy` copy."""
    leaves, spec = tree_flatten(tree)
    return tree_unflatten([to_numpy(leaf) for leaf in leaves], spec)


def save(path, tree: Any, aux: Optional[dict] = None) -> None:
    path = Path(path)
    tmp = path.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    try:
        flat, _ = tree_flatten_with_path(tree)
        arrays = {f"a{i}": leaf if isinstance(leaf, np.ndarray)
                  else to_numpy(leaf) for i, (_, leaf) in enumerate(flat)}
        np.savez(tmp / "arrays.npz", **arrays)
        crc = zlib.crc32((tmp / "arrays.npz").read_bytes())
        meta = {"paths": [keystr(p) for p, _ in flat], "crc32": crc,
                "aux": aux or {}}
        (tmp / "meta.json").write_text(
            json.dumps(meta, default=_json_default))
    except BaseException:
        # a torn write must never leave a half-built tmp dir behind: the
        # final destination only ever appears via the atomic replace below
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)


def _json_default(o):
    if isinstance(o, np.ndarray):
        return {"__nd__": o.tolist(), "dtype": str(o.dtype)}
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, tuple):
        return list(o)
    raise TypeError(f"not jsonable: {type(o)}")


def restore(path, like: Any) -> Tuple[Any, dict]:
    """The tree stored at ``path`` in the structure of ``like`` (a tree of
    tensors: the leaf paths and shapes must match; each leaf takes its
    ``like`` leaf's dtype and device), and the aux payload."""
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    crc = zlib.crc32((path / "arrays.npz").read_bytes())
    if crc != meta["crc32"]:
        raise IOError(f"checkpoint {path} failed CRC validation")
    flat, spec = tree_flatten_with_path(like)
    paths = [keystr(p) for p, _ in flat]
    if paths != meta["paths"]:
        raise IOError(f"checkpoint {path} holds leaves {meta['paths']}; "
                      f"expected {paths}")
    with np.load(path / "arrays.npz") as arrays:
        leaves = [arrays[f"a{i}"] for i in range(len(paths))]
    out = []
    for (p, ll), arr in zip(flat, leaves):
        if tuple(arr.shape) != tuple(ll.shape):
            raise IOError(f"checkpoint {path}: leaf {keystr(p)} has shape "
                          f"{arr.shape}; expected {tuple(ll.shape)}")
        out.append(torch.from_numpy(arr).to(device=ll.device, dtype=ll.dtype))
    return tree_unflatten(out, spec), meta.get("aux", {})
