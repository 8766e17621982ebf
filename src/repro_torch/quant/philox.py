"""Philox4x32-10 in plain PyTorch: the twin of ``kernels/csrc/philox.cuh``.

The counter-based generator (Salmon et al., SC 2011; Random123's
``philox4x32``) that every stochastic quantizer draws its uniforms from:
the logits head (``luq_matmul``, keys ``models.common.logits_key``) and
fake-quant's per-(seed, fold) streams (``luq_quant`` and the ghost norm,
keys ``quant.fake_quant.stream_key``).  On the card the kernels draw them
themselves; here they are drawn for CPU tensors and the kernels' plain
versions.  Both give the same words for the same key and counter.

* Key: two 32-bit words ``(k0, k1)``, Python ints.  Counter: four words.
* Element ``e`` of operand ``op`` (0 for a matmul's ``a``, 1 for its
  ``b``; 0 for the row a quantizer rounds) takes lane ``e % 4`` of the
  call with counter ``(e // 4 low word, e // 4 high word, op, 0)``.
* Its uniform is ``(word >> 8) * 2**-24``: exact in float32, in
  ``[0, 1 - 2**-24]``.

Words are held in int64 tensors.  The 32 x 32 -> 64-bit products are
built from 16-bit limbs, so no intermediate leaves int64's range and CPU
and CUDA tensors give the same words.
"""
from __future__ import annotations

import numbers
from collections import OrderedDict
from typing import Sequence, Tuple, Union

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57            # multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85            # Weyl key bumps
MASK32 = 0xFFFFFFFF
ROUNDS = 10

Key = Tuple[int, int]
Keys = Union[Key, Sequence[Key], torch.Tensor]

# groups (Philox calls) per chunk of the plain draws: bounds the int64
# temporaries to a few hundred MB whatever the operand's size
_CHUNK_GROUPS = 1 << 20
# the CPU row draws kept by row_uniforms, least recently used first, and
# the bytes they may hold together
_ROW_CACHE: "OrderedDict[Tuple[Key, int], torch.Tensor]" = OrderedDict()
_ROW_CACHE_BYTES = 128 * 2 ** 20


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) words of ``m * x`` for a 32-bit constant ``m`` and a
    tensor ``x`` of 32-bit values, from 16-bit limbs (every partial sum
    stays below 2**35)."""
    m_hi, m_lo = m >> 16, m & 0xFFFF
    x_hi, x_lo = x >> 16, x & 0xFFFF
    ll = x_lo * m_lo
    mid = x_lo * m_hi + x_hi * m_lo + (ll >> 16)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = x_hi * m_hi + (mid >> 16)
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """The four output words of Philox4x32-10 for counters ``c0..c3``
    (int64 tensors of 32-bit values, broadcastable) and key ``(k0, k1)``."""
    for i in range(ROUNDS):
        if i:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform24(words: torch.Tensor) -> torch.Tensor:
    return (words >> 8).to(torch.float32) * 2.0 ** -24


def _key_word(w, device):
    """A key word as a 32-bit value: an int, or, for a word held in a
    tensor (a key row of a device key tensor), an int64 0-dim tensor on
    ``device``, read without a host sync."""
    if isinstance(w, torch.Tensor):
        return w.to(device=device, dtype=torch.int64) & MASK32
    return int(w) & MASK32


def _group_uniforms(key: Key, op: int, groups: torch.Tensor) -> torch.Tensor:
    """(..., 4) float32 uniforms of elements 4 g .. 4 g + 3 for the int64
    group indices ``groups``."""
    zero = torch.zeros_like(groups)
    words = philox4x32_10(groups & MASK32, groups >> 32, zero + op, zero,
                          _key_word(key[0], groups.device),
                          _key_word(key[1], groups.device))
    return _uniform24(torch.stack(words, dim=-1))


def uniforms_2d(key: Key, op: int, rows: int, cols: int, row_stride: int,
                col0: int = 0, device="cpu") -> torch.Tensor:
    """(rows, cols) float32 uniforms of operand ``op``'s elements
    ``e = r * row_stride + col0 + c``: columns ``col0 .. col0 + cols - 1`` of
    a row-major matrix ``row_stride`` wide."""
    out = torch.empty((rows, cols), dtype=torch.float32, device=device)
    if rows == 0 or cols == 0:
        return out
    aligned = row_stride % 4 == 0 and col0 % 4 == 0
    width = -(-cols // 4) if aligned else cols
    step = max(1, _CHUNK_GROUPS // width)
    for r0 in range(0, rows, step):
        r = torch.arange(r0, min(rows, r0 + step), device=device)
        first = r * row_stride + col0                       # (rows,)
        if aligned:        # whole calls: element 4 j + lane of the row
            g = first[:, None] // 4 + torch.arange(width, device=device)
            u = _group_uniforms(key, op, g).reshape(len(r), 4 * width)
            out[r0:r0 + len(r)] = u[:, :cols]
        else:              # a call per element, its lane picked
            e = first[:, None] + torch.arange(cols, device=device)
            u = _group_uniforms(key, op, e // 4)
            lane = (e % 4)[..., None]
            out[r0:r0 + len(r)] = torch.gather(u, 2, lane)[..., 0]
    return out


def uniforms(key: Key, op: int, n: int, device="cpu") -> torch.Tensor:
    """(n,) float32 uniforms of operand ``op``'s elements ``0 .. n - 1``."""
    width = min(4 * _CHUNK_GROUPS, 4 * max(1, -(-n // 4)))
    rows = -(-n // width)
    return uniforms_2d(key, op, rows, width, width,
                       device=device).reshape(-1)[:n]


def row_uniforms(key: Key, n: int, device="cpu") -> torch.Tensor:
    """(n,) float32 uniforms of a quantized row of n elements: operand 0
    of ``key``'s stream, what the ``luq_quant`` kernel draws.  A key's
    draws never change (fake-quant's keys are fixed per (seed, fold)), so
    on the CPU, where the plain Philox is ~30x slower than ``torch.rand``,
    they are kept, least recently used out first, up to 128 MB in all.
    Callers must not write to the tensor returned."""
    if torch.device(device).type != "cpu":
        return uniforms(key, 0, n, device)
    k = ((int(key[0]) & MASK32, int(key[1]) & MASK32), int(n))
    u = _ROW_CACHE.get(k)
    if u is None:
        u = uniforms(key, 0, n)
        if 4 * n <= _ROW_CACHE_BYTES:
            _ROW_CACHE[k] = u
            while sum(t.numel() for t in _ROW_CACHE.values()) * 4 \
                    > _ROW_CACHE_BYTES:
                _ROW_CACHE.popitem(last=False)
    else:
        _ROW_CACHE.move_to_end(k)
    return u


def global_index(e: torch.Tensor, index_map) -> torch.Tensor:
    """The index in the whole row of element ``e`` of a shard's row under
    ``index_map`` ``(blk, gblk, off)``: a row whose dim of ``n_glob``
    entries, ``inner`` elements each, holds only ``n_loc`` of them from
    entry ``o`` keeps runs of ``blk = n_loc inner`` elements, each at
    ``off = o inner`` within a run of ``gblk = n_glob inner`` of the whole
    row: ``(e // blk) gblk + off + e % blk``."""
    blk, gblk, off = (int(v) for v in index_map)
    return (e // blk) * gblk + off + e % blk


def mapped_uniforms(key: Key, n: int, index_map, device="cpu"):
    """(n,) float32 uniforms of a shard's row of n elements, each drawn
    at its index in the whole row (:func:`global_index`): what
    :func:`row_uniforms` gives the whole row, at the shard's elements.
    Kept on the CPU as :func:`row_uniforms` keeps its draws."""
    cache = torch.device(device).type == "cpu"
    k = ((int(key[0]) & MASK32, int(key[1]) & MASK32), int(n),
         tuple(int(v) for v in index_map))
    u = _ROW_CACHE.get(k) if cache else None
    if u is not None:
        _ROW_CACHE.move_to_end(k)
        return u
    out = torch.empty((n,), dtype=torch.float32, device=device)
    step = 4 * _CHUNK_GROUPS
    for e0 in range(0, n, step):
        e = torch.arange(e0, min(n, e0 + step), device=device)
        g = global_index(e, index_map)
        u4 = _group_uniforms(key, 0, g // 4)
        out[e0:e0 + len(e)] = torch.gather(u4, 1, (g % 4)[:, None])[:, 0]
    if cache and 4 * n <= _ROW_CACHE_BYTES:
        _ROW_CACHE[k] = out
        while sum(t.numel() for t in _ROW_CACHE.values()) * 4 \
                > _ROW_CACHE_BYTES:
            _ROW_CACHE.popitem(last=False)
    return out


def split_keys(keys: Keys, rows: int):
    """``(list of keys, per_row)``: one ``(k0, k1)`` pair shared by every
    row, or one key a row: a sequence of ``rows`` pairs, or a (rows, 2)
    int32 / int64 tensor (then the list holds its rows, (2,) views, and
    nothing is read to the host)."""
    if isinstance(keys, torch.Tensor):
        if keys.dtype not in (torch.int32, torch.int64) or \
                tuple(keys.shape) != (rows, 2):
            raise ValueError(f"a key tensor must be ({rows}, 2) int32 or "
                             f"int64, got {keys.dtype} {tuple(keys.shape)}")
        return list(keys.unbind(0)), True
    if len(keys) == 2 and all(isinstance(k, numbers.Integral) for k in keys):
        return [(int(keys[0]) & MASK32, int(keys[1]) & MASK32)], False
    keys = [(int(k0) & MASK32, int(k1) & MASK32) for k0, k1 in keys]
    if len(keys) != rows:
        raise ValueError(f"{len(keys)} keys for {rows} rows")
    return keys, True


def key_tensor(keys, device) -> torch.Tensor:
    """Per-row keys as the (R, 2) int32 tensor on ``device`` that the
    kernels read (each word's 32 bits as an int32): a key tensor is cast
    on its device, a sequence of pairs is copied from the host."""
    if isinstance(keys, torch.Tensor):
        return keys.to(device=device, dtype=torch.int32).contiguous()
    words = [[(int(w) & MASK32) - ((int(w) & MASK32) >> 31 << 32)
              for w in key] for key in keys]
    return torch.tensor(words, dtype=torch.int32).to(device)


def column_chunks(K: int, N: int):
    """``(n0, n1)`` column ranges of a (K, N) operand, each a multiple of 4
    wide (whole Philox calls when N % 4 == 0) and at most ~4 M elements:
    the plain versions draw and quantize the logits head chunk by chunk."""
    step = max(4, (4 * _CHUNK_GROUPS) // max(K, 1) // 4 * 4)
    return [(n0, min(N, n0 + step)) for n0 in range(0, N, step)]
