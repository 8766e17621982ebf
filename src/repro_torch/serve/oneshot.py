"""Oneshot serving: one fixed batch, prefill, lockstep decode.

The counterpart of ``repro.serve.oneshot``, and the port's reference for
its own engine: for one greedy request the continuous engine must
reproduce these tokens exactly.  Every row of the batch is padded to the
batch's prompt length and decoded to the batch's generation length.
"""
from __future__ import annotations

import contextlib
import time
from typing import Tuple

import numpy as np
import torch

from repro_torch.serve.engine import sample_tokens


def build_oneshot_fns(model, cache_len: int, kv_fmt: str = "none",
                      layout=None) -> Tuple:
    """The (prefill, decode) pair for a cache of ``cache_len`` positions.
    ``kv_fmt`` is passed on only beyond ``"none"``, as the JAX package's
    registry fixes it: a family without a KV cache (Mamba-2) has no such
    argument.  ``layout``: a ``serve.layout.ServeLayout``; the pair then
    runs this rank's shard under the model group's context (its params
    ``model.prepare(layout.shard(whole))``)."""
    if kv_fmt not in model.kv_formats:
        raise ValueError(
            f"model family {model.config.family!r} does not support "
            f"kv_fmt={kv_fmt!r} (supported: {model.kv_formats})")
    kv = {} if kv_fmt == "none" else {"kv_fmt": kv_fmt}
    context = (layout.context if layout is not None
               else contextlib.nullcontext)

    def prefill_fn(params, batch):
        with context():
            return model.prefill(params, batch, cache_len=cache_len, **kv)

    def decode_fn(params, cache, token):
        with context():
            return model.decode_step(params, cache, token, **kv)

    return prefill_fn, decode_fn


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def oneshot_generate(prefill, decode, params, batch: dict, gen: int, *,
                     temperature: float = 0.0, seed: int = 0):
    """Prefill, then ``gen - 1`` lockstep decode steps.

    ``params`` should come from ``model.prepare``.  Returns ``(tokens,
    timings)``: the (B, gen) int32 array of generated ids (position 0 from
    the prefill logits) and ``prefill_s`` / ``decode_s`` wall times.  The
    prefill token is greedy; decode tokens are sampled at ``temperature``
    with one stream per step shared by the batch (the JAX driver's legacy
    schedule).
    """
    device = batch["tokens"].device
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    tok = logits.argmax(dim=-1).to(torch.int32)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    generated = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = decode(params, cache, tok)
        if temperature > 0:
            step_seed = (seed * 1_000_003 + 100 + i) % 2 ** 63
            tok = sample_tokens(logits, temperature,
                                [step_seed] * logits.shape[0])
        else:
            tok = logits.argmax(dim=-1)
        tok = tok.to(torch.int32)
        generated.append(tok)
    tokens = torch.stack(generated, dim=1).cpu().numpy().astype(np.int32)
    t_decode = time.perf_counter() - t0
    return tokens, {"prefill_s": t_prefill, "decode_s": t_decode}
