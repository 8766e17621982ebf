"""Continuous-batching serving engine over a slot-pool KV cache.

The counterpart of ``repro.serve.engine`` (its normal path; fault
injection, replay, deadlines, shedding and the supervisor come with the
port's runtime layer).  One ``ContinuousEngine`` owns a fixed
``max_slots x max_seq`` KV cache and runs the scheduler loop::

    while queue or active slots:
        admit queued requests into free slots   (B=1 prefill each, FCFS)
        one decode tick over every slot         (decode_slots + sampling)
        retire finished slots                   (budget / EOS / cache full)

A tick is one ``decode_slots`` call plus sampling on the device and one
(K,) device->host copy of the sampled tokens; the (K, V) logits never
leave the device.

Prefill bucketing: admission pads each prompt to the next power of two
(clamped to ``max_seq``) and passes the true length, so the prefill sees
at most ``ceil(log2(max_seq))`` distinct shapes (``prefill_programs``).

Quantized KV cache (``ServeConfig.kv_fmt``): codes plus per-(slot, token,
kv-head) bf16 scales.  On retirement the engine zeroes the slot's scale
rows: a zero scale dequantizes every code to exactly 0, so a refilled
slot never reads a predecessor's rows against stale scales.

Sampling: greedy (``temperature == 0``) is the argmax; otherwise
Gumbel-max with the noise drawn from a generator seeded by
:func:`sampling_seed` of ``(seed, request_id, position)``, so concurrent
slots never share a stream and reruns are token-identical.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import ServeConfig, resolve_device
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.slots import SlotPool, init_slot_cache

# Domain separation of the sampling streams from the logits head's
# (models.common.LOGITS_SEED), as the JAX package's SAMPLE_FOLD.
SAMPLE_FOLD = 0x53A7
_MIX = 1_000_003      # prime above any request id or position used here


def prefill_bucket(prompt_len: int, max_seq: int) -> int:
    """Padded prefill length: next power of two, clamped to ``max_seq``.

    The floor of 2 merges the length-1 bucket into length-2, so there are
    at most ``ceil(log2(max_seq))`` buckets.
    """
    if prompt_len < 1 or prompt_len > max_seq:
        raise ValueError(f"prompt_len={prompt_len} outside [1, {max_seq}]")
    return min(max(2, 1 << (prompt_len - 1).bit_length()), max_seq)


def sampling_seed(seed: int, request_id: int, position: int) -> int:
    """Seed of the sampling stream for one (request, position); distinct
    pairs give distinct seeds."""
    s = ((seed * _MIX + SAMPLE_FOLD) * _MIX + request_id) * _MIX + position
    return s % 2 ** 63


def sample_tokens(logits: torch.Tensor, temperature: float,
                  seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
    """One token per row of (n, V) logits, on their device: the argmax, or
    for ``temperature > 0`` Gumbel-max with row i's noise from ``seeds[i]``."""
    if temperature <= 0:
        return logits.argmax(dim=-1)
    u = torch.empty_like(logits, dtype=torch.float32)
    for i, s in enumerate(seeds):
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(s)
        u[i].uniform_(generator=gen)
    gumbel = -torch.log(-torch.log(u))
    return (logits.float() / temperature + gumbel).argmax(dim=-1)


@dataclasses.dataclass
class Request:
    """A queued generation request."""

    request_id: int
    prompt: np.ndarray              # (S,) int32 token ids
    max_new_tokens: int
    arrival_time: float = 0.0       # seconds relative to run() start
    eos_id: Optional[int] = None


@dataclasses.dataclass
class RequestResult:
    """Retired request: generated ids, timing record, terminal status."""

    request_id: int
    prompt: np.ndarray
    tokens: np.ndarray              # (n_generated,) int32
    timing: object                  # metrics.RequestTiming
    status: str = "ok"


class ContinuousEngine:
    """Slot-pool scheduler running one decode tick over all slots.

    ``model``: a ``repro_torch.models.registry.Model`` with the slot hooks;
    ``params``: its parameter dict on the model's device (cast once by
    ``model.prepare``); ``serve``: slot count, cache length, sampling;
    ``device``: where the engine runs, CUDA unless the caller asks for the
    CPU (raises without a GPU).
    """

    def __init__(self, model, params, serve: ServeConfig, device=None):
        """Check the model and device, prepare params, allocate the cache."""
        if model.decode_slots is None or model.slot_cache_spec is None:
            raise ValueError(
                f"model family {model.config.family!r} does not support "
                "continuous batching (no decode_slots/slot_cache_spec)")
        if serve.kv_fmt not in model.kv_formats:
            raise ValueError(
                f"model family {model.config.family!r} does not support "
                f"kv_fmt={serve.kv_fmt!r} (supported: {model.kv_formats})")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        misplaced = [k for k, t in params.items() if t.device != self.device]
        if misplaced:
            raise ValueError(f"params not on {self.device}: {misplaced}")
        self.model = model
        self.serve = serve
        self.params = model.prepare(params)
        self.reset()

    @property
    def prefill_programs(self) -> int:
        """Distinct prefill shapes run so far; at most
        ``ceil(log2(max_seq))`` for any mix of prompt lengths."""
        return len(self._buckets)

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #
    def reset(self):
        """Clear queue, slot, cache and metric state.  Request ids restart
        from 0, so a reset engine reproduces a fresh one exactly."""
        K = self.serve.max_slots
        self._next_id = 0
        self.cache = init_slot_cache(self.model, K, self.serve.max_seq,
                                     kv_fmt=self.serve.kv_fmt)
        self.pool = SlotPool(K)
        self.metrics = ServeMetrics()
        self.queue: collections.deque = collections.deque()
        self.results: Dict[int, RequestResult] = {}
        self._tokens_by_req: Dict[int, List[int]] = {}
        self._live: Dict[int, Request] = {}
        self._buckets: set = set()
        self._cur_tokens = np.zeros((K,), np.int32)
        self._active = np.zeros((K,), bool)
        self._rids = np.zeros((K,), np.int64)
        # device copy of the slot tokens, re-uploaded only after an
        # admission or retirement; otherwise the sampled tokens feed back
        self._dirty = True
        self._tokens_dev = None

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               arrival_time: float = 0.0,
               eos_id: Optional[int] = None) -> int:
        """Queue a request; returns its request id.  The scheduler admits
        it no earlier than ``arrival_time`` seconds after ``run()`` starts."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size > self.serve.max_seq:
            raise ValueError(
                f"prompt of {prompt.size} tokens exceeds max_seq="
                f"{self.serve.max_seq}")
        budget = (self.serve.max_new_tokens if max_new_tokens is None
                  else max_new_tokens)
        if budget < 1:
            raise ValueError("max_new_tokens must be >= 1")
        rid = self._next_id
        self._next_id += 1
        self.metrics.on_submit(rid, prompt.size, arrival_time)
        self._tokens_by_req[rid] = []
        self.queue.append(Request(request_id=rid, prompt=prompt,
                                  max_new_tokens=budget,
                                  arrival_time=arrival_time, eos_id=eos_id))
        return rid

    def run(self, clock: Optional[Callable[[], float]] = None
            ) -> Dict[int, RequestResult]:
        """Drive the scheduler until every submitted request completes.

        ``clock`` (for tests) replaces the wall clock (seconds since
        ``run()`` began); it only gates admission, never the tokens.
        """
        self.queue = collections.deque(
            sorted(self.queue, key=lambda r: r.arrival_time))
        t0 = time.perf_counter()
        now_fn = clock or (lambda: time.perf_counter() - t0)
        last_idle_now, stalled = None, 0
        try:
            while self.queue or self.pool.n_active:
                self._admit(now_fn)
                if self.pool.n_active:
                    self._tick(now_fn)
                    continue
                if not self.queue:
                    break
                now = now_fn()
                next_ready = min(r.arrival_time for r in self.queue)
                if next_ready > now:
                    if clock is None:
                        t_sleep = time.perf_counter()
                        time.sleep(min(next_ready - now, 0.05))
                        self.metrics.idle_wall += (time.perf_counter()
                                                   - t_sleep)
                    else:
                        stalled = stalled + 1 if now == last_idle_now else 0
                        if stalled > 1000:
                            raise RuntimeError(
                                "injected clock is not advancing past the "
                                f"next arrival ({next_ready})")
                    last_idle_now = now
        finally:
            self.metrics.run_wall += now_fn()
        return dict(self.results)

    # ------------------------------------------------------------------ #
    # scheduler internals
    # ------------------------------------------------------------------ #
    def _next_eligible(self, now: float) -> Optional[Request]:
        """Pop the first queued request that has arrived (FCFS)."""
        for i, req in enumerate(self.queue):
            if req.arrival_time <= now:
                del self.queue[i]
                return req
        return None

    def _admit(self, now_fn):
        """Fill free slots with arrived requests: bucketed B=1 prefill,
        cache rows copied into the slot, first token sampled at position
        ``prompt_len``."""
        while self.pool.n_free:
            req = self._next_eligible(now_fn())
            if req is None:
                return
            n = req.prompt.size
            slot = self.pool.acquire(req.request_id, n, req.max_new_tokens)
            bucket = prefill_bucket(n, self.serve.max_seq)
            self._buckets.add(bucket)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :n] = req.prompt
            logits, pcache = self.model.prefill(
                self.params, {"tokens": torch.from_numpy(padded).to(self.device)},
                prompt_len=n, kv_fmt=self.serve.kv_fmt)
            self._write(pcache, slot)
            seeds = [sampling_seed(self.serve.seed, req.request_id, n)]
            tok = int(sample_tokens(logits, self.serve.temperature, seeds)[0])
            now = now_fn()
            self._live[req.request_id] = req
            self.metrics.on_admit(req.request_id, now)
            self.metrics.on_first_token(req.request_id, now)
            self._record_token(slot, req, tok, now)

    def _write(self, pcache, slot: int):
        """Copy a B=1 prefill cache into ``slot`` (in place): its rows
        [0, bucket) of every code and scale array, and its position."""
        for name, arr in self.cache.items():
            if name == "pos":
                arr[slot] = pcache["pos"]
                continue
            upd = pcache[name]
            arr[:, slot:slot + 1, :, :upd.shape[3]] = upd

    def _record_token(self, slot: int, req: Request, tok: int, now: float):
        """Append one generated token; retire the slot if finished."""
        state = self.pool.state(slot)
        toks = self._tokens_by_req[req.request_id]
        toks.append(tok)
        state.remaining -= 1
        # the token just recorded is written at cache index prompt_len +
        # len(toks) - 1 on its decode tick; retire when that index falls
        # outside the slot, on EOS, or when the budget is spent
        pos_next = state.prompt_len + len(toks) - 1
        done = (state.remaining <= 0
                or (req.eos_id is not None and tok == req.eos_id)
                or pos_next >= self.serve.max_seq)
        if done:
            self._retire(slot, req, now)
        else:
            if not self._active[slot]:
                self._dirty = True
            self._active[slot] = True
            self._cur_tokens[slot] = tok
            self._rids[slot] = req.request_id

    def _tick(self, now_fn):
        """One decode + sample step over every slot."""
        if self._dirty:
            self._tokens_dev = torch.from_numpy(self._cur_tokens).to(self.device)
            self._dirty = False
        logits, self.cache = self.model.decode_slots(
            self.params, self.cache, self._tokens_dev, self._active,
            kv_fmt=self.serve.kv_fmt)
        seeds = None
        if self.serve.temperature > 0:
            seeds = [sampling_seed(self.serve.seed, int(r), int(p))
                     for r, p in zip(self._rids, self.cache["pos"].tolist())]
        toks_dev = sample_tokens(logits, self.serve.temperature,
                                 seeds).to(torch.int32)
        toks = toks_dev.cpu().numpy()       # the tick's one device->host copy
        self.metrics.decode_ticks += 1
        now = now_fn()
        for slot in np.nonzero(self._active)[0]:
            slot = int(slot)
            rid = self.pool.state(slot).request_id
            self._record_token(slot, self._live[rid], int(toks[slot]), now)
        if not self._dirty:
            self._tokens_dev = toks_dev

    def _retire(self, slot: int, req: Request, now: float):
        """Release a finished slot, zero its scale rows, record the result."""
        if self._active[slot]:
            self._dirty = True
        self._active[slot] = False
        self.pool.release(slot)
        for name in ("k_scale", "v_scale"):
            if name in self.cache:
                self.cache[name][:, slot] = 0
        self._live.pop(req.request_id, None)
        toks = np.asarray(self._tokens_by_req[req.request_id], np.int32)
        self.metrics.on_complete(req.request_id, now,
                                 n_generated=int(toks.size))
        self.results[req.request_id] = RequestResult(
            request_id=req.request_id, prompt=req.prompt, tokens=toks,
            timing=self.metrics.timings[req.request_id])
