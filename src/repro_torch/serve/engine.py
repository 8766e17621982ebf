"""Continuous-batching serving engine over a slot-pool KV cache.

The counterpart of ``repro.serve.engine``.  One ``ContinuousEngine`` owns
a fixed ``max_slots x max_seq`` KV cache and runs the scheduler loop::

    while queue or active slots:
        retire expired requests                 (deadlines)
        admit queued requests into free slots   (B=1 prefill each, FCFS)
        one decode tick over every slot         (decode_slots + sampling)
        retire finished slots                   (budget / EOS / cache full)

A tick is one ``decode_slots`` call plus sampling on the device and one
(K,) device->host copy of the sampled tokens; the (K, V) logits never
leave the device.  The decode step (trunk, KV write and logits head, the
counterpart of the reference's jitted ``self._step``) reads its tokens,
positions and active mask from static device buffers that the tick fills
in place; on CUDA it is captured as a CUDA graph at its first call, for
the engine's fixed ``(max_slots, max_seq, kv_fmt)``, and replayed every
call after (``repro_torch.graph.StepGraph``; a capture or replay that
fails raises).  The cache is only ever written in place (admissions,
retirements, injected poison), so the graph holds its addresses for the
engine's life, across ``reset()``.  The engine keeps a host mirror of the
slots' positions for its bookkeeping and copies it into the device
buffer before each step.  Sampling, with its (request_id, position)
seeds, stays outside the graph.

Prefill bucketing: admission pads each prompt to the next power of two
(clamped to ``max_seq``) and passes the true length as a device scalar,
so the prefill sees at most ``ceil(log2(max_seq))`` distinct shapes
(``prefill_programs``).  On CUDA each bucket's prefill is a CUDA graph,
captured at the bucket's first admission and replayed for every later
one: it reads the padded tokens and the length from one static device
buffer of the bucket, so an admission is one host->device copy and one
replay.  The prefill graphs share one memory pool, kept apart from the
decode graph's; a prefill's outputs are copied into its slot before any
other prefill graph replays.

Quantized KV cache (``ServeConfig.kv_fmt``): codes plus per-(slot, token,
kv-head) bf16 scales.  When a slot is released the engine zeroes its
scale rows: a zero scale dequantizes every code to exactly 0, so a
refilled slot never reads a predecessor's rows against stale scales.

Sampling: greedy (``temperature == 0``) is the argmax; otherwise
Gumbel-max with the noise drawn from a generator seeded by
:func:`sampling_seed` of ``(seed, request_id, position)``, so concurrent
slots never share a stream and reruns are token-identical.

A model group (``mesh=``, a mesh whose ``model`` axis has degree above
1, each rank running one engine): the engine shards whole params once
(``serve.layout``), holds its rank's shard of the slot cache (its KV
heads, or its sequence rows where the heads do not divide the group),
and runs the model code under the group's context, so every rank
computes the same whole logits and samples the same tokens.  Admission,
retirement and EOS follow from the tokens; what reads the wall clock
(arrival gating, deadlines, the idle wait) reads rank 0's, broadcast over
the group at every read, so every rank takes every host decision alike
(the supervisor raises on a model group).  Under gloo on CUDA (ranks
sharing a card) collectives cannot be captured: the constructor chooses,
from the group's backend, to run the prefills and ticks eagerly, and
``prefill_replays`` / ``decode_replays`` stay 0.  Under NCCL the engine
captures as it does alone.

Failure model: per-request deadlines (timeout retirement with partial
results), queue overload (bounded queue, load shedding at submit) and
injected faults (``runtime.faults.FaultPlan``: prefill and decode
dispatch failures, detected slot-cache poison, frozen clocks), polled at
the reference's hook points.  A fault victim is re-queued with linear
backoff and *replayed*: its prompt is prefilled in its own bucket, as at
its first admission, and the tokens it had generated are decoded again
through the decode step, its slot alone active, before its next token is
drawn at position ``prompt_len + len(prefix)``.  Every position of the
replay is computed as the fault-free run computed it (a slot's row of the
decode step does not depend on the other rows), so the recovered tokens
are bit-identical to a fault-free run, at any temperature and on any KV
format.  (The reference prefills ``prompt + prefix`` at once; that
computes the prefix's K/V without the quantized cache, in GEMMs of
another shape, and the next token's logits with the prefill's stream,
and on the card it does not reproduce the fault-free tokens:
``chip_smoke.py``'s replay witness.)  Every request retires with a typed
status on its ``RequestResult``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.config import ServeConfig, resolve_device
from repro_torch.graph import StepGraph
from repro_torch.runtime.faults import DEFAULT_FREEZE_READS, FaultPlan
from repro_torch.serve.layout import model_degree, serve_layout
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


class _Eager:
    """A step called as it is, every time (no graph): a ranks-sharing
    model group's, whose collectives a CUDA graph cannot capture."""

    replays = 0
    capture_s = 0.0

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self):
        return self.fn()


@dataclasses.dataclass
class Request:
    """A queued generation request."""

    request_id: int
    prompt: np.ndarray              # (S,) int32 token ids
    max_new_tokens: int
    arrival_time: float = 0.0       # seconds relative to run() start
    eos_id: Optional[int] = None
    deadline_s: Optional[float] = None   # from arrival; None = no deadline
    attempts: int = 0               # fault-triggered re-queues so far
    not_before: float = 0.0         # retry backoff gate (seconds)

    def expiry(self) -> Optional[float]:
        """Absolute deadline instant, or None when unbounded."""
        if self.deadline_s is None:
            return None
        return self.arrival_time + self.deadline_s


@dataclasses.dataclass
class RequestResult:
    """Retired request: generated ids, timing record, terminal status.

    ``status`` is one of ``metrics.REQUEST_STATUSES``: "ok" (possibly
    after fault recovery), "timed_out" (deadline expired; ``tokens`` holds
    the partial result), "shed" (queue full at submit), or "failed" (fault
    retries exhausted; partial tokens).
    """

    request_id: int
    prompt: np.ndarray
    tokens: np.ndarray              # (n_generated,) int32
    timing: object                  # metrics.RequestTiming
    status: str = "ok"


class ContinuousEngine:
    """Slot-pool scheduler running one decode tick over all slots.

    ``model``: a ``repro_torch.models.registry.Model`` with the slot hooks;
    ``params``: its parameter dict on the model's device (cast once by
    ``model.prepare``); ``serve``: slot count, cache length, sampling,
    admission control; ``device``: where the engine runs, CUDA unless the
    caller asks for the CPU (raises without a GPU); ``faults``: an
    optional ``runtime.faults.FaultPlan`` polled at the engine's hook
    points (prefill dispatch, decode tick, slot cache, clock reads);
    ``on_tick``: an optional callback ``(tick_index, tick_wall_s, now_s)``
    run after every decode-tick attempt, the supervisor's hook
    (``runtime.supervisor``); ``mesh``: a ``launch.mesh.CompatMesh``
    whose ``model`` axis this rank serves on (module docstring; its data
    axes of degree 1: one model group a run), ``params`` whole.
    """

    def __init__(self, model, params, serve: ServeConfig, device=None,
                 faults: Optional[FaultPlan] = None,
                 on_tick: Optional[Callable[[int, float, float], None]] = None,
                 mesh=None):
        """Check the model and device, shard and prepare params, allocate
        the cache."""
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
        self.faults = faults
        self.on_tick = on_tick
        self.mesh = mesh
        self.layout = None
        #: This rank's model group (an ``AxisGroup``), or None alone.
        self.model_group = None
        # whether each step runs eagerly: decided here, once, from the
        # model group's backend (gloo cannot be captured in a CUDA graph)
        self._eager = False
        if model_degree(mesh) > 1:
            data = mesh.size([a for a in mesh.axis_names if a != "model"])
            if data > 1:
                raise NotImplementedError(
                    f"the engine serves one model group; a mesh of {data} "
                    f"data replicas runs one engine a replica (ROADMAP.md "
                    f"section 1)")
            self.layout = serve_layout(
                model, mesh, {k: tuple(t.shape) for k, t in params.items()},
                serve.max_slots, serve.max_seq, serve.kv_fmt)
            params = self.layout.shard(params)
            self.model_group = self.layout.model_axis
            backend = dist.get_backend(self.model_group.group)
            self._eager = self.device.type == "cuda" and backend == "gloo"
            if self.device.type == "cuda" and not self._eager:
                # NCCL makes a communicator at its first collective, which
                # must not be inside a capture
                mesh.warm_collectives(self.device)
        self.params = model.prepare(params)
        self.cache = None
        # the decode step, a CUDA graph on CUDA, made at its first call
        self._decode = None
        # one prefill step a bucket, and its static input: the padded
        # tokens, then the prompt length
        self._prefills: Dict[int, StepGraph] = {}
        self._prefill_in: Dict[int, torch.Tensor] = {}
        self._prefill_pool = None
        self.reset()

    @property
    def prefill_programs(self) -> int:
        """Prefill steps (CUDA graphs on CUDA) made so far, one a bucket;
        at most ``ceil(log2(max_seq))`` for any mix of prompt lengths."""
        return len(self._prefills)

    @property
    def prefill_replays(self) -> int:
        """Replays of the prefill graphs so far (0 on the CPU)."""
        return sum(g.replays for g in self._prefills.values())

    @property
    def decode_replays(self) -> int:
        """Replays of the decode graph so far (0 on the CPU)."""
        return 0 if self._decode is None else self._decode.replays

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #
    def reset(self):
        """Clear queue, slot, cache, fault and metric state.  Request ids
        restart from 0, so a reset engine reproduces a fresh one exactly.
        The device buffers are zeroed in place (the graphs keep them), and
        the graphs are kept."""
        K = self.serve.max_slots
        self._next_id = 0
        if self.cache is None:
            with self._context():
                self.cache = init_slot_cache(self.model, K,
                                             self.serve.max_seq,
                                             kv_fmt=self.serve.kv_fmt)
            # the decode step's token and active-mask inputs
            self._tokens_dev = torch.zeros((K,), dtype=torch.int32,
                                           device=self.device)
            self._active_dev = torch.zeros((K,), dtype=torch.bool,
                                           device=self.device)
        else:
            for t in (*self.cache.values(), self._tokens_dev,
                      self._active_dev):
                t.zero_()
        self.pool = SlotPool(K)
        self.metrics = ServeMetrics()
        self.queue: collections.deque = collections.deque()
        self.results: Dict[int, RequestResult] = {}
        self._tokens_by_req: Dict[int, List[int]] = {}
        self._live: Dict[int, Request] = {}     # admitted, not yet retired
        self._cur_tokens = np.zeros((K,), np.int32)
        self._active = np.zeros((K,), bool)
        self._rids = np.zeros((K,), np.int64)
        # host mirror of cache["pos"]
        self._pos = np.zeros((K,), np.int32)
        # the device tokens and mask are re-uploaded only after an
        # admission or release; otherwise the sampled tokens feed back
        self._dirty = True
        # fault-tolerance state: the per-domain counters the FaultPlan is
        # polled against, the clock-freeze window, and the degraded-mode
        # admission cap (shrunk by the supervisor on replica loss)
        self._tick_index = 0
        self._prefill_count = 0
        self._freeze_reads = 0
        self._freeze_val = 0.0
        self.slot_cap = K
        #: Decode steps that replayed a fault victim's generated prefix.
        self.replayed_steps = 0

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               arrival_time: float = 0.0, eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None) -> int:
        """Queue a request; returns its request id.

        The scheduler admits it no earlier than ``arrival_time`` seconds
        after ``run()`` starts.  ``deadline_s`` (default
        ``ServeConfig.deadline_s``) bounds its life from arrival: expiry in
        the queue rejects it un-admitted, expiry in flight retires it with
        its partial tokens (status "timed_out").  When
        ``ServeConfig.max_queue`` > 0 and that many requests already wait,
        the request is shed: never queued, its result (status "shed", no
        tokens) recorded at once.
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size > self.serve.max_seq:
            raise ValueError(
                f"prompt of {prompt.size} tokens exceeds max_seq="
                f"{self.serve.max_seq}")
        rid = self._next_id
        self._next_id += 1
        budget = (self.serve.max_new_tokens if max_new_tokens is None
                  else max_new_tokens)
        if budget < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if deadline_s is None:
            deadline_s = self.serve.deadline_s
        self.metrics.on_submit(rid, prompt.size, arrival_time)
        self._tokens_by_req[rid] = []
        req = Request(request_id=rid, prompt=prompt, max_new_tokens=budget,
                      arrival_time=arrival_time, eos_id=eos_id,
                      deadline_s=deadline_s)
        if (self.serve.max_queue > 0
                and len(self.queue) >= self.serve.max_queue):
            self.metrics.on_shed(rid, arrival_time)
            self.results[rid] = RequestResult(
                request_id=rid, prompt=prompt,
                tokens=np.zeros((0,), np.int32),
                timing=self.metrics.timings[rid], status="shed")
            return rid
        self.queue.append(req)
        return rid

    def run(self, clock: Optional[Callable[[], float]] = None
            ) -> Dict[int, RequestResult]:
        """Drive the scheduler until every submitted request completes.

        ``clock`` (for tests) replaces the wall clock (seconds since
        ``run()`` began); it only gates admission and deadlines, never
        the tokens.
        """
        self.queue = collections.deque(
            sorted(self.queue, key=lambda r: r.arrival_time))
        t0 = time.perf_counter()
        raw_now = self._shared(clock or (lambda: time.perf_counter() - t0))

        def now_fn():
            # clock_freeze: hold time still for a bounded number of reads
            if self._freeze_reads > 0:
                self._freeze_reads -= 1
                return self._freeze_val
            return raw_now()

        last_idle_now, stalled = None, 0
        try:
            while self.queue or self.pool.n_active:
                self._expire_deadlines(now_fn)
                self._admit(now_fn)
                if self.pool.n_active:
                    self._tick(now_fn)
                    stalled = 0
                    continue
                if not self.queue:
                    break
                # idle until the next request arrives or its backoff ends
                now = now_fn()
                next_ready = min(max(r.arrival_time, r.not_before)
                                 for r in self.queue)
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
                                f"next eligible time ({next_ready}); engine "
                                "cannot make progress")
                    last_idle_now = now
        finally:
            # accumulated over runs; the raw clock, so that a freeze window
            # still open cannot shorten the wall
            self.metrics.run_wall += raw_now()
        return dict(self.results)

    # ------------------------------------------------------------------ #
    # the model group
    # ------------------------------------------------------------------ #
    def _context(self):
        """The model code's context on this rank (``serve.layout``)."""
        if self.layout is None:
            return contextlib.nullcontext()
        return self.layout.context()

    def _shared(self, clock: Callable[[], float]) -> Callable[[], float]:
        """``clock`` alone; on a model group rank 0's reading, broadcast
        over the group at every read (the ranks read it at the same points
        of identical schedules, so every read pairs up)."""
        axis = self.model_group
        if axis is None:
            return clock
        src = dist.get_global_rank(axis.group, 0)
        dev = ("cpu" if dist.get_backend(axis.group) == "gloo"
               else self.device)

        def now() -> float:
            t = torch.tensor([clock() if axis.index == 0 else 0.0],
                             dtype=torch.float64, device=dev)
            dist.broadcast(t, src=src, group=axis.group)
            return float(t.item())

        return now

    def _program(self, fn: Callable, pool=None):
        """A step of the engine: a CUDA graph of ``fn`` on CUDA, or ``fn``
        called as it is where the engine runs eagerly."""
        if self._eager:
            return _Eager(fn)
        return StepGraph(fn, self.device, pool=pool)

    # ------------------------------------------------------------------ #
    # scheduler internals
    # ------------------------------------------------------------------ #
    def _next_eligible(self, now: float) -> Optional[Request]:
        """Pop the first queued request that has arrived and is past its
        retry backoff (FCFS)."""
        for i, req in enumerate(self.queue):
            if req.arrival_time <= now and req.not_before <= now:
                del self.queue[i]
                return req
        return None

    def _admit(self, now_fn):
        """Fill free slots, up to ``slot_cap`` busy, with eligible requests:
        the prompt's bucketed prefill copied into the slot, a replayed
        request's generated prefix decoded again, then the next token
        sampled at position ``prompt_len + len(prefix)``.
        ``SlotState.prompt_len`` keeps the prompt's length, so the
        retirement arithmetic of ``_record_token`` holds across replays."""
        while self.pool.n_free and self.pool.n_active < self.slot_cap:
            req = self._next_eligible(now_fn())
            if req is None:
                return
            prefix = self._tokens_by_req[req.request_id]
            if self.faults is not None:
                attempt = self._prefill_count
                self._prefill_count += 1
                due = self.faults.take("prefill_fail", attempt)
                if due:
                    # injected prefill dispatch failure: the request never
                    # touches a slot; re-queue it behind its backoff gate
                    self.metrics.faults_injected += len(due)
                    self._requeue(req, now_fn())
                    continue
            n = req.prompt.size
            slot = self.pool.acquire(req.request_id, n,
                                     req.max_new_tokens - len(prefix))
            logits = self._prefill(req.prompt, slot)
            if prefix:
                logits = self._replay(slot, n, prefix)
            total = n + len(prefix)
            seeds = [sampling_seed(self.serve.seed, req.request_id, total)]
            tok = int(sample_tokens(logits, self.serve.temperature, seeds)[0])
            now = now_fn()
            self._live[req.request_id] = req
            self.metrics.on_admit(req.request_id, now)
            self.metrics.on_first_token(req.request_id, now)
            self._record_token(slot, req, tok, now)

    def _prefill(self, prompt: np.ndarray, slot: int) -> torch.Tensor:
        """The prompt's prefill in its bucket (the bucket's graph, captured
        at its first call), copied into ``slot``; returns the (1, V)
        logits of its last row."""
        n = prompt.size
        bucket = prefill_bucket(n, self.serve.max_seq)
        host = np.zeros((bucket + 1,), np.int32)
        host[:n] = prompt
        host[bucket] = n
        buf = self._prefill_in.get(bucket)
        if buf is None:
            buf = self._prefill_in[bucket] = torch.empty(
                (bucket + 1,), dtype=torch.int32, device=self.device)
        buf.copy_(torch.from_numpy(host))
        step = self._prefills.get(bucket)
        if step is None:
            if (self.device.type == "cuda" and not self._eager
                    and self._prefill_pool is None):
                self._prefill_pool = torch.cuda.graph_pool_handle()
            step = self._prefills[bucket] = self._program(
                lambda: self._prefill_step(buf, bucket),
                pool=self._prefill_pool)
        logits, pcache = step()
        self._write(pcache, slot, n)
        return logits

    def _prefill_step(self, buf: torch.Tensor, bucket: int):
        # a sequence-split cache: the prefill writes this rank's rows of
        # the slot's whole max_seq rows
        seq = ({"cache_len": self.serve.max_seq}
               if self.layout is not None and self.layout.kv_split == "kv_seq"
               else {})
        with self._context():
            return self.model.prefill(
                self.params, {"tokens": buf[:bucket].view(1, bucket)},
                prompt_len=buf[bucket], kv_fmt=self.serve.kv_fmt, **seq)

    def _write(self, pcache, slot: int, prompt_len: int):
        """Copy a B=1 prefill cache into ``slot`` (in place): its rows
        [0, bucket) of every code and scale array (a sequence shard: all
        of this rank's rows); the slot's position is ``prompt_len``."""
        for name, arr in self.cache.items():
            if name == "pos":
                self._pos[slot] = prompt_len
                continue
            upd = pcache[name]
            arr[:, slot:slot + 1, :, :upd.shape[3]] = upd

    def _replay(self, slot: int, prompt_len: int,
                prefix: Sequence[int]) -> torch.Tensor:
        """Decode a fault victim's generated ``prefix`` again in ``slot``
        (its prompt just prefilled there), its slot alone active: token i
        at position ``prompt_len + i``, as the fault-free run decoded it.
        The other slots' rows run through the step inactive, as a free
        slot's do every tick: their write lands at their own position,
        which their next tick writes again before reading it.  Returns
        the (1, V) logits of the last step."""
        K = self.serve.max_slots
        active = np.zeros((K,), bool)
        active[slot] = True
        self._active_dev.copy_(torch.from_numpy(active))
        tokens = np.zeros((K,), np.int32)
        for i, tok in enumerate(prefix):
            tokens[slot] = tok
            self._pos[slot] = prompt_len + i
            self._tokens_dev.copy_(torch.from_numpy(tokens))
            self.cache["pos"].copy_(torch.from_numpy(self._pos))
            logits = self._step()
            self.replayed_steps += 1
        self._pos[slot] = prompt_len + len(prefix)
        self._dirty = True
        return logits[slot:slot + 1]

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

    def _stage(self):
        """Fill the decode step's inputs in place: the positions from the
        host mirror, and after an admission or release the tokens and the
        active mask."""
        self.cache["pos"].copy_(torch.from_numpy(self._pos))
        if self._dirty:
            self._tokens_dev.copy_(torch.from_numpy(self._cur_tokens))
            self._active_dev.copy_(torch.from_numpy(self._active))
            self._dirty = False

    def _decode_step(self):
        with self._context():
            logits, _ = self.model.decode_slots(
                self.params, self.cache, self._tokens_dev, self._active_dev,
                kv_fmt=self.serve.kv_fmt)
        return logits

    def _step(self) -> torch.Tensor:
        """The decode step over the staged inputs; returns the (K, V)
        logits.  The graph is captured at the first call: its warm-up
        writes what the first replay writes (the same tokens at the same
        positions) and advances the positions, which are staged again."""
        if self._decode is None:
            self._decode = self._program(self._decode_step)
            self.cache["pos"].copy_(torch.from_numpy(self._pos))
        return self._decode()

    def _tick(self, now_fn):
        """One decode + sample step over every slot.

        Fault hook point: ``clock_freeze``, ``slot_corrupt`` and
        ``decode_fail`` are polled against the tick counter before the
        step runs; a decode failure makes every active slot a victim.
        ``on_tick`` runs after every attempt, failed ones included, with
        the tick's wall (the device->host copy of its tokens included).
        """
        tick = self._tick_index
        self._tick_index += 1
        t_start = time.perf_counter()
        try:
            if self.faults is not None:
                for ev in self.faults.take("clock_freeze", tick):
                    self.metrics.faults_injected += 1
                    # the frozen value is the instant the window opens
                    self._freeze_val = now_fn()
                    self._freeze_reads = ev.duration or DEFAULT_FREEZE_READS
                for ev in self.faults.take("slot_corrupt", tick):
                    self.metrics.faults_injected += 1
                    self.metrics.slot_faults += 1
                    self._corrupt_slot(ev, now_fn)
                due = self.faults.take("decode_fail", tick)
                if due:
                    self.metrics.faults_injected += len(due)
                    self.metrics.slot_faults += len(due)
                    self._fail_tick(now_fn)
                    return
                if not self.pool.n_active:
                    # every occupant was a poison victim
                    return
            self._stage()
            logits = self._step()
            self._pos += self._active                # as the step advanced pos
            seeds = None
            if self.serve.temperature > 0:
                seeds = [sampling_seed(self.serve.seed, int(r), int(p))
                         for r, p in zip(self._rids, self._pos)]
            toks_dev = sample_tokens(logits, self.serve.temperature,
                                     seeds).to(torch.int32)
            toks = toks_dev.cpu().numpy()    # the tick's one device->host copy
            self.metrics.decode_ticks += 1
            now = now_fn()
            for slot in np.nonzero(self._active)[0]:
                slot = int(slot)
                rid = self.pool.state(slot).request_id
                self._record_token(slot, self._live[rid], int(toks[slot]),
                                   now)
            if not self._dirty:
                self._tokens_dev.copy_(toks_dev)
        finally:
            if self.on_tick is not None:
                self.on_tick(tick, time.perf_counter() - t_start, now_fn())

    # ------------------------------------------------------------------ #
    # fault recovery
    # ------------------------------------------------------------------ #
    def _zero_scales(self, slot: int):
        """Zero ``slot``'s scale rows (a quantized cache), in place."""
        for name in ("k_scale", "v_scale"):
            if name in self.cache:
                self.cache[name][:, slot] = 0

    def _evict(self, slot: int) -> Request:
        """Tear a live request out of ``slot`` without finalizing it."""
        rid = self.pool.state(slot).request_id
        req = self._live.pop(rid)
        self._active[slot] = False
        self._dirty = True
        self.pool.release(slot)
        self._zero_scales(slot)
        return req

    def _requeue(self, req: Request, now: float):
        """Re-queue a fault victim with linear backoff, or retire it with
        status "failed" and its partial tokens once its retries are
        spent.  The generated prefix stays in ``_tokens_by_req``; the
        re-admission replays it (``_admit``)."""
        req.attempts += 1
        if req.attempts > self.serve.max_retries:
            self._finalize(req, now, status="failed")
            return
        req.not_before = now + req.attempts * self.serve.retry_backoff_s
        self.metrics.on_retry(req.request_id)
        self.queue.append(req)

    def _fail_tick(self, now_fn):
        """Injected decode dispatch failure: all active slots are victims."""
        now = now_fn()
        for slot in np.nonzero(self._active)[0]:
            self._requeue(self._evict(int(slot)), now)

    def _corrupt_slot(self, ev, now_fn):
        """Overwrite one slot's cache rows with the reference's
        deterministic junk, in place (the decode graph holds the cache's
        addresses).

        Modelled as *detected* poison: the occupant, if any, is evicted
        for replay and the slot's scale rows are zeroed before reuse.
        Under ``kv_fmt=none`` (no scales) the junk is masked by the
        positions until the next occupant overwrites it.  The junk is
        ``integers(-100, 100)`` of ``default_rng((plan seed, ev.at,
        slot))`` a cache array in the cache's order, cast to its dtype (a
        negative value wraps in an unsigned code array).
        """
        K = self.serve.max_slots
        slot = ev.target % K if ev.target >= 0 else 0
        rng = np.random.default_rng((self.faults.seed, ev.at, slot))
        for name, arr in self.cache.items():
            if name == "pos":
                continue
            junk = rng.integers(-100, 100,
                                size=(arr.shape[0], 1) + tuple(arr.shape[2:]))
            arr[:, slot:slot + 1] = torch.from_numpy(junk).to(arr.dtype).to(
                arr.device)
        if self._active[slot]:
            self._requeue(self._evict(slot), now_fn())
        else:
            self._zero_scales(slot)

    def _expire_deadlines(self, now_fn):
        """Retire every request whose deadline has passed: a queued one
        never admitted lands in the rejected bucket; a victim awaiting
        replay, and an in-flight one, retire "timed_out" with the tokens
        they generated."""
        if not self.queue and not self._live:
            return
        now = now_fn()
        keep: collections.deque = collections.deque()
        for req in self.queue:
            exp = req.expiry()
            if exp is None or exp > now:
                keep.append(req)
                continue
            self._finalize(req, now, status="timed_out")
        self.queue = keep
        for slot in np.nonzero(self._active)[0]:
            slot = int(slot)
            req = self._live[self.pool.state(slot).request_id]
            exp = req.expiry()
            if exp is not None and exp <= now:
                self._retire(slot, req, now, status="timed_out")

    def _finalize(self, req: Request, now: float, status: str):
        """Record the terminal result of a request that holds no slot."""
        rid = req.request_id
        toks = np.asarray(self._tokens_by_req.get(rid, []), np.int32)
        if status == "timed_out" and self.metrics.timings[rid].admitted is None:
            self.metrics.on_queue_timeout(rid, now)
        else:
            self.metrics.on_complete(rid, now, n_generated=int(toks.size),
                                     status=status)
        self.results[rid] = RequestResult(
            request_id=rid, prompt=req.prompt, tokens=toks,
            timing=self.metrics.timings[rid], status=status)

    # ------------------------------------------------------------------ #
    # degraded-mode hooks (runtime.supervisor)
    # ------------------------------------------------------------------ #
    def set_slot_cap(self, cap: int):
        """Cap concurrent admissions (degraded mode); clamped to [1, K]."""
        self.slot_cap = max(1, min(int(cap), self.serve.max_slots))

    def takeover_unfinished(self) -> List[Tuple[Request, List[int]]]:
        """Hand every unfinished request to the supervisor's oneshot
        fallback: evict every live slot and empty the queue; returns
        ``(request, generated_prefix)`` pairs in request-id order
        (``finalize_external`` records the fallback's results)."""
        out = []
        for slot in np.nonzero(self._active)[0]:
            req = self._evict(int(slot))
            out.append((req, list(self._tokens_by_req[req.request_id])))
        while self.queue:
            req = self.queue.popleft()
            out.append((req, list(self._tokens_by_req[req.request_id])))
        return sorted(out, key=lambda p: p[0].request_id)

    def finalize_external(self, req: Request, tokens, now: float,
                          status: str = "ok"):
        """Record a result completed outside the engine (oneshot fallback)."""
        self._tokens_by_req[req.request_id] = [int(t) for t in tokens]
        self._finalize(req, now, status=status)

    def _retire(self, slot: int, req: Request, now: float,
                status: str = "ok"):
        """Release a finished slot, zero its scale rows, record the result."""
        if self._active[slot]:
            self._dirty = True
        self._active[slot] = False
        self.pool.release(slot)
        self._zero_scales(slot)
        self._live.pop(req.request_id, None)
        toks = np.asarray(self._tokens_by_req[req.request_id], np.int32)
        self.metrics.on_complete(req.request_id, now,
                                 n_generated=int(toks.size), status=status)
        self.results[req.request_id] = RequestResult(
            request_id=req.request_id, prompt=req.prompt, tokens=toks,
            timing=self.metrics.timings[req.request_id], status=status)
