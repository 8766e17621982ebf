"""Serve supervisor: SLO instrumentation and degraded-mode handling.

The counterpart of ``repro.runtime.supervisor``.  It wires the runtime
modules (``Heartbeat`` / ``FailureDetector``, ``StragglerDetector``,
``plan_remesh``) into the continuous engine's tick loop through its
``on_tick`` hook.  The supervisor models the serving fleet as
``n_replicas`` virtual replicas sharing the engine's clock:

* every tick, each live replica beats its heartbeat file and records the
  tick's wall time into the straggler EWMA (a ``replica_slow`` fault
  multiplies one replica's reported time by ``factor``);
* a ``replica_death`` fault stops a replica's heartbeats, so the
  ``FailureDetector`` declares it dead once its last beat ages past the
  deadline on the same clock;
* dead or straggling replicas trigger the degraded-mode ladder:

  1. **re-plan** — ``plan_remesh`` over the surviving chips, and the
     engine's admission cap shrinks proportionally
     (``set_slot_cap``) so the smaller fleet is not oversubscribed;
  2. **oneshot fallback** — after ``slot_fault_threshold`` slot-pool
     faults the slot cache is presumed unreliable;
     :class:`DegradeToOneshot` aborts the tick loop and
     :func:`drain_with_oneshot` finishes every unfinished request, one at
     a time and lockstep, on a cache of its own, sampling with the
     *engine's* ``(request_id, position)`` seeds so tokens stay
     bit-identical to a fault-free continuous run;
  3. **shed** — with no capacity at all, admission control rejects new
     work at submit (``ServeConfig.max_queue``).

Every degraded event is appended to ``ServeSupervisor.events`` and
counted in ``ServeMetrics.degraded_events``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

import torch

from repro_torch.runtime.elastic import plan_remesh
from repro_torch.runtime.faults import FaultPlan
from repro_torch.runtime.heartbeat import FailureDetector, Heartbeat
from repro_torch.runtime.straggler import StragglerDetector


class DegradeToOneshot(RuntimeError):
    """Slot pool faulted too often; abort the tick loop for the fallback."""


class ServeSupervisor:
    """Heartbeat/straggler supervision of a ``ContinuousEngine`` run.

    Construction attaches the supervisor to ``engine.on_tick``.  Drive the
    engine through :func:`run_supervised` (or call ``engine.run`` and
    catch :class:`DegradeToOneshot` yourself).
    """

    def __init__(self, engine, *, n_replicas: int = 2,
                 hb_dir: Optional[str] = None,
                 hb_deadline_s: float = 2.0,
                 faults: Optional[FaultPlan] = None,
                 chips_per_replica: int = 1,
                 model_parallel: int = 1,
                 per_replica_batch: int = 1,
                 dataset_size: int = 1_000_000,
                 slot_fault_threshold: int = 3,
                 straggler_patience: int = 3):
        """Attach to ``engine`` and model an ``n_replicas`` virtual fleet.

        ``hb_dir`` enables file-based failure detection (tests use a
        tmpdir); without it a killed replica is declared dead on the next
        tick directly.  ``faults`` defaults to the engine's plan so one
        seeded plan drives both tick-level and replica-level events.
        """
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if getattr(engine, "model_group", None) is not None:
            # its heartbeats and stragglers read each rank's own wall
            # clock, and a rank must not re-plan or drain alone
            raise NotImplementedError(
                "the supervisor does not run over an engine on a model "
                "group: its heartbeat and straggler decisions read each "
                "rank's wall clock (ROADMAP.md section 1)")
        self.engine = engine
        self.n_replicas = n_replicas
        self.faults = faults if faults is not None else engine.faults
        self.chips_per_replica = chips_per_replica
        self.model_parallel = model_parallel
        self.per_replica_batch = per_replica_batch
        self.dataset_size = dataset_size
        self.slot_fault_threshold = slot_fault_threshold
        self.straggler = StragglerDetector(patience=straggler_patience)
        self.detector = (FailureDetector(hb_dir, deadline_s=hb_deadline_s)
                         if hb_dir else None)
        self.heartbeats: Dict[int, Heartbeat] = (
            {r: Heartbeat(hb_dir, r) for r in range(n_replicas)}
            if hb_dir else {})
        self._killed: Set[int] = set()      # stopped beating (fault fired)
        self._slow: Dict[int, float] = {}   # replica -> tick-time factor
        self.dead: Set[int] = set()         # declared dead / evicted
        self.plans: List = []               # MeshPlan after each re-plan
        self.events: List[dict] = []        # degraded-event log
        self._tick = 0
        self._oneshot_raised = False
        engine.on_tick = self.on_tick

    # ------------------------------------------------------------------ #
    def live_replicas(self) -> List[int]:
        """Replicas not yet declared dead, in id order."""
        return [r for r in range(self.n_replicas) if r not in self.dead]

    def on_tick(self, tick: int, dt: float, now: float) -> None:
        """Per-tick supervision: beats, EWMA, detection, degraded ladder."""
        t = self._tick
        self._tick += 1
        if self.faults is not None:
            for ev in self.faults.take("replica_death", t):
                self.engine.metrics.faults_injected += 1
                self._killed.add(ev.target % self.n_replicas)
            for ev in self.faults.take("replica_slow", t):
                self.engine.metrics.faults_injected += 1
                self._slow[ev.target % self.n_replicas] = ev.factor
        for r in self.live_replicas():
            if r in self._killed:
                continue                    # dead replicas stop beating
            if self.heartbeats:
                self.heartbeats[r].beat(step=tick, now=now)
            self.straggler.record(r, dt * self._slow.get(r, 1.0))
        self.straggler.update_strikes()
        newly_dead = set()
        if self.detector is not None:
            newly_dead |= {r for r in self.detector.dead_hosts(now=now)
                           if r not in self.dead}
        else:
            newly_dead |= self._killed - self.dead
        newly_dead |= {r for r in self.straggler.stragglers()
                       if r not in self.dead}
        if newly_dead:
            self.dead |= newly_dead
            self._replan(now, sorted(newly_dead))
        if (self.engine.metrics.slot_faults >= self.slot_fault_threshold
                and not self._oneshot_raised):
            self._oneshot_raised = True
            self.engine.metrics.degraded_events += 1
            self.events.append({"t": now, "kind": "oneshot_fallback",
                                "slot_faults":
                                    self.engine.metrics.slot_faults})
            raise DegradeToOneshot(
                f"{self.engine.metrics.slot_faults} slot-pool faults "
                f">= threshold {self.slot_fault_threshold}")

    def _replan(self, now: float, lost: List[int]) -> None:
        """Degraded-mode re-plan after replica loss / straggler eviction."""
        n_live = len(self.live_replicas())
        plan = plan_remesh(n_live * self.chips_per_replica,
                           self.model_parallel, self.per_replica_batch,
                           self.dataset_size)
        self.plans.append(plan)
        # shrink admissions proportionally to surviving capacity; the
        # engine clamps to >= 1 (it is the one real executor here)
        cap = max(1, (self.engine.serve.max_slots * max(n_live, 1))
                  // self.n_replicas)
        self.engine.set_slot_cap(cap)
        self.engine.metrics.degraded_events += 1
        self.events.append({
            "t": now, "kind": "replan", "lost": lost,
            "live": self.live_replicas(), "slot_cap": self.engine.slot_cap,
            "plan": dataclasses.asdict(plan) if plan is not None else None})


# ---------------------------------------------------------------------- #
# oneshot fallback
# ---------------------------------------------------------------------- #
def drain_with_oneshot(engine, now: float = 0.0):
    """Finish every unfinished engine request, one at a time, lockstep.

    Each request runs alone through the engine's own steps, eagerly, on a
    fresh cache of the engine's slot geometry (the engine's is presumed
    unreliable), in its row 0: its prompt's bucketed prefill, its
    generated prefix decoded again (the engine's replay), then one decode
    step a token, sampled with the engine's ``sampling_seed(seed,
    request_id, position)`` and retired on the engine's conditions
    (budget, EOS, cache full).  Every position is computed as the
    fault-free continuous run computed it, so the drained tokens are
    bit-identical to it.  The B=1 lockstep decode of ``serve.oneshot``
    is not: a GEMM of one row rounds otherwise than the tick's of K rows
    on the card, where its logits are not the slot row's bits
    (``chip_smoke.py``'s replay witness).  Returns the engine's full
    results dict.
    """
    from repro_torch.serve.engine import (prefill_bucket, sample_tokens,
                                          sampling_seed)
    from repro_torch.serve.slots import init_slot_cache

    pending = engine.takeover_unfinished()
    if not pending:
        return dict(engine.results)
    model, params, serve = engine.model, engine.params, engine.serve
    dev, kv_fmt = engine.device, serve.kv_fmt
    cache = init_slot_cache(model, serve.max_slots, serve.max_seq,
                            kv_fmt=kv_fmt)
    tokens = torch.zeros((serve.max_slots,), dtype=torch.int32, device=dev)
    active = torch.zeros((serve.max_slots,), dtype=torch.bool, device=dev)
    active[0] = True

    def decode(tok):
        tokens[0] = tok
        logits, _ = model.decode_slots(params, cache, tokens, active,
                                       kv_fmt=kv_fmt)
        return logits[:1]

    for req, prefix in pending:
        exp = req.expiry()
        if exp is not None and exp <= now:
            engine.finalize_external(req, prefix, now, status="timed_out")
            continue
        n, rid = req.prompt.size, req.request_id
        bucket = prefill_bucket(n, serve.max_seq)
        padded = torch.zeros((1, bucket), dtype=torch.int32)
        padded[0, :n] = torch.tensor(req.prompt)
        logits, pcache = model.prefill(
            params, {"tokens": padded.to(dev)},
            prompt_len=torch.tensor(n, dtype=torch.int32, device=dev),
            kv_fmt=kv_fmt)
        for name, arr in cache.items():
            arr.zero_()
            if name != "pos":
                arr[:, :1, :, :bucket] = pcache[name]
        cache["pos"][0] = n
        for tok in prefix:
            logits = decode(tok)
        toks = list(prefix)
        pos = n + len(toks)             # position of the next sample
        remaining = req.max_new_tokens - len(toks)
        while remaining > 0:
            seeds = [sampling_seed(serve.seed, rid, pos)]
            tok = int(sample_tokens(logits, serve.temperature, seeds)[0])
            toks.append(tok)
            remaining -= 1
            # the engine's retirement: budget, EOS, or the recorded
            # token's cache index (== pos) outside the slot
            if (remaining <= 0
                    or (req.eos_id is not None and tok == req.eos_id)
                    or pos >= serve.max_seq):
                break
            logits = decode(tok)
            pos += 1
        engine.finalize_external(req, toks, now, status="ok")
    return dict(engine.results)


def run_supervised(engine, clock=None):
    """``engine.run`` with the supervisor's oneshot-fallback rung applied."""
    try:
        return engine.run(clock=clock)
    except DegradeToOneshot:
        # the slot pool is presumed unreliable: finish what is left one
        # request at a time (token-identical; see drain_with_oneshot)
        now = engine.metrics.run_wall
        return drain_with_oneshot(engine, now=now)
