"""Deterministic seeded fault injection for the serve and train loops.

The counterpart of ``repro.runtime.faults``, copied whole (numpy only).
A ``FaultPlan`` is an explicit, seed-derived schedule of fault events —
*which* fault, *when* (a dispatch/tick/step counter, not wall time), and
*where* (a slot / replica target).  Hooks poll the plan at explicit points
(``take``), so every failure-recovery path is reproducible: the same seed
produces the same faults at the same counters on every run.  In the port
the trainer polls ``"preempt"`` (through
``repro_torch.runtime.preemption``), the serving engine
(``repro_torch.serve.engine``) the four engine kinds and the serving
supervisor (``repro_torch.runtime.supervisor``) the two replica kinds.

Fault kinds and the counter domain each is polled against:

=================  =========================  ==============================
kind               counter domain             injected effect
=================  =========================  ==============================
``prefill_fail``   engine prefill attempts    admission prefill dispatch
                                              raises; request re-queued with
                                              backoff
``decode_fail``    engine decode ticks        the fused decode tick raises;
                                              every active request loses its
                                              slot and is re-queued for
                                              deterministic replay
``slot_corrupt``   engine decode ticks        a slot's cache rows (codes and
                                              scales) are overwritten with
                                              garbage; modelled as *detected*
                                              poison (ECC-style), so the
                                              occupant is replayed
``clock_freeze``   engine decode ticks        the engine's clock returns a
                                              frozen value for ``duration``
                                              reads, then thaws
``replica_death``  supervisor ticks           a virtual replica stops
                                              heartbeating; the failure
                                              detector evicts it and the
                                              supervisor re-plans the mesh
``replica_slow``   supervisor ticks           a replica's reported tick time
                                              is multiplied by ``factor`` so
                                              the straggler detector flags it
``preempt``        trainer step index         the trainer checkpoints
                                              mid-epoch and stops
=================  =========================  ==============================

Counters are per-domain, so one plan can drive serve and train hooks
simultaneously without collisions.  Every fired event is appended to
``FaultPlan.log`` (JSON-serializable).

Determinism is the point: DP accounting is per-step ``(sigma, q)``
tuples, so recovery never perturbs the privacy guarantee.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence

import numpy as np

FAULT_KINDS = ("prefill_fail", "decode_fail", "slot_corrupt", "clock_freeze",
               "replica_death", "replica_slow", "preempt")

# Default number of clock reads a clock_freeze holds time still for.  Kept
# well under the engine's frozen-clock stall guard (1000 idle iterations)
# so an injected freeze can never be mistaken for a hung injected clock.
DEFAULT_FREEZE_READS = 8


class FaultInjected(RuntimeError):
    """Raised by an injected dispatch failure (prefill/decode)."""

    def __init__(self, event: "FaultEvent"):
        """Wrap the fault event that fired."""
        super().__init__(f"injected fault: {event}")
        self.event = event


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: what, when (a counter value), and where."""

    kind: str
    at: int                 # counter value in the kind's domain (see module doc)
    target: int = -1        # slot / replica index; -1 = unspecified
    duration: int = 0       # clock_freeze: reads held frozen (0 = default)
    factor: float = 4.0     # replica_slow: tick-time multiplier

    def __post_init__(self):
        """Validate the kind and schedule point."""
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{FAULT_KINDS}")
        if self.at < 0:
            raise ValueError(f"fault scheduled at negative counter {self.at}")


class FaultPlan:
    """A consumable, seed-reproducible schedule of :class:`FaultEvent`.

    ``take(kind, at)`` returns (and consumes) every pending event of
    ``kind`` whose schedule point is ``<= at`` — the ``<=`` makes plans
    robust to counters that skip values (e.g. a tick that also consumed a
    failure).  Consumed events are appended to ``log`` with the counter
    value they actually fired at.
    """

    def __init__(self, events: Sequence[FaultEvent] = (), *, seed: int = 0):
        """Hold ``events`` (kept sorted by schedule point) for consumption."""
        self.seed = seed
        self._pending: List[FaultEvent] = sorted(events, key=lambda e: e.at)
        self.log: List[dict] = []

    # ------------------------------------------------------------------ #
    @classmethod
    def generate(cls, seed: int, *, kinds: Sequence[str] = FAULT_KINDS,
                 horizon: int, n_faults: Optional[int] = None,
                 n_slots: int = 1, n_replicas: int = 1,
                 freeze_reads: int = DEFAULT_FREEZE_READS,
                 slow_factor: float = 4.0) -> "FaultPlan":
        """Derive a plan purely from ``seed``.

        ``n_faults`` events (default: one per kind, round-robin over
        ``kinds``) are scheduled uniformly over ``[1, horizon)`` with
        uniformly-drawn slot/replica targets.  Same arguments + same seed
        => the identical plan, which is what makes every chaos test
        reproducible.
        """
        if horizon < 2:
            raise ValueError(f"horizon must be >= 2, got {horizon}")
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        rng = np.random.default_rng(seed)
        n = n_faults if n_faults is not None else len(kinds)
        events = []
        for i in range(n):
            kind = kinds[i % len(kinds)]
            at = int(rng.integers(1, horizon))
            target = int(rng.integers(0, max(n_slots, 1)))
            if kind in ("replica_death", "replica_slow"):
                target = int(rng.integers(0, max(n_replicas, 1)))
            events.append(FaultEvent(
                kind=kind, at=at, target=target,
                duration=freeze_reads if kind == "clock_freeze" else 0,
                factor=slow_factor))
        return cls(events, seed=seed)

    # ------------------------------------------------------------------ #
    @property
    def pending(self) -> List[FaultEvent]:
        """Events not yet consumed, in schedule order."""
        return list(self._pending)

    def take(self, kind: str, at: int) -> List[FaultEvent]:
        """Consume every pending ``kind`` event scheduled at ``<= at``."""
        due = [e for e in self._pending if e.kind == kind and e.at <= at]
        if due:
            self._pending = [e for e in self._pending if e not in due]
            for e in due:
                self.log.append({**dataclasses.asdict(e), "fired_at": at})
        return due

    def has_pending(self, kind: Optional[str] = None) -> bool:
        """Whether any (or any ``kind``) events remain unconsumed."""
        return any(kind is None or e.kind == kind for e in self._pending)

    # ------------------------------------------------------------------ #
    def log_json(self, extra: Optional[dict] = None) -> str:
        """The fired-event log (plus ``extra`` context) as a JSON string."""
        return json.dumps({"seed": self.seed, "fired": self.log,
                           "pending": [dataclasses.asdict(e)
                                       for e in self._pending],
                           **(extra or {})}, indent=2)
