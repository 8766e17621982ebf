"""Preemption handling for the training loop.

The counterpart of ``repro.runtime.preemption``.  A ``PreemptionHandler``
turns two interrupt sources into one polled flag:

* **signals** — SIGTERM (the notice a scheduler gives an evicted job);
* **injected faults** — ``FaultPlan`` "preempt" events polled against the
  trainer's global step counter, so preemption tests are seed-exact.

``repro_torch.train_loop.Trainer`` polls ``should_preempt(step)`` after
every loop step and every scan chunk; when it fires, the trainer writes a
*mid-epoch* checkpoint (params, optimizer state, accountant history,
DPQuant scheduler state, sampler and probe RNG stream positions, the
epoch's step index and losses) and raises :class:`Preempted`.  Restoring
all of that is what makes a preempted-and-resumed run bit-identical to an
uninterrupted one.
"""
from __future__ import annotations

import signal
from typing import Optional

from repro_torch.runtime.faults import FaultPlan


class Preempted(RuntimeError):
    """Raised by the trainer after a preemption checkpoint was written."""

    def __init__(self, step: int, message: str = ""):
        """Record the global step the run was preempted at."""
        super().__init__(message or f"preempted at step {step}")
        self.step = step


class PreemptionHandler:
    """One polled preemption flag fed by signals and/or injected faults."""

    def __init__(self, faults: Optional[FaultPlan] = None,
                 handle_signals: bool = False):
        """Optionally consume ``faults`` and/or install a SIGTERM handler."""
        self.faults = faults
        self._requested = False
        self._prev_handlers = {}
        if handle_signals:
            self.install()

    def install(self, signals=(signal.SIGTERM,)) -> None:
        """Route ``signals`` to the preemption flag (remembers old handlers).

        Only callable from the main thread (a Python ``signal`` limitation);
        workers driving the trainer from another thread use ``request()``.
        """
        for s in signals:
            self._prev_handlers[s] = signal.signal(s, self._on_signal)

    def uninstall(self) -> None:
        """Restore the signal handlers ``install`` replaced."""
        for s, h in self._prev_handlers.items():
            signal.signal(s, h)
        self._prev_handlers = {}

    def _on_signal(self, signum, frame) -> None:
        self._requested = True

    def request(self) -> None:
        """Request preemption programmatically (tests, external watchers)."""
        self._requested = True

    @property
    def requested(self) -> bool:
        """Whether preemption is pending (without consuming fault events)."""
        return self._requested

    def should_preempt(self, step: int) -> bool:
        """Poll at a step boundary: injected "preempt" events at ``<= step``
        (trainer global-step domain) latch the flag, as do signals."""
        if self.faults is not None and self.faults.take("preempt", step):
            self._requested = True
        return self._requested

    def clear(self) -> None:
        """Drop a latched request (after the checkpoint was written)."""
        self._requested = False
