"""Serving metrics: per-request timings and fleet-level throughput/latency.

A copy of ``repro.serve.metrics`` (the port imports nothing of the JAX
package).

The engine stamps four events per request — arrival (submit), admission
(slot acquired + prefill), first token, completion — and this module turns
them into the numbers a serving benchmark reports: tokens/sec over the run,
and p50/p99 of end-to-end latency, time-to-first-token, and queue wait.
All times are seconds on whatever clock the engine uses (wall clock by
default; tests may inject a fake clock).

Fault tolerance adds a ``status`` to every request and a set of recovery
counters:

* ``ok`` — completed normally (possibly after retries: ``recovered``);
* ``timed_out`` — deadline expired, either in the queue (never admitted)
  or in flight (retired with partial tokens);
* ``shed`` — rejected at submit because the queue was at ``max_queue``;
* ``failed`` — a fault victim whose retry budget ran out.

Requests that never produced tokens (``shed``, queue-expired
``timed_out``) have ``admitted``/``first_token``/``completed`` = None and
are reported through ``rejected()`` — ``summary()`` and ``per_request()``
never crash on them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

#: Terminal request states a RequestTiming / RequestResult may carry.
REQUEST_STATUSES = ("ok", "timed_out", "shed", "failed")


@dataclasses.dataclass
class RequestTiming:
    """Event timestamps, token counts, and terminal status for one request."""

    request_id: int
    prompt_len: int
    arrival: float
    admitted: Optional[float] = None
    first_token: Optional[float] = None
    completed: Optional[float] = None
    n_generated: int = 0
    status: str = "ok"
    retries: int = 0

    @property
    def queue_wait(self) -> Optional[float]:
        """Seconds spent queued before a slot freed up (None if never)."""
        if self.admitted is None:
            return None
        return self.admitted - self.arrival

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token, from arrival (None if none was produced)."""
        if self.first_token is None:
            return None
        return self.first_token - self.arrival

    @property
    def latency(self) -> Optional[float]:
        """End-to-end seconds from arrival to retirement (None if open)."""
        if self.completed is None:
            return None
        return self.completed - self.arrival


class ServeMetrics:
    """Accumulates per-request timings and summarizes a serving run."""

    def __init__(self):
        """Start with an empty timing table and zeroed counters."""
        self.timings: Dict[int, RequestTiming] = {}
        self.decode_ticks = 0
        # both walls accumulate across run() calls (reset() clears them):
        # run_wall = total scheduler-loop time, idle_wall = the part spent
        # sleeping for future arrivals (no decodable work)
        self.run_wall: float = 0.0
        self.idle_wall: float = 0.0
        # ---- fault-tolerance counters ----
        self.shed = 0               # rejected at submit (queue full)
        self.retried = 0            # re-queue events after a fault
        self.deadline_missed = 0    # queued + in-flight deadline expiries
        self.recovered = 0          # requests that completed ok after >=1 retry
        self.faults_injected = 0    # FaultPlan events that actually fired
        self.slot_faults = 0        # slot-pool faults (corruption/decode)
        self.degraded_events = 0    # supervisor re-plans (death/straggler)

    def on_submit(self, request_id: int, prompt_len: int,
                  arrival: float) -> None:
        """Record a request entering the queue."""
        self.timings[request_id] = RequestTiming(
            request_id=request_id, prompt_len=prompt_len, arrival=arrival)

    def on_admit(self, request_id: int, now: float) -> None:
        """Record slot acquisition (first admission only: retries keep the
        original admission stamp so queue_wait measures the first wait)."""
        t = self.timings[request_id]
        if t.admitted is None:
            t.admitted = now

    def on_first_token(self, request_id: int, now: float) -> None:
        """Record the first generated token (first admission only)."""
        t = self.timings[request_id]
        if t.first_token is None:
            t.first_token = now

    def on_retry(self, request_id: int) -> None:
        """Record one fault-triggered re-queue of ``request_id``."""
        self.retried += 1
        self.timings[request_id].retries += 1

    def on_shed(self, request_id: int, now: float) -> None:
        """Record a submit-time rejection (queue at max_queue)."""
        self.shed += 1
        self.timings[request_id].status = "shed"

    def on_complete(self, request_id: int, now: float,
                    n_generated: int, status: str = "ok") -> None:
        """Record retirement with the request's generated-token count."""
        if status not in REQUEST_STATUSES:
            raise ValueError(f"unknown request status {status!r}")
        t = self.timings[request_id]
        t.completed = now
        t.n_generated = n_generated
        t.status = status
        if status == "timed_out":
            self.deadline_missed += 1
        if status == "ok" and t.retries > 0:
            self.recovered += 1

    def on_queue_timeout(self, request_id: int, now: float) -> None:
        """Record a deadline expiry of a request still in the queue.

        The request was never admitted, so ``admitted``/``first_token``
        stay None and the row lands in ``rejected()``.
        """
        t = self.timings[request_id]
        t.status = "timed_out"
        self.deadline_missed += 1

    def _done(self) -> List[RequestTiming]:
        """Requests that were admitted and retired (any terminal status)."""
        return [t for t in self.timings.values() if t.completed is not None]

    def _rejected(self) -> List[RequestTiming]:
        """Requests that terminated without ever being admitted."""
        return [t for t in self.timings.values()
                if t.completed is None and t.status != "ok"]

    def per_request(self) -> List[dict]:
        """Per-request timing rows (admitted + retired, by request id).

        One dict per request with its TTFT / latency / queue wait in
        seconds plus terminal ``status`` and ``retries`` — the raw rows
        behind ``summary()``'s percentiles, which benchmarks embed in
        their JSON so regressions are attributable to specific requests
        rather than buried in an aggregate.  Never-admitted requests
        (shed / queue-expired) are reported by ``rejected()`` instead.
        """
        return [{
            "request_id": t.request_id,
            "prompt_len": t.prompt_len,
            "n_generated": t.n_generated,
            "status": t.status,
            "retries": t.retries,
            "ttft_s": t.ttft,
            "latency_s": t.latency,
            "queue_wait_s": t.queue_wait,
        } for t in sorted(self._done(), key=lambda t: t.request_id)]

    def rejected(self) -> List[dict]:
        """Rows for shed / never-admitted timed-out requests.

        These have no admission, first-token, or completion stamps; only
        identity, arrival, and the rejection status are meaningful.
        """
        return [{
            "request_id": t.request_id,
            "prompt_len": t.prompt_len,
            "arrival_s": t.arrival,
            "status": t.status,
        } for t in sorted(self._rejected(), key=lambda t: t.request_id)]

    def summary(self) -> dict:
        """Aggregate throughput and latency percentiles for completed work.

        ``tokens_per_sec`` counts *generated* tokens only (prompt tokens are
        input, not output) over ``run_wall``, which the engine sets to the
        full scheduler-loop wall time.  Percentiles cover ``status == "ok"``
        completions; shed / timed-out / failed requests are counted in
        their own buckets so they can't silently skew the latency story.
        """
        done = self._done()
        ok = [t for t in done if t.status == "ok"]
        counters = {
            "shed": self.shed,
            "retried": self.retried,
            "deadline_missed": self.deadline_missed,
            "recovered": self.recovered,
            "faults_injected": self.faults_injected,
            "slot_faults": self.slot_faults,
            "degraded_events": self.degraded_events,
            "n_timed_out": sum(1 for t in self.timings.values()
                               if t.status == "timed_out"),
            "n_failed": sum(1 for t in done if t.status == "failed"),
            "n_rejected": len(self._rejected()),
        }
        if not ok:
            # same key set as the populated branch so callers can index
            # unconditionally
            return {"n_requests": 0,
                    "total_new_tokens": int(sum(t.n_generated for t in done)),
                    "run_wall_s": self.run_wall,
                    "idle_wall_s": self.idle_wall,
                    "tokens_per_sec": 0.0,
                    "decode_ticks": self.decode_ticks,
                    "latency_p50_s": 0.0, "latency_p99_s": 0.0,
                    "ttft_p50_s": 0.0, "ttft_p99_s": 0.0,
                    "queue_wait_p50_s": 0.0, "queue_wait_p99_s": 0.0,
                    **counters}
        lat = np.array([t.latency for t in ok])
        ttft = np.array([t.ttft for t in ok if t.ttft is not None])
        # a request the oneshot fallback drained from the queue was never
        # admitted: it has no queue wait (the reference's summary raises)
        wait = np.array([t.queue_wait for t in ok if t.queue_wait is not None])
        # all retired tokens count as produced work (a timed-out request's
        # partial tokens were still generated and returned)
        total_new = int(sum(t.n_generated for t in done))
        wall = self.run_wall or max(t.completed for t in done) - min(
            t.arrival for t in done)
        return {
            "n_requests": len(ok),
            "total_new_tokens": total_new,
            "run_wall_s": wall,
            "idle_wall_s": self.idle_wall,
            "tokens_per_sec": total_new / max(wall, 1e-9),
            "decode_ticks": self.decode_ticks,
            "latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p99_s": float(np.percentile(lat, 99)),
            "ttft_p50_s": (float(np.percentile(ttft, 50)) if ttft.size
                           else 0.0),
            "ttft_p99_s": (float(np.percentile(ttft, 99)) if ttft.size
                           else 0.0),
            "queue_wait_p50_s": (float(np.percentile(wait, 50)) if wait.size
                                 else 0.0),
            "queue_wait_p99_s": (float(np.percentile(wait, 99)) if wait.size
                                 else 0.0),
            **counters,
        }
