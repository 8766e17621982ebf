"""Serving: continuous batching over a slot-pool KV cache.

* ``ContinuousEngine`` / ``Request`` / ``RequestResult`` — the scheduler
  (``repro_torch.serve.engine``),
* ``SlotPool`` — slot bookkeeping (``repro_torch.serve.slots``),
* ``ServeMetrics`` — throughput/latency accounting
  (``repro_torch.serve.metrics``),
* ``oneshot_generate`` / ``build_oneshot_fns`` — the lockstep reference
  driver (``repro_torch.serve.oneshot``).
"""
from repro_torch.serve.engine import (ContinuousEngine, Request, RequestResult,
                                      SAMPLE_FOLD, prefill_bucket,
                                      sampling_seed)
from repro_torch.serve.metrics import RequestTiming, ServeMetrics
from repro_torch.serve.oneshot import build_oneshot_fns, oneshot_generate
from repro_torch.serve.slots import SlotPool, SlotState, init_slot_cache

__all__ = [
    "ContinuousEngine", "Request", "RequestResult", "SAMPLE_FOLD",
    "prefill_bucket", "sampling_seed", "RequestTiming", "ServeMetrics",
    "build_oneshot_fns", "oneshot_generate", "SlotPool", "SlotState",
    "init_slot_cache",
]
