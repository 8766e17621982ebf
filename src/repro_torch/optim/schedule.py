"""Learning-rate schedules (host-side floats; the counterpart of
``repro.optim.schedule``)."""
from __future__ import annotations

import math

from repro_torch.config import OptimConfig


def make_schedule(cfg: OptimConfig, total_steps: int):
    base = cfg.lr
    warm = max(cfg.warmup_steps, 0)

    def sched(step: int) -> float:
        lr = base
        if warm > 0:
            lr = lr * min(1.0, (step + 1) / warm)
        frac = min(max((step - warm) / max(total_steps - warm, 1), 0.0), 1.0)
        if cfg.schedule == "cosine":
            lr = lr * 0.5 * (1 + math.cos(math.pi * frac))
        elif cfg.schedule == "linear":
            lr = lr * (1 - frac)
        return lr

    return sched
