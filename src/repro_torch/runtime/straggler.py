"""Straggler detection: per-host step-time EWMA + deviation policy.

The counterpart of ``repro.runtime.straggler``, copied whole (the
standard library only); the serving supervisor
(``repro_torch.runtime.supervisor``) drives it.

A host is flagged when its step-time EWMA exceeds ``mu + k*sigma`` of the
fleet for ``patience`` consecutive windows; flagged hosts are reported for
eviction (the elastic planner then re-meshes without them).  DP noise is
key-derived, so recomputing a flagged host's shard elsewhere is
bit-identical — eviction never perturbs the privacy accounting.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List


@dataclasses.dataclass
class HostStats:
    ewma: float = 0.0
    n: int = 0
    strikes: int = 0


class StragglerDetector:
    def __init__(self, alpha: float = 0.2, k_sigma: float = 3.0,
                 patience: int = 3):
        self.alpha = alpha
        self.k_sigma = k_sigma
        self.patience = patience
        self.hosts: Dict[int, HostStats] = {}

    def record(self, host_id: int, step_time_s: float) -> None:
        st = self.hosts.setdefault(host_id, HostStats())
        st.ewma = (step_time_s if st.n == 0
                   else (1 - self.alpha) * st.ewma + self.alpha * step_time_s)
        st.n += 1

    def _fleet_stats(self):
        vals = [s.ewma for s in self.hosts.values() if s.n > 0]
        if len(vals) < 2:
            return None, None
        mu = sum(vals) / len(vals)
        var = sum((v - mu) ** 2 for v in vals) / (len(vals) - 1)
        return mu, math.sqrt(var)

    def update_strikes(self) -> None:
        mu, sigma = self._fleet_stats()
        if mu is None:
            return
        thresh = mu + self.k_sigma * max(sigma, 1e-9) + 1e-12
        for st in self.hosts.values():
            if st.ewma > thresh:
                st.strikes += 1
            else:
                st.strikes = 0

    def stragglers(self) -> List[int]:
        return sorted(h for h, s in self.hosts.items()
                      if s.strikes >= self.patience)
