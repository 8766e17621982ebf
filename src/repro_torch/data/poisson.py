"""Poisson subsampling — the sampling assumption of the SGM analysis.

DP-SGD's privacy analysis (and the paper's Prop. 2) assumes each example is
included independently with probability q = B/N per step.  ``PoissonSampler``
implements that exactly; the realized batch size therefore varies around B
(we pad/trim to a fixed physical batch for jit shape stability and track the
*expected* rate in the accountant — the standard practical compromise, same
as Opacus' default).
"""
from __future__ import annotations

import numpy as np


class PoissonSampler:
    def __init__(self, dataset_size: int, batch_size: int, seed: int = 0):
        self.n = dataset_size
        self.batch_size = batch_size
        self.q = batch_size / dataset_size
        self._rng = np.random.RandomState(seed)

    def sample(self) -> np.ndarray:
        """Poisson-subsampled indices, padded/trimmed to ``batch_size``."""
        mask = self._rng.rand(self.n) < self.q
        idx = np.nonzero(mask)[0]
        if len(idx) >= self.batch_size:
            idx = idx[: self.batch_size]
        else:
            pad = self._rng.randint(0, self.n, self.batch_size - len(idx))
            idx = np.concatenate([idx, pad])
        return idx

    def sample_epoch(self, steps: int) -> np.ndarray:
        """Pre-draw ``steps`` batches as a ``(steps, batch_size)`` array.

        Consumes the RNG stream exactly as ``steps`` successive ``sample()``
        calls would, so the scanned epoch executor sees bit-identical batch
        indices to the legacy per-step loop (and checkpointed sampler state
        stays interchangeable between the two executors).
        """
        return np.stack([self.sample() for _ in range(steps)])

    def state_dict(self) -> dict:
        return {"rng_state": self._rng.get_state()}

    def load_state_dict(self, state: dict) -> None:
        self._rng.set_state(state["rng_state"])
