"""Algorithm 2 — SELECTTARGETS (paper A.15).

Given EMA'd loss-impact scores L[p] for each candidate policy:
  1. min-max normalize v = (L - min) / (max - min)
  2. pi = softmax(-beta * v)
  3. sample m policies WITHOUT replacement from pi (multinomial)
  4. return the union of their layer sets.

beta -> 0 recovers pure probabilistic layer sampling (PLS);
beta -> inf recovers deterministic lowest-impact-first selection.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from repro_torch.core.policy import QuantPolicy, union_policy


def selection_probs(scores: np.ndarray, beta: float) -> np.ndarray:
    scores = np.asarray(scores, np.float64)
    lo, hi = scores.min(), scores.max()
    v = np.zeros_like(scores) if hi - lo < 1e-12 else (scores - lo) / (hi - lo)
    z = -beta * v
    z -= z.max()
    p = np.exp(z)
    return p / p.sum()


def sample_without_replacement(probs: np.ndarray, m: int,
                               rng: np.random.RandomState) -> List[int]:
    """Sequential multinomial sampling without replacement."""
    probs = probs.astype(np.float64).copy()
    chosen: List[int] = []
    m = min(m, (probs > 0).sum() if (probs > 0).any() else 0)
    for _ in range(m):
        p = probs / probs.sum()
        idx = rng.choice(len(p), p=p)
        chosen.append(int(idx))
        probs[idx] = 0.0
    return chosen


def select_targets(scores: np.ndarray, policies: Sequence[QuantPolicy],
                   beta: float, m: int, rng: np.random.RandomState,
                   n_layers: int) -> QuantPolicy:
    """Full Algorithm 2: returns the union policy of the m sampled policies."""
    probs = selection_probs(scores, beta)
    idx = sample_without_replacement(probs, m, rng)
    return union_policy([policies[i] for i in idx], n_layers)
