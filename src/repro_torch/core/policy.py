"""Quantization policies (paper §5.2).

The counterpart of ``repro.core.policy``.  A *policy* is a set of layers
to run quantized.  DPQuant's estimator scores candidate policies;
Algorithm 2 samples ``m`` of them and quantizes the union of their layers.
The default candidate set is one singleton policy per layer (so the score
of policy i estimates layer i's loss sensitivity R(l_i)).

Policies materialize as a host-side tuple of bools, one per layer
(``flags()``: logging, checkpoints).  The trainer copies them into its
(policy_len,) float32 flags tensor on the device, which the quantizers
read there, as the JAX package's traced flags under ``lax.cond``: one
CUDA graph of the train step serves every policy.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """An immutable set of layer indices to quantize."""
    layers: Tuple[int, ...]
    n_layers: int

    def flags(self) -> Tuple[bool, ...]:
        chosen = set(self.layers)
        return tuple(i in chosen for i in range(self.n_layers))

    def __len__(self):
        return len(self.layers)


def full_policy(n_layers: int) -> QuantPolicy:
    return QuantPolicy(tuple(range(n_layers)), n_layers)


def empty_policy(n_layers: int) -> QuantPolicy:
    return QuantPolicy((), n_layers)


def singleton_policies(n_layers: int, group_size: int = 1) -> List[QuantPolicy]:
    """Candidate policy set P: one policy per layer (or per group)."""
    out = []
    for start in range(0, n_layers, group_size):
        layers = tuple(range(start, min(start + group_size, n_layers)))
        out.append(QuantPolicy(layers, n_layers))
    return out


def union_policy(policies: Sequence[QuantPolicy], n_layers: int) -> QuantPolicy:
    layers = sorted({l for p in policies for l in p.layers})
    return QuantPolicy(tuple(layers), n_layers)


def random_policy(n_layers: int, k: int, rng: np.random.RandomState) -> QuantPolicy:
    """A uniformly random k-subset — the paper's static random baseline."""
    layers = tuple(sorted(rng.choice(n_layers, size=k, replace=False).tolist()))
    return QuantPolicy(layers, n_layers)
