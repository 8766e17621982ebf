"""DPQuant core — the paper's primary contribution.

The counterpart of ``repro.core``: policies (per-layer quantization flag
sets), Algorithm 1 (COMPUTELOSSIMPACT, the DP loss-sensitivity
estimator), Algorithm 2 (SELECTTARGETS, softmax sampling without
replacement), and the epoch scheduler tying them together.
"""
from repro_torch.core.loss_impact import compute_loss_impact
from repro_torch.core.policy import (QuantPolicy, empty_policy, full_policy,
                                     random_policy, singleton_policies,
                                     union_policy)
from repro_torch.core.scheduler import DPQuantScheduler
from repro_torch.core.selection import (sample_without_replacement,
                                        select_targets, selection_probs)

__all__ = [
    "compute_loss_impact", "QuantPolicy", "empty_policy", "full_policy",
    "random_policy", "singleton_policies", "union_policy",
    "DPQuantScheduler", "sample_without_replacement", "select_targets",
    "selection_probs",
]
