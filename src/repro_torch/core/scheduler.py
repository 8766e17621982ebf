"""DPQuantScheduler — the paper's full mechanism, orchestrated (the
counterpart of ``repro.core.scheduler``).

Per epoch e:
  * if e % analysis_interval == 0: run COMPUTELOSSIMPACT (Algorithm 1) on a
    Poisson-sampled batch -> update EMA scores, charge one "analysis" SGM
    step to the accountant;
  * SELECTTARGETS (Algorithm 2): sample m policies from softmax(-beta *
    normalized EMA) without replacement, quantize the union of their layers,
    sized to the compute budget (quant_fraction * n_layers).

Modes:
  * mode="dpquant"   PLS + LLP (the full method)
  * mode="pls"       probabilistic layer sampling only (uniform scores)
  * mode="static"    a fixed random subset chosen once (the paper's baseline)

State (EMA scores, RNG, current policy) is checkpointable.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config import DPConfig
from repro_torch.core import selection
from repro_torch.core.loss_impact import compute_loss_impact
from repro_torch.core.policy import (QuantPolicy, empty_policy, random_policy,
                                     singleton_policies, union_policy)
from repro_torch.dp.accountant import RDPAccountant


@dataclasses.dataclass
class DPQuantScheduler:
    n_layers: int
    dp: DPConfig
    mode: str = "dpquant"                 # dpquant | pls | static
    group_size: int = 1
    seed: int = 0

    def __post_init__(self):
        self.policies = singleton_policies(self.n_layers, self.group_size)
        self.scores = np.zeros((len(self.policies),), np.float64)
        self._rng = np.random.RandomState(self.seed)
        self._static: Optional[QuantPolicy] = None
        self.current: QuantPolicy = empty_policy(self.n_layers)
        self.n_analyses = 0

    # ------------------------------------------------------------------ #
    @property
    def k_quantized(self) -> int:
        return int(round(self.dp.quant_fraction * self.n_layers))

    def _m_policies(self) -> int:
        """#policies to sample so the union covers ~k layers."""
        per = max(1, self.group_size)
        return max(1, int(round(self.k_quantized / per)))

    # ------------------------------------------------------------------ #
    def maybe_analyze(self, *, probe_step: Callable, params, opt_state,
                      batches: Sequence[dict], sample_rate: float,
                      accountant: Optional[RDPAccountant],
                      epoch: int, seed: int, device="cpu") -> bool:
        """Run Algorithm 1 if due this epoch. Returns True if it ran."""
        if self.mode != "dpquant":
            return False
        if epoch % max(self.dp.analysis_interval, 1) != 0:
            return False
        self.scores = compute_loss_impact(
            probe_step=probe_step, params=params, opt_state=opt_state,
            policies=self.policies, batches=batches,
            reps=self.dp.analysis_reps, seed=seed,
            measure_clip=self.dp.analysis_clip,
            measure_noise=self.dp.analysis_noise,
            sample_rate=sample_rate, accountant=accountant,
            ema_scores=self.scores if self.n_analyses else None,
            ema_alpha=self.dp.ema_alpha, device=device)
        self.n_analyses += 1
        return True

    def select(self, epoch: int) -> QuantPolicy:
        """Pick this epoch's policy (Algorithm 2 / PLS / static)."""
        k = self.k_quantized
        if self.mode == "static":
            if self._static is None:
                self._static = random_policy(self.n_layers, k, self._rng)
            self.current = self._static
        elif self.mode == "pls":
            # uniform scores -> pure rotation
            probs = np.full((len(self.policies),), 1.0 / len(self.policies))
            idx = selection.sample_without_replacement(
                probs, self._m_policies(), self._rng)
            self.current = union_policy([self.policies[i] for i in idx],
                                        self.n_layers)
        else:
            self.current = selection.select_targets(
                self.scores, self.policies, self.dp.beta,
                self._m_policies(), self._rng, self.n_layers)
        return self.current

    def flags(self) -> Tuple[bool, ...]:
        return self.current.flags()

    # ------------------------------------------------------------------ #
    def state_dict(self) -> dict:
        return {
            "scores": self.scores.tolist(),
            "rng_state": self._rng.get_state(),
            "current_layers": list(self.current.layers),
            "static_layers": (list(self._static.layers)
                              if self._static else None),
            "n_analyses": self.n_analyses,
        }

    def load_state_dict(self, state: dict) -> None:
        self.scores = np.asarray(state["scores"], np.float64)
        self._rng.set_state(state["rng_state"])
        self.current = QuantPolicy(tuple(state["current_layers"]),
                                   self.n_layers)
        if state.get("static_layers") is not None:
            self._static = QuantPolicy(tuple(state["static_layers"]),
                                       self.n_layers)
        self.n_analyses = int(state["n_analyses"])
