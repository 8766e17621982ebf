"""RDP accountant for the Sampled Gaussian Mechanism (SGM).

Re-implementation (no Opacus available) of the Mironov–Talwar–Zhang (2019)
RDP analysis of the SGM, with the same math as TF-privacy / Opacus:

  * integer orders alpha: binomial expansion,
        A(alpha) = sum_k C(alpha,k) (1-q)^(alpha-k) q^k exp(k(k-1)/(2 sigma^2))
  * fractional orders: the two-sided series with erfc terms,
  * RDP(alpha) = log A(alpha) / (alpha - 1),
  * RDP -> (eps, delta) via the improved conversion
        eps = rdp + log((alpha-1)/alpha) - (log(delta) + log(alpha))/(alpha-1)
    minimized over orders.

The paper (§5.4, Prop. 2) composes the *training* SGM steps with the DPQuant
*analysis* SGM steps under one accountant; we expose that as labelled
``step(..., label=...)`` entries so the analysis fraction (Fig. 3) can be
reported.  The accountant history is a plain list of tuples -> trivially
checkpointable (``state_dict`` / ``from_state_dict``).

A copy of ``repro.dp.accountant``, which needs no JAX: the JAX package's
tests validate it against a direct numerical integration of the Renyi
divergence, and ``tests/test_torch_train.py`` holds the two copies to the
same epsilon.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

DEFAULT_ORDERS: Tuple[float, ...] = tuple(
    [1.25, 1.5, 1.75, 2.0, 2.25, 2.5, 3.0, 3.5, 4.0, 4.5]
    + list(range(5, 64))
    + [80.0, 96.0, 128.0, 192.0, 256.0, 384.0, 512.0]
)


# --------------------------------------------------------------------------- #
# log-space helpers
# --------------------------------------------------------------------------- #
def _log_add(a: float, b: float) -> float:
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    hi, lo = max(a, b), min(a, b)
    return hi + math.log1p(math.exp(lo - hi))


def _log_sub(a: float, b: float) -> float:
    """log(exp(a) - exp(b)); requires a >= b."""
    if b == -math.inf:
        return a
    if a == b:
        return -math.inf
    if a < b:
        raise ValueError("log_sub requires a >= b")
    return a + math.log1p(-math.exp(b - a))


def _log_erfc(x: float) -> float:
    """Numerically stable log(erfc(x))."""
    if x < 8.0:
        return math.log(math.erfc(x))
    # Asymptotic expansion for large x.
    return (-(x ** 2) - math.log(x) - 0.5 * math.log(math.pi)
            + math.log1p(-0.5 / (x ** 2) + 0.75 / (x ** 4)))


def _log_binom_next(alpha: float, i: int, sign: float,
                    logv: float) -> Tuple[float, float]:
    """(sign, log|binom(alpha, i)|) for real alpha, integer i >= 1, from
    those of ``binom(alpha, i - 1)``: the product's next factor, the same
    float operations in the same order as the product taken from k = 1."""
    if sign == 0.0:
        return 0.0, -math.inf
    term = (alpha - i + 1) / i
    if term == 0.0:
        return 0.0, -math.inf
    if term < 0:
        sign = -sign
    return sign, logv + math.log(abs(term))


# --------------------------------------------------------------------------- #
# RDP of a single SGM step
# --------------------------------------------------------------------------- #
def _compute_log_a_int(q: float, sigma: float, alpha: int) -> float:
    log_a = -math.inf
    for k in range(alpha + 1):
        log_coef = (math.lgamma(alpha + 1) - math.lgamma(k + 1)
                    - math.lgamma(alpha - k + 1))
        term = (log_coef + k * math.log(q) + (alpha - k) * math.log(1 - q)
                + (k * k - k) / (2 * sigma ** 2))
        log_a = _log_add(log_a, term)
    return log_a


def _compute_log_a_frac(q: float, sigma: float, alpha: float) -> float:
    log_a0, log_a1 = -math.inf, -math.inf
    z0 = sigma ** 2 * math.log(1.0 / q - 1.0) + 0.5
    i = 0
    sign, log_coef = 1.0, 0.0                  # binom(alpha, 0)
    while True:
        if i:
            sign, log_coef = _log_binom_next(alpha, i, sign, log_coef)
        j = alpha - i
        log_t0 = log_coef + i * math.log(q) + j * math.log(1 - q)
        log_t1 = log_coef + j * math.log(q) + i * math.log(1 - q)
        log_e0 = math.log(0.5) + _log_erfc((i - z0) / (math.sqrt(2) * sigma))
        log_e1 = math.log(0.5) + _log_erfc((z0 - j) / (math.sqrt(2) * sigma))
        log_s0 = log_t0 + (i * i - i) / (2 * sigma ** 2) + log_e0
        log_s1 = log_t1 + (j * j - j) / (2 * sigma ** 2) + log_e1
        if sign > 0:
            log_a0 = _log_add(log_a0, log_s0)
            log_a1 = _log_add(log_a1, log_s1)
        elif sign < 0:
            log_a0 = _log_sub(log_a0, log_s0)
            log_a1 = _log_sub(log_a1, log_s1)
        i += 1
        if max(log_s0, log_s1) < -30 and i > alpha:
            break
        if i > 10_000:   # safety valve
            break
    return _log_add(log_a0, log_a1)


def compute_rdp_sgm(q: float, noise_multiplier: float, alpha: float) -> float:
    """RDP (in nats) of one SGM step at order ``alpha``."""
    sigma = noise_multiplier
    if q == 0.0 or sigma == math.inf:
        return 0.0
    if sigma == 0.0:
        return math.inf
    if q == 1.0:
        # plain Gaussian mechanism
        return alpha / (2 * sigma ** 2)
    if float(alpha).is_integer():
        log_a = _compute_log_a_int(q, sigma, int(alpha))
    else:
        log_a = _compute_log_a_frac(q, sigma, alpha)
    return log_a / (alpha - 1)


def rdp_to_eps(rdp: Sequence[float], orders: Sequence[float],
               delta: float) -> Tuple[float, float]:
    """Improved RDP->(eps, delta) conversion; returns (eps, optimal order)."""
    best_eps, best_order = math.inf, orders[0]
    for r, a in zip(rdp, orders):
        if a <= 1 or math.isinf(r):
            continue
        eps = r + math.log1p(-1.0 / a) - (math.log(delta) + math.log(a)) / (a - 1)
        if eps < best_eps:
            best_eps, best_order = eps, a
    return max(best_eps, 0.0), best_order


# --------------------------------------------------------------------------- #
# Accountant
# --------------------------------------------------------------------------- #
# One SGM step's RDP at every order, by (sigma, q, orders): a pure
# function of its key, shared by every accountant of the process (a
# restored trainer's, a probe run's), so each is computed once.
_RDP_CACHE: Dict[Tuple[float, float, Tuple[float, ...]],
                 Tuple[float, ...]] = {}

@dataclasses.dataclass
class SGMEvent:
    noise_multiplier: float
    sample_rate: float
    steps: int
    label: str = "train"


class RDPAccountant:
    """Composes SGM steps (training + DPQuant analysis) under RDP."""

    def __init__(self, orders: Sequence[float] = DEFAULT_ORDERS):
        self.orders = tuple(orders)
        self.history: List[SGMEvent] = []

    # -- recording -------------------------------------------------------- #
    def step(self, *, noise_multiplier: float, sample_rate: float,
             steps: int = 1, label: str = "train") -> None:
        """Record ``steps`` SGM steps in one call.

        RDP composition is additive across steps, so charging an epoch in
        one ``steps=steps_per_epoch`` call (as the scanned epoch executor
        does) is mathematically identical to — and, with event merging
        below, produces the same history as — ``steps`` single-step calls.
        """
        if not (0.0 <= sample_rate <= 1.0):
            raise ValueError(f"sample_rate must be in [0,1], got {sample_rate}")
        if noise_multiplier < 0:
            raise ValueError("noise_multiplier must be >= 0")
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        if self.history and self.history[-1].noise_multiplier == noise_multiplier \
                and self.history[-1].sample_rate == sample_rate \
                and self.history[-1].label == label:
            self.history[-1].steps += steps
        else:
            self.history.append(SGMEvent(noise_multiplier, sample_rate, steps, label))

    # -- querying --------------------------------------------------------- #
    def total_steps(self, label: Optional[str] = None) -> int:
        """Total recorded SGM steps (optionally for one label)."""
        return sum(ev.steps for ev in self.history
                   if label is None or ev.label == label)

    def _rdp_single(self, sigma: float, q: float) -> Tuple[float, ...]:
        key = (sigma, q, self.orders)
        if key not in _RDP_CACHE:
            _RDP_CACHE[key] = tuple(
                compute_rdp_sgm(q, sigma, a) for a in self.orders)
        return _RDP_CACHE[key]

    def total_rdp(self, labels: Optional[Sequence[str]] = None) -> List[float]:
        total = [0.0] * len(self.orders)
        for ev in self.history:
            if labels is not None and ev.label not in labels:
                continue
            per = self._rdp_single(ev.noise_multiplier, ev.sample_rate)
            for i in range(len(total)):
                total[i] += ev.steps * per[i]
        return total

    def get_epsilon(self, delta: float,
                    labels: Optional[Sequence[str]] = None) -> Tuple[float, float]:
        return rdp_to_eps(self.total_rdp(labels), self.orders, delta)

    def analysis_fraction(self, delta: float) -> float:
        """Fraction of the spent budget attributable to DPQuant analysis
        (paper Fig. 3b), measured in RDP at the overall-optimal order."""
        total_rdp = self.total_rdp()
        _, order = rdp_to_eps(total_rdp, self.orders, delta)
        idx = self.orders.index(order)
        analysis = self.total_rdp(labels=("analysis",))[idx]
        return analysis / total_rdp[idx] if total_rdp[idx] > 0 else 0.0

    # -- checkpointing ---------------------------------------------------- #
    def state_dict(self) -> dict:
        return {"orders": list(self.orders),
                "history": [dataclasses.asdict(e) for e in self.history]}

    @classmethod
    def from_state_dict(cls, state: dict) -> "RDPAccountant":
        acc = cls(orders=tuple(state["orders"]))
        acc.history = [SGMEvent(**e) for e in state["history"]]
        return acc
