"""Algorithm 1 — COMPUTELOSSIMPACT (paper §5.2–5.4).

The counterpart of ``repro.core.loss_impact``.  For each candidate policy
p (and the no-quantization baseline p0): restore the model snapshot, run R
DP-SGD iterations on the sampled batches under policy p, record the
average loss.  The loss-difference vector R[p] = avg_loss[p] -
avg_loss[p0] is then *privatized* as a Sampled Gaussian Mechanism:
clipped to l2 norm C_measure, Gaussian noise N(0, sigma^2 C^2) added
(step 3), and folded into an EMA of per-policy scores (step 4 —
post-processing, no extra privacy cost).

Privacy accounting (Prop. 2): one SGM step at rate q = |B| / |D| and
noise scale sigma_measure per invocation, charged to the same RDP
accountant as training, labelled "analysis".

RESTOREMODEL: a policy's probe run starts from ``params`` /
``opt_state`` and writes neither (the trainer's probe graph copies them
into static buffers of its own first), so every policy starts from the
same snapshot and the probes never touch the live model.

The policies' flags go to the device in one copy (a (P + 1, L) float32
table, one row a run); each run's R losses stay on the device, and all of
them are read back once per analysis.  The averages, the privatization,
the accountant charge and the EMA are taken on the host in float64, in
the order the reference takes them.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.policy import QuantPolicy
from repro_torch.dp.accountant import RDPAccountant

# Offset of the probe noise's generator seed from the analysis seed (the
# JAX package's PRNGKey(seed + 10_007)).
PROBE_NOISE_OFFSET = 10_007


def compute_loss_impact(
    *,
    probe_step: Callable,       # (params, opt_state, batches, seeds, flags)
                                #   -> (R,) losses on the device
    params,
    opt_state,
    policies: Sequence[QuantPolicy],
    batches: Sequence[dict],    # |R| sampled batches (reused across policies)
    reps: int,
    seed: int,
    measure_clip: float,
    measure_noise: float,
    sample_rate: float,
    accountant: Optional[RDPAccountant],
    ema_scores: Optional[np.ndarray],
    ema_alpha: float,
    baseline_flags=None,
    device="cpu",
) -> np.ndarray:
    """Returns updated EMA scores (one per policy).  Host-side
    orchestration; ``probe_step`` runs a policy's R train steps from the
    snapshot, step r on ``batches[r]`` at seed ``seed + r``, under the
    policy's row of the device flags table.  The privatizing noise comes
    from a generator on ``device`` seeded ``seed + 10_007``."""
    n_layers = policies[0].n_layers
    p0_flags = (baseline_flags if baseline_flags is not None
                else (False,) * n_layers)
    n = min(reps, len(batches))
    stacked = {k: torch.stack([b[k] for b in batches[:n]])
               for k in batches[0]}
    seeds = [seed + r for r in range(n)]
    table = torch.tensor([p0_flags] + [pol.flags() for pol in policies],
                         dtype=torch.float32).to(device)
    losses = torch.stack([probe_step(params, opt_state, stacked, seeds,
                                     table[i]) for i in range(len(table))])
    runs = losses.tolist()               # the analysis's one host read

    def avg_loss(row) -> float:
        total = 0.0
        for loss in row:
            total += loss
        return total / max(n, 1)

    base = avg_loss(runs[0])
    diffs = np.array([avg_loss(row) - base for row in runs[1:]], np.float64)

    # ---- step 3: privatize (clip to C, add N(0, sigma^2 C^2)) ----
    norm = float(np.linalg.norm(diffs))
    clipped = diffs * min(1.0, measure_clip / max(norm, 1e-12))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + PROBE_NOISE_OFFSET)
    noise = torch.randn(len(policies), generator=gen, device=device,
                        dtype=torch.float32).cpu().numpy().astype(np.float64)
    privatized = clipped + measure_noise * measure_clip * noise

    # ---- privacy accounting: one SGM step ----
    if accountant is not None:
        accountant.step(noise_multiplier=measure_noise,
                        sample_rate=sample_rate, steps=1, label="analysis")

    # ---- step 4: EMA update (post-processing) ----
    if ema_scores is None:
        return privatized.astype(np.float64)
    return (1.0 - ema_alpha) * np.asarray(ema_scores) + ema_alpha * privatized
