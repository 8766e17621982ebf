"""Trainer: the DPQuant training loop (paper Fig. 2 pipeline).

The counterpart of ``repro.train_loop`` with its ``loop`` executor, the
only one ported.  Per epoch:

  1. (every ``analysis_interval`` epochs) COMPUTELOSSIMPACT on sampled
     probe batches — charges one "analysis" SGM step;
  2. SELECTTARGETS -> this epoch's quantized-layer flags (host-side bools,
     fixed for the epoch);
  3. ``steps_per_epoch`` DP-SGD/DP-Adam steps on Poisson-sampled batches
     (images or token sequences), one step per Python iteration: one host
     sync (the step's loss) and one accountant charge per step;
  4. optional eval (the ResNet family; a dense LM has no eval set).

The sampler, probe draws, per-step seeds and learning rates come from
``RunConfig.seed`` exactly as in the JAX package, so a fixed seed sees the
same batches in both.  Not ported yet: the ``scan`` executor (one compiled
epoch; here it would be one CUDA-graph-captured epoch), checkpointing and
preemption.

Also supports mode="pls" / mode="static" (ablations / baselines) and
dp.enabled=False (the non-private comparison in paper Fig. 1a).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.config import RunConfig
from repro_torch.core.scheduler import DPQuantScheduler
from repro_torch.data.poisson import PoissonSampler
from repro_torch.dp.accountant import RDPAccountant
from repro_torch.launch.steps import build_train_setup
from repro_torch.models.registry import Model, build_model
from repro_torch.optim.schedule import make_schedule
from repro_torch.quant.backend import resolve_backend


@dataclasses.dataclass
class EpochStats:
    epoch: int
    loss: float
    eps: float
    analysis_eps_fraction: float
    quantized_layers: int
    accuracy: Optional[float] = None
    wall_s: float = 0.0


class Trainer:
    def __init__(self, run: RunConfig, dataset, *, mode: str = "dpquant",
                 eval_dataset=None, device=None):
        resolve_backend(run.quant.backend)       # fail fast on a typo
        self.run = run
        self.dataset = dataset
        self.eval_dataset = eval_dataset
        self.mode = mode
        self.model: Model = build_model(run.model, run.quant, device=device)
        self.device = self.model.device
        self.setup = build_train_setup(self.model, run)
        self.step_fn = self.setup.step_fn
        self.schedule = make_schedule(run.optim, run.steps)
        self.sampler = PoissonSampler(dataset.n, run.global_batch,
                                      seed=run.seed)
        self._probe_rng = np.random.RandomState(run.seed + 777)
        self.accountant = RDPAccountant()
        self.scheduler = DPQuantScheduler(
            n_layers=run.model.policy_len(), dp=run.dp, mode=mode,
            seed=run.seed)
        self.params = self.model.init(run.seed)
        self.opt_state = self.setup.opt_init_fn(self.params)
        self.step = 0
        self.history: List[EpochStats] = []
        # wall seconds of the last analysis (Algorithm 1), 0 if none ran,
        # and of every train step (batch draw, step, the loss read that
        # synchronizes with the device)
        self.last_analysis_s = 0.0
        self.step_wall_s: List[float] = []

    # ------------------------------------------------------------------ #
    def _to_device(self, batch: dict) -> dict:
        return {k: v.to(self.device) for k, v in batch.items()}

    def _probe_step(self, params, opt_state, batch, seed, flags):
        return self.step_fn(params, opt_state, batch, seed, flags,
                            self.schedule(self.step))

    def _sample_batch(self) -> dict:
        return self._to_device(self.dataset.get(self.sampler.sample()))

    # ------------------------------------------------------------------ #
    def train_epoch(self, epoch: int) -> EpochStats:
        t0 = time.time()
        run = self.run
        # ---- Algorithm 1 (analysis) ----
        self.last_analysis_s = 0.0
        if self.mode == "dpquant":
            nb = min(run.dp.analysis_batch_size, run.global_batch)
            nb = max(run.dp.microbatch_size, nb)
            probe_batches = [self._to_device(self.dataset.get(
                self._probe_rng.randint(0, self.dataset.n, nb)))
                for _ in range(run.dp.analysis_reps)]
            ta = time.perf_counter()
            ran = self.scheduler.maybe_analyze(
                probe_step=self._probe_step, params=self.params,
                opt_state=self.opt_state, batches=probe_batches,
                sample_rate=min(1.0, nb / self.dataset.n),
                accountant=self.accountant,
                epoch=epoch, seed=run.seed * 1000 + epoch,
                device=self.device)
            if ran:
                self.last_analysis_s = time.perf_counter() - ta
        # ---- Algorithm 2 (selection) ----
        policy = self.scheduler.select(epoch)
        flags = policy.flags()

        # ---- DP-SGD steps ----
        losses = self._train_steps_loop(flags)

        eps, _ = (self.accountant.get_epsilon(run.dp.delta)
                  if run.dp.enabled else (0.0, 0))
        frac = (self.accountant.analysis_fraction(run.dp.delta)
                if run.dp.enabled and self.mode == "dpquant" else 0.0)
        acc = self.evaluate() if self.eval_dataset is not None else None
        stats = EpochStats(epoch=epoch, loss=float(np.mean(losses)),
                           eps=eps, analysis_eps_fraction=frac,
                           quantized_layers=len(policy), accuracy=acc,
                           wall_s=time.time() - t0)
        self.history.append(stats)
        return stats

    def _train_steps_loop(self, flags) -> List[float]:
        """One step, one host sync and one accountant charge per
        iteration."""
        run = self.run
        losses = []
        for _ in range(run.steps_per_epoch):
            t0 = time.perf_counter()
            batch = self._sample_batch()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch, self.step + run.seed,
                flags, self.schedule(self.step))
            losses.append(float(metrics["loss"]))
            self.step_wall_s.append(time.perf_counter() - t0)
            if run.dp.enabled:
                self.accountant.step(
                    noise_multiplier=run.dp.noise_multiplier,
                    sample_rate=self.sampler.q, steps=1, label="train")
            self.step += 1
        return losses

    def train(self, epochs: int, *, eps_budget: Optional[float] = None,
              verbose: bool = False) -> List[EpochStats]:
        start = len(self.history)
        for e in range(start, start + epochs):
            stats = self.train_epoch(e)
            if verbose:
                print(f"epoch {e}: loss={stats.loss:.4f} eps={stats.eps:.3f} "
                      f"k={stats.quantized_layers} acc={stats.accuracy}",
                      flush=True)
            if eps_budget is not None and stats.eps >= eps_budget:
                break  # paper: truncate training at the privacy budget
        return self.history

    # ------------------------------------------------------------------ #
    def evaluate(self, n: int = 512) -> float:
        idx = np.arange(min(n, self.eval_dataset.n))
        batch = self._to_device(self.eval_dataset.get(idx))
        flags = (False,) * self.run.model.policy_len()
        preds = self._predict(batch, flags)
        return float((preds == batch["label"].cpu().numpy()).mean())

    def _predict(self, batch, flags) -> np.ndarray:
        if self.run.model.family != "resnet":
            raise ValueError(f"no predict for family {self.run.model.family}")
        with torch.no_grad():
            logits = self.model.forward(self.params, batch["image"], flags)
        return logits.argmax(-1).cpu().numpy()
