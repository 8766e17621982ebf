"""Trainer: the DPQuant training loop (paper Fig. 2 pipeline).

The counterpart of ``repro.train_loop``.  Per epoch:

  1. (every ``analysis_interval`` epochs) COMPUTELOSSIMPACT on sampled
     probe batches — charges one "analysis" SGM step; each probe step is
     the train step at the probe batch, as the reference's jitted step:
     under ``scan`` replays of one CUDA graph (``probe_fn``, an
     ``EpochRunner`` with static params of its own, into which each
     policy's run first copies the snapshot), under ``loop`` eager steps;
  2. SELECTTARGETS -> this epoch's quantized-layer flags, copied into the
     trainer's (policy_len,) float32 flags tensor ``qflags`` on the device
     (one copy an epoch), which the quantizers read on the device;
  3. ``steps_per_epoch`` DP-SGD/DP-Adam steps on Poisson-sampled batches
     (images, token sequences, labelled token sequences, or token
     sequences with the encoder's frame embeddings, cast to the compute
     dtype on the device);
  4. optional eval (the classification families: ResNet, DenseNet and
     BERT; an LM has no eval set), and a checkpoint when a directory is given (params,
     optimizer state, accountant, scheduler, sampler and probe RNG).

Two epoch executors (``RunConfig.epoch_executor``), as in the reference:

  * ``"scan"`` (default) — the epoch's batches are drawn with
    ``PoissonSampler.sample_epoch``, stacked and copied to the device in
    one copy, and the steps run as replays of one CUDA graph of the train
    step (``launch.steps.EpochRunner``; on the CPU the same staging and
    static buffers with the step called directly), captured once for
    every policy of the run; the probe graph shares its memory pool (the
    two never run at once, and neither reads what the other's capture
    allocated: each reads its own static buffers and keeps its outputs),
    and where the probe batch has the train batch's shape (the LMs) the
    second capture skips its eager warm-up step, whose temporaries would
    need memory beside the pool.  The host reads the
    chunk's metrics once per chunk (``epoch_chunk`` steps, 0 = the whole
    epoch) and charges the accountant once per chunk with ``steps=k``.
  * ``"loop"`` — one eager step, one host sync (the step's loss) and one
    accountant charge per step.

Both draw the same sample indices, per-step seeds (the DP noise
generator is re-seeded to ``NOISE_SEED_OFFSET + step + seed`` before each
step) and learning rates (a 0-dim device tensor each step), and the
accountant merges consecutive identical SGM events, so they give the
same params, optimizer state and epsilon on a fixed seed.  The sampler,
probe draws, per-step seeds and learning rates come from
``RunConfig.seed`` exactly as in the JAX package, so a fixed seed sees
the same batches in both.  Not ported yet: ``epoch_unroll > 1``.

Preemption (``preemption``, a ``runtime.preemption.PreemptionHandler``)
is polled after every loop step and every scan chunk, after the host read
and the accountant charge; when it fires, a mid-epoch checkpoint is
written and :class:`~repro_torch.runtime.preemption.Preempted` raised.
``restore_latest`` then resumes bit for bit: nothing else needs saving,
since the DP noise generator is re-seeded from the step seed before every
step or replay and the quantizer's Philox keys ``(seed, 0x4C550000 +
fold)`` do not change from step to step.

Data parallel (``mesh``, a ``repro_torch.launch.mesh.CompatMesh`` over
the ranks of ``torch.distributed``): every rank runs this loop with the
same seed, so it draws the same global Poisson batches, probe batches,
step seeds and learning rates, and charges its accountant the same; the
step (``launch.steps.build_train_setup`` on the mesh) computes each
rank's share of the batch and reduces the clipped sums, and the DPQuant
probes run through that same step, so every rank sees the same losses
and picks the same policies.  At the end of each epoch one all-reduce of
a max and a min of the params' and the policy's fingerprints checks that
the ranks agree, and raises if they do not.  A preemption poll is one
MAX all-reduce of the ranks' requests, so a request on any rank stops
every rank at the same step.  Only rank 0 prints and writes checkpoints
(the others wait at a barrier); every rank restores.

On a mesh whose ``model`` axis has degree > 1 each rank holds its blocks
of the params and optimizer state (``TrainSetup.shard``), the replica
check compares them over the data axes only (the ranks that hold the
same blocks), and a checkpoint holds the whole tree, as the
reference's does: every rank gathers it (``TrainSetup.unshard``) and
rank 0 writes it; a restore, on any mesh, takes this rank's blocks of
it.

Also supports mode="pls" / mode="static" (ablations / baselines) and
dp.enabled=False (the non-private comparison in paper Fig. 1a).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import RunConfig, validate_executor
from repro_torch.core.scheduler import DPQuantScheduler
from repro_torch.data.poisson import PoissonSampler
from repro_torch.dp.accountant import RDPAccountant
from repro_torch.launch.mesh import DATA_AXES
from repro_torch.launch.steps import EpochRunner, build_train_setup
from repro_torch.models.registry import Model, build_model
from repro_torch.optim.schedule import make_schedule
from repro_torch.parallel.collectives import replicas_agree
from repro_torch.quant.backend import resolve_backend
from repro_torch.runtime.preemption import Preempted, PreemptionHandler


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
                 eval_dataset=None, device=None, checkpoint_dir=None,
                 preemption: Optional[PreemptionHandler] = None, mesh=None):
        resolve_backend(run.quant.backend)       # fail fast on a typo
        validate_executor(run)
        self.run = run
        self.dataset = dataset
        self.eval_dataset = eval_dataset
        self.mode = mode
        self.model: Model = build_model(run.model, run.quant, device=device)
        self.device = self.model.device
        self.mesh = mesh
        # the group of every rank, None without one (module docstring)
        world = (mesh.axis_group(mesh.axis_names)
                 if mesh is not None else None)
        self._world = (world if world is not None and world.group is not None
                       else None)
        # the ranks that hold the same blocks of the params: the data axes
        replicas = (mesh.axis_group(tuple(a for a in DATA_AXES
                                          if a in mesh.axis_names))
                    if mesh is not None else None)
        self._replicas = (replicas if replicas is not None
                          and replicas.group is not None else None)
        self.rank = 0 if mesh is None else mesh.rank
        self.setup = build_train_setup(self.model, run, mesh)
        self.step_fn = self.setup.step_fn
        spec = (self.model.batch_spec(1, 1)
                if self.model.batch_spec is not None else {})
        self._input_dtypes = {name: dtype for name, (_, dtype) in spec.items()
                              if dtype.is_floating_point}
        # the policy flags the quantizers read on the device, one copy an
        # epoch (QuantPolicy.flags() stays the host tuple)
        self.qflags = torch.zeros((run.model.policy_len(),),
                                  dtype=torch.float32, device=self.device)
        self.epoch_fn = self.probe_fn = None
        if run.epoch_executor == "scan":
            pool = (torch.cuda.graph_pool_handle()
                    if self.device.type == "cuda" else None)
            warmed = set()
            self.epoch_fn = EpochRunner(self.setup, self.device, pool=pool,
                                        warmed=warmed)
            self.probe_fn = EpochRunner(self.setup, self.device, adopt=False,
                                        pool=pool, warmed=warmed)
        self.schedule = make_schedule(run.optim, run.steps)
        self.sampler = PoissonSampler(dataset.n, run.global_batch,
                                      seed=run.seed)
        self._probe_rng = np.random.RandomState(run.seed + 777)
        self.accountant = RDPAccountant()
        self.scheduler = DPQuantScheduler(
            n_layers=run.model.policy_len(), dp=run.dp, mode=mode,
            seed=run.seed)
        self.params = self.setup.shard(self.model.init(run.seed))
        self.opt_state = self.setup.opt_init_fn(self.params)
        self.step = 0
        self.history: List[EpochStats] = []
        # wall seconds of the last analysis (Algorithm 1), 0 if none ran,
        # the probe graph's capture included (last_probe_capture_s); of
        # every train step (loop: batch draw, step, the loss read that
        # synchronizes with the device; scan: its chunk's wall over its
        # steps, capture excluded); of the last epoch's CUDA graph warm-up
        # and capture (scan on CUDA, 0 if none)
        self.last_analysis_s = 0.0
        self.last_probe_capture_s = 0.0
        self.step_wall_s: List[float] = []
        self.last_capture_s = 0.0
        self.ckpt = (CheckpointManager(checkpoint_dir)
                     if checkpoint_dir else None)
        self.preemption = preemption
        # epoch cursor: train(n) runs n epochs starting here; restore sets
        # it past the checkpointed epoch (or *at* it for mid-epoch resume)
        self._next_epoch = 0
        # mid-epoch resume record ({"epoch", "epoch_step", "epoch_losses"})
        # set by restore_latest when the checkpoint was a preemption save
        self._mid_epoch: Optional[dict] = None

    # ------------------------------------------------------------------ #
    def _to_device(self, batch: dict) -> dict:
        """``batch`` on the device, a floating input of the model's
        ``batch_spec`` (the encoder-decoder's float32 ``enc_embeds``) cast
        there to the spec's dtype."""
        return {k: v.to(self.device).to(self._input_dtypes.get(k, v.dtype))
                for k, v in batch.items()}

    def _lr(self, step: int) -> torch.Tensor:
        """The schedule's learning rate at ``step``, a 0-dim float32 tensor
        on the device (a fill, no host copy)."""
        return torch.full((), self.schedule(step), dtype=torch.float32,
                          device=self.device)

    def _set_flags(self, flags) -> torch.Tensor:
        """``qflags`` filled with the policy ``flags`` (host bools), one
        copy outside any graph; returns it."""
        self.qflags.copy_(torch.tensor(flags, dtype=torch.float32))
        return self.qflags

    def _probe_step(self, params, opt_state, batches: dict, seeds, flags):
        """The losses ((R,), on the device) of R train steps from
        ``params`` / ``opt_state`` under the device ``flags``, one per
        probe batch (``batches`` stacked on a leading axis) at its seed:
        replays of the probe graph, or eager steps under ``loop``.  Writes
        neither argument (RESTOREMODEL)."""
        lr = self._lr(self.step)
        if self.probe_fn is not None:
            _, _, metrics = self.probe_fn(params, opt_state, batches, seeds,
                                          flags, lr.expand(len(seeds)))
            self.last_probe_capture_s += self.probe_fn.last_capture_s
            return metrics["loss"]
        losses = []
        for r, seed in enumerate(seeds):
            params, opt_state, metrics = self.step_fn(
                params, opt_state, {k: v[r] for k, v in batches.items()},
                seed, flags, lr)
            losses.append(metrics["loss"])
        return torch.stack(losses)

    def _sample_batch(self) -> dict:
        return self._to_device(self.dataset.get(self.sampler.sample()))

    # ------------------------------------------------------------------ #
    def train_epoch(self, epoch: int) -> EpochStats:
        t0 = time.time()
        run = self.run
        resume = None
        if self._mid_epoch is not None:
            if self._mid_epoch["epoch"] != epoch:
                raise RuntimeError(
                    f"mid-epoch checkpoint is for epoch "
                    f"{self._mid_epoch['epoch']}, cannot run epoch {epoch}")
            resume, self._mid_epoch = self._mid_epoch, None
        self.last_analysis_s = self.last_probe_capture_s = 0.0
        if resume is None:
            # ---- Algorithm 1 (analysis) ----
            if self.mode == "dpquant":
                nb = min(run.dp.analysis_batch_size, run.global_batch)
                nb = max(run.dp.microbatch_size, nb)
                # a whole number of the step's microbatches (on a mesh the
                # global one) or of the sharded ghost driver's shards
                m = self.setup.batch_multiple
                nb = -(-nb // m) * m
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
        else:
            # mid-epoch resume: analysis and selection ran before the
            # preemption, and their draws and accountant charges are in
            # the restored state; the restored scheduler holds this
            # epoch's policy
            policy = self.scheduler.current
        qflags = self._set_flags(policy.flags())

        # ---- DP-SGD steps ----
        start = resume["epoch_step"] if resume else 0
        prior = resume["epoch_losses"] if resume else []
        if self.epoch_fn is not None:
            losses = self._train_steps_scan(qflags, epoch, start, prior)
        else:
            losses = self._train_steps_loop(qflags, epoch, start, prior)

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
        if self._replicas is not None and not replicas_agree(
                [*self.params.values(), self.qflags], self._replicas):
            raise RuntimeError(f"epoch {epoch}: the ranks' params or "
                               f"policies differ")
        if self.ckpt is not None:
            self.save(epoch)
        return stats

    def _maybe_preempt(self, epoch: Optional[int], epoch_step: int,
                       losses: List[float]) -> None:
        """Step-boundary preemption poll (both executors call it; steps run
        outside an epoch, ``epoch`` None, are not polled).

        When the handler fires, a *mid-epoch* checkpoint is written and
        :class:`Preempted` raised.  The accountant is exact at every step
        boundary (the loop charges per step, the scan executor per chunk,
        and consecutive identical SGM events merge), so the saved epsilon
        equals the uninterrupted run's at the same global step.
        """
        if epoch is None or self.preemption is None:
            return
        fire = self.preemption.should_preempt(self.step)
        if self._world is not None:
            # the ranks act on one step together: any rank's request (a
            # signal reaches one process) preempts every rank
            flag = torch.tensor([float(fire)], device=self.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX,
                            group=self._world.group)
            fire = bool(flag.item())
        if not fire:
            return
        if self.ckpt is not None:
            self.save(epoch, epoch_step=epoch_step, epoch_losses=losses,
                      mid_epoch=True)
            self.ckpt.wait()
        raise Preempted(self.step)

    def _train_steps_loop(self, qflags, epoch: Optional[int] = None,
                          start: int = 0, prior=()) -> List[float]:
        """Steps ``start`` to the epoch's end under the policy ``qflags``
        (the flags tensor), one host sync and one accountant charge each;
        returns ``prior`` and their losses."""
        run = self.run
        losses = list(prior)
        for es in range(start, run.steps_per_epoch):
            t0 = time.perf_counter()
            batch = self._sample_batch()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch, self.step + run.seed,
                qflags, self._lr(self.step))
            losses.append(float(metrics["loss"]))
            self.step_wall_s.append(time.perf_counter() - t0)
            if run.dp.enabled:
                self.accountant.step(
                    noise_multiplier=run.dp.noise_multiplier,
                    sample_rate=self.sampler.q, steps=1, label="train")
            self.step += 1
            self._maybe_preempt(epoch, es + 1, losses)
        return losses

    def _train_steps_scan(self, qflags, epoch: Optional[int] = None,
                          start: int = 0, prior=()) -> List[float]:
        """Steps ``start`` to the epoch's end under the policy ``qflags``
        (the flags tensor) in chunks of ``epoch_chunk`` steps (0: one
        chunk), each staged in one copy and run by ``self.epoch_fn``; one
        host read, one accountant charge and one preemption poll a
        chunk."""
        run = self.run
        steps = run.steps_per_epoch
        chunk = run.epoch_chunk if run.epoch_chunk > 0 else steps
        losses: List[float] = list(prior)
        self.last_capture_s = 0.0
        done = start
        while done < steps:
            k = min(chunk, steps - done)
            t0 = time.perf_counter()
            flat = self.dataset.get(self.sampler.sample_epoch(k).reshape(-1))
            batches = self._to_device(
                {name: t.reshape((k, -1) + tuple(t.shape[1:]))
                 for name, t in flat.items()})
            seeds = np.arange(self.step, self.step + k) + run.seed
            lrs = torch.tensor([self.schedule(self.step + i)
                                for i in range(k)],
                               dtype=torch.float32).to(self.device)
            self.params, self.opt_state, metrics = self.epoch_fn(
                self.params, self.opt_state, batches, seeds, qflags, lrs)
            losses.extend(metrics["loss"].tolist())   # the chunk's host read
            capture = self.epoch_fn.last_capture_s
            self.last_capture_s += capture
            wall = time.perf_counter() - t0 - capture
            self.step_wall_s.extend([wall / k] * k)
            if run.dp.enabled:
                self.accountant.step(
                    noise_multiplier=run.dp.noise_multiplier,
                    sample_rate=self.sampler.q, steps=k, label="train")
            self.step += k
            done += k
            self._maybe_preempt(epoch, done, losses)
        return losses

    def train(self, epochs: int, *, eps_budget: Optional[float] = None,
              verbose: bool = False) -> List[EpochStats]:
        """Train ``epochs`` more epochs from the epoch cursor: 0 for a
        fresh trainer; after ``restore_latest``, past the last completed
        epoch, or *at* the preempted epoch for a mid-epoch checkpoint,
        which is finished first."""
        start = self._next_epoch
        for e in range(start, start + epochs):
            stats = self.train_epoch(e)
            self._next_epoch = e + 1
            if verbose and self.rank == 0:
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
        """Class predictions of a classification family: a CNN's logits
        of the images, BERT's of the [CLS] row through ``cls_w``,
        ``cls_b``."""
        inputs = {"resnet": "image", "densenet": "image", "bert": "tokens"}
        family = self.run.model.family
        if family not in inputs:
            raise ValueError(f"no predict for family {family}")
        with torch.no_grad():
            logits = self.model.forward(self.params, batch[inputs[family]],
                                        flags)
        return logits.argmax(-1).cpu().numpy()

    # ------------------------------------------------------------------ #
    def save(self, epoch: int, *, epoch_step: int = 0,
             epoch_losses=(), mid_epoch: bool = False) -> None:
        """Checkpoint what a bit-identical resume needs: params and
        optimizer state (host copies, taken before this returns), and in
        the aux payload the accountant, the scheduler's EMA and policy,
        the sampler's and the probe RNG's stream positions, the history
        and, for a preemption save (``mid_epoch``), the epoch's step index
        and its losses so far.  On a mesh rank 0 writes it and every rank
        waits at a barrier until it is on disk.  The tree is the whole one
        (every rank gathers its blocks on a model-parallel mesh)."""
        tree = {"params": self.setup.unshard(self.params),
                "opt": self.setup.unshard(self.opt_state)}
        if self.rank == 0:
            self._save(tree, epoch, epoch_step, epoch_losses, mid_epoch)
        if self._world is not None:
            if self.rank == 0:
                self.ckpt.wait()
            dist.barrier(group=self._world.group)

    def _save(self, tree, epoch, epoch_step, epoch_losses,
              mid_epoch) -> None:
        aux = {
            "accountant": self.accountant.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "sampler": self.sampler.state_dict(),
            "probe_rng": self._probe_rng.get_state(),
            "history": [dataclasses.asdict(s) for s in self.history],
            "step": self.step,
            "epoch": epoch,
            "mid_epoch": bool(mid_epoch),
            "epoch_step": int(epoch_step),
            "epoch_losses": [float(x) for x in epoch_losses],
        }
        self.ckpt.save(self.step, tree, aux)

    def restore_latest(self) -> Optional[int]:
        """Restore the latest valid checkpoint; returns its epoch (None:
        no directory or no checkpoint).  The scan executor copies the
        restored tensors into its static buffers at its next call."""
        if self.ckpt is None:
            return None
        res = self.ckpt.restore_latest({
            "params": self.setup.whole_like(self.params),
            "opt": self.setup.whole_like(self.opt_state)})
        if res is None:
            return None
        _, tree, aux = res
        self.params = self.setup.shard(tree["params"])
        self.opt_state = self.setup.shard(tree["opt"])
        self.accountant = RDPAccountant.from_state_dict(aux["accountant"])
        self.scheduler.load_state_dict(aux["scheduler"])
        self.sampler.load_state_dict(aux["sampler"])
        self._probe_rng.set_state(aux["probe_rng"])
        self.history = [EpochStats(**d) for d in aux["history"]]
        self.step = aux["step"]
        if aux["mid_epoch"]:
            # preemption save: re-enter the interrupted epoch, skipping
            # analysis, selection and the steps already run (train_epoch)
            self._mid_epoch = {"epoch": aux["epoch"],
                               "epoch_step": aux["epoch_step"],
                               "epoch_losses": list(aux["epoch_losses"])}
            self._next_epoch = aux["epoch"]
        else:
            self._mid_epoch = None
            self._next_epoch = aux["epoch"] + 1
        return aux["epoch"]
