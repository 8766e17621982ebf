"""The train step: DP-SGD / DP-Adam or plain, as one functional call.

The counterpart of ``repro.launch.steps.build_train_setup`` for one
device (no mesh, no shardings, no sharded ghost driver): the clipped
gradient sum of the vmap engine (``dp.clip``) or the ghost engine
(``dp.ghost``), noised, then the optimizer.  ``step_fn(params, opt_state,
batch, seed, qflags, lr) -> (params, opt_state, metrics)`` returns new
params and optimizer state and writes neither argument in place, which
is what lets the DPQuant probes restore the model by keeping the old
ones.  It never synchronizes with the host: the metrics are 0-dim device
tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.func import grad_and_value

from repro_torch.config import RunConfig
from repro_torch.dp.clip import per_example_clipped_grad_sum
from repro_torch.dp.engine import validate_grad_mode
from repro_torch.dp.ghost import ghost_clipped_grad_sum
from repro_torch.dp.noise import add_gaussian_noise
from repro_torch.models.registry import Model
from repro_torch.optim import apply_updates, make_optimizer

# Offset of the DP noise's generator seed from the step seed: each step
# draws its noise from its own stream, seeded from the step seed alone
# (the JAX package splits PRNGKey(seed) into clip, noise and loss keys).
# Below 2**31 with the step seed added, as PyTorch's CPU generator keeps
# only the low 32 bits of a seed.
NOISE_SEED_OFFSET = 2 ** 29


@dataclasses.dataclass
class TrainSetup:
    step_fn: Callable
    opt_init_fn: Callable


def noise_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(NOISE_SEED_OFFSET + int(seed))
    return gen


def build_train_setup(model: Model, run: RunConfig) -> TrainSetup:
    if model.loss_fn is None:
        raise ValueError(f"model family {model.config.family!r} has no "
                         "training hooks in repro_torch yet")
    if run.dp.enabled:
        validate_grad_mode(run.dp, model)
    opt = make_optimizer(run.optim)
    mb = max(1, min(run.dp.microbatch_size, run.global_batch))
    ghost = run.dp.enabled and run.dp.grad_mode == "ghost"

    def train_step(params, opt_state, batch, seed, qflags, lr):
        if ghost:
            grad_sum, metrics = ghost_clipped_grad_sum(
                lambda p, b, hooks: model.per_example_loss(
                    p, b, qflags, hooks=hooks),
                params, batch, clip_norm=run.dp.clip_norm,
                hooked_mask=model.ghost_mask(params),
                aux=(model.ghost_aux(qflags) if model.ghost_aux is not None
                     else None),
                ghost_microbatch=run.dp.ghost_microbatch)
        elif run.dp.enabled:
            def loss_one(p, ex):
                return model.loss_fn(p, {k: v[None] for k, v in ex.items()},
                                     qflags)

            grad_sum, metrics = per_example_clipped_grad_sum(
                loss_one, params, batch, clip_norm=run.dp.clip_norm,
                microbatch_size=mb, clip_backend=run.dp.clip_backend)
        else:
            grads, loss = grad_and_value(
                lambda p: model.loss_fn(p, batch, qflags))(params)
            metrics = {"loss": loss}
        if run.dp.enabled:
            # the expected batch size, as in the JAX package (a probe
            # batch of another size is divided by it too)
            grads = add_gaussian_noise(
                grad_sum, clip_norm=run.dp.clip_norm,
                noise_multiplier=run.dp.noise_multiplier,
                batch_size=run.global_batch,
                generator=noise_generator(seed, model.device))
            del grad_sum      # one float32 copy of the params fewer live
        updates, new_opt = opt.update(grads, opt_state, params, lr)
        del grads
        return apply_updates(params, updates), new_opt, metrics

    return TrainSetup(step_fn=train_step, opt_init_fn=opt.init)
