"""Minimal functional optimizers over parameter dicts.

The counterpart of ``repro.optim.optimizers``, same API:
``opt.init(params) -> state``; ``opt.update(grads, state, params, lr) ->
(updates, state)``; apply with ``apply_updates``.  Functional, as in the
JAX package: an update returns new tensors and never writes ``params`` or
``state`` in place, so a caller may keep the old ones (the DPQuant probes
restore the model by simply keeping them).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.config import OptimConfig


def tmap(fn, *trees: dict) -> dict:
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable   # (grads, state, params, lr) -> (updates, state)
    name: str = "opt"


def apply_updates(params: dict, updates: dict) -> dict:
    return tmap(lambda p, u: (p + u).to(p.dtype), params, updates)


def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr):
        return tmap(lambda g: -lr * g, grads), state

    return Optimizer(init, update, "sgd")


def momentum(mu: float = 0.9) -> Optimizer:
    def init(params):
        return tmap(lambda p: torch.zeros_like(p, dtype=torch.float32), params)

    def update(grads, state, params, lr):
        new_v = tmap(lambda v, g: mu * v + g, state, grads)
        return tmap(lambda v: -lr * v, new_v), new_v

    return Optimizer(init, update, "momentum")


class AdamState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, name: str = "adam") -> Optimizer:
    def init(params):
        def z():
            return tmap(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
        device = next(iter(params.values())).device
        return AdamState(z(), z(), torch.zeros((), dtype=torch.int32,
                                               device=device))

    def update(grads, state, params, lr):
        count = state.count + 1
        mu = tmap(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tmap(lambda v, g: b2 * v + (1 - b2) * g.square(), state.nu,
                  grads)
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()

        def upd(m, v, p):
            step = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return -lr * step

        return tmap(upd, mu, nu, params), AdamState(mu, nu, count)

    return Optimizer(init, update, name)


def adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    return adam(b1, b2, eps, weight_decay, name="adamw")


def make_optimizer(cfg: OptimConfig) -> Optimizer:
    if cfg.name == "sgd":
        return sgd() if cfg.momentum == 0.0 else momentum(cfg.momentum)
    if cfg.name == "momentum":
        return momentum(cfg.momentum or 0.9)
    if cfg.name == "adam":
        return adam(cfg.beta1, cfg.beta2, cfg.eps)
    if cfg.name == "adamw":
        return adamw(cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.name}")
