"""Elastic re-meshing after failures.

The counterpart of ``repro.runtime.elastic``, copied whole (the
standard library only); the serving supervisor
(``repro_torch.runtime.supervisor``) drives it.

Given the surviving host/chip count, pick the largest expressible mesh
(keeping the model axis intact when possible — TP degree is baked into
weight-shard divisibility, so we prefer shrinking the data/pod axes), and
re-derive the DP accounting rate: privacy accounting is per-step (sigma, q)
tuples, so a batch-size change on re-mesh is accounted exactly by updating
the sample rate of subsequent steps.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class MeshPlan:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    global_batch: int
    sample_rate: float


def plan_remesh(n_chips: int, model_parallel: int,
                per_replica_batch: int, dataset_size: int,
                pods: int = 1) -> Optional[MeshPlan]:
    """Largest mesh with the given TP degree that fits ``n_chips``.

    ``n_chips`` is the *total* surviving chip count across ``pods``; with
    ``pods > 1`` the mesh gains a leading pod axis and the data degree is
    what fits per pod (every pod must host the same sub-mesh), so the
    shape is ``(pods, data, model)``.  Returns None if even one replica no
    longer fits.
    """
    if pods < 1:
        raise ValueError(f"pods must be >= 1, got {pods}")
    data = n_chips // (model_parallel * pods)
    if data < 1:
        return None
    global_batch = pods * data * per_replica_batch
    if pods > 1:
        shape: Tuple[int, ...] = (pods, data, model_parallel)
        axis_names: Tuple[str, ...] = ("pod", "data", "model")
    else:
        shape = (data, model_parallel)
        axis_names = ("data", "model")
    return MeshPlan(
        shape=shape,
        axis_names=axis_names,
        global_batch=global_batch,
        sample_rate=min(1.0, global_batch / dataset_size),
    )


def degrade_sequence(start_chips: int, model_parallel: int,
                     per_replica_batch: int, dataset_size: int,
                     failures: List[int]) -> List[MeshPlan]:
    """Simulate successive failures; returns the mesh plan after each."""
    plans = []
    chips = start_chips
    for lost in failures:
        chips -= lost
        plan = plan_remesh(chips, model_parallel, per_replica_batch,
                           dataset_size)
        if plan is None:
            break
        plans.append(plan)
    return plans
