"""Process groups over the ranks of ``torch.distributed``, as meshes.

The counterpart of ``repro.launch.mesh``.  One rank drives one device
(a CUDA card, or the CPU), so the reference's device mesh becomes a mesh
of ranks: :class:`CompatMesh` lays the world's ranks out row-major over
named axes, knows this rank's coordinates, and holds one process group
for each axis and each axis tuple a partitioner rule names (``("pod",
"data")``), over the ranks that share every other coordinate.

:func:`init_distributed` reads the torchrun environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
picks the backend from the device: NCCL for CUDA with one card a rank,
gloo on the CPU.  Several ranks on one card need gloo (NCCL refuses two
ranks on one device), which moves each collective through the host and
cannot be captured in a CUDA graph; that is allowed only when the caller
asks for it (``share_device=True``), never by default.

:func:`make_production_mesh` is the reference's production layout,
(16, 16) over ``("data", "model")`` or (2, 16, 16) over ``("pod",
"data", "model")``, as a :class:`MeshLayout`: the ranks' arrangement
without a process group, which the partitioner reads (the specs, a
rank's block) whatever the world running it.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.partitioner import DEFAULT_RULES, axis_sizes

#: The data-parallel axes, in the order the batch is split over them.
DATA_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The ranks of one mesh-axis tuple that this rank reduces with:
    ``group`` (None when ``size`` is 1: nothing to reduce), this rank's
    ``index`` in it (its coordinates over the axes, row-major, which is
    also its rank within ``group``) and ``size``."""

    group: Optional[object]
    index: int
    size: int


def init_distributed(device: str = "cuda", *, share_device: bool = False,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``rank``, ``world_size`` and ``init_method`` default to the torchrun
    environment (``env://``).  ``device="cuda"`` means ``cuda:LOCAL_RANK``
    and the NCCL backend; when the node's ranks outnumber its cards, it
    raises unless ``share_device``, which puts every rank on
    ``cuda:LOCAL_RANK % cards`` under gloo.  ``device="cpu"``: gloo.
    """
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    local = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' (CLI: --device cpu)")
        cards = torch.cuda.device_count()
        if local_world > cards and not share_device:
            raise RuntimeError(
                f"{local_world} ranks on this node but {cards} CUDA "
                f"card(s): NCCL takes one card a rank; ranks that share a "
                f"card need gloo and the loop executor "
                f"(init_distributed(share_device=True))")
        dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
        backend = "gloo" if local_world > cards else "nccl"
    elif kind == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"unsupported device {device!r}")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size, **kw)
    return dev


def _rank_and_world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class CompatMesh:
    """The world's ranks laid out row-major over ``axis_names``.

    ``devices``: the (shape) array of ranks, as a JAX mesh holds its
    devices, so that ``repro_torch.parallel.partitioner`` reads both;
    ``coords``: ``{axis: this rank's coordinate}``.  The groups are made
    here, by every rank in the same order (``torch.distributed``'s rule),
    for each axis and each rule's axis tuple whose ranks number more than
    one.  A mesh of one rank needs no process group at all.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        rank, world = _rank_and_world()
        self.axis_names = tuple(axis_names)
        self.devices = np.arange(world).reshape(tuple(shape))
        self.rank = rank
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(
                                   rank, self.devices.shape))))
        self._groups: Dict[Tuple[str, ...], AxisGroup] = {}
        tuples = [(a,) for a in self.axis_names]
        for cands in DEFAULT_RULES.values():
            tuples += [tuple(c) for c in cands if len(c) > 1
                       and all(a in self.axis_names for a in c)]
        for axes in dict.fromkeys(tuples):
            self._make_group(axes)
        # every axis at once: the world
        self._groups[self.axis_names] = AxisGroup(
            dist.group.WORLD if world > 1 else None, rank, world)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def size(self, axes: Sequence[str]) -> int:
        sizes = self.shape
        return int(np.prod([sizes[a] for a in axes], dtype=np.int64))

    def _make_group(self, axes: Tuple[str, ...]) -> None:
        dims = [self.axis_names.index(a) for a in axes]
        rest = [d for d in range(len(self.axis_names)) if d not in dims]
        # ranks by (other coordinates, then the axes' coordinates)
        order = np.transpose(self.devices, rest + dims).reshape(
            -1, self.size(axes))
        mine = None
        for ranks in order:
            ranks = [int(r) for r in ranks]
            group = (dist.new_group(ranks) if len(ranks) > 1 else None)
            if self.rank in ranks:
                mine = AxisGroup(group, ranks.index(self.rank), len(ranks))
        self._groups[axes] = mine

    def axis_group(self, axes: Sequence[str]) -> AxisGroup:
        """This rank's :class:`AxisGroup` over ``axes`` (an empty tuple: a
        group of one)."""
        axes = tuple(axes)
        if not axes:
            return AxisGroup(None, 0, 1)
        return self._groups[axes]

    def model_group(self) -> AxisGroup:
        """This rank's group over the ``model`` axis: the ranks that
        split every layer (a group of one without that axis)."""
        if "model" not in self.axis_names:
            return AxisGroup(None, 0, 1)
        return self._groups[("model",)]

    def warm_collectives(self, device) -> None:
        """One all-reduce of a one-element tensor on ``device`` in every
        group of the mesh: NCCL makes a group's communicator at its first
        collective, which must not be inside a CUDA graph capture."""
        groups = [g.group for g in self._groups.values()
                  if g.group is not None]
        for group in groups:
            dist.all_reduce(torch.zeros(1, device=device), group=group)

    def __repr__(self) -> str:
        return f"CompatMesh({self.shape}, rank {self.rank})"


def make_compat_mesh(shape: Sequence[int], axes: Sequence[str]) -> CompatMesh:
    """A mesh of ``shape`` over ``axes``; its size must be the world's."""
    _, world = _rank_and_world()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {tuple(shape)} over {tuple(axes)} needs "
                         f"{int(np.prod(shape))} ranks; the world has "
                         f"{world}")
    return CompatMesh(shape, axes)


class MeshLayout:
    """A mesh's layout alone: ``axis_names``, ``devices`` (the ranks, row
    major) and the coordinates of ``rank``; no process group.  What the
    partitioner reads of a :class:`CompatMesh`."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int = 0):
        self.axis_names = tuple(axis_names)
        self.devices = np.arange(int(np.prod(shape))).reshape(tuple(shape))
        self.rank = rank
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(
                                   rank, self.devices.shape))))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"MeshLayout({self.shape}, rank {self.rank})"


def make_production_mesh(*, multi_pod: bool = False,
                         rank: int = 0) -> MeshLayout:
    """The reference's production mesh: (16, 16) over ``("data",
    "model")``, or (2, 16, 16) over ``("pod", "data", "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshLayout(shape, axes, rank)


def make_host_mesh(model_parallel: int = 1) -> CompatMesh:
    """``(world // mp, mp)`` over ``("data", "model")``, the world being
    every rank there is (1 without ``torch.distributed``); raises when
    ``model_parallel`` does not divide it."""
    _, n = _rank_and_world()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} does not divide "
                         f"the world of {n} rank(s)")
    return make_compat_mesh((n // model_parallel, model_parallel),
                            ("data", "model"))


def data_degree(mesh) -> int:
    """The product of the mesh's data axes (1 for no mesh)."""
    if mesh is None:
        return 1
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes.get(a, 1) for a in DATA_AXES]))
