"""The trainer's and server's mesh (port of ``repro.launch.mesh``).

The reference names its devices on a ``jax.sharding.Mesh`` of axes
``("data", "model")`` (``("pod", "data", "model")`` across pods).  In the
port:

* ``data`` (times ``pod``) is the number of candidate workers K.  Either
  one process runs its K candidates one after another (the counterpart of
  the reference's forced host-device count), or the data axis is
  processes: ``group``, a ``torch.distributed`` process group of K ranks,
  one per candidate (the rank's data group).  At M = 1 the flat layout of
  ``distributed.robust_allreduce`` runs over it; the stacked layout, the
  gspmd step, serving and the flat layout at M > 1 run the grid below.
* ``model`` is the tensor-parallel (TP) axis: ``model_group``, a process
  group of M ranks, one per TP shard of the model (``gloo`` on the CPU or
  M ranks sharing one card, ``nccl`` on M cards).  A mesh with ``model >
  1`` and no such group is refused: nothing falls back to M = 1.

**The grid.**  With both axes as processes the mesh is a grid of K x M
ranks (p x K x M under ``multi_pod``): rank r has the coordinates
``np.unravel_index(r, shape)``, ``model`` the fastest axis, the order in
which the reference's ``jax.make_mesh(shape, axes, devices=devices[:n])``
lays a device list out.  Each rank belongs to its model group (the M
ranks of its candidate) and its data group (the K ranks with its model
index), and computes one candidate's gradient on its model block.
``grid_layout`` gives every rank's coordinates and every group's ranks
for a shape; ``make_grid`` creates the groups (every rank creates every
group, in the same order, as ``torch.distributed.new_group`` needs) and
``make_production_mesh`` builds the reference's 16 x 16 (2 x 16 x 16)
grid from 256 (512) initialised ranks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch.distributed as dist

@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This process's place on the ``model`` axis: the group of M ranks, M
    and this rank's index in it (its TP shard)."""

    group: Any
    size: int
    rank: int


@dataclasses.dataclass(frozen=True)
class DataAxis:
    """This process's place on the data axis as processes: its data group
    of K (p x K) ranks, one per candidate, K and this rank's index in it
    (its candidate, and its FSDP block)."""

    group: Any
    size: int
    rank: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` is ``{"data": K, "model": M}`` (``{"pod": p, "data": K,
    "model": M}`` across pods); ``group``, when set, the rank's data group
    of K (p x K) ranks, one per candidate; ``model_group``, when M > 1,
    its group of the M TP ranks."""

    shape: Dict[str, int]
    group: Optional[Any] = None
    model_group: Optional[Any] = None

    @property
    def axis_names(self):
        return tuple(self.shape)

    def model_axis(self) -> Optional[ModelAxis]:
        """None at M = 1, else this process's ``ModelAxis``."""
        M = self.shape.get("model", 1)
        if M == 1:
            return None
        return ModelAxis(self.model_group, M, dist.get_rank(self.model_group))

    def data_axis(self) -> Optional[DataAxis]:
        """None when the data axis runs in one process, else this process's
        ``DataAxis``."""
        if self.group is None:
            return None
        return DataAxis(self.group, dist.get_world_size(self.group),
                        dist.get_rank(self.group))

    def grid_group(self):
        """The group of every rank of the mesh (the K x M grid): the
        statistics of the stacked all-reduce are summed over it."""
        if self.group is None:
            return self.model_group
        if self.model_group is None:
            return self.group
        return dist.group.WORLD


def model_size(mesh: Optional[Mesh]) -> int:
    """M, the size of the mesh's model axis (1 without a mesh)."""
    return 1 if mesh is None else int(mesh.shape.get("model", 1))


def data_axis(mesh: Optional[Mesh]) -> Optional[DataAxis]:
    """The mesh's data axis as processes, or None (no mesh, or the data axis
    in one process)."""
    return None if mesh is None else mesh.data_axis()


class GridLayout(NamedTuple):
    """A grid's ranks: ``coords`` (n, axes) every rank's coordinates in the
    shape's axis order; ``data_groups`` the ranks of each data group (one
    per model index, in (pod, data) order), ``model_groups`` those of each
    model group (one per (pod, data) coordinate, in model order)."""

    coords: np.ndarray
    data_groups: List[List[int]]
    model_groups: List[List[int]]


def grid_layout(shape: Dict[str, int]) -> GridLayout:
    """The ranks of a grid of ``shape`` (axes in the mesh's order, ``model``
    last; a ``pod`` of 0 is no axis): rank r at ``np.unravel_index(r,
    dims)``, the order of ``np.arange(n).reshape(dims)``."""
    dims = tuple(int(v) for k, v in shape.items() if not (k == "pod" and v == 0))
    n = math.prod(dims)
    ranks = np.arange(n).reshape(dims)
    M = dims[-1]
    coords = np.stack(np.unravel_index(np.arange(n), dims), axis=1)
    by_candidate = ranks.reshape(-1, M)
    return GridLayout(coords, by_candidate.T.tolist(), by_candidate.tolist())


def make_grid(data: int, model: int = 1, pod: int = 0) -> Mesh:
    """The grid of ``data`` (times ``pod``) x ``model`` ranks over every rank
    of the initialised default group (its size must be their product):
    every rank creates every data and model group, in the same order, and
    keeps its own."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a grid needs an initialised torch.distributed process group "
                           "(torchrun, or init_process_group in each process)")
    shape = {"pod": pod, "data": data, "model": model} if pod else \
        {"data": data, "model": model}
    lay = grid_layout(shape)
    n = lay.coords.shape[0]
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a grid of {shape} needs {n} ranks, the default group has {world}")
    me = dist.get_rank()

    def mine(groups):
        if len(groups) == 1:
            return dist.group.WORLD
        out = None
        for ranks in groups:
            g = dist.new_group(ranks)
            if me in ranks:
                out = g
        return out

    model_group = mine(lay.model_groups) if model > 1 else None
    group = mine(lay.data_groups) if n // model > 1 else None
    return make_test_mesh(data, model, pod, group=group, model_group=model_group)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256 ranks per pod; 2 pods = 512 ranks when ``multi_pod``,
    as the reference's: the grid over the initialised default group.
    Fewer initialised ranks raise the reference's RuntimeError."""
    n = 512 if multi_pod else 256
    found = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if found < n:
        raise RuntimeError(
            f"production mesh needs {n} devices, found {found} — launch {n} ranks "
            "(torchrun) with an initialised process group")
    return make_grid(16, 16, pod=2 if multi_pod else 0)


def make_test_mesh(data: int = 1, model: int = 1, pod: int = 0, group=None,
                   model_group=None) -> Mesh:
    """A mesh of ``data`` (times ``pod``) candidate workers and ``model`` TP
    shards.  ``group``: the rank's data group, one rank per candidate
    (``data`` x ``pod`` ranks); ``model_group``: its group of exactly
    ``model`` ranks, required when ``model > 1``.  With both, the mesh is
    the grid over every rank of the default group (``make_grid`` creates
    such groups)."""
    if data < 1 or model < 1 or pod < 0:
        raise ValueError(f"data = {data}, model = {model}, pod = {pod}: a mesh needs at "
                         "least one candidate and one model shard")
    if model > 1:
        if model_group is None:
            raise ValueError(f"model = {model} needs a process group of {model} ranks "
                             "(model_group=): the model axis never runs in one process")
        if dist.get_world_size(model_group) != model:
            raise ValueError(f"the model group has {dist.get_world_size(model_group)} "
                             f"ranks, the mesh {model} model shards")
    elif model_group is not None and dist.get_world_size(model_group) != 1:
        raise ValueError("model = 1 takes no model group of several ranks")
    K = data * (pod or 1)
    if group is not None and dist.get_world_size(group) != K:
        raise ValueError(f"the data group has {dist.get_world_size(group)} ranks, "
                         f"the mesh {K} candidates: one rank per candidate")
    if group is not None and model > 1 and dist.get_world_size() != K * model:
        raise ValueError(f"a grid of {K} x {model} ranks is every rank of the default "
                         f"group, which has {dist.get_world_size()}")
    shape = {"pod": pod, "data": data, "model": model} if pod else \
        {"data": data, "model": model}
    return Mesh(shape=shape, group=group, model_group=model_group if model > 1 else None)
