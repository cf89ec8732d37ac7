"""The trainer's and server's mesh (port of ``repro.launch.mesh``).

The reference names its devices on a ``jax.sharding.Mesh`` of axes
``("data", "model")`` (``("pod", "data", "model")`` across pods).  In the
port:

* ``data`` (times ``pod``) is the number of candidate workers K.  One
  process runs its K candidates one after another (the counterpart of the
  reference's forced host-device count); the mesh may also carry
  ``group``, a ``torch.distributed`` process group of K ranks, one per
  candidate, over which the flat layout of ``distributed.robust_allreduce``
  runs instead of emulating them.
* ``model`` is the tensor-parallel (TP) axis: ``model_group``, a process
  group of M ranks, one per TP shard of the model (``gloo`` on the CPU or
  M ranks sharing one card, ``nccl`` on M cards).  Every rank of it runs
  all K candidates on its shard of the model.  A mesh with ``model > 1``
  and no such group is refused: nothing falls back to M = 1.

The data axis as processes beside a model axis (the K x M process grid,
``fsdp_params``, serving FSDP) and so the production mesh's 256 or 512
ranks are ROADMAP queue 1, item 12.2b.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch.distributed as dist

MULTI_CARD = ("the data axis as processes beside the model axis (fsdp_params, the K x M "
              "process grid, serving FSDP, the production mesh) is not ported yet "
              "(ROADMAP queue 1, item 12.2b)")
# what the model axis does not run yet: the other families' layers, the
# adaptive attacks, Adafactor, gather_dtype
TP_QUEUE = "ROADMAP queue 1, item 12.8"


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This process's place on the ``model`` axis: the group of M ranks, M
    and this rank's index in it (its TP shard)."""

    group: Any
    size: int
    rank: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` is ``{"data": K, "model": M}`` (``{"pod": p, "data": K,
    "model": M}`` across pods); ``group``, when set, a process group of K
    ranks, one per candidate (the flat layout); ``model_group``, when M >
    1, the process group of the M TP ranks."""

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


def model_size(mesh: Optional[Mesh]) -> int:
    """M, the size of the mesh's model axis (1 without a mesh)."""
    return 1 if mesh is None else int(mesh.shape.get("model", 1))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256 ranks per pod; 2 pods = 512 ranks when ``multi_pod``,
    as the reference's.  Fewer initialised ranks raise the reference's
    RuntimeError; with enough, the data axis as processes is refused
    (``MULTI_CARD``)."""
    n = 512 if multi_pod else 256
    found = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if found < n:
        raise RuntimeError(
            f"production mesh needs {n} devices, found {found} — launch {n} ranks "
            "(torchrun) with an initialised process group")
    raise NotImplementedError(MULTI_CARD)


def make_test_mesh(data: int = 1, model: int = 1, pod: int = 0, group=None,
                   model_group=None) -> Mesh:
    """A mesh of ``data`` (times ``pod``) candidate workers and ``model`` TP
    shards.  ``group``: a process group of ``data`` ranks (the flat layout's
    one rank per candidate, M = 1 only); ``model_group``: the process group
    of exactly ``model`` ranks, required when ``model > 1``."""
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
        if group is not None:
            raise NotImplementedError(MULTI_CARD)
    elif model_group is not None and dist.get_world_size(model_group) != 1:
        raise ValueError("model = 1 takes no model group of several ranks")
    K = data * (pod or 1)
    if group is not None and dist.get_world_size(group) != K:
        raise ValueError(f"the process group has {dist.get_world_size(group)} ranks, "
                         f"the mesh {K} candidates: one rank per candidate")
    shape = {"pod": pod, "data": data, "model": model} if pod else \
        {"data": data, "model": model}
    return Mesh(shape=shape, group=group, model_group=model_group if model > 1 else None)
