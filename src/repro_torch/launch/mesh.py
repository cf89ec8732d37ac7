"""The candidate mesh of the robust-DP trainer (port of
``repro.launch.mesh``).

The reference names its devices on a ``jax.sharding.Mesh`` whose ``data``
axis holds the K candidate workers.  On one card the port runs the K
candidates in one process, so ``data`` is the number of candidate workers
(the counterpart of the reference's forced host-device count).  The mesh
may also carry a ``torch.distributed`` process group with one rank per
candidate, rank = candidate index: the flat layout of
``distributed.robust_allreduce`` then runs across those processes instead
of emulating them.  A ``model`` axis above 1, a ``pod`` axis and the
production mesh are the multi-card trainer (ROADMAP queue 1, item 12).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch.distributed as dist

MULTI_CARD = ("the multi-card trainer (a model axis, pods, the production mesh) is not "
              "ported yet (ROADMAP queue 1, item 12)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` is ``{"data": K, "model": 1}``; ``group``, when set, is a
    process group of K ranks, one per candidate."""

    shape: Dict[str, int]
    group: Optional[Any] = None

    @property
    def axis_names(self):
        return tuple(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    raise NotImplementedError(MULTI_CARD)


def make_test_mesh(data: int = 1, model: int = 1, pod: int = 0, group=None) -> Mesh:
    """A mesh of ``data`` candidate workers.  ``group``: a process group of
    ``data`` ranks (the flat layout's one-rank-per-candidate form)."""
    if model != 1 or pod:
        raise NotImplementedError(MULTI_CARD)
    if data < 1:
        raise ValueError(f"data = {data}: a mesh needs at least one candidate")
    if group is not None and dist.get_world_size(group) != data:
        raise ValueError(f"the process group has {dist.get_world_size(group)} ranks, "
                         f"the mesh {data} candidates: one rank per candidate")
    return Mesh(shape={"data": data, "model": 1}, group=group)
