"""Logical-axis sharding annotations (port of ``repro.distributed.logical``).

Model code annotates activations with *logical* axis names:

    h = shard(h, "batch", "seq", "heads", None)

The step builders install a mesh and a logical -> mesh-axis rule table
(``use_sharding``); outside it the annotations are no-ops, so the same
model code runs on one card and on the model axis.  In the reference
``shard`` is a ``with_sharding_constraint`` that GSPMD satisfies by moving
data.  In the port a tensor is already the rank's local shard, so
``shard`` returns it unchanged: it checks that the local extent of each
named axis whose global size the context knows (``dims``) is that size
divided by the size of the mesh axis the rule maps it to, which catches a
layer that forgot to split (or split twice).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Mapping, Optional, Tuple, Union

import torch

MeshAxis = Union[None, str, Tuple[str, ...]]

_state = threading.local()


def _ctx():
    return getattr(_state, "ctx", None)


def axis_size(mesh, axis: MeshAxis) -> int:
    """The size of a mesh axis (a tuple: the product); 1 for None or no mesh."""
    if axis is None or mesh is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= int(mesh.shape[a])
        return n
    return int(mesh.shape[axis])


@contextlib.contextmanager
def use_sharding(mesh, rules: Mapping[str, MeshAxis],
                 dims: Optional[Mapping[str, int]] = None):
    """Install (mesh, logical -> mesh rules, the logical axes' global sizes)
    for the enclosed region."""
    prev = _ctx()
    _state.ctx = (mesh, dict(rules), dict(dims or {}))
    try:
        yield
    finally:
        _state.ctx = prev


def logical_spec(*axes: Optional[str]) -> Tuple[MeshAxis, ...]:
    """The mesh axes (a spec: a tuple of axis names or None) of ``axes``."""
    ctx = _ctx()
    rules = ctx[1] if ctx else {}
    return tuple(rules.get(a) if a else None for a in axes)


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """``x`` unchanged, after checking its local extents against the
    context's rules (no-op outside a ``use_sharding`` context).  Extra
    trailing dims beyond the names given are not checked."""
    ctx = _ctx()
    if ctx is None:
        return x
    mesh, rules, dims = ctx
    for i, a in enumerate(axes[: x.ndim]):
        if a is None or a not in dims:
            continue
        n = axis_size(mesh, rules.get(a))
        if dims[a] % n or x.shape[i] != dims[a] // n:
            raise ValueError(f"logical axis {a!r} (dim {i} of {tuple(x.shape)}): local "
                             f"extent {x.shape[i]}, expected {dims[a]} / {n}")
    return x


def current_mesh():
    ctx = _ctx()
    return ctx[0] if ctx else None


def current_rules() -> Dict[str, MeshAxis]:
    ctx = _ctx()
    return dict(ctx[1]) if ctx else {}
