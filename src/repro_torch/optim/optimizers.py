"""Optimizers from scratch (port of ``repro.optim.optimizers``).

The API mirrors optax, on trees of dicts of tensors:
  opt = make_optimizer(name, **hp)
  opt.init(params)                      -> state
  opt.update(grads, state, params, lr)  -> (updates, new_state)
where ``updates`` are ADDED to params (they already include the -lr).

``params`` is the reference's tree: for a ``DecoderLM`` the stacked tree
of ``core.flatten.module_tree``, so a leaf-wide statistic (Adafactor's
update clip) spans all L layers of a leaf, as it does in the reference.
The step count, ``b ** t``, the schedules and the learning rate are
float32 tensors, as ``jnp`` computes them; Python scalars enter an
operation in the tensor's float32, as ``jnp``'s weak types do.

Implemented:
  sgd        momentum SGD (paper Section V-A: momentum=0.9)
  adamw      decoupled weight decay Adam
  adafactor  factored second moments, update clipping (over blocks of
             the leaves too: ``LeafBlock``)
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.flatten import tree_leaves, tree_map, tree_unflatten

Tensor = torch.Tensor
F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Tensor], Tuple[Any, Any]]


def _count() -> Tensor:
    """The step count, an int32 0-d tensor on the host."""
    return torch.zeros((), dtype=torch.int32)


# ---------------------------------------------------------------------------
# SGD + momentum
# ---------------------------------------------------------------------------

def sgd(momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"mu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params, lr):
        mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
        updates = tree_map(lambda m: -lr * m, mu)
        return updates, {"mu": mu}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        zeros32 = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)  # noqa: E731
        return {"m": tree_map(zeros32, params), "v": tree_map(zeros32, params),
                "t": _count()}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(F32), state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(F32)),
                     state["v"], grads)
        tf = t.to(F32)
        c1 = 1.0 - torch.tensor(b1, dtype=F32) ** tf
        c2 = 1.0 - torch.tensor(b2, dtype=F32) ** tf

        def upd(m, v, p):
            mh = m / c1
            vh = v / c2
            step = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(F32)
            return (-lr * step).to(p.dtype)

        updates = tree_map(upd, m, v, params)
        return updates, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (simplified: factored second moment, update clipping)
# ---------------------------------------------------------------------------

class LeafBlock(NamedTuple):
    """A parameter leaf of which this rank holds a block: the whole leaf's
    (logical) ``shape``, and per cut dim ``(dim, group)``, the process
    group whose ranks hold the other blocks along it (a leaf cut over the
    model axis and the data axis has two); ``live``, where the block holds
    pad head slots of a padded layout, ``(dim, n)``: its first n entries
    along dim are live, the rest pad slots the whole leaf does not have
    (``core.flatten.pad_tails``)."""

    shape: Tuple[int, ...]
    cuts: Tuple[Tuple[int, Any], ...] = ()
    live: Optional[Tuple[int, int]] = None


def _mean(x: Tensor, dims: Tuple[int, ...], n: int, groups, keepdim: bool = False) -> Tensor:
    """The mean of ``x`` over ``dims`` of a leaf of ``n`` values there: the
    block's sum added over each group whose ranks hold the rest, over n (a
    block that is the whole: ``x.mean``)."""
    if not groups:
        return x.mean(dims, keepdim=keepdim) if dims else x.mean()
    from repro_torch.distributed.spmd import all_reduce_in_rank_order

    s = x.sum(dims, keepdim=keepdim) if dims else x.sum()
    for group in groups:
        s = all_reduce_in_rank_order(s, group)
    return s / n


def adafactor(decay: float = 0.99, eps: float = 1e-30, clip_threshold: float = 1.0,
              min_dim_factored: int = 128,
              blocks: Optional[Sequence[Optional[LeafBlock]]] = None) -> Optimizer:
    """Adafactor.  ``blocks`` (per leaf in tree order, None for a leaf
    held whole) describes a rank that holds blocks of the leaves (the model
    axis, a grid's FSDP blocks): ``factored`` is decided from the whole
    leaf's shape, and each mean over a cut dim (``g2``'s over the last dim
    where the leaf is cut on it, over dim -2 and ``vr``'s over its last
    where it is cut on -2, the update clip's RMS over the whole leaf) adds
    the block's sum over that cut's group; ``vr`` and ``vc`` are the
    blocks of the whole leaf's factors (whole along a dim they reduce).  A
    block's pad head slots (``LeafBlock.live``) take no part in its sums
    (the means count the whole leaf's live values) and get updates of 0."""
    def factored(shape) -> bool:
        return (len(shape) >= 2 and shape[-1] >= min_dim_factored
                and shape[-2] >= min_dim_factored)

    def leaf_blocks(params):
        return list(blocks) if blocks is not None else [None] * len(tree_leaves(params))

    def init(params):
        # second-moment statistics as a list aligned with the leaves of the
        # reference's tree (factored leaves hold dicts)
        def make(p, blk):
            z = dict(dtype=F32, device=p.device)
            if factored(blk.shape if blk is not None else p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}

        return {"v": [make(p, blk) for p, blk in zip(tree_leaves(params), leaf_blocks(params))],
                "t": _count()}

    def update(grads, state, params, lr):
        t = state["t"] + 1

        def upd(g, v, p, blk):
            shape = blk.shape if blk is not None else tuple(p.shape)
            cuts = blk.cuts if blk is not None else ()
            nd = len(shape)
            on = lambda d: [grp for dim, grp in cuts if dim == d]  # noqa: E731
            gf = g.to(F32)
            g2 = torch.square(gf) + eps
            if blk is not None and blk.live is not None:
                d, n = blk.live
                live = (torch.arange(g.shape[d], device=g.device) < n).reshape(
                    (-1,) + (1,) * (g.ndim - d - 1))
                gf = torch.where(live, gf, 0.0)
                g2 = torch.where(live, g2, 0.0)
            if factored(shape):
                vr = decay * v["vr"] + (1 - decay) * _mean(g2, (-1,), shape[-1], on(nd - 1))
                vc = decay * v["vc"] + (1 - decay) * _mean(g2, (-2,), shape[-2], on(nd - 2))
                new_v = {"vr": vr, "vc": vc}
                denom = torch.clamp(_mean(vr, (-1,), shape[-2], on(nd - 2), keepdim=True),
                                    min=eps)
                vhat = vr[..., None] * vc[..., None, :] / denom[..., None]
            else:
                vhat = decay * v["v"] + (1 - decay) * g2
                new_v = {"v": vhat}
            u = gf * torch.rsqrt(vhat + eps)
            # update clipping (RMS <= threshold) over the whole leaf
            rms = torch.sqrt(_mean(torch.square(u), (), math.prod(shape),
                                   [grp for _, grp in cuts]) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return (-lr * u).to(p.dtype), new_v

        outs = [upd(g, v, p, blk) for g, v, p, blk in zip(
            tree_leaves(grads), state["v"], tree_leaves(params), leaf_blocks(params))]
        updates = tree_unflatten(grads, [o[0] for o in outs])
        return updates, {"v": [o[1] for o in outs], "t": t}

    return Optimizer(init, update)


OPTIMIZERS = {"sgd": sgd, "adamw": adamw, "adafactor": adafactor}


def make_optimizer(name: str, blocks: Optional[Sequence[Optional[LeafBlock]]] = None,
                   **hp) -> Optimizer:
    """The optimizer ``name`` with hyper-parameters ``hp``; ``blocks``: the
    leaves' places where this rank holds blocks of them (``LeafBlock``),
    which Adafactor's leaf-wide statistics need (SGD and AdamW act per
    coordinate)."""
    if name == "adafactor":
        hp["blocks"] = blocks
    return OPTIMIZERS[name](**hp)


# ---------------------------------------------------------------------------
# LR schedule
# ---------------------------------------------------------------------------

def warmup_cosine(peak_lr: float, warmup: int = 100, total: int = 10_000,
                  floor: float = 0.1) -> Callable[[Any], Tensor]:
    """Linear warmup to ``peak_lr``, then a cosine decay to ``floor *
    peak_lr`` at ``total``; a float32 0-d tensor of the step."""
    def lr(step):
        s = torch.as_tensor(step).to(F32)
        warm = peak_lr * torch.clamp(s / max(warmup, 1), max=1.0)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(s < warmup, warm, cos)

    return lr


def constant_lr(v: float) -> Callable[[Any], Tensor]:
    return lambda step: torch.full((), v, dtype=F32)
