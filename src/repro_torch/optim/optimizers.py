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
  adafactor  factored second moments, update clipping
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

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

def adafactor(decay: float = 0.99, eps: float = 1e-30, clip_threshold: float = 1.0,
              min_dim_factored: int = 128) -> Optimizer:
    def factored(p) -> bool:
        return (p.ndim >= 2 and p.shape[-1] >= min_dim_factored
                and p.shape[-2] >= min_dim_factored)

    def init(params):
        # second-moment statistics as a list aligned with the leaves of the
        # reference's tree (factored leaves hold dicts)
        def make(p):
            z = dict(dtype=F32, device=p.device)
            if factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}

        return {"v": [make(p) for p in tree_leaves(params)], "t": _count()}

    def update(grads, state, params, lr):
        t = state["t"] + 1

        def upd(g, v, p):
            gf = g.to(F32)
            g2 = torch.square(gf) + eps
            if factored(p):
                vr = decay * v["vr"] + (1 - decay) * g2.mean(-1)
                vc = decay * v["vc"] + (1 - decay) * g2.mean(-2)
                new_v = {"vr": vr, "vc": vc}
                denom = torch.clamp(vr.mean(-1, keepdim=True), min=eps)
                vhat = vr[..., None] * vc[..., None, :] / denom[..., None]
            else:
                vhat = decay * v["v"] + (1 - decay) * g2
                new_v = {"v": vhat}
            u = gf * torch.rsqrt(vhat + eps)
            # update clipping (RMS <= threshold) over the whole leaf
            rms = torch.sqrt(torch.square(u).mean() + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return (-lr * u).to(p.dtype), new_v

        outs = [upd(g, v, p) for g, v, p in zip(tree_leaves(grads), state["v"],
                                                 tree_leaves(params))]
        updates = tree_unflatten(grads, [o[0] for o in outs])
        return updates, {"v": [o[1] for o in outs], "t": t}

    return Optimizer(init, update)


OPTIMIZERS = {"sgd": sgd, "adamw": adamw, "adafactor": adafactor}


def make_optimizer(name: str, **hp) -> Optimizer:
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
