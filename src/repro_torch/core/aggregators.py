"""Mask helpers and the mean baseline (port of ``repro.core.aggregators``).

Every function works on tensors with any leading axes (a leading N axis
for the per-node gossip batch) and selects along the last axis.  The
Krum and clustering helpers are not ported yet (ROADMAP queue 1, item 3).
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

Tensor = torch.Tensor


def _stable_rank(scores: Tensor) -> Tensor:
    """Rank of each entry along the last axis, ties broken by index."""
    order = torch.argsort(scores, dim=-1, stable=True)
    ar = torch.arange(scores.shape[-1], device=scores.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


def smallest_k_mask(scores: Tensor, k: int) -> Tensor:
    """Boolean mask selecting the k smallest scores (ties broken by index,
    the ``lax.top_k`` order of the reference)."""
    K = scores.shape[-1]
    return _stable_rank(scores) < max(0, min(int(k), K))


def smallest_k_mask_dyn(scores: Tensor, k: Union[Tensor, int]) -> Tensor:
    """``smallest_k_mask`` with a per-row keep count ``k`` (leading-axes
    shaped, clamped to [0, K]); same stable tie order."""
    K = scores.shape[-1]
    k = torch.as_tensor(k, device=scores.device)
    return _stable_rank(scores) < torch.clamp(k, 0, K)[..., None]


def masked_mean(updates: Tensor, mask: Tensor) -> Tensor:
    """Mean of the masked rows of ``updates (..., K, d)``."""
    w = mask.to(updates.dtype)
    denom = torch.clamp(w.sum(-1), min=1.0)
    return (w[..., None] * updates).sum(-2) / denom[..., None]


def mean_agg(updates: Tensor) -> Tuple[Tensor, Tensor]:
    K = updates.shape[-2]
    return updates.mean(-2), torch.ones(updates.shape[:-2] + (K,),
                                        dtype=torch.bool, device=updates.device)


def mean_agg_dyn(updates: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor]:
    valid = valid.to(torch.bool)
    return masked_mean(updates, valid), valid
