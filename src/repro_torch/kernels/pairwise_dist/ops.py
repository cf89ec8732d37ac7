"""Public wrappers of the pairwise Gram kernel (port of
``repro.kernels.pairwise_dist.ops``).  ``pairwise_gram`` gives the raw
((K, K) Gram, (K,) squared norms) pair to the consumers that need inner
products (cosine distances, Krum's Gram expansion); reconstructing the
Gram from the distance matrix would round-trip two cancellation-prone
conversions.

Dispatch is by the tensor's device alone: a CUDA tensor goes to the
hand-written kernel (``kernel.pairwise_gram_cuda``), and a failed build
or launch raises; a CPU tensor goes to ``pairwise_gram_plain``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import trust
from repro_torch.kernels.pairwise_dist import kernel


def pairwise_gram_plain(updates: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """((K, K) Gram, (K,) squared norms) in plain PyTorch."""
    u = updates.to(torch.float32)
    return u @ u.T, (u * u).sum(-1)


def pairwise_gram(updates: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """((K, K) Gram matrix, (K,) squared norms) of ``updates (K, d)`` in one
    pass.  Any K on the CPU; K <= ``kernel.MAX_K`` (1,024) on the card,
    where the kernel raises past it."""
    if updates.ndim != 2:
        raise ValueError(f"updates must be (K, d), got {tuple(updates.shape)}")
    dev = updates.device
    if dev.type == "cpu":
        return pairwise_gram_plain(updates)
    if dev.type != "cuda":
        raise ValueError(f"pairwise_gram runs on cuda or cpu, not {dev}")
    return kernel.pairwise_gram_cuda(updates.to(torch.float32).contiguous())


def pairwise_sq_dists(updates: torch.Tensor) -> torch.Tensor:
    """(K, K) squared distances through the Gram expansion, clamped at 0,
    the diagonal pinned to 0 (``core.trust.sq_dists_from_gram``)."""
    return trust.sq_dists_from_gram(pairwise_gram(updates)[0])
