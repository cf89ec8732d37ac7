"""Plain PyTorch oracle: pairwise squared distances for Krum (port of
``repro.kernels.pairwise_dist.ref``)."""
from __future__ import annotations

import torch


def pairwise_dist_ref(updates: torch.Tensor) -> torch.Tensor:
    """(K, D) -> (K, K) squared Euclidean distances, from the differences
    (no Gram expansion, so no cancellation; K * K * D memory)."""
    u = updates.to(torch.float32)
    diff = u[:, None, :] - u[None, :, :]
    return (diff * diff).sum(-1)
