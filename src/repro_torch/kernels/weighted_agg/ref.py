"""Plain PyTorch oracle of the WFAgg-E combine (port of
``repro.kernels.weighted_agg.ref``)."""
from __future__ import annotations

import torch


def weighted_agg_ref(local: torch.Tensor, updates: torch.Tensor,
                     weights: torch.Tensor, alpha: float) -> torch.Tensor:
    """Eq. 3: (1-a)*local + a * sum_j w'_j theta_j with w' normalized.
    If all weights are zero the neighbour term vanishes and the local
    model is returned unchanged."""
    wsum = weights.sum()
    w_norm = weights / torch.clamp(wsum, min=1e-12)
    zero = torch.zeros_like(wsum)
    eff_alpha = torch.where(wsum > 0, zero + alpha, zero)
    return (1.0 - eff_alpha) * local + eff_alpha * (w_norm @ updates)
