"""Evaluation metrics (paper Section V-C); port of ``repro.core.metrics``."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def micro_accuracy(logits: Tensor, labels: Tensor) -> Tensor:
    """Micro-averaged multi-class accuracy = total TP / |D_test| (Eq. 6),
    over the last two axes (leading axes, e.g. nodes, are kept)."""
    pred = logits.argmax(-1)
    return (pred == labels).to(torch.float32).mean(-1)


def r_squared(vectors: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    """Multivariate R^2 consistency metric (Eq. 7): ``1 - SSR / SST`` with
    SSR the dispersion of the rows around their mean vector and SST their
    squared norms.  ``weights`` (0/1) selects the cohort."""
    if weights is None:
        vbar = vectors.mean(0)
        ssr = ((vectors - vbar[None, :]) ** 2).sum()
        sst = (vectors ** 2).sum()
    else:
        w = weights.to(vectors.dtype)
        n = torch.clamp(w.sum(), min=1.0)
        vbar = torch.einsum("n,nd->d", w, vectors) / n
        ssr = (w[:, None] * (vectors - vbar[None, :]) ** 2).sum()
        sst = (w[:, None] * vectors ** 2).sum()
    return 1.0 - ssr / torch.clamp(sst, min=1e-12)


def cross_entropy(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean softmax cross-entropy with integer labels."""
    return F.cross_entropy(logits, labels.long())
