"""Plain PyTorch oracles for the robust statistics (port of
``repro.kernels.robust_stats.ref``).

``robust_stats_ref`` takes one candidate matrix ``updates (K, D)`` and
returns the median and beta-trimmed mean ``med, trim (D,)`` beside the
statistics below with K-shaped fields (``mednorm2`` a scalar).
``robust_stats_indexed_ref`` does the same for every receiving node n of a
gossip round, with candidate rows ``u_k = models[idx[n, k]]``:
  dist2     (N, K)  squared L2 distance of each candidate to the median model
  dotmed    (N, K)  inner product of each candidate with the median model
  norm2     (N, K)  squared L2 norm of each candidate
  mednorm2  (N,)    squared L2 norm of the median model
and, with the previous-round models ``prev``:
  prev_dist2 (N, K) squared L2 distance to the previous model (WFAgg-T s_t)
  prev_dot   (N, K) inner product with the previous model
  prev_norm2 (N, K) squared L2 norm of the previous model

These are the sufficient statistics of WFAgg-D (Alg. 2), WFAgg-C (Alg. 3)
and WFAgg-T (Alg. 4).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor


class RobustStats(NamedTuple):
    med: Optional[Tensor]
    trim: Optional[Tensor]
    dist2: Tensor
    dotmed: Tensor
    norm2: Tensor
    mednorm2: Tensor
    # temporal tail: populated only when ``prev`` was given
    prev_dist2: Optional[Tensor] = None
    prev_dot: Optional[Tensor] = None
    prev_norm2: Optional[Tensor] = None
    # (N, K, K) candidate Gram: populated only with ``need_gram``
    gram: Optional[Tensor] = None

    def cosine_to_median(self) -> Tensor:
        """1 - cos(theta_j, theta_med): the WFAgg-C metric (clip-invariant)."""
        denom = torch.sqrt(torch.clamp(self.norm2 * self.mednorm2[..., None],
                                       min=1e-24))
        return 1.0 - self.dotmed / denom

    def cosine_to_prev(self) -> Tensor:
        """1 - cos(theta_j^t, theta_j^{t-1}): the WFAgg-T b_t metric."""
        denom = torch.sqrt(torch.clamp(self.norm2 * self.prev_norm2, min=1e-24))
        return 1.0 - self.prev_dot / denom


def trim_count(K: int, beta: float) -> int:
    return int(beta * K)


def valid_median(u: Tensor, valid: Tensor) -> Tensor:
    """Median over the valid rows of ``u (N, K, D)``: invalid rows sort to
    +inf and the median is taken at the dynamic middles ``(v-1)//2`` and
    ``v//2`` of the node's valid count v.  A degree-0 node's empty median
    is 0, so every statistic stays finite (its valid mask rejects every
    slot and it keeps its local model)."""
    srt = torch.sort(torch.where(valid[..., None], u, torch.inf), dim=1).values
    v = valid.sum(dim=1)
    lo = torch.clamp((v - 1) // 2, min=0)    # v = 0 is zeroed below
    take = lambda j: torch.gather(  # noqa: E731
        srt, 1, j[:, None, None].expand(-1, 1, srt.shape[-1]))[:, 0, :]
    med = 0.5 * (take(lo) + take(v // 2))
    return torch.where((v > 0)[:, None], med, torch.zeros_like(med))


def robust_stats_indexed_ref(
    models: Tensor,                 # (M, D) model matrix
    neighbor_idx: Tensor,           # (N, K) rows into models (padded w/ self)
    valid: Optional[Tensor] = None,  # (N, K) bool; None = all valid
    prev: Optional[Tensor] = None,   # (N, K, D) per-edge or (M, D) matrix
    need_gram: bool = False,
    prev_idx: Optional[Tensor] = None,  # (N, K) rows into matrix ``prev``
) -> RobustStats:
    """Oracle for the gather-free round kernel (the oracle MAY gather).

    Per-candidate statistics are computed on the raw padded rows (a
    padded slot holds the node's own finite model); the caller masks
    them with ``valid``.  ``med``/``trim`` are None: the WFAgg filter bank
    never reads a d-sized center.
    """
    idx = neighbor_idx.long()
    u = models[idx].to(torch.float32)                 # (N, K, D)
    N, K, _ = u.shape
    vmask = (torch.ones((N, K), dtype=torch.bool, device=u.device)
             if valid is None else valid.to(torch.bool))
    med = valid_median(u, vmask)                      # (N, D)
    diff = u - med[:, None, :]
    dist2 = (diff * diff).sum(-1)
    dotmed = (u * med[:, None, :]).sum(-1)
    norm2 = (u * u).sum(-1)
    mednorm2 = (med * med).sum(-1)
    prev_dist2 = prev_dot = prev_norm2 = None
    if prev is not None:
        if prev_idx is not None and prev.ndim != 2:
            raise ValueError("prev_idx requires a matrix-form prev")
        pidx = idx if prev_idx is None else prev_idx.long()
        pe = (prev[pidx] if prev.ndim == 2 else prev).to(torch.float32)
        dp = u - pe
        prev_dist2 = (dp * dp).sum(-1)
        prev_dot = (u * pe).sum(-1)
        prev_norm2 = (pe * pe).sum(-1)
    gram = torch.einsum("nkd,njd->nkj", u, u) if need_gram else None
    return RobustStats(None, None, dist2, dotmed, norm2, mednorm2,
                       prev_dist2, prev_dot, prev_norm2, gram)


def sort_columns(u: Tensor) -> Tensor:
    """Columns of ``u (K, D)`` sorted along axis 0, a column holding a NaN
    all NaN: what a sorting network whose compare-exchange propagates NaN
    (``jnp.minimum``/``jnp.maximum``, the Pallas kernel's) returns, and
    what ``jnp.median`` computes on."""
    srt = torch.sort(u, dim=0).values
    return torch.where(torch.isnan(u).any(0), torch.nan, srt)


def median_and_trim(srt: Tensor, beta: float):
    """Median (mean of the two middles for even K) and beta-trimmed mean of
    columns already sorted along axis 0 of ``srt (K, D)``."""
    K = srt.shape[0]
    med = srt[K // 2] if K % 2 == 1 else 0.5 * (srt[K // 2 - 1] + srt[K // 2])
    t = trim_count(K, beta)
    return med, srt[t:K - t].mean(0)


def center_stats(u: Tensor, med: Optional[Tensor], trim: Optional[Tensor],
                 prev: Optional[Tensor] = None,
                 center: Optional[Tensor] = None) -> RobustStats:
    """The per-candidate sums of ``u (K, D)`` about the median ``center``
    (``med`` unless given), with the temporal tail when ``prev (K, D)`` is
    given; ``med``/``trim`` are passed through to the result."""
    c = med if center is None else center
    diff = u - c
    prev_dist2 = prev_dot = prev_norm2 = None
    if prev is not None:
        pe = prev.to(torch.float32)
        dp = u - pe
        prev_dist2 = (dp * dp).sum(-1)
        prev_dot = (u * pe).sum(-1)
        prev_norm2 = (pe * pe).sum(-1)
    return RobustStats(med, trim, (diff * diff).sum(-1), (u * c).sum(-1),
                       (u * u).sum(-1), (c * c).sum(), prev_dist2, prev_dot,
                       prev_norm2)


def robust_stats_ref(updates: Tensor, beta: float = 0.1,
                     prev: Optional[Tensor] = None) -> RobustStats:
    """Oracle of the single-matrix statistics: sorted median and
    beta-trimmed mean of ``updates (K, D)`` and the statistics about the
    median."""
    u = updates.to(torch.float32)
    med, trim = median_and_trim(torch.sort(u, dim=0).values, beta)
    return center_stats(u, med, trim, prev)
