"""Centralized Byzantine-robust aggregation baselines (port of
``repro.core.aggregators``, paper Section II-B).

Every rule takes a candidate matrix ``updates (K, d)`` (the K received
models, flattened), or a batch of them ``(..., K, d)`` (a leading N axis
for the gossip round's gathered slates), and returns ``(aggregated
(..., d), mask (..., K) bool)``, ``mask`` marking the candidates that took
part:
  mean          FedAvg simplification [McMahan et al. 2016]
  median        coordinate-wise median [Yin et al. 2018]
  trimmed_mean  coordinate-wise beta-trimmed mean [Yin et al. 2018]
  krum          Krum [Blanchard et al. 2017]
  multi_krum    Multi-Krum [Blanchard et al. 2017]
  clustering    2-way agglomerative clustering, average linkage, cosine
                distance; aggregate the larger cluster [Sattler et al. 2020]

The mask helpers, the Krum scores and the clustering merge take the same
leading axes and select along the last axis (the last two for (K, K)
matrices).

``DYN_AGGREGATORS`` holds the valid-masked variants (``*_agg_dyn``) for
padded gossip slates (irregular degrees, dynamic and chaos schedules):
each also takes ``valid (..., K) bool``; invalid candidates never reach
the aggregate or the participation mask, and with every slot valid each
reduces to its static counterpart.  All of them are plain PyTorch, as the
reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels.robust_stats.ref import median_and_trim, sort_columns

Tensor = torch.Tensor
_EPS = 1e-12


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


# ---------------------------------------------------------------------------
# single-matrix rules
# ---------------------------------------------------------------------------

def _all(updates: Tensor) -> Tensor:
    return torch.ones(updates.shape[:-1], dtype=torch.bool, device=updates.device)


def coordinate_median(updates: Tensor) -> Tensor:
    """Coordinate-wise median over the K axis of ``(..., K, d)`` (the
    median of a ``(K,)`` vector); mean of the two middles if K even; NaN
    where a column holds a NaN, as ``jnp.median``."""
    if updates.ndim == 1:
        return coordinate_median(updates[:, None])[0]
    return median_and_trim(sort_columns(updates), 0.0)[0]


def pairwise_sq_dists(updates: Tensor) -> Tensor:
    """(..., K, K) squared Euclidean distances via the Gram expansion."""
    sq = (updates * updates).sum(-1)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * (updates @ updates.transpose(-1, -2))
    return torch.clamp(d2, min=0.0)


def cosine_distance_matrix(updates: Tensor) -> Tensor:
    norms = torch.linalg.norm(updates, dim=-1, keepdim=True)
    unit = updates / torch.clamp(norms, min=_EPS)
    return 1.0 - unit @ unit.transpose(-1, -2)


def median_agg(updates: Tensor) -> Tuple[Tensor, Tensor]:
    return coordinate_median(updates), _all(updates)


def trimmed_mean_agg(updates: Tensor, beta: float = 0.1) -> Tuple[Tensor, Tensor]:
    """Remove the smallest/largest floor(beta*K) values per coordinate."""
    return median_and_trim(torch.sort(updates, dim=-2).values, beta)[1], _all(updates)


def _plus_inf_diagonal(d2: Tensor) -> Tensor:
    K = d2.shape[-1]
    eye = torch.eye(K, dtype=torch.bool, device=d2.device)
    return torch.where(eye, torch.inf, d2)


def krum_scores_from_sq_dists(d2: Tensor, f: int) -> Tensor:
    """Krum scores from a precomputed (..., K, K) squared-distance matrix:
    each candidate's sum of squared distances to its ``max(1, K - f - 2)``
    closest peers, added in ascending order."""
    K = d2.shape[-1]
    n_closest = max(1, K - int(f) - 2)
    srt = torch.sort(_plus_inf_diagonal(d2), dim=-1).values
    return srt[..., :n_closest].sum(-1)


def krum_scores_from_sq_dists_dyn(d2: Tensor, f: int, n_valid: Tensor) -> Tensor:
    """Krum scores over a (..., K, K) squared-distance matrix whose invalid
    rows/columns carry +inf, scoring each candidate by its
    ``max(1, n_valid - f - 2)`` closest valid peers (``n_valid`` a tensor of
    the leading shape).  Matches ``krum_scores_from_sq_dists`` when every
    candidate is valid."""
    K = d2.shape[-1]
    srt = torch.sort(_plus_inf_diagonal(d2), dim=-1).values
    n_closest = torch.clamp(torch.as_tensor(n_valid, device=d2.device) - int(f) - 2,
                            min=1)
    take = torch.arange(K, device=d2.device) < n_closest[..., None, None]
    return torch.where(take, srt, torch.zeros_like(srt)).sum(-1)


def krum_scores(updates: Tensor, f: int) -> Tensor:
    """Krum score per candidate: sum of sq-dists to its K-f-2 closest peers."""
    return krum_scores_from_sq_dists(pairwise_sq_dists(updates), f)


def krum_agg(updates: Tensor, f: int = 2) -> Tuple[Tensor, Tensor]:
    best = torch.argmin(krum_scores(updates, f), dim=-1, keepdim=True)
    mask = torch.arange(updates.shape[-2], device=updates.device) == best
    return torch.take_along_dim(updates, best[..., None], dim=-2)[..., 0, :], mask


def multi_krum_agg(updates: Tensor, f: int = 2,
                   m: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    K = updates.shape[-2]
    if m is None:
        m = max(1, K // 4)  # paper: m = K/4
    mask = smallest_k_mask(krum_scores(updates, f), m)
    return masked_mean(updates, mask), mask


def clustering_select_from_dist(D0: Tensor) -> Tensor:
    """Agglomerative 2-way clustering (average linkage) on a precomputed
    (..., K, K) distance matrix; returns the mask of the LARGER cluster.
    The all-valid case of ``clustering_select_from_dist_dyn``."""
    return clustering_select_from_dist_dyn(
        D0, torch.ones(D0.shape[:-1], dtype=torch.bool, device=D0.device))


def clustering_select_from_dist_dyn(D0: Tensor, valid: Tensor) -> Tensor:
    """``clustering_select_from_dist`` restricted to the valid candidates
    of a padded slate (leading axes batch independent problems).

    The Lance-Williams recurrence of the reference, step for step: invalid
    slots start inactive with size 0 and +inf distances; each of the K - 2
    steps merges the closest active pair (i < j, the first in row-major
    order among equal distances), replaces row and column i by the
    size-weighted average of rows i and j, and retires j; steps at or past
    ``n_valid - 2`` change nothing.  The larger final cluster (the first
    among equal sizes) is kept; with <= 2 valid candidates all of them
    are.  Every step is a tensor op (no host read), so it runs on the
    card as it does on the CPU."""
    K = D0.shape[-1]
    valid = valid.to(torch.bool)
    if K <= 2:
        return valid
    dev = D0.device
    eye = torch.eye(K, dtype=torch.bool, device=dev)
    ar = torch.arange(K, device=dev)
    D = torch.where(valid[..., :, None] & valid[..., None, :], D0, torch.inf)
    n_merge = valid.sum(-1) - 2
    active = valid
    sizes = valid.to(D0.dtype)
    assign = ar.expand(valid.shape)
    for s in range(K - 2):
        gate = (s < n_merge)[..., None]
        pair_ok = active[..., :, None] & active[..., None, :] & ~eye
        Dm = torch.where(pair_ok, D, torch.inf)
        flat = torch.argmin(Dm.flatten(-2), dim=-1)
        i0, j0 = flat // K, flat % K
        i = torch.minimum(i0, j0)[..., None]
        j = torch.maximum(i0, j0)[..., None]
        ni = torch.gather(sizes, -1, i)
        nj = torch.gather(sizes, -1, j)
        row = lambda k: torch.gather(  # noqa: E731
            D, -2, k[..., None].expand(*k.shape[:-1], 1, K))[..., 0, :]
        newrow = (ni * row(i) + nj * row(j)) / torch.clamp(ni + nj, min=1.0)
        is_i, is_j = ar == i, ar == j
        nD = torch.where(is_i[..., :, None], newrow[..., None, :], D)
        nD = torch.where(is_i[..., None, :], newrow[..., :, None], nD)
        nsizes = torch.where(is_j, 0.0, torch.where(is_i, ni + nj, sizes))
        D = torch.where(gate[..., None], nD, D)
        active = torch.where(gate, active & ~is_j, active)
        sizes = torch.where(gate, nsizes, sizes)
        assign = torch.where(gate & (assign == j), i, assign)
    big = torch.argmax(sizes, dim=-1, keepdim=True)
    return torch.where((n_merge + 2 <= 2)[..., None], valid, (assign == big) & valid)


def clustering_select(updates: Tensor) -> Tensor:
    """2-way agglomerative clustering of the candidates (cosine distance)."""
    return clustering_select_from_dist(cosine_distance_matrix(updates))


def clustering_agg(updates: Tensor) -> Tuple[Tensor, Tensor]:
    mask = clustering_select(updates)
    return masked_mean(updates, mask), mask


# ---------------------------------------------------------------------------
# valid-masked variants (padded slates)
# ---------------------------------------------------------------------------

def fraction_count(x: float, v: Tensor) -> Tensor:
    """``int(x * v)`` as the reference computes it on a traced count: the
    product in float32, truncated to int32."""
    return (torch.tensor(x, dtype=torch.float32, device=v.device)
            * v.to(torch.float32)).to(torch.int32)


def _sort_valid(updates: Tensor, valid: Tensor) -> Tensor:
    """Columns of ``updates (..., K, d)`` sorted along K with the invalid
    rows as +inf.  ``torch.sort`` puts a NaN last in its column, after the
    +inf padding, as ``jnp.sort`` does: a NaN does not spread over the
    column (unlike ``coordinate_median``)."""
    return torch.sort(torch.where(valid[..., None], updates, torch.inf), dim=-2).values


def masked_median(updates: Tensor, valid: Tensor) -> Tensor:
    """Coordinate-wise median of the valid rows of ``updates (..., K, d)``:
    the mean of the sorted values at the middles ``(v-1)//2`` and ``v//2``
    of the node's valid count v (0 when v = 0).  A NaN makes the median NaN
    only where a middle lands on it.  Matches ``coordinate_median`` on
    finite inputs when every row is valid."""
    K = updates.shape[-2]
    valid = valid.to(torch.bool)
    srt = _sort_valid(updates, valid)
    v = valid.sum(-1)
    take = lambda j: torch.gather(  # noqa: E731
        srt, -2, torch.clamp(j, 0, K - 1)[..., None, None].expand(
            *srt.shape[:-2], 1, srt.shape[-1]))[..., 0, :]
    med = 0.5 * (take((v - 1) // 2) + take(v // 2))
    return torch.where((v > 0)[..., None], med, torch.zeros_like(med))


def median_agg_dyn(updates: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor]:
    return masked_median(updates, valid), valid.to(torch.bool)


def trimmed_mean_agg_dyn(updates: Tensor, valid: Tensor,
                         beta: float = 0.1) -> Tuple[Tensor, Tensor]:
    """beta-trimmed mean over the valid rows: per coordinate, drop the
    ``int(beta * v)`` smallest and largest valid values and average the
    rest (0 when v = 0)."""
    K = updates.shape[-2]
    valid = valid.to(torch.bool)
    v = valid.sum(-1)
    t = fraction_count(beta, v)
    srt = _sort_valid(updates, valid)
    ranks = torch.arange(K, device=updates.device)[:, None]
    keep = (ranks >= t[..., None, None]) & (ranks < (v - t)[..., None, None])
    denom = torch.clamp((v - 2 * t).to(updates.dtype), min=1.0)
    out = torch.where(keep, srt, torch.zeros_like(srt)).sum(-2) / denom[..., None]
    return torch.where((v > 0)[..., None], out, torch.zeros_like(out)), valid


def _masked_sq_dists(updates: Tensor, valid: Tensor) -> Tensor:
    vpair = valid[..., :, None] & valid[..., None, :]
    return torch.where(vpair, pairwise_sq_dists(updates), torch.inf)


def _krum_scores_dyn(updates: Tensor, valid: Tensor, f: int) -> Tensor:
    """Krum scores over the valid peers; invalid candidates score +inf."""
    scores = krum_scores_from_sq_dists_dyn(_masked_sq_dists(updates, valid), f,
                                           valid.sum(-1))
    return torch.where(valid, scores, torch.inf)


def krum_agg_dyn(updates: Tensor, valid: Tensor, f: int = 2) -> Tuple[Tensor, Tensor]:
    valid = valid.to(torch.bool)
    best = torch.argmin(_krum_scores_dyn(updates, valid, f), dim=-1, keepdim=True)
    mask = (torch.arange(updates.shape[-2], device=updates.device) == best) & valid
    return masked_mean(updates, mask), mask


def multi_krum_agg_dyn(updates: Tensor, valid: Tensor, f: int = 2,
                       m: Optional[Union[int, Tensor]] = None) -> Tuple[Tensor, Tensor]:
    """Multi-Krum on the valid peers: keep the ``min(m, v)`` best scores
    (``max(v // 4, 1)`` when ``m`` is None; ``m`` may be per-node)."""
    valid = valid.to(torch.bool)
    v = valid.sum(-1)
    keep = (torch.clamp(v // 4, min=1) if m is None
            else torch.minimum(torch.as_tensor(m, device=v.device), v))
    mask = smallest_k_mask_dyn(_krum_scores_dyn(updates, valid, f), keep) & valid
    return masked_mean(updates, mask), mask


def clustering_agg_dyn(updates: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor]:
    valid = valid.to(torch.bool)
    D = torch.where(valid[..., :, None] & valid[..., None, :],
                    cosine_distance_matrix(updates), torch.inf)
    mask = clustering_select_from_dist_dyn(D, valid)
    return masked_mean(updates, mask), mask


# valid-masked registry: AGGREGATORS' keyword convention after ``valid``
DYN_AGGREGATORS: Dict[str, Callable[..., Tuple[Tensor, Tensor]]] = {
    "mean": lambda u, v, **kw: mean_agg_dyn(u, v),
    "median": lambda u, v, **kw: median_agg_dyn(u, v),
    "trimmed_mean": lambda u, v, **kw: trimmed_mean_agg_dyn(u, v, beta=kw.get("beta", 0.1)),
    "krum": lambda u, v, **kw: krum_agg_dyn(u, v, f=kw.get("f", 2)),
    "multi_krum": lambda u, v, **kw: multi_krum_agg_dyn(u, v, f=kw.get("f", 2),
                                                        m=kw.get("m")),
    "clustering": lambda u, v, **kw: clustering_agg_dyn(u, v),
}

AGGREGATORS: Dict[str, Callable[..., Tuple[Tensor, Tensor]]] = {
    "mean": lambda u, **kw: mean_agg(u),
    "median": lambda u, **kw: median_agg(u),
    "trimmed_mean": lambda u, **kw: trimmed_mean_agg(u, beta=kw.get("beta", 0.1)),
    "krum": lambda u, **kw: krum_agg(u, f=kw.get("f", 2)),
    "multi_krum": lambda u, **kw: multi_krum_agg(u, f=kw.get("f", 2), m=kw.get("m")),
    "clustering": lambda u, **kw: clustering_agg(u),
}
