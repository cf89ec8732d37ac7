"""WFAgg trust-weight derivation from O(K) sufficient statistics (port of
``repro.core.trust``).

The scoring stage of WFAgg (Alg. 1 lines 9-22 plus the valid-aware
filter masks).  The CUDA round kernel
(``kernels/robust_stats/csrc/wfagg_round.cu``) runs the same logic in
its epilogue; this module is the plain version that the CPU path, the
reference backend and the tests use.  Every function takes statistics
with a leading N axis: ``(N, K)`` per-candidate values, ``(N,)``
per-node values.

``cfg`` arguments are duck-typed ``core.wfagg.WFAggConfig`` instances and
``stats`` arguments duck-typed ``RobustStats`` containers.  The Alt-WFAgg
filters (Multi-Krum, Clustering) read a (K, K) candidate Gram: the
single-node masks take it as an argument, as the reference's do; the
batched ``*_valid`` masks read it from ``stats.gram`` (N, K, K).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core import aggregators as agg

Tensor = torch.Tensor
RobustStats = Any   # duck-typed: .dist2/.norm2/.cosine_to_median()/...
_EPS = 1e-12


def wfagg_scores(mask_d: Tensor, mask_c: Tensor, mask_t: Tensor, cfg) -> Tensor:
    """Alg. 1 lines 9-22: tau-weighted filter votes with a 2-filter floor."""
    w = (cfg.tau1 * mask_d.to(torch.float32)
         + cfg.tau2 * mask_c.to(torch.float32)
         + cfg.tau3 * mask_t.to(torch.float32))
    return torch.where(w < cfg.accept_threshold - 1e-9,
                       torch.zeros_like(w), w)


def ewma_mean_std(hist: Tensor, count: Tensor, decay: float
                  ) -> Tuple[Tensor, Tensor]:
    """Exponentially weighted mean/std over ring buffers ``hist (N, W, K)``
    (index 0 most recent); entries at or beyond ``count (N,)`` are
    masked.  Returns ``(mu, sd)``, each (N, K)."""
    W = hist.shape[-2]
    ages = torch.arange(W, dtype=torch.float32, device=hist.device)
    live = ages < count.to(torch.float32)[..., None]           # (N, W)
    w = torch.where(live, decay ** ages, torch.zeros_like(ages))
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=_EPS)
    mu = (w[..., None] * hist).sum(-2)
    var = (w[..., None] * (hist - mu[..., None, :]) ** 2).sum(-2)
    return mu, torch.sqrt(torch.clamp(var, min=0.0))


def push_history(hist_s: Tensor, hist_b: Tensor, count: Tensor, t: Tensor,
                 s_t: Tensor, b_t: Tensor
                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """WFAgg-T ring-buffer advance (most recent at index 0, count capped
    at the window W), batched over the leading N axis."""
    W = hist_s.shape[-2]
    hist_s = torch.cat([s_t[..., None, :], hist_s[..., :-1, :]], dim=-2)
    hist_b = torch.cat([b_t[..., None, :], hist_b[..., :-1, :]], dim=-2)
    return hist_s, hist_b, torch.clamp(count + 1, max=W), t + 1


def temporal_bands(hist_s: Tensor, hist_b: Tensor, count: Tensor, t: Tensor,
                   cfg) -> Tensor:
    """The WFAgg-T acceptance bands as a flat ``(N, 4K)`` tensor
    ``[lo_d | hi_d | lo_c | hi_c]``.

    A candidate passes iff ``lo_d <= s_t <= hi_d`` and ``lo_c <= b_t <=
    hi_c``.  The transient / empty-history gate folds into the bands:
    inactive nodes get ``(+inf, -inf)`` bands no finite metric satisfies,
    so the in-kernel test is four compares with no extra flag input.
    """
    mu_d, sd_d = ewma_mean_std(hist_s, count, cfg.ewma_decay)
    mu_c, sd_c = ewma_mean_std(hist_b, count, cfg.ewma_decay)
    active = ((t > cfg.transient) & (count > 0))[..., None]
    inf = torch.full_like(mu_d, torch.inf)
    return torch.cat([
        torch.where(active, mu_d - sd_d, inf),
        torch.where(active, mu_d + sd_d, -inf),
        torch.where(active, mu_c - sd_c, inf),
        torch.where(active, mu_c + sd_c, -inf),
    ], dim=-1)


def needs_gram(cfg) -> bool:
    """True when an Alt-WFAgg filter consumes the (K, K) candidate Gram."""
    return cfg.distance_filter == "multi_krum" or cfg.similarity_filter == "clustering"


def sq_dists_from_gram(gram: Tensor, norm2: Tensor) -> Tensor:
    """(..., K, K) squared distances from a Gram matrix and squared norms;
    the self-distance, where the expansion cancels, is pinned to 0."""
    d2 = norm2[..., :, None] + norm2[..., None, :] - 2.0 * gram
    K = gram.shape[-1]
    d2 = d2 * (1.0 - torch.eye(K, dtype=d2.dtype, device=d2.device))
    return torch.clamp(d2, min=0.0)


def cosine_dist_from_gram(gram: Tensor, norm2: Tensor) -> Tensor:
    """(..., K, K) cosine distances from a Gram matrix and squared norms."""
    n = torch.sqrt(torch.clamp(norm2, min=_EPS))
    return 1.0 - gram / torch.clamp(n[..., :, None] * n[..., None, :], min=_EPS)


def multi_krum_m(cfg, K: int) -> int:
    """Multi-Krum's keep count m: the configured one, else max(1, K // 4)."""
    return cfg.multi_krum_m or max(1, K // 4)


def fused_distance_mask(stats: RobustStats, gram: Optional[Tensor], cfg) -> Tensor:
    """One node's distance-filter mask ``(K,)`` from its statistics:
    WFAgg-D keeps the K - f - 1 candidates closest to the median;
    Multi-Krum keeps the m best Krum scores of the Gram's distances."""
    K = stats.dist2.shape[-1]
    if cfg.distance_filter == "wfagg_d":
        return agg.smallest_k_mask(stats.dist2, K - int(cfg.f) - 1)
    if cfg.distance_filter == "multi_krum":
        scores = agg.krum_scores_from_sq_dists(
            sq_dists_from_gram(gram, stats.norm2), cfg.f)
        return agg.smallest_k_mask(scores, multi_krum_m(cfg, K))
    raise ValueError(f"unknown distance filter {cfg.distance_filter!r}")


def fused_similarity_mask(stats: RobustStats, gram: Optional[Tensor], cfg) -> Tensor:
    """One node's similarity-filter mask ``(K,)``: WFAgg-C ranks the cosine
    to the median (invariant to the norm clipping of Alg. 3, so the same
    selection as ``wfagg_c_select``); Clustering keeps the larger cluster
    of the Gram's cosine distances."""
    K = stats.dist2.shape[-1]
    if cfg.similarity_filter == "wfagg_c":
        return agg.smallest_k_mask(stats.cosine_to_median(), K - int(cfg.f) - 1)
    if cfg.similarity_filter == "clustering":
        return agg.clustering_select_from_dist(cosine_dist_from_gram(gram, stats.norm2))
    raise ValueError(f"unknown similarity filter {cfg.similarity_filter!r}")


def fused_distance_mask_valid(stats: RobustStats, valid: Tensor, cfg) -> Tensor:
    """Valid-aware distance mask ``(N, K)``: keep counts follow each node's
    true degree v, and padded slots score +inf and are never selected.
    WFAgg-D keeps the ``v - f - 1`` valid candidates closest to the median;
    Multi-Krum the ``min(m, v)`` best Krum scores over the valid peers."""
    K = valid.shape[-1]
    v = valid.sum(-1)
    if cfg.distance_filter == "wfagg_d":
        scores = torch.where(valid, stats.dist2, torch.inf)
        return agg.smallest_k_mask_dyn(scores, v - int(cfg.f) - 1)
    if cfg.distance_filter == "multi_krum":
        d2 = sq_dists_from_gram(stats.gram, stats.norm2)
        vpair = valid[..., :, None] & valid[..., None, :]
        scores = agg.krum_scores_from_sq_dists_dyn(
            torch.where(vpair, d2, torch.inf), cfg.f, v)
        return agg.smallest_k_mask_dyn(torch.where(valid, scores, torch.inf),
                                       torch.clamp(v, max=multi_krum_m(cfg, K)))
    raise ValueError(f"unknown distance filter {cfg.distance_filter!r}")


def fused_similarity_mask_valid(stats: RobustStats, valid: Tensor, cfg) -> Tensor:
    """Valid-aware similarity mask ``(N, K)`` (see
    ``fused_distance_mask_valid``): WFAgg-C by cosine to the median, or
    Clustering on the valid submatrix of the Gram's cosine distances."""
    v = valid.sum(-1)
    if cfg.similarity_filter == "wfagg_c":
        scores = torch.where(valid, stats.cosine_to_median(), torch.inf)
        return agg.smallest_k_mask_dyn(scores, v - int(cfg.f) - 1)
    if cfg.similarity_filter == "clustering":
        return agg.clustering_select_from_dist_dyn(
            cosine_dist_from_gram(stats.gram, stats.norm2), valid)
    raise ValueError(f"unknown similarity filter {cfg.similarity_filter!r}")


def derive_trust_weights(
    stats: RobustStats,
    valid: Tensor,             # (N, K) bool or 0/1 float, True on real edges
    tbands: Optional[Tensor],  # (N, 4K) from temporal_bands, or None
    cfg,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The WFAgg scoring stage: ``(mask_d, mask_c, mask_t, weights)``.

    ``weights`` already carries the valid mask (padded slots weigh 0), so
    a degree-0 node scores an all-zero vector and keeps its local model.
    """
    valid_b = valid.to(torch.bool)
    mask_d = fused_distance_mask_valid(stats, valid_b, cfg)
    mask_c = fused_similarity_mask_valid(stats, valid_b, cfg)
    if tbands is None:
        mask_t = torch.zeros_like(valid_b)
    else:
        K = valid_b.shape[-1]
        lo_d, hi_d, lo_c, hi_c = (tbands[..., i * K:(i + 1) * K]
                                  for i in range(4))
        s_t = stats.prev_dist2
        b_t = stats.cosine_to_prev()
        mask_t = ((s_t >= lo_d) & (s_t <= hi_d)
                  & (b_t >= lo_c) & (b_t <= hi_c) & valid_b)
    weights = wfagg_scores(mask_d, mask_c, mask_t, cfg) * valid_b.to(torch.float32)
    return mask_d, mask_c, mask_t, weights


def combine_coefficients(weights: Tensor, alpha: float,
                         valid: Optional[Tensor] = None,
                         mean_fallback: bool = False) -> Tuple[Tensor, Tensor]:
    """Normalize trust weights into the WFAgg-E combine coefficients:
    returns ``(alpha_eff * w_norm (..., K), 1 - alpha_eff (...))`` for one
    node's ``(K,)`` weights or a batch's ``(N, K)``.

    ``mean_fallback=True`` is the robust all-reduce convention: when every
    candidate is rejected the combine degrades to the uniform mean of the
    valid candidates (``valid`` is read only then).  False is the DFL /
    Eq. 3 convention: the node keeps its local model.
    """
    wsum = weights.sum(-1)
    w_norm = weights / torch.clamp(wsum, min=_EPS)[..., None]
    zero = torch.zeros_like(wsum)
    if mean_fallback:
        valid_f = valid.to(torch.float32)
        vsum = valid_f.sum(-1)
        uniform = valid_f / torch.clamp(vsum, min=1.0)[..., None]
        w_norm = torch.where((wsum > 0)[..., None], w_norm, uniform)
        # an all-invalid (degree-0) slate has no mean to fall back to:
        # keep the local anchor rather than emitting zeros
        eff_alpha = torch.where(vsum > 0, zero + alpha, zero)
    else:
        eff_alpha = torch.where(wsum > 0, zero + alpha, zero)
    return eff_alpha[..., None] * w_norm, 1.0 - eff_alpha
