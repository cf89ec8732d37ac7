"""Public wrappers of the robust-statistics kernels (port of
``repro.kernels.robust_stats.ops``): ``robust_stats`` over one (K, d)
candidate matrix, the gather-free ``robust_stats_indexed`` of a gossip
round and the single-launch round ``wfagg_round_indexed``.

Dispatch is by the tensors' device alone: CUDA tensors go to the
hand-written kernel (``kernel.robust_stats_cuda``,
``kernel.robust_stats_indexed_cuda``, ``kernel.wfagg_round_indexed_cuda``),
and a failed build or launch raises; CPU tensors go to
``robust_stats_plain`` / ``ref.robust_stats_indexed_ref`` /
``wfagg_round_indexed_plain``, the same functions in plain PyTorch.
There is no fallback from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import trust
from repro_torch.kernels.common import check_table, pad_d
from repro_torch.kernels.robust_stats import kernel
from repro_torch.kernels.robust_stats.ref import (
    RobustStats, center_stats, median_and_trim, robust_stats_indexed_ref,
    sort_columns)
from repro_torch.kernels.weighted_agg.ops import weighted_agg_indexed_plain

# rows padded to whole 128-byte lines, so every neighbour row the kernel
# reads starts aligned (zero padding is exact, see common.pad_d)
_ROW_ALIGN = 32


def robust_stats_plain(updates: torch.Tensor, prev: Optional[torch.Tensor] = None,
                       beta: float = 0.1, need_center: bool = True) -> RobustStats:
    """The single-matrix statistics in plain PyTorch, as the kernel
    computes them: a column holding a NaN sorts to all NaN (the kernel's
    network propagates NaN like ``jnp.minimum``, as the Pallas kernel's
    does), so its median and trimmed mean are NaN."""
    u = updates.to(torch.float32)
    med, trim = median_and_trim(sort_columns(u), beta)
    if not need_center:
        return center_stats(u, None, None, prev, center=med)
    return center_stats(u, med, trim, prev)


def robust_stats(
    updates: torch.Tensor,                   # (K, d) candidate matrix
    prev: Optional[torch.Tensor] = None,     # (K, d) previous-round rows
    beta: float = 0.1,
    need_center: bool = True,
) -> RobustStats:
    """Median / trimmed-mean / WFAgg filter statistics over (K, d) in one
    pass.  With ``prev`` the WFAgg-T temporal tail (prev_dist2 / prev_dot /
    prev_norm2) comes too; ``need_center=False`` skips the (d,)-sized
    median and trimmed mean (``med``/``trim`` come back None).  K <= 32 on
    every device (the kernel's limit)."""
    if updates.ndim != 2:
        raise ValueError(f"updates must be (K, d), got {tuple(updates.shape)}")
    K = updates.shape[0]
    if K > kernel.MAX_K:
        raise ValueError(
            f"robust_stats takes at most {kernel.MAX_K} candidates, got K={K} "
            "(CFL with more than 32 nodes: ROADMAP queue 2, item 4)")
    if prev is not None and prev.shape != updates.shape:
        raise ValueError(f"prev has shape {tuple(prev.shape)}, expected "
                         f"{tuple(updates.shape)}")
    dev = updates.device
    if dev.type == "cpu":
        return robust_stats_plain(updates, prev, beta, need_center)
    if dev.type != "cuda":
        raise ValueError(f"robust_stats runs on cuda or cpu, not {dev}")
    p = prev.to(torch.float32).contiguous() if prev is not None else None
    return kernel.robust_stats_cuda(updates.to(torch.float32).contiguous(), p,
                                    beta, need_center)


def _check_prev_form(prev: Optional[torch.Tensor],
                     prev_idx: Optional[torch.Tensor], kernel_name: str) -> None:
    if prev_idx is not None:
        raise NotImplementedError(
            f"prev_idx (the chaos transport's staleness re-keying) is not "
            f"ported yet in {kernel_name}: ROADMAP queue 2, item 1 (prev_idx "
            "variant)")
    if prev is not None and prev.ndim != 2:
        raise NotImplementedError(
            f"per-edge (N, K, d) prev is not ported yet in {kernel_name}: "
            "ROADMAP queue 2, item 1 (per-edge prev variant); pass the (M, d) "
            "matrix")


def robust_stats_indexed(
    models: torch.Tensor,                   # (M, d) model matrix
    neighbor_idx: torch.Tensor,             # (N, K) rows into models
    valid: Optional[torch.Tensor] = None,   # (N, K) bool; None = all valid
    prev: Optional[torch.Tensor] = None,    # (M, d) previous model matrix
    need_gram: bool = False,
    prev_idx: Optional[torch.Tensor] = None,
) -> RobustStats:
    """Gather-free batched statistics of a gossip round: the valid-masked
    median of each node's K neighbour rows ``models[idx[n]]`` and the
    per-candidate sums about it (``RobustStats`` with (N, K) fields,
    ``mednorm2`` (N,), ``med``/``trim`` None), with ``prev`` the WFAgg-T
    tail read through the same table, and with ``need_gram`` each node's
    (K, K) candidate Gram in ``gram``.  Statistics of padded slots are
    finite values the caller masks with ``valid``.  K <= 32."""
    _check_prev_form(prev, prev_idx, "robust_stats_indexed")
    N, K = neighbor_idx.shape
    M, d = models.shape
    if K > kernel.MAX_K:
        raise ValueError(f"robust_stats_indexed takes at most {kernel.MAX_K} "
                         f"neighbours, got K={K}")
    if prev is not None and prev.shape != models.shape:
        raise ValueError(f"prev has shape {tuple(prev.shape)}, expected "
                         f"{tuple(models.shape)}")
    dev = models.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"robust_stats_indexed runs on cuda or cpu, not {dev}")
    check_table(neighbor_idx, M)
    v = (torch.ones((N, K), dtype=torch.bool, device=dev) if valid is None
         else valid.to(torch.bool))
    if dev.type == "cpu":
        return robust_stats_indexed_ref(models, neighbor_idx, v, prev, need_gram)
    p = prev.to(torch.float32).contiguous() if prev is not None else None
    return kernel.robust_stats_indexed_cuda(
        models.to(torch.float32).contiguous(),
        neighbor_idx.to(torch.int32).contiguous(), v.contiguous(), p, need_gram)


def wfagg_round_indexed_plain(local, models, neighbor_idx, valid, cfg,
                              prev=None, tbands=None, alpha=None,
                              mean_fallback=False):
    """The round in plain PyTorch: gather, valid-masked median at the
    dynamic middles, the ported ``trust`` scoring stage, and the combine
    in the kernel's slot order.  Same arguments and returns as
    ``wfagg_round_indexed`` (``valid`` a (N, K) bool tensor, ``tbands``
    flat (N, 4K))."""
    alpha = cfg.alpha if alpha is None else alpha
    stats = robust_stats_indexed_ref(models, neighbor_idx, valid, prev,
                                     need_gram=trust.needs_gram(cfg))
    mask_d, mask_c, mask_t, weights = trust.derive_trust_weights(
        stats, valid, tbands, cfg)
    wcomb, lcoef = trust.combine_coefficients(weights, alpha, valid,
                                              mean_fallback)
    out = weighted_agg_indexed_plain(wcomb, lcoef, local, models, neighbor_idx)
    return out, weights, mask_d, mask_c, mask_t, stats


def wfagg_round_indexed(
    local: torch.Tensor,            # (N, d) combine anchors (local models)
    models: torch.Tensor,           # (M, d) model matrix
    neighbor_idx: torch.Tensor,     # (N, K) rows into models
    valid: Optional[torch.Tensor],  # (N, K) bool; None = all valid
    cfg,                            # WFAggConfig (sets the filters)
    prev: Optional[torch.Tensor] = None,     # (M, d) previous model matrix
    tbands: Optional[torch.Tensor] = None,   # (N, 4, K) or (N, 4K) bands
    prev_idx: Optional[torch.Tensor] = None,
    alpha: Optional[float] = None,
    mean_fallback: bool = False,
):
    """One-launch gossip round: valid-masked median and filter statistics,
    the WFAgg scoring stage and the trust-weighted WFAgg-E combine.

    Returns ``(out (N, d), weights (N, K), mask_d, mask_c, mask_t ((N, K)
    bool), stats)`` with ``stats`` a ``RobustStats`` of (N, K) fields
    (``mednorm2`` (N,); with a Multi-Krum or Clustering filter the (N, K, K)
    Gram too); the caller pushes the WFAgg-T ring buffers from its temporal
    tail.  ``mean_fallback`` selects the all-rejected behaviour: local
    model (DFL, Eq. 3) or uniform valid mean.
    """
    if tbands is not None and prev is None:
        raise ValueError(
            "tbands requires prev: the in-kernel WFAgg-T band compare "
            "reads the kernel's own prev_dist2/cosine temporal statistics")
    _check_prev_form(prev, prev_idx, "wfagg_round_indexed")
    alpha = cfg.alpha if alpha is None else float(alpha)
    N, K = neighbor_idx.shape
    M, d = models.shape
    dev = models.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"wfagg_round_indexed runs on cuda or cpu, not {dev}")
    check_table(neighbor_idx, M)
    v = (torch.ones((N, K), dtype=torch.bool, device=dev) if valid is None
         else valid.to(torch.bool))
    tb = tbands.reshape(N, 4 * K).to(torch.float32) if tbands is not None else None
    if dev.type == "cpu":
        return wfagg_round_indexed_plain(local, models, neighbor_idx, v, cfg,
                                         prev, tb, alpha, mean_fallback)
    m = pad_d(models, _ROW_ALIGN).contiguous()
    loc = pad_d(local, _ROW_ALIGN).contiguous()
    p = pad_d(prev, _ROW_ALIGN).contiguous() if prev is not None else None
    out, weights, mask_d, mask_c, mask_t, stats = kernel.wfagg_round_indexed_cuda(
        loc, m, neighbor_idx.to(torch.int32).contiguous(), v.contiguous(), p,
        tb.contiguous() if tb is not None else None, cfg, alpha, mean_fallback)
    return out[:, :d], weights, mask_d, mask_c, mask_t, stats
