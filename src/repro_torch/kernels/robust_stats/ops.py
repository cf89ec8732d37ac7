"""Public wrapper of the single-launch WFAgg round (port of
``repro.kernels.robust_stats.ops.wfagg_round_indexed``).

Dispatch is by the tensors' device alone: CUDA tensors go to the
hand-written kernel (``kernel.wfagg_round_indexed_cuda``), and a failed
build or launch raises; CPU tensors go to ``wfagg_round_indexed_plain``,
the same function in plain PyTorch.  There is no fallback from one to
the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import trust
from repro_torch.kernels.common import pad_d
from repro_torch.kernels.robust_stats import kernel
from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

# rows padded to whole 128-byte lines, so every neighbour row the kernel
# reads starts aligned (zero padding is exact, see common.pad_d)
_ROW_ALIGN = 32


def wfagg_round_indexed_plain(local, models, neighbor_idx, valid, cfg,
                              prev=None, tbands=None, alpha=None,
                              mean_fallback=False):
    """The round in plain PyTorch: gather, valid-masked median at the
    dynamic middles, the ported ``trust`` scoring stage, and the combine
    in the kernel's slot order.  Same arguments and returns as
    ``wfagg_round_indexed`` (``valid`` a (N, K) bool tensor, ``tbands``
    flat (N, 4K))."""
    alpha = cfg.alpha if alpha is None else alpha
    K = neighbor_idx.shape[1]
    stats = robust_stats_indexed_ref(models, neighbor_idx, valid, prev)
    mask_d, mask_c, mask_t, weights = trust.derive_trust_weights(
        stats, valid, tbands, cfg)
    wcomb, lcoef = trust.combine_coefficients(weights, alpha, valid,
                                              mean_fallback)
    u = models[neighbor_idx.long()].to(torch.float32)
    out = lcoef[:, None] * local.to(torch.float32) + wcomb[:, 0, None] * u[:, 0]
    for k in range(1, K):
        out = out + wcomb[:, k, None] * u[:, k]
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
    (``mednorm2`` (N,)); the caller pushes the WFAgg-T ring buffers from
    its temporal tail.  ``mean_fallback`` selects the all-rejected
    behaviour: local model (DFL, Eq. 3) or uniform valid mean.
    """
    if tbands is not None and prev is None:
        raise ValueError(
            "tbands requires prev: the in-kernel WFAgg-T band compare "
            "reads the kernel's own prev_dist2/cosine temporal statistics")
    if prev_idx is not None:
        raise NotImplementedError(
            "prev_idx (the chaos transport's staleness re-keying) is not "
            "ported yet: ROADMAP queue 2, item 1 (prev_idx variant)")
    if prev is not None and prev.ndim != 2:
        raise NotImplementedError(
            "per-edge (N, K, d) prev is not ported yet: ROADMAP queue 2, "
            "item 1 (per-edge prev variant); pass the (M, d) matrix")
    if trust.needs_gram(cfg):
        raise NotImplementedError(trust.GRAM_NOT_PORTED)
    alpha = cfg.alpha if alpha is None else float(alpha)
    N, K = neighbor_idx.shape
    M, d = models.shape
    dev = models.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"wfagg_round_indexed runs on cuda or cpu, not {dev}")
    # the kernel reads rows through the table: reject out-of-range rows
    # before any pointer is passed (one host read of two integers)
    lo, hi = (int(x) for x in torch.aminmax(neighbor_idx))
    if lo < 0 or hi >= M:
        raise ValueError(f"neighbor_idx holds rows in [{lo}, {hi}], outside "
                         f"[0, {M}) of the model matrix")
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
