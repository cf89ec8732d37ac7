"""Public wrappers of the robust-statistics kernels (port of
``repro.kernels.robust_stats.ops``): ``robust_stats`` over one (K, d)
candidate matrix, ``robust_stats_batch`` over a gathered (N, K, d)
tensor, the gather-free ``robust_stats_indexed`` of a gossip round and the
single-launch round ``wfagg_round_indexed``.  The indexed wrappers take
the WFAgg-T ``prev`` as a matrix (read through the neighbour table or
``prev_idx``) or per edge, (N, K, d).

Dispatch is by the tensors' device alone: CUDA tensors go to the
hand-written kernel (``kernel.robust_stats_cuda``,
``kernel.robust_stats_batch_cuda``, ``kernel.robust_stats_indexed_cuda``,
``kernel.wfagg_round_indexed_cuda``), and a failed build or launch raises;
CPU tensors go to ``robust_stats_plain`` / ``ref.robust_stats_batch_ref``
/ ``ref.robust_stats_indexed_ref`` / ``wfagg_round_indexed_plain``, the
same functions in plain PyTorch.  There is no fallback from one to the
other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import trust
from repro_torch.kernels.common import check_table
from repro_torch.kernels.robust_stats import kernel
from repro_torch.kernels.robust_stats.ref import (
    RobustStats, robust_stats_batch_ref, robust_stats_indexed_ref)
from repro_torch.kernels.weighted_agg.ops import weighted_agg_indexed_plain


def robust_stats_plain(updates: torch.Tensor, prev: Optional[torch.Tensor] = None,
                       beta: float = 0.1, need_center: bool = True) -> RobustStats:
    """The single-matrix statistics in plain PyTorch, as the kernel
    computes them: a column holding a NaN sorts to all NaN (the kernel's
    network propagates NaN like ``jnp.minimum``, as the Pallas kernel's
    does), so its median and trimmed mean are NaN.  The batched plain
    version on one node."""
    return robust_stats_batch_ref(updates, prev, beta, need_center)


def robust_stats(
    updates: torch.Tensor,                   # (K, d) candidate matrix
    prev: Optional[torch.Tensor] = None,     # (K, d) previous-round rows
    beta: float = 0.1,
    need_center: bool = True,
) -> RobustStats:
    """Median / trimmed-mean / WFAgg filter statistics over (K, d) in one
    pass.  With ``prev`` the WFAgg-T temporal tail (prev_dist2 / prev_dot /
    prev_norm2) comes too; ``need_center=False`` skips the (d,)-sized
    median and trimmed mean (``med``/``trim`` come back None).  Any K on
    the CPU; K <= ``kernel.MAX_K`` (1,024) on the card, where the kernel
    raises past it."""
    if updates.ndim != 2:
        raise ValueError(f"updates must be (K, d), got {tuple(updates.shape)}")
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


def robust_stats_batch(
    updates: torch.Tensor,                   # (N, K, d) gathered candidates
    prev: Optional[torch.Tensor] = None,     # (N, K, d) per-edge previous rows
    beta: float = 0.1,
    need_center: bool = True,
) -> RobustStats:
    """``robust_stats`` for every node of a gossip round at once, over the
    gathered (N, K, d) tensor: one launch of the batched kernel.  Every
    ``RobustStats`` field gains a leading N axis (``mednorm2`` (N,);
    ``med``/``trim`` (N, d), None without ``need_center``).  Any K on the
    CPU; K <= ``kernel.MAX_K`` (1,024) on the card."""
    if updates.ndim != 3:
        raise ValueError(f"updates must be (N, K, d), got {tuple(updates.shape)}")
    if prev is not None and prev.shape != updates.shape:
        raise ValueError(f"prev has shape {tuple(prev.shape)}, expected "
                         f"{tuple(updates.shape)}")
    dev = updates.device
    if dev.type == "cpu":
        return robust_stats_batch_ref(updates, prev, beta, need_center)
    if dev.type != "cuda":
        raise ValueError(f"robust_stats_batch runs on cuda or cpu, not {dev}")
    # unpadded rows: the kernel picks its copy width from d and the pointers
    p = None if prev is None else _f32(prev)
    return kernel.robust_stats_batch_cuda(_f32(updates), p, beta, need_center)


def _check_prev(models: torch.Tensor, prev: Optional[torch.Tensor],
                prev_idx: Optional[torch.Tensor], N: int, K: int) -> None:
    """``prev`` is a matrix read through the neighbour table (the model
    matrix's shape) or through ``prev_idx (N, K)`` (any row count, the
    model matrix's width), or a per-edge (N, K, d) tensor (no
    ``prev_idx``); rows of ``prev_idx`` are checked like the neighbour
    table's."""
    if prev is not None and prev.ndim == 3:
        if prev_idx is not None:
            raise ValueError("prev_idx requires a matrix-form prev")
        if prev.shape != (N, K, models.shape[1]):
            raise ValueError(f"per-edge prev has shape {tuple(prev.shape)}, "
                             f"expected {(N, K, models.shape[1])}")
        return
    if prev_idx is not None:
        if prev is None:
            raise ValueError("prev_idx requires prev")
        if prev.shape[1] != models.shape[1]:
            raise ValueError(f"prev has shape {tuple(prev.shape)}, expected "
                             f"(rows, {models.shape[1]})")
        check_table(prev_idx, prev.shape[0], "prev_idx")
    elif prev is not None and prev.shape != models.shape:
        raise ValueError(f"prev has shape {tuple(prev.shape)}, expected "
                         f"{tuple(models.shape)}")


def _i32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.to(torch.int32).contiguous()


def _f32(t: torch.Tensor) -> torch.Tensor:
    """The float32 contiguous tensor a kernel reads (``t`` itself when it
    already is one: no copy)."""
    return t.to(torch.float32).contiguous()


def robust_stats_indexed(
    models: torch.Tensor,                   # (M, d) model matrix
    neighbor_idx: torch.Tensor,             # (N, K) rows into models
    valid: Optional[torch.Tensor] = None,   # (N, K) bool; None = all valid
    prev: Optional[torch.Tensor] = None,    # (M, d) matrix or (N, K, d) per edge
    need_gram: bool = False,
    prev_idx: Optional[torch.Tensor] = None,   # (N, K) rows into a matrix prev
) -> RobustStats:
    """Gather-free batched statistics of a gossip round: the valid-masked
    median of each node's K neighbour rows ``models[idx[n]]`` and the
    per-candidate sums about it (``RobustStats`` with (N, K) fields,
    ``mednorm2`` (N,), ``med``/``trim`` None), with ``prev`` the WFAgg-T
    tail read through the same table (or through ``prev_idx``: the chaos
    transport's last served payload of each edge; or a per-edge (N, K, d)
    tensor, the gathered path's state), and with ``need_gram``
    each node's (K, K) candidate Gram in ``gram``.  Statistics of padded
    slots are finite values the caller masks with ``valid``.  Any K on the
    CPU; K <= ``kernel.INDEXED_MAX_K`` (1,024) on the card, where the
    kernel raises past it."""
    N, K = neighbor_idx.shape
    M, d = models.shape
    dev = models.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"robust_stats_indexed runs on cuda or cpu, not {dev}")
    check_table(neighbor_idx, M)
    _check_prev(models, prev, prev_idx, N, K)
    v = (torch.ones((N, K), dtype=torch.bool, device=dev) if valid is None
         else valid.to(torch.bool))
    if dev.type == "cpu":
        return robust_stats_indexed_ref(models, neighbor_idx, v, prev, need_gram,
                                        prev_idx=prev_idx)
    m = models.to(torch.float32).contiguous()
    p = None if prev is None else (
        m if prev is models else prev.to(torch.float32).contiguous())
    return kernel.robust_stats_indexed_cuda(
        m, _i32(neighbor_idx), v.contiguous(), p, need_gram, prev_idx=_i32(prev_idx))


def wfagg_round_indexed_plain(local, models, neighbor_idx, valid, cfg,
                              prev=None, tbands=None, alpha=None,
                              mean_fallback=False, prev_idx=None):
    """The round in plain PyTorch: gather, valid-masked median at the
    dynamic middles, the ported ``trust`` scoring stage, and the combine
    in the kernel's slot order.  Same arguments and returns as
    ``wfagg_round_indexed`` (``valid`` a (N, K) bool tensor, ``tbands``
    flat (N, 4K))."""
    alpha = cfg.alpha if alpha is None else alpha
    stats = robust_stats_indexed_ref(models, neighbor_idx, valid, prev,
                                     need_gram=trust.needs_gram(cfg),
                                     prev_idx=prev_idx)
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
    prev: Optional[torch.Tensor] = None,     # (M, d) matrix or (N, K, d) per edge
    tbands: Optional[torch.Tensor] = None,   # (N, 4, K) or (N, 4K) bands
    prev_idx: Optional[torch.Tensor] = None,  # (N, K) rows into a matrix prev
    alpha: Optional[float] = None,
    mean_fallback: bool = False,
):
    """One-launch gossip round: valid-masked median and filter statistics,
    the WFAgg scoring stage and the trust-weighted WFAgg-E combine.
    ``prev`` is read through the neighbour table, or through ``prev_idx``
    (the chaos transport's last served payload of each edge; ``prev`` may
    then be ``models`` itself, the stacked matrix, passed once), or is a
    per-edge (N, K, d) tensor (the gathered path's state).

    Returns ``(out (N, d), weights (N, K), mask_d, mask_c, mask_t ((N, K)
    bool), stats)`` with ``stats`` a ``RobustStats`` of (N, K) fields
    (``mednorm2`` (N,); with a Multi-Krum or Clustering filter the (N, K, K)
    Gram too); the caller pushes the WFAgg-T ring buffers from its temporal
    tail.  ``mean_fallback`` selects the all-rejected behaviour: local
    model (DFL, Eq. 3) or uniform valid mean.  Any K on the CPU; K <=
    ``kernel.INDEXED_MAX_K`` (1,024) on the card, where the kernel raises
    past it.
    """
    if tbands is not None and prev is None:
        raise ValueError(
            "tbands requires prev: the in-kernel WFAgg-T band compare "
            "reads the kernel's own prev_dist2/cosine temporal statistics")
    alpha = cfg.alpha if alpha is None else float(alpha)
    N, K = neighbor_idx.shape
    M = models.shape[0]
    dev = models.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"wfagg_round_indexed runs on cuda or cpu, not {dev}")
    check_table(neighbor_idx, M)
    _check_prev(models, prev, prev_idx, N, K)
    v = (torch.ones((N, K), dtype=torch.bool, device=dev) if valid is None
         else valid.to(torch.bool))
    tb = tbands.reshape(N, 4 * K).to(torch.float32) if tbands is not None else None
    if dev.type == "cpu":
        return wfagg_round_indexed_plain(local, models, neighbor_idx, v, cfg,
                                         prev, tb, alpha, mean_fallback, prev_idx)
    # unpadded rows (the kernel picks its copy width from d and the
    # pointers); the chaos round's prev IS its stacked model matrix and is
    # passed as the same pointer
    m = _f32(models)
    p = None if prev is None else (m if prev is models else _f32(prev))
    return kernel.wfagg_round_indexed_cuda(
        _f32(local), m, _i32(neighbor_idx), v.contiguous(), p,
        tb.contiguous() if tb is not None else None, cfg, alpha, mean_fallback,
        prev_idx=_i32(prev_idx))
