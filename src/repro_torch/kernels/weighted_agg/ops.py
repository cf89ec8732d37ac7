"""Public wrappers of the WFAgg-E combine kernels (port of
``repro.kernels.weighted_agg.ops``): ``weighted_agg`` for one node and the
gather-free ``weighted_agg_indexed`` for every node of a gossip round.

The O(K) coefficients (``wsum``, ``w_norm``, ``eff_alpha``) are computed
as the reference does (``core.trust.combine_coefficients``) and stay on
the tensors' device: the kernels read ``wvec`` and ``lcoef`` through
pointers, so no value comes back to the host.  Dispatch is by the
tensors' device alone: CUDA tensors go to the hand-written kernels
(``kernel.weighted_agg_cuda``, ``kernel.weighted_agg_indexed_cuda``), and
a failed build or launch raises; CPU tensors go to ``weighted_agg_plain``
/ ``weighted_agg_indexed_plain``.  The plain versions take the kernels'
order: ``round(lcoef * local)``, then each slot's rounded product added
in slot order, so a kernel equals its plain version bit for bit on the
card.  The kernels read rows of any width in place: the only tensor a
wrapper allocates at the width of the rows is its output.
"""
from __future__ import annotations

import torch

from repro_torch.core import trust
from repro_torch.kernels.common import check_table
from repro_torch.kernels.weighted_agg import kernel


def weighted_agg_plain(wvec: torch.Tensor, lcoef: torch.Tensor,
                       local: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    """``lcoef * local + sum_k wvec[k] * updates[k]`` in plain PyTorch, in
    ``csrc/weighted_agg.cu``'s order: ``lcoef * local``, then each slot's
    product added for k = 0 .. K-1, every op rounded to float32."""
    out = lcoef * local.to(torch.float32)
    for k in range(updates.shape[0]):
        out = out + wvec[k] * updates[k].to(torch.float32)
    return out


def weighted_agg(local: torch.Tensor, updates: torch.Tensor,
                 weights: torch.Tensor, alpha: float = 0.8) -> torch.Tensor:
    """Eq. 3 for one node: ``(1 - a) local + a sum_k w'_k updates[k]`` with
    ``local (d,)``, ``updates (K, d)``, ``weights (K,)``."""
    if updates.ndim != 2 or local.shape != updates.shape[1:] \
            or weights.shape != updates.shape[:1]:
        raise ValueError(f"expected local (d,), updates (K, d), weights (K,); "
                         f"got {tuple(local.shape)}, {tuple(updates.shape)}, "
                         f"{tuple(weights.shape)}")
    wvec, lcoef = trust.combine_coefficients(weights.to(torch.float32), alpha)
    lcoef = lcoef.reshape(1)
    dev = updates.device
    if dev.type == "cpu":
        return weighted_agg_plain(wvec, lcoef, local, updates)
    if dev.type != "cuda":
        raise ValueError(f"weighted_agg runs on cuda or cpu, not {dev}")
    return kernel.weighted_agg_cuda(wvec.contiguous(), lcoef,
                                    local.to(torch.float32).contiguous(),
                                    updates.to(torch.float32).contiguous())


def weighted_agg_indexed_plain(wvec: torch.Tensor, lcoef: torch.Tensor,
                               local: torch.Tensor, models: torch.Tensor,
                               neighbor_idx: torch.Tensor) -> torch.Tensor:
    """``lcoef[n] * local[n] + sum_k wvec[n, k] * models[idx[n, k]]`` in plain
    PyTorch: gathered, then ``csrc/weighted_agg_indexed.cu``'s order,
    ``lcoef * local`` and each slot's product added for k = 0 .. K-1, every
    op rounded to float32."""
    u = models[neighbor_idx.long()].to(torch.float32)         # (N, K, d)
    out = lcoef[:, None] * local.to(torch.float32) + wvec[:, 0, None] * u[:, 0]
    for k in range(1, u.shape[1]):
        out = out + wvec[:, k, None] * u[:, k]
    return out


def weighted_agg_indexed(local: torch.Tensor, models: torch.Tensor,
                         neighbor_idx: torch.Tensor, weights: torch.Tensor,
                         alpha: float = 0.8) -> torch.Tensor:
    """Gather-free Eq. 3 for every node of a gossip round: ``out[n] = (1 -
    a_n) local[n] + a_n sum_k w'_nk models[idx[n, k]]`` with ``local (N,
    d)``, ``models (M, d)``, ``neighbor_idx (N, K)`` and trust ``weights
    (N, K)`` (0 on invalid slots).  A node whose weights sum to zero keeps
    its local model.  Any K on the CPU; K <= ``kernel.MAX_K`` (1,024) on the
    card, where the kernel raises past it."""
    N, K = neighbor_idx.shape
    M, d = models.shape
    if local.shape != (N, d) or weights.shape != (N, K):
        raise ValueError(f"expected local (N, d), models (M, d), neighbor_idx "
                         f"(N, K), weights (N, K); got {tuple(local.shape)}, "
                         f"{tuple(models.shape)}, {tuple(neighbor_idx.shape)}, "
                         f"{tuple(weights.shape)}")
    dev = models.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"weighted_agg_indexed runs on cuda or cpu, not {dev}")
    check_table(neighbor_idx, M)
    wvec, lcoef = trust.combine_coefficients(weights.to(torch.float32), alpha)
    if dev.type == "cpu":
        return weighted_agg_indexed_plain(wvec, lcoef, local, models, neighbor_idx)
    return kernel.weighted_agg_indexed_cuda(
        wvec.contiguous(), lcoef.contiguous(), local.to(torch.float32).contiguous(),
        models.to(torch.float32).contiguous(), neighbor_idx.to(torch.int32).contiguous())
