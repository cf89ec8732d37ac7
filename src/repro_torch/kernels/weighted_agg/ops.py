"""Public wrapper of the single-node WFAgg-E combine kernel (port of
``repro.kernels.weighted_agg.ops.weighted_agg``).

The O(K) coefficients (``wsum``, ``w_norm``, ``eff_alpha``) are computed
as the reference does (``core.trust.combine_coefficients``) and stay on
the tensors' device: the kernel reads ``wvec`` and ``lcoef`` through
pointers, so no value comes back to the host.  Dispatch is by the tensors' device alone: CUDA tensors
go to the hand-written kernel (``kernel.weighted_agg_cuda``), and a failed
build or launch raises; CPU tensors go to ``weighted_agg_plain``.
"""
from __future__ import annotations

import torch

from repro_torch.core import trust
from repro_torch.kernels.common import pad_d
from repro_torch.kernels.weighted_agg import kernel

# the kernel reads float4: rows padded to whole 16-byte vectors (zero
# padding is exact, see common.pad_d)
_VEC = 4


def weighted_agg_plain(wvec: torch.Tensor, lcoef: torch.Tensor,
                       local: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    """``lcoef * local + sum_k wvec[k] * updates[k]`` in plain PyTorch, k in
    the kernel's order."""
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
    d = updates.shape[1]
    out = kernel.weighted_agg_cuda(wvec.contiguous(), lcoef,
                                   pad_d(local, _VEC).contiguous(),
                                   pad_d(updates, _VEC).contiguous())
    return out[:d]
