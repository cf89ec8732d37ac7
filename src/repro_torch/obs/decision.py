"""Decision plane: the packed per-edge filter-verdict record (port of
``repro.obs.decision``).

Bit layout of the (…, K) uint8 ``verdict`` (bit SET = the edge passed
that test; a filter rejection is ``valid & ~bit``):

    bit 0  accepted by the distance filter (mask_d)
    bit 1  accepted by the similarity filter (mask_c)
    bit 2  accepted by the temporal filter (mask_t)
    bit 3  the edge exists this round (padded slates)
    bit 4  final verdict: positive trust weight

The chaos-transport bits 5-7 come with ROADMAP queue 1, item 8.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

Tensor = torch.Tensor

_EPS = 1e-12


class DecisionRecord(NamedTuple):
    """One round's filter decisions, leading axes as the call site has
    them ((N,) per node for a gossip round)."""
    verdict: Tensor        # (..., K) uint8 packed per-edge bitmask
    accepted: Tensor       # (...,)   int32 accepted-neighbor count
    mean_fallback: Tensor  # (...,)   bool: valid neighbors existed, ALL rejected
    degree_zero: Tensor    # (...,)   bool: no valid neighbors at all
    entropy: Tensor        # (...,)   f32 entropy (nats) of normalized trust weights


def pack_verdict(mask_d: Tensor, mask_c: Tensor, mask_t: Tensor,
                 valid: Tensor, accepted: Tensor) -> Tensor:
    """Pack five boolean (…, K) masks into one uint8 bitmask."""
    u8 = lambda m: m.to(torch.uint8)  # noqa: E731 — bool->uint8, no floats
    return (u8(mask_d)
            | (u8(mask_c) << 1)
            | (u8(mask_t) << 2)
            | (u8(valid) << 3)
            | (u8(accepted) << 4))


def record_from_masks(mask_d: Tensor, mask_c: Tensor, mask_t: Tensor,
                      valid: Tensor, weights: Tensor) -> DecisionRecord:
    """Build the record from the raw filter masks + trust weights.

    ``mean_fallback`` means the node had valid neighbours but the vote
    rejected all of them (it keeps its local model); ``degree_zero`` means
    there was nothing to aggregate.
    """
    valid_b = valid.to(torch.bool)
    acc = (weights > 0) & valid_b
    verdict = pack_verdict(mask_d.to(torch.bool), mask_c.to(torch.bool),
                           mask_t.to(torch.bool), valid_b, acc)
    degree = valid_b.sum(-1)
    n_accepted = acc.sum(-1).to(torch.int32)
    wsum = (weights * valid_b).sum(-1)
    mean_fallback = (degree > 0) & (wsum <= 0)
    # entropy of the normalized trust distribution (0 log 0 := 0; all
    # rejected := 0)
    p = (weights * valid_b) / torch.clamp(wsum, min=_EPS)[..., None]
    ent = -torch.where(p > 0, p * torch.log(torch.clamp(p, min=_EPS)),
                       torch.zeros_like(p)).sum(-1)
    ent = torch.where(wsum > 0, ent, torch.zeros_like(ent)).to(torch.float32)
    return DecisionRecord(verdict=verdict, accepted=n_accepted,
                          mean_fallback=mean_fallback,
                          degree_zero=degree == 0, entropy=ent)


def record_from_info(info: Dict[str, Tensor],
                     valid: Optional[Tensor] = None) -> DecisionRecord:
    """Build the record from a WFAgg ``info`` dict.  ``valid`` falls back
    to info's, then to all-true."""
    if valid is None:
        valid = info.get("valid")
    w = info["weights"]
    if valid is None:
        valid = torch.ones(w.shape, dtype=torch.bool, device=w.device)
    return record_from_masks(info["mask_d"], info["mask_c"], info["mask_t"],
                             valid, w)


def record_uniform(valid: Tensor) -> DecisionRecord:
    """Record for aggregators with no per-edge filter verdicts (the mean
    baseline): every valid edge counts as accepted with uniform weight,
    the three filter bits stay 0, and degree-0 is still tracked."""
    valid_b = valid.to(torch.bool)
    zeros = torch.zeros_like(valid_b)
    verdict = pack_verdict(zeros, zeros, zeros, valid_b, valid_b)
    degree = valid_b.sum(-1)
    return DecisionRecord(
        verdict=verdict,
        accepted=degree.to(torch.int32),
        mean_fallback=torch.zeros_like(degree, dtype=torch.bool),
        degree_zero=degree == 0,
        entropy=torch.where(
            degree > 0,
            torch.log(torch.clamp(degree.to(torch.float32), min=1.0)),
            torch.zeros(degree.shape, device=degree.device)),
    )
