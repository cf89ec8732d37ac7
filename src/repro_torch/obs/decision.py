"""Decision plane: the packed per-edge filter-verdict record (port of
``repro.obs.decision``).

Bit layout of the (…, K) uint8 ``verdict`` (bit SET = the edge passed
that test; a filter rejection is ``valid & ~bit``):

    bit 0  accepted by the distance filter (mask_d)
    bit 1  accepted by the similarity filter (mask_c)
    bit 2  accepted by the temporal filter (mask_t)
    bit 3  the edge exists this round (padded slates)
    bit 4  final verdict: positive trust weight
    bit 5  transport: delivery dropped / over budget
    bit 6  transport: a stale (lag > 0) payload was served
    bit 7  transport: corruption hit the edge's payload

Bits 5-7 are the chaos-transport attribution bits
(``repro_torch.dfl.faults``), OR'd in by ``with_fault_bits`` on
fault-injected rounds and always 0 on clean ones.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

Tensor = torch.Tensor

BIT_D = 1 << 0
BIT_C = 1 << 1
BIT_T = 1 << 2
BIT_VALID = 1 << 3
BIT_ACCEPTED = 1 << 4
BIT_DROPPED = 1 << 5
BIT_STALE = 1 << 6
BIT_CORRUPT = 1 << 7

#: name -> bit position for the five masks ``pack_verdict`` packs
BITS = {"mask_d": 0, "mask_c": 1, "mask_t": 2, "valid": 3, "accepted": 4}
#: transport-attribution bits, OR'd in by ``with_fault_bits`` only
FAULT_BITS = {"dropped": 5, "stale": 6, "corrupt": 7}

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


def unpack_verdict(verdict) -> Dict[str, object]:
    """Inverse of ``pack_verdict``: name -> boolean mask, a tensor for a
    tensor and a numpy array for anything else.  Also unpacks the
    transport bits (``FAULT_BITS``), zero unless ``with_fault_bits`` OR'd
    them in."""
    out = {}
    for name, bit in {**BITS, **FAULT_BITS}.items():
        b = (verdict >> bit) & 1
        out[name] = b.to(torch.bool) if isinstance(b, torch.Tensor) else np.asarray(b) == 1
    return out


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


def with_fault_bits(record: DecisionRecord, dropped: Tensor, stale: Tensor,
                    corrupt: Tensor) -> DecisionRecord:
    """OR the chaos-transport attribution bits into a record's verdict
    (uint8 bit math on the packed mask; the summaries are untouched).
    ``dropped``/``stale``/``corrupt`` are the (…, K) telemetry masks of
    ``faults.TransportOut``."""
    u8 = lambda m: m.to(torch.uint8)  # noqa: E731 — bool->uint8, no floats
    verdict = (record.verdict
               | (u8(dropped) << 5)
               | (u8(stale) << 6)
               | (u8(corrupt) << 7))
    return record._replace(verdict=verdict)


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
