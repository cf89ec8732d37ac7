"""Plain PyTorch versions of the flash-attention kernel (port of
``repro.kernels.flash_attn.ref``).

* ``flash_attention_ref``: the reference's dense-softmax oracle
  (``src/repro/kernels/flash_attn/ref.py:11``), the route of
  ``ops.flash_attention(use_kernel=False)``.
* ``flash_attention_plain``: the kernel's own contract, that of
  ``flash_attention_pallas`` (``src/repro/kernels/flash_attn/kernel.py:81``):
  ``(q, k, v, scale, causal, sk_valid, q_offset) -> (o, m, l)`` on padded
  ``(BH, S, hd)`` arrays, with the Pallas kernel's masks and its fully
  masked rows (``o = 0``, ``m = -1e30``, ``l = 0``).  The wrapper takes it
  for CPU tensors; ``chip_smoke.py`` holds the CUDA kernel against it.
  With ``p_terms`` it emulates the bf16 tensor-core kernel's ``P·V`` (``p``
  as that many bf16 terms), which the tests and ``chip_smoke.py`` hold to
  the exact version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30
# rows of one score block of the plain version: (BH, rows, Sk) f32 stays
# within 2^28 elements (1 GiB), whatever the sequence length
_PLAIN_BLOCK_ELEMS = 1 << 28


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, causal: bool = True) -> torch.Tensor:
    """q (BH, Sq, hd), k/v (BH, Sk, hd) -> (BH, Sq, hd); dense softmax, the
    causal mask aligned at the ends (decode style)."""
    scores = torch.einsum("bqd,bkd->bqk", q, k).to(torch.float32) * scale
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        qpos = torch.arange(Sq, device=q.device) + (Sk - Sq)
        mask = torch.arange(Sk, device=q.device)[None, :] <= qpos[:, None]
        scores = torch.where(mask[None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w.to(v.dtype), v)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, causal: bool = True,
                          sk_valid: Optional[int] = None, q_offset: int = 0,
                          p_terms: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: q (BH, Sq, hd), k/v (BH, Sk,
    hd) -> (o (BH, Sq, hd) in q's dtype, m (BH, Sq) f32, l (BH, Sq) f32).

    Inputs are upcast to f32, ``s = q kᵀ * scale``; key ``j`` is live for
    query row ``i`` when ``j < sk_valid`` and, if causal, ``j <= i +
    q_offset``; dead scores are -1e30 and their ``p`` is 0.  ``m`` is the
    row's largest score (-1e30 if none is live), ``l = sum p`` with ``p =
    exp(s - m)``, ``o = (p v) / max(l, 1e-30)``: the online softmax's final
    state, taken at once.  Query rows are independent, so they go in blocks
    that keep the score block within 1 GiB.

    ``p_terms = n`` takes ``p v`` as the bf16 tensor-core kernel does: ``p``
    as n bf16 terms, each the bf16 rounding of what the earlier ones left,
    each multiplied by v in f32 (exact for bf16 v); ``l`` stays the f32 sum."""
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    sk_valid = Sk if sk_valid is None else min(int(sk_valid), Sk)
    qf, kf, vf = q.to(torch.float32), k.to(torch.float32), v.to(torch.float32)
    kpos = torch.arange(Sk, device=q.device)
    o = torch.empty((BH, Sq, hd), dtype=q.dtype, device=q.device)
    m = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    l = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    rows = max(1, _PLAIN_BLOCK_ELEMS // max(1, BH * Sk))
    for r0 in range(0, Sq, rows):
        r1 = min(Sq, r0 + rows)
        s = torch.matmul(qf[:, r0:r1], kf.transpose(1, 2)) * scale     # (BH, r, Sk)
        live = (kpos < sk_valid)[None, :]
        if causal:
            qpos = torch.arange(r0, r1, device=q.device) + q_offset
            live = live & (kpos[None, :] <= qpos[:, None])
        s = torch.where(live[None], s, NEG_INF)
        mb = torch.clamp(s.amax(dim=-1), min=NEG_INF)
        p = torch.where(live[None], torch.exp(s - mb[..., None]), 0.0)
        del s
        lb = p.sum(dim=-1)
        if p_terms is None:
            pv = torch.matmul(p, vf)
        else:
            pv = torch.zeros((BH, r1 - r0, hd), dtype=torch.float32, device=q.device)
            for _ in range(p_terms):
                term = p.to(torch.bfloat16).to(torch.float32)
                pv += torch.matmul(term, vf)
                p -= term
        o[:, r0:r1] = (pv / torch.clamp(lb, min=1e-30)[..., None]).to(q.dtype)
        m[:, r0:r1] = mb
        l[:, r0:r1] = lb
    return o, m, l
