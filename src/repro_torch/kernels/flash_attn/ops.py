"""Public wrapper of the flash-attention kernel (port of
``repro.kernels.flash_attn.ops``).

Reshapes (B, H, S, hd) <-> (BH, S, hd) and passes ``sk_valid = Sk`` and
``q_offset = Sk - Sq``.  The reference pads Sq and Sk to its Pallas block
sizes first; the CUDA kernel tiles at its own 64 x 64 and guards ragged
rows and keys itself, and the plain version takes any shape, so the port
passes the unpadded views (the rows below Sq are the same either way).
Dispatch is by the tensors' device alone: CUDA tensors go to
the hand-written kernel (``kernel.flash_attention_cuda``), and a failed
build or launch raises; CPU tensors go to its plain version
(``ref.flash_attention_plain``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn import kernel
from repro_torch.kernels.flash_attn.ref import flash_attention_plain, flash_attention_ref


def flash_attention_blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float, causal: bool, sk_valid: int, q_offset: int):
    """``(o, m, l)`` of the kernel's contract on padded (BH, S, hd) arrays:
    the CUDA kernel for CUDA tensors, its plain version for CPU tensors."""
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, scale, causal, sk_valid, q_offset)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    return kernel.flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                       scale, causal, sk_valid, q_offset)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = True,
                    use_kernel: bool = True) -> torch.Tensor:
    """q (B, H, Sq, hd), k/v (B, H, Sk, hd) -> (B, H, Sq, hd)."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    qf = q.reshape(B * H, Sq, hd)
    kf = k.reshape(B * H, Sk, hd)
    vf = v.reshape(B * H, Sk, hd)
    if not use_kernel:
        return flash_attention_ref(qf, kf, vf, scale, causal).reshape(B, H, Sq, hd)
    out, _, _ = flash_attention_blocks(
        qf, kf, vf, scale, causal, sk_valid=Sk,
        q_offset=Sk - Sq)  # align ends: standard self/decode convention
    return out.reshape(B, H, Sq, hd)
