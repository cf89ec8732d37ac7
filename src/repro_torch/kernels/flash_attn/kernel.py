"""Bind and launch the flash-attention kernel.

``csrc/flash_attn.cu`` replaces the Pallas TPU kernel ``_flash_kernel`` /
``flash_attention_pallas`` (``src/repro/kernels/flash_attn/kernel.py:29`` /
``:81``): causal, padded online-softmax attention over ``q (BH, Sq, hd)``
and ``k``/``v (BH, Sk, hd)``, f32 or bf16, returning ``o`` in q's type and
the f32 running max ``m`` and denominator ``l``.

One source, two kernels (see its header):

* bf16, the prefill's type, runs on the tensor cores (``mma.sync``
  m16n8k16, f32 accumulators).  The reference multiplies the upcast bf16
  inputs in f32, and a product of two bf16 values is exact in f32, so the
  score products are the reference's.  ``p`` is f32 and is not rounded to
  one bf16 value: ``P·V`` runs as ``P_TERMS`` bf16 products (``hi =
  bf16(p)``, ``lo = bf16(p - hi)``), which holds o to one bf16 rounding of
  the plain version.  Bound: tensor-core operations (989 TFLOP/s bf16).
  Its pointers must be 16-byte aligned (``cp.async``); a misaligned one
  raises here, it is never copied.
* f32 runs on the CUDA cores, bound by f32 operations (TF32 stays off).

Built with ``nvcc`` at first use (``kernels.common.build``) and called
through ``ctypes`` on PyTorch's current stream; nothing runs at import.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Tuple

import torch

from repro_torch.kernels import common

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attn.cu"
HEAD_DIMS = (32, 64, 80, 128)
DTYPES = (torch.float32, torch.bfloat16)
# bf16 terms of p in the tensor-core kernel's P·V (``kPTerms`` in the source)
P_TERMS = 2

# Kernel launches so far in this process: bumped once per launch, right
# where the kernel is launched.  ``launches`` counts both kernels of the
# source, ``launches_tc`` the bf16 tensor-core kernel's alone.
launches = 0
launches_tc = 0


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attn_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 6 + [I] * 5 + [ctypes.c_float] + [I] * 3 + [P]
    fn.restype = I


def flash_attention_cuda(q: torch.Tensor,   # (BH, Sq, hd) f32 or bf16
                         k: torch.Tensor,   # (BH, Sk, hd), q's dtype
                         v: torch.Tensor,   # (BH, Sk, hd), q's dtype
                         scale: float, causal: bool, sk_valid: int, q_offset: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on the tensors' CUDA device and stream; returns
    ``(o (BH, Sq, hd) in q's dtype, m (BH, Sq) f32, l (BH, Sq) f32)``,
    allocated here."""
    global launches, launches_tc
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if hd not in HEAD_DIMS or q.dtype not in DTYPES or BH < 1 or Sq < 1 or Sk < 1:
        raise ValueError(f"the flash_attn kernel takes hd in {HEAD_DIMS}, dtype in "
                         f"{DTYPES} and non-empty shapes, got q {tuple(q.shape)} "
                         f"{q.dtype}, k {tuple(k.shape)}")
    for name, t, shape in (("q", q, (BH, Sq, hd)), ("k", k, (BH, Sk, hd)),
                           ("v", v, (BH, Sk, hd))):
        common.check_tensor(name, t, q.dtype, shape, dev)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"the bf16 flash_attn kernel loads 16-byte rows with "
                                 f"cp.async: {name} must be 16-byte aligned")
    fn = common.load(SOURCE, _bind).flash_attn_launch
    o = torch.empty_like(q)
    m = torch.empty((BH, Sq), dtype=torch.float32, device=dev)
    l = torch.empty((BH, Sq), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(),
                 l.data_ptr(), BH, Sq, Sk, hd, int(bf16),
                 float(scale), int(bool(causal)), int(sk_valid), int(q_offset), stream)
    common.launch_error("flash_attn", err)
    launches += 1
    launches_tc += bf16
    return o, m, l
