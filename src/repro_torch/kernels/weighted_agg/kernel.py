"""Bind and launch the single-node WFAgg-E combine kernel.

``csrc/weighted_agg.cu`` replaces the Pallas TPU kernel
``_weighted_agg_kernel`` / ``weighted_agg_pallas``
(``src/repro/kernels/weighted_agg/kernel.py:22`` / ``:88``):
``out = lcoef * local + wvec @ U``.  It is bound by the bytes it moves
(U and local read once, out written once); see the source's header.
Built with ``nvcc`` at first use (``kernels.common.build``) and called
through ``ctypes`` on PyTorch's current stream; nothing runs at import.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import common

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "weighted_agg.cu"

# Kernel launches so far in this process: bumped once per launch, right
# where the kernel is launched.
launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.weighted_agg_launch
    P = ctypes.c_void_p
    fn.argtypes = [P, P, P, P, P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, P]
    fn.restype = ctypes.c_int


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if it starts on a 16-byte boundary, else a copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def weighted_agg_cuda(wvec: torch.Tensor,    # (K,) f32, eff_alpha * w_norm
                      lcoef: torch.Tensor,   # (1,) f32, 1 - eff_alpha
                      local: torch.Tensor,   # (D,) f32, D a multiple of 4
                      updates: torch.Tensor  # (K, D) f32
                      ) -> torch.Tensor:
    """Launch the combine on the tensors' CUDA device and stream; returns
    ``out (D,)``, allocated here."""
    global launches
    K, D = updates.shape
    dev = updates.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if K < 1 or D % 4:
        raise ValueError(f"the weighted_agg kernel takes K >= 1 and D a "
                         f"multiple of 4, got K={K}, D={D}")
    for name, t, shape in (("wvec", wvec, (K,)), ("lcoef", lcoef, (1,)),
                           ("local", local, (D,)), ("updates", updates, (K, D))):
        common.check_tensor(name, t, torch.float32, shape, dev)
    local, updates = _aligned(local), _aligned(updates)
    fn = common.load(SOURCE, _bind).weighted_agg_launch
    out = torch.empty((D,), dtype=torch.float32, device=dev)
    n_blocks = common.grid_blocks(dev, -(-(D // 4) // 256))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(wvec.data_ptr(), lcoef.data_ptr(), local.data_ptr(),
                 updates.data_ptr(), out.data_ptr(), K, D, n_blocks, stream)
    common.launch_error("weighted_agg", err)
    launches += 1
    return out
