"""Bind and launch the WFAgg-E combine kernels.

* ``csrc/weighted_agg.cu`` replaces the Pallas TPU kernel
  ``_weighted_agg_kernel`` / ``weighted_agg_pallas``
  (``src/repro/kernels/weighted_agg/kernel.py:22`` / ``:88``): one node's
  ``out = lcoef * local + wvec @ U``.
* ``csrc/weighted_agg_indexed.cu`` replaces
  ``_weighted_agg_indexed_kernel`` / ``weighted_agg_indexed_pallas``
  (``kernel.py:30`` / ``:56``): every node of a gossip round,
  ``out[n] = lcoef[n] * local[n] + sum_k wvec[n, k] * models[idx[n, k]]``,
  the rows read through the table (the combine launch of the two-launch
  backend).

Both are bound by the bytes they move (rows and local read once, out
written once); see the sources' headers.  Built with ``nvcc`` at first
use (``kernels.common.build``) and called through ``ctypes`` on
PyTorch's current stream; nothing runs at import.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import common

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "weighted_agg.cu"
INDEXED_SOURCE = CSRC / "weighted_agg_indexed.cu"
MAX_K = 32

# Kernel launches so far in this process, one counter per kernel: bumped
# once per launch, right where the kernel is launched.
launches = 0            # weighted_agg.cu
indexed_launches = 0    # weighted_agg_indexed.cu


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.weighted_agg_launch
    P = ctypes.c_void_p
    fn.argtypes = [P, P, P, P, P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, P]
    fn.restype = ctypes.c_int


def _bind_indexed(lib: ctypes.CDLL) -> None:
    fn = lib.weighted_agg_indexed_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 6 + [I, I, ctypes.c_longlong, I, P]
    fn.restype = I


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


def weighted_agg_indexed_cuda(wvec: torch.Tensor,    # (N, K) f32, eff_alpha * w_norm
                              lcoef: torch.Tensor,   # (N,) f32, 1 - eff_alpha
                              local: torch.Tensor,   # (N, D) f32, D a multiple of 4
                              models: torch.Tensor,  # (M, D) f32
                              neighbor_idx: torch.Tensor  # (N, K) int32 in [0, M)
                              ) -> torch.Tensor:
    """Launch the gather-free combine on the tensors' CUDA device and
    stream; returns ``out (N, D)``, allocated here."""
    global indexed_launches
    N, K = neighbor_idx.shape
    M, D = models.shape
    dev = models.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if not 1 <= K <= MAX_K or D % 4:
        raise ValueError(f"the weighted_agg_indexed kernel takes 1 <= K <= "
                         f"{MAX_K} and D a multiple of 4, got K={K}, D={D}")
    for name, t, dtype, shape in (
            ("wvec", wvec, torch.float32, (N, K)), ("lcoef", lcoef, torch.float32, (N,)),
            ("local", local, torch.float32, (N, D)),
            ("models", models, torch.float32, (M, D)),
            ("neighbor_idx", neighbor_idx, torch.int32, (N, K))):
        common.check_tensor(name, t, dtype, shape, dev)
    local, models = _aligned(local), _aligned(models)
    fn = common.load(INDEXED_SOURCE, _bind_indexed).weighted_agg_indexed_launch
    out = torch.empty((N, D), dtype=torch.float32, device=dev)
    n_chunks = common.grid_blocks(dev, -(-(D // 4) // 256), rows=N)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(wvec.data_ptr(), lcoef.data_ptr(), local.data_ptr(),
                 models.data_ptr(), neighbor_idx.data_ptr(), out.data_ptr(),
                 N, K, D, n_chunks, stream)
    common.launch_error("weighted_agg_indexed", err)
    indexed_launches += 1
    return out
