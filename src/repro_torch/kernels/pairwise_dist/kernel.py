"""Bind and launch the pairwise Gram kernel.

``csrc/pairwise_gram.cu`` replaces the Pallas TPU kernel
``_pairwise_kernel`` / ``pairwise_pallas``
(``src/repro/kernels/pairwise_dist/kernel.py:17`` / ``:29``): the (K, K)
Gram and the (K,) squared norms of a (K, D) candidate matrix.  It is
bound by the bytes it reads (the matrix, once) at the K it serves: a
double-buffered ``cp.async`` stream of 256-coordinate tiles, reduced in
4 x 4 register blocks of Gram entries, with every entry summed by the same
expression tree so that bit-identical rows stay tied (see the source's
header).  Any D and any float alignment: the kernel picks 16-, 8- or
4-byte loads itself.  Built with ``nvcc`` at first use
(``kernels.common.build``) and called through ``ctypes`` on PyTorch's
current stream; nothing runs at import.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Tuple

import torch

from repro_torch.kernels import common

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "pairwise_gram.cu"
MAX_K = 32
TILE = 256       # coordinates per tile of pairwise_gram.cu (kTile)
PER_SM = 2       # CTAs per SM (64 KiB of shared memory each at K = 32)

# Kernel launches so far in this process: bumped once per launch, right
# where the kernel is launched.
launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.pairwise_gram_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, I, ctypes.c_longlong, I, P]
    fn.restype = I


def pairwise_gram_cuda(updates: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Gram kernel on the tensor's CUDA device and stream.
    Returns ``(gram (K, K), norm2 (K,))``, allocated here; the Gram is
    exactly symmetric and its diagonal is ``norm2``."""
    global launches
    K, D = updates.shape
    dev = updates.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"the pairwise_gram kernel takes 1 <= K <= {MAX_K} "
                         f"candidates, got K={K}")
    common.check_tensor("updates", updates, torch.float32, (K, D), dev)
    fn = common.load(SOURCE, _bind).pairwise_gram_launch
    f32 = dict(dtype=torch.float32, device=dev)
    n_blocks = common.grid_blocks(dev, -(-D // TILE), per_sm=PER_SM)
    partials = torch.empty((n_blocks, K * K), **f32)
    gram = torch.empty((K, K), **f32)
    norm2 = torch.empty((K,), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(updates.data_ptr(), partials.data_ptr(), gram.data_ptr(),
                 norm2.data_ptr(), K, D, n_blocks, stream)
    common.launch_error("pairwise_gram", err)
    launches += 1
    return gram, norm2
