"""Bind and launch the pairwise Gram kernel.

``csrc/pairwise_gram.cu`` replaces the Pallas TPU kernel
``_pairwise_kernel`` / ``pairwise_pallas``
(``src/repro/kernels/pairwise_dist/kernel.py:17`` / ``:29``): the (K, K)
Gram and the (K,) squared norms of a (K, D) candidate matrix, K up to
``MAX_K`` = 1,024.  At K <= 32 it is bound by the bytes it reads (the
matrix, once): a double-buffered ``cp.async`` stream of 256-coordinate
tiles, reduced in 4 x 4 register blocks of Gram entries.  Above, by its
operations: 64 x 64 output tiles of the upper triangle, each CTA one tile
pair and one of ``splits`` slices of D (``gram_plan``).  Every entry is
summed by the same expression tree so that bit-identical rows stay tied
(see the source's header).  Any D and any float alignment.  Built with
``nvcc`` at first use (``kernels.common.build``) and called through
``ctypes`` on PyTorch's current stream; nothing runs at import.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Tuple

import torch

from repro_torch.kernels import common

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "pairwise_gram.cu"
MAX_K = 1024
BLOCKED_MAX_K = 32  # the register-blocked stream's K; above it the output tiles
TILE = 256       # coordinates per tile of the stream (kTile)
PER_SM = 2       # CTAs per SM (64 KiB of shared memory each at K = 32)
TILE_K = 64      # Gram entries a side of an output tile above 32 (kTileK)
CHUNK = 16       # coordinates a step of the tiled path (kChunk)
TILES_PER_SM = 4  # the tiled path's CTAs per SM (256 threads of 63 registers, 17 KiB)

# Kernel launches so far in this process: bumped once per launch, right
# where the kernel is launched.
launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.pairwise_gram_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, I, ctypes.c_longlong, I, P]
    fn.restype = I


def gram_plan(K: int, D: int, sms: int) -> dict:
    """How ``pairwise_gram.cu`` runs K candidates over D coordinates on a
    card of ``sms`` SMs: ``path`` ("blocked" at K <= 32, "tiles" above),
    ``blocks`` (the stream's CTAs, or the splits of D), and on the tiled
    path ``tile_pairs`` (of the upper triangle of 64 x 64 tiles): the
    splits are the card's resident CTAs over the pairs, rounded down so the
    grid runs in one wave, at least 1 and at most one per 16 coordinates,
    so the partials, ``blocks`` K^2 floats, stay a few MB whatever K."""
    if K <= BLOCKED_MAX_K:
        return dict(path="blocked", blocks=max(1, min(-(-D // TILE), PER_SM * sms)))
    nt = -(-K // TILE_K)
    pairs = nt * (nt + 1) // 2
    splits = max(1, min(-(-D // CHUNK), TILES_PER_SM * sms // pairs))
    return dict(path="tiles", blocks=splits, tile_pairs=pairs)


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
                         f"candidates, got K={K} (ROADMAP queue 2, item E)")
    common.check_tensor("updates", updates, torch.float32, (K, D), dev)
    fn = common.load(SOURCE, _bind).pairwise_gram_launch
    f32 = dict(dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_blocks = gram_plan(K, D, sms)["blocks"]
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
