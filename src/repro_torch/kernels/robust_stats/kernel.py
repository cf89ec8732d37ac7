"""Bind and launch the robust-statistics kernels of the port.

* ``csrc/wfagg_round.cu`` replaces the Pallas TPU kernel
  ``_wfagg_round_indexed_kernel`` / ``wfagg_round_indexed_pallas``
  (``src/repro/kernels/robust_stats/kernel.py:367`` / ``:511``): the whole
  gossip round in one launch.  It is bound by the bytes it must move:
  models, prev and local read once, out written once.  One CTA per
  receiving node streams the node's neighbour rows twice (statistics,
  then the combine); the second pass hits L2 at the paper's size.
  With an Alt-WFAgg filter (Multi-Krum, Clustering) the Gram variant
  also accumulates each node's (K, K) Gram and runs those filters in the
  epilogue.
* ``csrc/robust_stats_indexed.cu`` replaces ``_robust_stats_indexed_kernel``
  / ``robust_stats_indexed_pallas`` (``kernel.py:191`` / ``:271``): phase 0
  of the round alone (statistics, optional Gram and temporal tail), the
  statistics launch of the two-launch backend; bound by bytes without the
  Gram.  Both sources include ``csrc/valid_median.cuh``.
* ``csrc/robust_stats.cu`` replaces ``_robust_stats_kernel`` /
  ``robust_stats_pallas`` (``kernel.py:70`` / ``:136``, ``d_axis=0``): the
  median, trimmed mean and WFAgg filter statistics of one (K, D)
  candidate matrix, as the single-node ``wfagg()`` and the CFL server
  call it.  Bound by bytes at the paper's K; see the source's header.

Each source is compiled with ``nvcc`` into a shared library with a plain
C entry point at first use (``kernels.common.build``) and called through
``ctypes`` on PyTorch's current stream.  Nothing here runs at import:
this module imports on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core import trust
from repro_torch.kernels import common
from repro_torch.kernels.common import check_tensor as _check
from repro_torch.kernels.common import ptr as _ptr
from repro_torch.kernels.robust_stats.ref import RobustStats, trim_count

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "wfagg_round.cu"
STATS_SOURCE = CSRC / "robust_stats.cu"
INDEXED_SOURCE = CSRC / "robust_stats_indexed.cu"
MAX_K = 32
TILE = 256       # coordinates per tile of robust_stats[_indexed].cu (kThreads)

# Kernel launches so far in this process, one counter per kernel: bumped
# once per launch, right where the kernel is launched.  A run that must
# show it went through a kernel sets its counter to 0 before and reads it
# after.
launches = 0                 # wfagg_round.cu
robust_stats_launches = 0    # robust_stats.cu
indexed_launches = 0         # robust_stats_indexed.cu (its two kernels as one)


def _bind_round(lib: ctypes.CDLL) -> None:
    fn = lib.wfagg_round_indexed_launch
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([P] * 19 + [I, I, ctypes.c_longlong, I, F, F, F, F, F, I,
                                I, I, I, P])
    fn.restype = I


def _bind_indexed(lib: ctypes.CDLL) -> None:
    fn = lib.robust_stats_indexed_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 7 + [I, I, ctypes.c_longlong, I, P]
    fn.restype = I


def gram_filters(cfg, K: int):
    """``(dist_krum, sim_cluster, krum_m)`` of the round kernel's epilogue:
    which filters read the Gram, and Multi-Krum's keep count m."""
    if cfg.distance_filter not in ("wfagg_d", "multi_krum"):
        raise ValueError(f"unknown distance filter {cfg.distance_filter!r}")
    if cfg.similarity_filter not in ("wfagg_c", "clustering"):
        raise ValueError(f"unknown similarity filter {cfg.similarity_filter!r}")
    return (int(cfg.distance_filter == "multi_krum"),
            int(cfg.similarity_filter == "clustering"),
            trust.multi_krum_m(cfg, K))


def _bind_stats(lib: ctypes.CDLL) -> None:
    fn = lib.robust_stats_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, I, ctypes.c_longlong, I, I, P]
    fn.restype = I


def wfagg_round_indexed_cuda(
    local: torch.Tensor,         # (N, D) f32
    models: torch.Tensor,        # (M, D) f32
    neighbor_idx: torch.Tensor,  # (N, K) int32, values in [0, M)
    valid: torch.Tensor,         # (N, K) bool
    prev: Optional[torch.Tensor],     # (M, D) f32 or None
    tbands: Optional[torch.Tensor],   # (N, 4K) f32 or None
    cfg,
    alpha: float,
    mean_fallback: bool,
):
    """Launch the round kernel on the tensors' CUDA device and stream.

    Every output is allocated here with ``torch.empty``.  Returns
    ``(out (N, D), weights (N, K), mask_d, mask_c, mask_t ((N, K) bool),
    stats)`` with ``stats`` a ``RobustStats`` of (N, K) / (N,) fields and,
    when ``cfg`` names a Multi-Krum or Clustering filter (the Gram
    variant), the (N, K, K) Gram in ``stats.gram``.
    """
    global launches
    M, D = models.shape
    N, K = neighbor_idx.shape
    dev = models.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"the round kernel takes 1 <= K <= {MAX_K}, got K={K}")
    _check("models", models, torch.float32, (M, D), dev)
    _check("local", local, torch.float32, (N, D), dev)
    _check("neighbor_idx", neighbor_idx, torch.int32, (N, K), dev)
    _check("valid", valid, torch.bool, (N, K), dev)
    if prev is not None:
        _check("prev", prev, torch.float32, (M, D), dev)
    if tbands is not None:
        if prev is None:
            raise ValueError("tbands requires prev")
        _check("tbands", tbands, torch.float32, (N, 4 * K), dev)
    dist_krum, sim_cluster, krum_m = gram_filters(cfg, K)
    fn = common.load(SOURCE, _bind_round).wfagg_round_indexed_launch

    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((N, D), **f32)
    weights = torch.empty((N, K), **f32)
    masks = [torch.empty((N, K), dtype=torch.bool, device=dev) for _ in range(3)]
    dist2, dotmed, norm2 = (torch.empty((N, K), **f32) for _ in range(3))
    mednorm2 = torch.empty((N,), **f32)
    tail = ([torch.empty((N, K), **f32) for _ in range(3)]
            if prev is not None else [None, None, None])
    gram = (torch.empty((N, K, K), **f32) if dist_krum or sim_cluster else None)
    floor = float(np.float32(cfg.accept_threshold - 1e-9))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(_ptr(local), _ptr(models), _ptr(neighbor_idx), _ptr(valid),
                 _ptr(prev), _ptr(tbands), _ptr(out), _ptr(weights),
                 *(_ptr(m) for m in masks), _ptr(dist2), _ptr(dotmed),
                 _ptr(norm2), _ptr(mednorm2), *(_ptr(t) for t in tail),
                 _ptr(gram), N, K, D, int(cfg.f), float(cfg.tau1),
                 float(cfg.tau2), float(cfg.tau3), floor, float(alpha),
                 int(bool(mean_fallback)), dist_krum, sim_cluster, krum_m, stream)
    common.launch_error("wfagg_round_indexed", err)
    launches += 1
    stats = RobustStats(None, None, dist2, dotmed, norm2, mednorm2, *tail, gram)
    return (out, weights, *masks, stats)


def robust_stats_indexed_cuda(
    models: torch.Tensor,        # (M, D) f32
    neighbor_idx: torch.Tensor,  # (N, K) int32, values in [0, M)
    valid: torch.Tensor,         # (N, K) bool
    prev: Optional[torch.Tensor],     # (M, D) f32 or None
    need_gram: bool,
) -> RobustStats:
    """Launch the gather-free statistics kernel on the tensors' CUDA device
    and stream.

    Every output is allocated here with ``torch.empty``: the per-CTA
    partial rows, one (N, 6K+1) tensor ``[dist2 | dotmed | norm2 |
    prev_dist2 | prev_dot | prev_norm2 | mednorm2]`` that the returned
    ``RobustStats`` views, and the (N, K, K) Gram with ``need_gram``.
    """
    global indexed_launches
    M, D = models.shape
    N, K = neighbor_idx.shape
    dev = models.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"the indexed statistics kernel takes 1 <= K <= {MAX_K}, "
                         f"got K={K}")
    _check("models", models, torch.float32, (M, D), dev)
    _check("neighbor_idx", neighbor_idx, torch.int32, (N, K), dev)
    _check("valid", valid, torch.bool, (N, K), dev)
    if prev is not None:
        _check("prev", prev, torch.float32, (M, D), dev)
    fn = common.load(INDEXED_SOURCE, _bind_indexed).robust_stats_indexed_launch
    f32 = dict(dtype=torch.float32, device=dev)
    n_chunks = common.grid_blocks(dev, -(-D // TILE), rows=N)
    n_stats = 6 * K + 1
    n_fields = n_stats + (K * (K + 1) // 2 if need_gram else 0)
    partials = torch.empty((N, n_chunks, n_fields), **f32)
    flat = torch.empty((N, n_stats), **f32)
    gram = torch.empty((N, K, K), **f32) if need_gram else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(_ptr(models), _ptr(neighbor_idx), _ptr(valid), _ptr(prev),
                 _ptr(partials), _ptr(flat), _ptr(gram), N, K, D, n_chunks, stream)
    common.launch_error("robust_stats_indexed", err)
    indexed_launches += 1
    f = [flat[:, i * K:(i + 1) * K] for i in range(6)]
    tail = f[3:] if prev is not None else [None, None, None]
    return RobustStats(None, None, f[0], f[1], f[2], flat[:, 6 * K], *tail, gram)


def robust_stats_cuda(
    updates: torch.Tensor,            # (K, D) f32
    prev: Optional[torch.Tensor],     # (K, D) f32 or None
    beta: float,
    need_center: bool,
) -> RobustStats:
    """Launch the single-matrix statistics kernel on the tensors' CUDA
    device and stream.

    Every output is allocated here with ``torch.empty``: the (D,) centers
    when ``need_center``, the per-CTA partial sums, and one flat vector
    ``[dist2 | dotmed | norm2 | prev_dist2 | prev_dot | prev_norm2 |
    mednorm2]`` that the returned ``RobustStats`` views.
    """
    global robust_stats_launches
    K, D = updates.shape
    dev = updates.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"the robust_stats kernel takes 1 <= K <= {MAX_K} "
                         f"candidates, got K={K}")
    n_trim = trim_count(K, beta)
    if K - 2 * n_trim < 1:
        raise ValueError(f"beta={beta} trims every one of the K={K} candidates")
    _check("updates", updates, torch.float32, (K, D), dev)
    if prev is not None:
        _check("prev", prev, torch.float32, (K, D), dev)
    fn = common.load(STATS_SOURCE, _bind_stats).robust_stats_launch
    f32 = dict(dtype=torch.float32, device=dev)
    med = torch.empty((D,), **f32) if need_center else None
    trim = torch.empty((D,), **f32) if need_center else None
    n_blocks = common.grid_blocks(dev, -(-D // TILE))
    n_out = 6 * K + 1
    partials = torch.empty((n_blocks, n_out), **f32)
    flat = torch.empty((n_out,), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(_ptr(updates), _ptr(prev), _ptr(med), _ptr(trim),
                 _ptr(partials), _ptr(flat), K, D, n_trim, n_blocks, stream)
    common.launch_error("robust_stats", err)
    robust_stats_launches += 1
    f = [flat[i * K:(i + 1) * K] for i in range(6)]
    tail = f[3:] if prev is not None else [None, None, None]
    return RobustStats(med, trim, f[0], f[1], f[2], flat[6 * K], *tail)
