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
  epilogue.  The ``prev_idx`` variant (chaos transport) reads ``prev``
  through its own (N, K) table instead of the neighbour table; the
  per-edge variant (a per-edge (N, K, D) ``prev``, the state the gathered
  path carries) is the same launch on that tensor viewed as (N*K, D),
  read through the table ``n*K + k``: the Pallas kernel's per-edge
  BlockSpec addresses.
* ``csrc/robust_stats_indexed.cu`` replaces ``_robust_stats_indexed_kernel``
  / ``robust_stats_indexed_pallas`` (``kernel.py:191`` / ``:271``): phase 0
  of the round alone (statistics, optional Gram and temporal tail, with
  the same ``prev_idx`` and per-edge variants), the statistics launch of
  the two-launch backend; bound by bytes without the Gram.  Both sources
  include ``csrc/valid_median.cuh``.
* ``csrc/robust_stats.cu`` replaces ``_robust_stats_kernel`` in both of
  its launches: ``robust_stats_pallas`` (``kernel.py:70`` / ``:136``,
  ``d_axis=0``, kernel 4), the median, trimmed mean and WFAgg filter
  statistics of one (K, D) candidate matrix, as the single-node
  ``wfagg()`` and the CFL server call it; and ``robust_stats_batch_pallas``
  (``kernel.py:652``, ``d_axis=1``, kernel 5), the same for every node of
  a gathered (N, K, D) tensor, as the gathered ``wfagg_batch`` calls it.
  Bound by bytes at the paper's K; see the source's header.

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
prev_idx_launches = 0        # wfagg_round.cu launches of the prev_idx variant
per_edge_launches = 0        # wfagg_round.cu launches with a per-edge prev
robust_stats_launches = 0    # robust_stats.cu, one matrix (its two kernels as one)
batch_launches = 0           # robust_stats.cu, a gathered tensor (its two kernels as one)
indexed_launches = 0         # robust_stats_indexed.cu (its two kernels as one)
indexed_prev_idx_launches = 0  # robust_stats_indexed.cu, prev_idx variant
indexed_per_edge_launches = 0  # robust_stats_indexed.cu, per-edge prev


def _bind_round(lib: ctypes.CDLL) -> None:
    fn = lib.wfagg_round_indexed_launch
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([P] * 20 + [I, I, ctypes.c_longlong, I, F, F, F, F, F, I,
                                I, I, I, P])
    fn.restype = I


def _bind_indexed(lib: ctypes.CDLL) -> None:
    fn = lib.robust_stats_indexed_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 8 + [I, I, ctypes.c_longlong, I, P]
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


def _prev_rows(prev, prev_idx, M, N, K, D, dev):
    """``prev`` as the kernels read it: a matrix through the neighbour table
    (the model matrix's rows), a matrix through ``prev_idx`` (rows of its
    own), or a per-edge (N, K, D) tensor, which is the matrix of its N*K
    rows read through the table ``n*K + k`` (built on the device, no host
    read).  Returns ``(prev, prev_idx, per_edge)`` for the launch."""
    if prev is not None and prev.ndim == 3:
        if prev_idx is not None:
            raise ValueError("prev_idx requires a matrix-form prev")
        _check("prev", prev, torch.float32, (N, K, D), dev)
        table = torch.arange(N * K, dtype=torch.int32, device=dev).view(N, K)
        return prev.view(N * K, D), table, True
    if prev_idx is not None:
        if prev is None:
            raise ValueError("prev_idx requires prev")
        _check("prev_idx", prev_idx, torch.int32, (N, K), dev)
    if prev is not None:
        rows = M if prev_idx is None else prev.shape[0]
        _check("prev", prev, torch.float32, (rows, D), dev)
    return prev, prev_idx, False


def _bind_stats(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.robust_stats_launch
    fn.argtypes = [P, P, P, P, P, P, I, ctypes.c_longlong, I, I, P]
    fn.restype = I
    fn = lib.robust_stats_batch_launch
    fn.argtypes = [P, P, P, P, P, P, I, I, ctypes.c_longlong, I, I, P]
    fn.restype = I


def wfagg_round_indexed_cuda(
    local: torch.Tensor,         # (N, D) f32
    models: torch.Tensor,        # (M, D) f32
    neighbor_idx: torch.Tensor,  # (N, K) int32, values in [0, M)
    valid: torch.Tensor,         # (N, K) bool
    prev: Optional[torch.Tensor],     # (M, D) f32, (Mp, D) with prev_idx, (N, K, D), or None
    tbands: Optional[torch.Tensor],   # (N, 4K) f32 or None
    cfg,
    alpha: float,
    mean_fallback: bool,
    prev_idx: Optional[torch.Tensor] = None,  # (N, K) int32, values in [0, Mp)
):
    """Launch the round kernel on the tensors' CUDA device and stream.

    ``prev`` may be the same tensor as ``models`` (the chaos round's
    stacked matrix); the kernel only reads both.  A per-edge ``prev``
    (N, K, D) goes through the ``prev_idx`` variant (see ``_prev_rows``)
    and is counted apart.  Every output is allocated here with
    ``torch.empty``.  Returns
    ``(out (N, D), weights (N, K), mask_d, mask_c, mask_t ((N, K) bool),
    stats)`` with ``stats`` a ``RobustStats`` of (N, K) / (N,) fields and,
    when ``cfg`` names a Multi-Krum or Clustering filter (the Gram
    variant), the (N, K, K) Gram in ``stats.gram``.
    """
    global launches, prev_idx_launches, per_edge_launches
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
    prev, prev_idx, per_edge = _prev_rows(prev, prev_idx, M, N, K, D, dev)
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
                 _ptr(prev), _ptr(prev_idx), _ptr(tbands), _ptr(out), _ptr(weights),
                 *(_ptr(m) for m in masks), _ptr(dist2), _ptr(dotmed),
                 _ptr(norm2), _ptr(mednorm2), *(_ptr(t) for t in tail),
                 _ptr(gram), N, K, D, int(cfg.f), float(cfg.tau1),
                 float(cfg.tau2), float(cfg.tau3), floor, float(alpha),
                 int(bool(mean_fallback)), dist_krum, sim_cluster, krum_m, stream)
    common.launch_error("wfagg_round_indexed", err)
    launches += 1
    if per_edge:
        per_edge_launches += 1
    elif prev_idx is not None:
        prev_idx_launches += 1
    stats = RobustStats(None, None, dist2, dotmed, norm2, mednorm2, *tail, gram)
    return (out, weights, *masks, stats)


def robust_stats_indexed_cuda(
    models: torch.Tensor,        # (M, D) f32
    neighbor_idx: torch.Tensor,  # (N, K) int32, values in [0, M)
    valid: torch.Tensor,         # (N, K) bool
    prev: Optional[torch.Tensor],     # (M, D) f32, (Mp, D) with prev_idx, (N, K, D), or None
    need_gram: bool,
    prev_idx: Optional[torch.Tensor] = None,  # (N, K) int32, values in [0, Mp)
) -> RobustStats:
    """Launch the gather-free statistics kernel on the tensors' CUDA device
    and stream (``prev`` may be the same tensor as ``models``; a per-edge
    (N, K, D) ``prev`` goes through the ``prev_idx`` variant, counted
    apart).

    Every output is allocated here with ``torch.empty``: the per-CTA
    partial rows, one (N, 6K+1) tensor ``[dist2 | dotmed | norm2 |
    prev_dist2 | prev_dot | prev_norm2 | mednorm2]`` that the returned
    ``RobustStats`` views, and the (N, K, K) Gram with ``need_gram``.
    """
    global indexed_launches, indexed_prev_idx_launches, indexed_per_edge_launches
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
    prev, prev_idx, per_edge = _prev_rows(prev, prev_idx, M, N, K, D, dev)
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
                 _ptr(prev_idx), _ptr(partials), _ptr(flat), _ptr(gram), N, K, D,
                 n_chunks, stream)
    common.launch_error("robust_stats_indexed", err)
    indexed_launches += 1
    if per_edge:
        indexed_per_edge_launches += 1
    elif prev_idx is not None:
        indexed_prev_idx_launches += 1
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


def robust_stats_batch_cuda(
    updates: torch.Tensor,            # (N, K, D) f32
    prev: Optional[torch.Tensor],     # (N, K, D) f32 or None
    beta: float,
    need_center: bool,
) -> RobustStats:
    """Launch the batched statistics kernel (kernel 5) on the tensors' CUDA
    device and stream: every node's (K, D) slab of the gathered tensor.

    Every output is allocated here with ``torch.empty``: the (N, D)
    centers when ``need_center``, the per-CTA partial rows (N, blocks,
    6K+1), and one (N, 6K+1) tensor ``[dist2 | dotmed | norm2 | prev_dist2
    | prev_dot | prev_norm2 | mednorm2]`` that the returned
    ``RobustStats`` views ((N, K) fields, ``mednorm2`` (N,)).
    """
    global batch_launches
    N, K, D = updates.shape
    dev = updates.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"the robust_stats_batch kernel takes 1 <= K <= {MAX_K} "
                         f"candidates, got K={K}")
    if not 1 <= N <= 65535:
        raise ValueError(f"the robust_stats_batch kernel takes 1 <= N <= 65535 "
                         f"nodes, got N={N}")
    n_trim = trim_count(K, beta)
    if K - 2 * n_trim < 1:
        raise ValueError(f"beta={beta} trims every one of the K={K} candidates")
    _check("updates", updates, torch.float32, (N, K, D), dev)
    if prev is not None:
        _check("prev", prev, torch.float32, (N, K, D), dev)
    fn = common.load(STATS_SOURCE, _bind_stats).robust_stats_batch_launch
    f32 = dict(dtype=torch.float32, device=dev)
    med = torch.empty((N, D), **f32) if need_center else None
    trim = torch.empty((N, D), **f32) if need_center else None
    n_blocks = common.grid_blocks(dev, -(-D // TILE), rows=N)
    n_out = 6 * K + 1
    partials = torch.empty((N, n_blocks, n_out), **f32)
    flat = torch.empty((N, n_out), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(_ptr(updates), _ptr(prev), _ptr(med), _ptr(trim), _ptr(partials),
                 _ptr(flat), N, K, D, n_trim, n_blocks, stream)
    common.launch_error("robust_stats_batch", err)
    batch_launches += 1
    f = [flat[:, i * K:(i + 1) * K] for i in range(6)]
    tail = f[3:] if prev is not None else [None, None, None]
    return RobustStats(med, trim, f[0], f[1], f[2], flat[:, 6 * K], *tail)
