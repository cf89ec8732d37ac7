"""Bind and launch the robust-statistics kernels of the port.

* ``csrc/wfagg_round.cu`` replaces the Pallas TPU kernel
  ``_wfagg_round_indexed_kernel`` / ``wfagg_round_indexed_pallas``
  (``src/repro/kernels/robust_stats/kernel.py:367`` / ``:511``): the whole
  gossip round in one launch.  It is bound by the bytes it must move:
  models, prev and local read once, out written once.  A cluster of up to
  8 CTAs per receiving node splits D; each CTA streams its tiles of the
  node's neighbour rows through shared memory (``cp.async``), rank 0 adds
  the ranks' statistics in rank order and scores the node, and every rank
  then combines its own tiles (the rows a second time).  With an Alt-WFAgg
  filter (Multi-Krum, Clustering) the Gram variant also accumulates each
  node's (K, K) Gram in register blocks and runs those filters in the
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
  the two-launch backend, in one launch; bound by bytes.  Both sources run
  one phase-0 body, ``csrc/indexed_phase0.cuh`` (with
  ``csrc/valid_median.cuh`` and ``kernels/csrc/tile_stream.cuh``).
* ``csrc/robust_stats.cu`` replaces ``_robust_stats_kernel`` in both of
  its launches: ``robust_stats_pallas`` (``kernel.py:70`` / ``:136``,
  ``d_axis=0``, kernel 4), the median, trimmed mean and WFAgg filter
  statistics of one (K, D) candidate matrix, as the single-node
  ``wfagg()`` and the CFL server call it; and ``robust_stats_batch_pallas``
  (``kernel.py:652``, ``d_axis=1``, kernel 5), the same for every node of
  a gathered (N, K, D) tensor, as the gathered ``wfagg_batch`` calls it.
  Bound by bytes.  B CTAs per node (B N about the CTAs the card holds,
  from the instance's occupancy: ``stats_plan``) stream the node's tiles
  through a ring of ``cp.async`` stages, sort each coordinate with an
  odd-even merge network of ``fminf``/``fmaxf`` and a per-column NaN flag,
  sum every term in float32 without fused multiply-adds (so
  ``ref.robust_stats_kernel_order`` reproduces the sums bit for bit), and
  the last CTA of a node, by a ticket, adds the CTAs' totals in block
  order: one launch per call.

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
MAX_NODES = 65535  # nodes are the grid's y axis in kernels 1, 2 and 5

# Kernel launches so far in this process, one counter per kernel: bumped
# once per launch, right where the kernel is launched.  A run that must
# show it went through a kernel sets its counter to 0 before and reads it
# after.
launches = 0                 # wfagg_round.cu
prev_idx_launches = 0        # wfagg_round.cu launches of the prev_idx variant
per_edge_launches = 0        # wfagg_round.cu launches with a per-edge prev
robust_stats_launches = 0    # robust_stats.cu, one matrix
batch_launches = 0           # robust_stats.cu, a gathered tensor
indexed_launches = 0         # robust_stats_indexed.cu
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
    fn.argtypes = [P] * 7 + [I, I, ctypes.c_longlong, P]
    fn.restype = I
    lib.indexed_cluster_size.argtypes = [ctypes.c_longlong]
    lib.indexed_cluster_size.restype = I


def cluster_size(D: int) -> int:
    """CTAs per node (the thread-block cluster size) that kernels 1 and 2
    take over D coordinates, as ``csrc/indexed_phase0.cuh`` decides it;
    builds the statistics library if needed, launches nothing."""
    return common.load(INDEXED_SOURCE, _bind_indexed).indexed_cluster_size(D)


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
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.robust_stats_launch
    fn.argtypes = [P] * 7 + [I, L, I, I, P]
    fn.restype = I
    fn = lib.robust_stats_batch_launch
    fn.argtypes = [P] * 7 + [I, I, L, I, I, P]
    fn.restype = I
    lib.robust_stats_plan.argtypes = [I, I, I, P]
    lib.robust_stats_plan.restype = I


_plans: dict = {}


def stats_plan(N: int, K: int, D: int, has_prev: bool, need_center: bool,
               device) -> dict:
    """How ``robust_stats.cu`` runs N nodes of K candidates over D
    coordinates on ``device``, as its C side decides it (builds the
    library if needed, launches nothing): ``stages`` of its ``cp.async``
    ring, ``tile`` coordinates per tile, ``ctas_per_sm`` (the occupancy of
    the instance), ``kp`` (the network's template width), ``specialised``
    (no padding wires) and ``blocks``, the CTAs per node: the card's
    resident CTAs shared among the N nodes, at least 1 and at most one per
    tile, rounded down so the grid runs in one wave."""
    dev = torch.device(device)
    key = (K, bool(has_prev), bool(need_center), dev)
    plan = _plans.get(key)
    if plan is None:
        fn = common.load(STATS_SOURCE, _bind_stats).robust_stats_plan
        out = (ctypes.c_int * 5)()
        with torch.cuda.device(dev):
            err = fn(K, int(bool(has_prev)), int(bool(need_center)), out)
        common.launch_error("robust_stats_plan", err)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = dict(stages=out[0], tile=out[1], ctas_per_sm=out[2], kp=out[3],
                    specialised=bool(out[4]), resident=out[2] * sms)
        _plans[key] = plan
    n_tiles = -(-D // plan["tile"])
    return dict(plan, blocks=max(1, min(n_tiles, plan["resident"] // N)))


_tickets: dict = {}


def _zeroed_tickets(N: int, dev: torch.device, stream: int) -> torch.Tensor:
    """At least N zeroed per-node counters for ``robust_stats.cu``'s
    launches on ``stream``: each node's last CTA resets its counter, so the
    buffer stays zero from one launch to the next (launches on one stream
    run in order) and is allocated once per stream."""
    t = _tickets.get((dev, stream))
    if t is None or t.numel() < N:
        t = torch.zeros((max(N, 64),), dtype=torch.int32, device=dev)
        _tickets[(dev, stream)] = t
    return t


def _launch_stats(entry: str, updates, prev, beta, need_center, N, K, D,
                  dev) -> RobustStats:
    """Allocate the outputs of one ``robust_stats.cu`` launch over N nodes
    (``entry`` ``robust_stats``: one matrix, no node axis) and launch it.
    The kernel writes the sums as (N, 7, K): rows dist2, dotmed, norm2,
    prev_dist2, prev_dot, prev_norm2, then mednorm2 at column 0 and zeros;
    the returned ``RobustStats`` views them."""
    n_trim = trim_count(K, beta)
    if K - 2 * n_trim < 1:
        raise ValueError(f"beta={beta} trims every one of the K={K} candidates")
    lib = common.load(STATS_SOURCE, _bind_stats)
    n_blocks = stats_plan(N, K, D, prev is not None, need_center, dev)["blocks"]
    f32 = dict(dtype=torch.float32, device=dev)
    lead = (N,) if entry == "robust_stats_batch" else ()
    med = torch.empty(lead + (D,), **f32) if need_center else None
    trim = torch.empty(lead + (D,), **f32) if need_center else None
    n_part = N * n_blocks * (6 * K + 1)
    # each CTA's totals, then the nodes' totals: one allocation
    sums = torch.empty((n_part + N * 7 * K,), **f32)
    out = sums[n_part:].view(lead + (7, K))
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = _zeroed_tickets(N, dev, stream)
    args = (_ptr(updates), _ptr(prev), _ptr(med), _ptr(trim), _ptr(sums), _ptr(tickets),
            _ptr(out), *((K,) if entry == "robust_stats" else (N, K)), D, n_trim,
            n_blocks, stream)
    with torch.cuda.device(dev):
        err = getattr(lib, f"{entry}_launch")(*args)
    common.launch_error(entry, err)
    f = out.unbind(-2)  # the RobustStats views in two tensor operations
    tail = f[3:6] if prev is not None else (None, None, None)
    return RobustStats(med, trim, f[0], f[1], f[2], f[6][..., 0], *tail)


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
    if not 1 <= N <= MAX_NODES:
        raise ValueError(f"the round kernel takes 1 <= N <= {MAX_NODES} nodes, "
                         f"got N={N}")
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

    Every output is allocated here with ``torch.empty``: one (N, 6K+1)
    tensor ``[dist2 | dotmed | norm2 | prev_dist2 | prev_dot | prev_norm2
    | mednorm2]`` that the returned ``RobustStats`` views, and the (N, K,
    K) Gram with ``need_gram``.  One launch.
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
    if not 1 <= N <= MAX_NODES:
        raise ValueError(f"the indexed statistics kernel takes 1 <= N <= {MAX_NODES} "
                         f"nodes, got N={N}")
    _check("models", models, torch.float32, (M, D), dev)
    _check("neighbor_idx", neighbor_idx, torch.int32, (N, K), dev)
    _check("valid", valid, torch.bool, (N, K), dev)
    prev, prev_idx, per_edge = _prev_rows(prev, prev_idx, M, N, K, D, dev)
    fn = common.load(INDEXED_SOURCE, _bind_indexed).robust_stats_indexed_launch
    f32 = dict(dtype=torch.float32, device=dev)
    flat = torch.empty((N, 6 * K + 1), **f32)
    gram = torch.empty((N, K, K), **f32) if need_gram else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(_ptr(models), _ptr(neighbor_idx), _ptr(valid), _ptr(prev),
                 _ptr(prev_idx), _ptr(flat), _ptr(gram), N, K, D, stream)
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
    """Launch the single-matrix statistics kernel (kernel 4) on the
    tensors' CUDA device and stream.

    Every output is allocated here with ``torch.empty``: the (D,) centers
    when ``need_center``, and one buffer of the per-CTA partial sums and
    the (7, K) sums that the returned ``RobustStats`` views.  One launch.
    """
    global robust_stats_launches
    K, D = updates.shape
    dev = updates.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"the robust_stats kernel takes 1 <= K <= {MAX_K} "
                         f"candidates, got K={K}")
    _check("updates", updates, torch.float32, (K, D), dev)
    if prev is not None:
        _check("prev", prev, torch.float32, (K, D), dev)
    st = _launch_stats("robust_stats", updates, prev, beta, need_center, 1, K, D, dev)
    robust_stats_launches += 1
    return st


def robust_stats_batch_cuda(
    updates: torch.Tensor,            # (N, K, D) f32
    prev: Optional[torch.Tensor],     # (N, K, D) f32 or None
    beta: float,
    need_center: bool,
) -> RobustStats:
    """Launch the batched statistics kernel (kernel 5) on the tensors' CUDA
    device and stream: every node's (K, D) slab of the gathered tensor.

    Every output is allocated here with ``torch.empty``: the (N, D)
    centers when ``need_center``, and one buffer of the per-CTA partial
    rows (N, blocks, 6K+1) and the (N, 7, K) sums that the returned
    ``RobustStats`` views ((N, K) fields, ``mednorm2`` (N,)).  One launch.
    """
    global batch_launches
    N, K, D = updates.shape
    dev = updates.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"the robust_stats_batch kernel takes 1 <= K <= {MAX_K} "
                         f"candidates, got K={K}")
    if not 1 <= N <= MAX_NODES:
        raise ValueError(f"the robust_stats_batch kernel takes 1 <= N <= {MAX_NODES} "
                         f"nodes, got N={N}")
    _check("updates", updates, torch.float32, (N, K, D), dev)
    if prev is not None:
        _check("prev", prev, torch.float32, (N, K, D), dev)
    st = _launch_stats("robust_stats_batch", updates, prev, beta, need_center, N, K, D,
                       dev)
    batch_launches += 1
    return st
