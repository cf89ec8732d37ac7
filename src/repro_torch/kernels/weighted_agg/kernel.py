"""Bind and launch the WFAgg-E combine kernels.

* ``csrc/weighted_agg.cu`` replaces the Pallas TPU kernel
  ``_weighted_agg_kernel`` / ``weighted_agg_pallas``
  (``src/repro/kernels/weighted_agg/kernel.py:22`` / ``:88``): one node's
  ``out = lcoef * local + wvec @ U``: a grid-stride stream of vector
  loads, each thread walking the K rows over its coordinates.
* ``csrc/weighted_agg_indexed.cu`` replaces
  ``_weighted_agg_indexed_kernel`` / ``weighted_agg_indexed_pallas``
  (``kernel.py:30`` / ``:56``): every node of a gossip round,
  ``out[n] = lcoef[n] * local[n] + sum_k wvec[n, k] * models[idx[n, k]]``,
  the rows read through the table (the combine launch of the two-launch
  backend).  A CTA combines a group of G nodes over its D-tiles and
  stages each distinct row the group's table reaches once per tile
  (``combine_plan``); any K up to ``MAX_K`` = 1,024, and where one node's
  distinct rows do not fit, the direct route reads them in slot order
  from device memory.

Both add each slot's float32 product in slot order without fused
multiply-adds, so each equals its plain version (``ops.py``) bit for
bit; both are bound by the bytes they move (each input read once, out
written once; see the sources' headers) and take rows of any D and
alignment (16-, 8- or 4-byte copies, nothing padded).  Built with
``nvcc`` at first use (``kernels.common.build``) and called through
``ctypes`` on PyTorch's current stream; nothing runs at import.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import common

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "weighted_agg.cu"
INDEXED_SOURCE = CSRC / "weighted_agg_indexed.cu"
MAX_K = 1024           # kernel 3 (weighted_agg_indexed.cu); kernel 7 takes any K
MAX_NODES = 65535      # groups are the grid's y axis of weighted_agg_indexed.cu
BEYOND = "ROADMAP queue 2, item E"   # where kernel 3's limit is lifted next
DIRECT_THREADS = 256   # the direct route's CTA (kDirectThreads)
DIRECT_VEC = 4         # coordinates a thread of it takes at once, at most

# combine_plan's choices.  weighted_agg_indexed.cu owns the shared-memory
# layout (_smem_bytes restates its sum) and checks only what it needs: an
# instance for the tile, two stages or more, SMEM_BYTES at most.
SMEM_BYTES = 232448    # 227 KB: the dynamic shared memory one CTA may use on Hopper
TILES = (128, 64, 32)  # coordinates per tile, widest first: the kernel's instances
MIN_STAGES, MAX_STAGES = 3, 8
IN_FLIGHT_BYTES = 32 << 10

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
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.weighted_agg_indexed_launch
    fn.argtypes = [P] * 6 + [I, I, I, ctypes.c_longlong, I, I, I, I, P]
    fn.restype = I
    lib.weighted_agg_indexed_occupancy.argtypes = [I, I, P]
    lib.weighted_agg_indexed_occupancy.restype = I


def _smem_bytes(rows: int, group: int, K: int, tile: int, stages: int) -> int:
    """Dynamic shared memory of weighted_agg_indexed.cu (its smem_bytes): the
    ring, a (weight, row) pair per slot and per local row (an even count a
    node), the staged rows' keys and their counter."""
    return 4 * stages * rows * tile + 8 * group * ((K + 2) & ~1) + 4 * (rows + 1)


_combine_plans: dict = {}


def combine_plan(M: int, N: int, K: int, D: int, device=None) -> dict:
    """How ``weighted_agg_indexed.cu`` combines N nodes of K slots over an
    (M, D) row matrix, from M, N and K alone:

    * ``group`` G: the most consecutive nodes one CTA combines, N wherever
      a stage of ``rows`` = min(M, G K) + G rows (every distinct row the
      group's table can reach, and its local rows) fits three times at the
      narrowest tile; ``n_groups`` groups of G (the last one shorter);
    * ``tile`` T: the widest of 128, 64, 32 coordinates at which three
      stages fit;
    * ``stages``: the fewest (at least 3) that keep 32 KB in flight (one
      tile read while stages - 1 are in flight), at most 8, within
      ``SMEM_BYTES`` with the slots' (weight, row) pairs; ``smem`` bytes;
    * ``n_tiles`` D-tiles;
    * ``route`` "staged"; or "direct" where one node's rows do not fit three
      stages of the narrowest tile (K above ~600 over as many rows): one node
      a group, ``tile`` and ``stages`` 0, no shared ring (``smem`` 0), and
      ``n_tiles`` the CTA-wide spans of ``DIRECT_THREADS`` vectors.

    With a CUDA ``device`` (the library built if needed, nothing launched)
    also ``ctas_per_sm``, the occupancy of that tile's instance at that
    shared memory, and ``blocks``, the CTAs per group: the card's resident
    CTAs shared among the groups, at least 1, at most one per tile."""
    if not (M >= 1 and 1 <= N <= MAX_NODES and 1 <= K <= MAX_K and D >= 1):
        raise ValueError(f"combine_plan takes M >= 1, 1 <= N <= {MAX_NODES}, "
                         f"1 <= K <= {MAX_K} and D >= 1, got M={M}, N={N}, K={K}, D={D} "
                         f"({BEYOND})")

    def rows(g):
        return min(M, g * K) + g

    def fits(g, tile, stages):
        return _smem_bytes(rows(g), g, K, tile, stages) <= SMEM_BYTES

    if not fits(1, TILES[-1], MIN_STAGES):
        plan = dict(route="direct", group=1, n_groups=N, rows=rows(1), tile=0, stages=0,
                    smem=0, n_tiles=-(-D // (DIRECT_THREADS * DIRECT_VEC)))
    else:
        lo, hi = 1, N                  # fits() falls as G grows
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if fits(mid, TILES[-1], MIN_STAGES) else (lo, mid - 1)
        g = lo
        tile = next(t for t in TILES if fits(g, t, MIN_STAGES))
        stage = 4 * rows(g) * tile
        stages = min(MAX_STAGES, max(MIN_STAGES, 1 + -(-IN_FLIGHT_BYTES // stage)))
        while stages > MIN_STAGES and not fits(g, tile, stages):
            stages -= 1
        plan = dict(route="staged", group=g, n_groups=-(-N // g), rows=rows(g), tile=tile,
                    stages=stages, smem=_smem_bytes(rows(g), g, K, tile, stages),
                    n_tiles=-(-D // tile))
    if device is None or torch.device(device).type != "cuda":
        return plan
    dev = torch.device(device)
    out = (ctypes.c_int * 1)()
    with torch.cuda.device(dev):
        err = common.load(INDEXED_SOURCE, _bind_indexed).weighted_agg_indexed_occupancy(
            plan["tile"], plan["smem"], out)
    common.launch_error("weighted_agg_indexed_occupancy", err)
    resident = max(1, out[0]) * torch.cuda.get_device_properties(dev).multi_processor_count
    return dict(plan, ctas_per_sm=out[0],
                blocks=max(1, min(plan["n_tiles"], resident // plan["n_groups"])))


def weighted_agg_cuda(wvec: torch.Tensor,    # (K,) f32, eff_alpha * w_norm
                      lcoef: torch.Tensor,   # (1,) f32, 1 - eff_alpha
                      local: torch.Tensor,   # (D,) f32
                      updates: torch.Tensor  # (K, D) f32
                      ) -> torch.Tensor:
    """Launch the combine on the tensors' CUDA device and stream; returns
    ``out (D,)``, allocated here.  Any K >= 1 and D >= 1."""
    global launches
    K, D = updates.shape
    dev = updates.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if K < 1 or D < 1:
        raise ValueError(f"the weighted_agg kernel takes K >= 1 and D >= 1, "
                         f"got K={K}, D={D}")
    for name, t, shape in (("wvec", wvec, (K,)), ("lcoef", lcoef, (1,)),
                           ("local", local, (D,)), ("updates", updates, (K, D))):
        common.check_tensor(name, t, torch.float32, shape, dev)
    fn = common.load(SOURCE, _bind).weighted_agg_launch
    out = torch.empty((D,), dtype=torch.float32, device=dev)
    n_blocks = common.grid_blocks(dev, -(-D // 256))  # the C side trims it to its vectors
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(wvec.data_ptr(), lcoef.data_ptr(), local.data_ptr(),
                 updates.data_ptr(), out.data_ptr(), K, D, n_blocks, stream)
    common.launch_error("weighted_agg", err)
    launches += 1
    return out


def weighted_agg_indexed_cuda(wvec: torch.Tensor,    # (N, K) f32, eff_alpha * w_norm
                              lcoef: torch.Tensor,   # (N,) f32, 1 - eff_alpha
                              local: torch.Tensor,   # (N, D) f32
                              models: torch.Tensor,  # (M, D) f32
                              neighbor_idx: torch.Tensor  # (N, K) int32 in [0, M)
                              ) -> torch.Tensor:
    """Launch the gather-free combine on the tensors' CUDA device and
    stream; returns ``out (N, D)``, allocated here.  ``local`` may be
    ``models`` itself (its rows are then staged once with the table's)."""
    global indexed_launches
    N, K = neighbor_idx.shape
    M, D = models.shape
    dev = models.device
    if not 1 <= K <= MAX_K or not 1 <= N <= MAX_NODES or D < 1:
        raise ValueError(f"the weighted_agg_indexed kernel takes 1 <= K <= {MAX_K}, "
                         f"1 <= N <= {MAX_NODES} and D >= 1, got N={N}, K={K}, D={D} "
                         f"({BEYOND})")
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    for name, t, dtype, shape in (
            ("wvec", wvec, torch.float32, (N, K)), ("lcoef", lcoef, torch.float32, (N,)),
            ("local", local, torch.float32, (N, D)),
            ("models", models, torch.float32, (M, D)),
            ("neighbor_idx", neighbor_idx, torch.int32, (N, K))):
        common.check_tensor(name, t, dtype, shape, dev)
    plan = _combine_plans.get((M, N, K, D, dev))
    if plan is None:
        plan = _combine_plans[(M, N, K, D, dev)] = combine_plan(M, N, K, D, dev)
    fn = common.load(INDEXED_SOURCE, _bind_indexed).weighted_agg_indexed_launch
    out = torch.empty((N, D), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(wvec.data_ptr(), lcoef.data_ptr(), local.data_ptr(),
                 models.data_ptr(), neighbor_idx.data_ptr(), out.data_ptr(),
                 N, K, M, D, plan["group"], plan["tile"], plan["stages"],
                 plan["blocks"], stream)
    common.launch_error("weighted_agg_indexed", err)
    indexed_launches += 1
    return out
