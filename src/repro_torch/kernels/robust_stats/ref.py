"""Plain PyTorch oracles for the robust statistics (port of
``repro.kernels.robust_stats.ref``).

``robust_stats_ref`` takes one candidate matrix ``updates (K, D)`` and
returns the median and beta-trimmed mean ``med, trim (D,)`` beside the
statistics below with K-shaped fields (``mednorm2`` a scalar);
``robust_stats_batch_ref`` does so for a gathered ``(N, K, D)`` tensor,
every field with a leading N axis.
``robust_stats_indexed_ref`` does the same for every receiving node n of a
gossip round, with candidate rows ``u_k = models[idx[n, k]]``:
  dist2     (N, K)  squared L2 distance of each candidate to the median model
  dotmed    (N, K)  inner product of each candidate with the median model
  norm2     (N, K)  squared L2 norm of each candidate
  mednorm2  (N,)    squared L2 norm of the median model
and, with the previous-round models ``prev``:
  prev_dist2 (N, K) squared L2 distance to the previous model (WFAgg-T s_t)
  prev_dot   (N, K) inner product with the previous model
  prev_norm2 (N, K) squared L2 norm of the previous model

These are the sufficient statistics of WFAgg-D (Alg. 2), WFAgg-C (Alg. 3)
and WFAgg-T (Alg. 4).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor


class RobustStats(NamedTuple):
    med: Optional[Tensor]
    trim: Optional[Tensor]
    dist2: Tensor
    dotmed: Tensor
    norm2: Tensor
    mednorm2: Tensor
    # temporal tail: populated only when ``prev`` was given
    prev_dist2: Optional[Tensor] = None
    prev_dot: Optional[Tensor] = None
    prev_norm2: Optional[Tensor] = None
    # (N, K, K) candidate Gram: populated only with ``need_gram``
    gram: Optional[Tensor] = None

    def cosine_to_median(self) -> Tensor:
        """1 - cos(theta_j, theta_med): the WFAgg-C metric (clip-invariant)."""
        denom = torch.sqrt(torch.clamp(self.norm2 * self.mednorm2[..., None],
                                       min=1e-24))
        return 1.0 - self.dotmed / denom

    def cosine_to_prev(self) -> Tensor:
        """1 - cos(theta_j^t, theta_j^{t-1}): the WFAgg-T b_t metric."""
        denom = torch.sqrt(torch.clamp(self.norm2 * self.prev_norm2, min=1e-24))
        return 1.0 - self.prev_dot / denom


def trim_count(K: int, beta: float) -> int:
    return int(beta * K)


def valid_median(u: Tensor, valid: Tensor) -> Tensor:
    """Median over the valid rows of ``u (N, K, D)``: invalid rows sort to
    +inf and the median is taken at the dynamic middles ``(v-1)//2`` and
    ``v//2`` of the node's valid count v.  A degree-0 node's empty median
    is 0, so every statistic stays finite (its valid mask rejects every
    slot and it keeps its local model)."""
    srt = torch.sort(torch.where(valid[..., None], u, torch.inf), dim=1).values
    v = valid.sum(dim=1)
    lo = torch.clamp((v - 1) // 2, min=0)    # v = 0 is zeroed below
    take = lambda j: torch.gather(  # noqa: E731
        srt, 1, j[:, None, None].expand(-1, 1, srt.shape[-1]))[:, 0, :]
    med = 0.5 * (take(lo) + take(v // 2))
    return torch.where((v > 0)[:, None], med, torch.zeros_like(med))


def robust_stats_indexed_ref(
    models: Tensor,                 # (M, D) model matrix
    neighbor_idx: Tensor,           # (N, K) rows into models (padded w/ self)
    valid: Optional[Tensor] = None,  # (N, K) bool; None = all valid
    prev: Optional[Tensor] = None,   # (N, K, D) per-edge or (M, D) matrix
    need_gram: bool = False,
    prev_idx: Optional[Tensor] = None,  # (N, K) rows into matrix ``prev``
) -> RobustStats:
    """Oracle for the gather-free round kernel (the oracle MAY gather).

    Per-candidate statistics are computed on the raw padded rows (a
    padded slot holds the node's own finite model); the caller masks
    them with ``valid``.  ``med``/``trim`` are None: the WFAgg filter bank
    never reads a d-sized center.
    """
    idx = neighbor_idx.long()
    u = models[idx].to(torch.float32)                 # (N, K, D)
    N, K, _ = u.shape
    vmask = (torch.ones((N, K), dtype=torch.bool, device=u.device)
             if valid is None else valid.to(torch.bool))
    med = valid_median(u, vmask)                      # (N, D)
    diff = u - med[:, None, :]
    dist2 = (diff * diff).sum(-1)
    dotmed = (u * med[:, None, :]).sum(-1)
    norm2 = (u * u).sum(-1)
    mednorm2 = (med * med).sum(-1)
    prev_dist2 = prev_dot = prev_norm2 = None
    if prev is not None:
        if prev_idx is not None and prev.ndim != 2:
            raise ValueError("prev_idx requires a matrix-form prev")
        pidx = idx if prev_idx is None else prev_idx.long()
        pe = (prev[pidx] if prev.ndim == 2 else prev).to(torch.float32)
        dp = u - pe
        prev_dist2 = (dp * dp).sum(-1)
        prev_dot = (u * pe).sum(-1)
        prev_norm2 = (pe * pe).sum(-1)
    gram = torch.einsum("nkd,njd->nkj", u, u) if need_gram else None
    return RobustStats(None, None, dist2, dotmed, norm2, mednorm2,
                       prev_dist2, prev_dot, prev_norm2, gram)


# the summation order of the CUDA kernels 1 and 2 (csrc/indexed_phase0.cuh)
KERNEL_TILE = 256                # coordinates per tile (kTile)
KERNEL_WARPS = 8                 # warps per CTA (kWarps)
KERNEL_GROUPS = KERNEL_TILE // 4  # float4 groups of a tile row (kGroups)
INDEXED_NARROW_K = 32            # the register route's K (kNarrowK); above: the wide route
GRAM_CHUNK = 16                  # the wide route's Gram: coordinates a step (kGramChunk)


def _fma(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """float32 ``fmaf(a, b, c)``: the product is exact in float64, rounded
    once there and once to float32 (the hardware rounds once; the two agree
    but for a rare double rounding)."""
    return (a.double() * b.double() + c.double()).float()


def _butterfly(x: Tensor) -> Tensor:
    """The xor butterfly over the last axis (32 lanes, or any power of
    two): lane 0's sum."""
    lanes = torch.arange(x.shape[-1], device=x.device)
    o = x.shape[-1] // 2
    while o:
        x = x + x[..., lanes ^ o]
        o //= 2
    return x[..., 0]


def _in_order(parts: Tensor) -> Tensor:
    """0 + parts[..., 0] + parts[..., 1] + ..., left to right."""
    t = torch.zeros_like(parts[..., 0])
    for r in range(parts.shape[-1]):
        t = t + parts[..., r]
    return t


def robust_stats_indexed_kernel_order(
    models: Tensor,
    neighbor_idx: Tensor,
    valid: Optional[Tensor] = None,
    prev: Optional[Tensor] = None,
    need_gram: bool = False,
    prev_idx: Optional[Tensor] = None,
    cluster: int = 8,
) -> RobustStats:
    """``robust_stats_indexed_ref`` summed in the order of the CUDA kernels
    1 and 2 (``csrc/indexed_phase0.cuh``) with ``cluster`` CTAs per node:
    the D axis in tiles of 256 coordinates, rank r of the cluster taking
    tiles r, r + C, ... (C = min(cluster, tiles)); per slot, lane i of a
    warp adds coordinates 4i .. 4i + 3 and 128 + 4i .. 128 + 4i + 3 of a
    tile, each term the float32 value the plain version forms, into
    running float64 sums (rounded to float32 last); the 32 lanes by an xor
    butterfly; mednorm2 per thread (one coordinate of each tile, float64),
    by warp butterflies and the 8 warps in order; the Gram, in float32,
    per slice s of the S of each 4 x 4 block
    pair (float4 groups s, s + S, ... of each tile, one fmaf chain over
    all tiles), the slices in order; then the C ranks in order.

    K > 32, the wide route (``csrc/indexed_wide.cuh``): the same cluster
    of C ranks over tiles of ``wide_tile(K)`` coordinates; per slot,
    ``wide_group(K)`` = G groups, group g adding columns g, g + G, ... of
    each of its rank's tiles in order into running float64 sums, the G
    groups in order; mednorm2 per thread as above; the Gram per rank one
    fmaf chain an entry over the rank's coordinates in order (rank r
    takes the 16-coordinate chunks [r P, (r + 1) P), P = ceil(chunks /
    C)), the ranks in order.

    A plain version of the order, for the CPU tests; the sums equal the
    kernel's but for a rare double rounding of the Gram's ``_fma``."""
    idx = neighbor_idx.long()
    u = models[idx].to(torch.float32)                  # (N, K, D)
    N, K, D = u.shape
    v = (torch.ones((N, K), dtype=torch.bool, device=u.device) if valid is None
         else valid.to(torch.bool))
    wide = K > INDEXED_NARROW_K
    T = wide_tile(K) if wide else KERNEL_TILE
    C = min(cluster, -(-D // KERNEL_TILE))             # the cluster: 256-coordinate tiles
    n_tiles = -(-D // T)
    my = -(-n_tiles // C)                              # tiles of rank 0, the most
    pad = my * C * T - D
    # tile t = i C + r of rank r exists while t < n_tiles: (my, C)
    exists = (torch.arange(my)[:, None] * C + torch.arange(C)[None, :]) < n_tiles
    exists = exists.to(u.device)
    tiles = lambda x: torch.nn.functional.pad(x, (0, pad)).reshape(  # noqa: E731
        *x.shape[:-1], my, C, T)
    med = valid_median(u, v)
    U, M = tiles(u), tiles(med)                        # (N, K, my, C, T), (N, my, C, T)
    P = None
    if prev is not None:
        if prev_idx is not None and prev.ndim != 2:
            raise ValueError("prev_idx requires a matrix-form prev")
        pidx = idx if prev_idx is None else prev_idx.long()
        P = tiles((prev[pidx] if prev.ndim == 2 else prev).to(torch.float32))
    if wide:
        return _indexed_wide_order(u, U, M, P, exists, need_gram, C)

    # per-slot sums: fields (N, K, C, 32 lanes), float64
    lane = lambda X, i, p, e: X[..., i, :, :].reshape(  # noqa: E731
        *X.shape[:-3], C, 2, 32, 4)[..., p, :, e]
    n_fields = 6 if P is not None else 3
    acc = torch.zeros((n_fields, N, K, C, 32), dtype=torch.float64, device=u.device)
    mn2 = torch.zeros((N, C, KERNEL_TILE), dtype=torch.float64, device=u.device)
    for i in range(my):
        live = exists[i][:, None]                      # (C, 1)
        for p in range(2):
            for e in range(4):
                x, m = lane(U, i, p, e), lane(M, i, p, e)[:, None]
                dd = x - m
                terms = [dd * dd, x * m, x * x]
                if P is not None:
                    q = lane(P, i, p, e)
                    dp = x - q
                    terms += [dp * dp, x * q, q * q]
                acc = torch.where(live, acc + torch.stack(terms).double(), acc)
        mi = M[:, i]                                   # (N, C, T)
        mn2 = torch.where(live, mn2 + (mi * mi).double(), mn2)
    fields = _in_order(_butterfly(acc)).float()        # (n_fields, N, K)
    warps = _butterfly(mn2.reshape(N, C, KERNEL_WARPS, 32))
    mednorm2 = _in_order(_in_order(warps)).float()

    gram = None
    if need_gram:
        nb = (K + 3) // 4
        S = min(256 // (nb * (nb + 1) // 2), KERNEL_GROUPS)
        steps = -(-KERNEL_GROUPS // S)
        G = torch.zeros((N, K, K, C, S), device=u.device)
        UG = U.reshape(N, K, my, C, KERNEL_GROUPS, 4)
        for i in range(my):
            for q in range(steps):
                g = torch.arange(S, device=u.device) + S * q     # slice s's group
                live = exists[i][:, None] & (g < KERNEL_GROUPS)[None, :]  # (C, S)
                xg = UG[:, :, i].index_select(3, g.clamp(max=KERNEL_GROUPS - 1))
                for e in range(4):
                    x = xg[..., e]                               # (N, K, C, S)
                    G = torch.where(live, _fma(x[:, :, None], x[:, None, :], G), G)
        gram = _in_order(_in_order(G))                 # slices, then ranks
    tail = tuple(fields[3:]) if P is not None else (None, None, None)
    return RobustStats(None, None, fields[0], fields[1], fields[2], mednorm2, *tail, gram)


def _indexed_wide_order(u: Tensor, U: Tensor, M: Tensor, P: Optional[Tensor],
                        exists: Tensor, need_gram: bool, C: int) -> RobustStats:
    """The wide route's order (``robust_stats_indexed_kernel_order`` above
    K = 32) on the tiled rows ``U (N, K, my, C, T)``, the tiled median ``M
    (N, my, C, T)`` and prev ``P``."""
    N, K, D = u.shape
    T, G = U.shape[-1], wide_group(K)
    n_fields = 6 if P is not None else 3
    acc = torch.zeros((n_fields, N, K, C, G), dtype=torch.float64, device=u.device)
    mn2 = torch.zeros((N, C, KERNEL_TILE), dtype=torch.float64, device=u.device)
    for i in range(U.shape[-3]):
        live = exists[i][:, None]                      # (C, 1)
        for c in range(0, T, G):
            x, m = U[..., i, :, c:c + G], M[:, i, :, c:c + G][:, None]
            dd = x - m
            terms = [dd * dd, x * m, x * x]
            if P is not None:
                q = P[..., i, :, c:c + G]
                dp = x - q
                terms += [dp * dp, x * q, q * q]
            acc = torch.where(live, acc + torch.stack(terms).double(), acc)
        mi = M[:, i]                                   # (N, C, T)
        mn2[..., :T] = torch.where(live, mn2[..., :T] + (mi * mi).double(), mn2[..., :T])
    fields = _in_order(_in_order(acc)).float()         # groups, then ranks
    warps = _butterfly(mn2.reshape(N, C, KERNEL_WARPS, 32))
    mednorm2 = _in_order(_in_order(warps)).float()

    gram = None
    if need_gram:
        n_chunks = -(-D // GRAM_CHUNK)
        span = -(-n_chunks // C) * GRAM_CHUNK          # coordinates of a rank
        X = torch.nn.functional.pad(u, (0, C * span - D)).reshape(N, K, C, span)
        Gr = torch.zeros((N, K, K, C), device=u.device)
        for q in range(span):
            x = X[..., q]                              # (N, K, C)
            Gr = _fma(x[:, :, None], x[:, None, :], Gr)
        gram = _in_order(Gr)                           # ranks
    tail = tuple(fields[3:]) if P is not None else (None, None, None)
    return RobustStats(None, None, fields[0], fields[1], fields[2], mednorm2, *tail, gram)


SORT_CHUNK = 1 << 24      # elements a column block of ``sort_columns`` sorts at once


def sort_columns(u: Tensor) -> Tensor:
    """Columns of ``u (..., K, D)`` sorted along the K axis, a column
    holding a NaN all NaN: what a sorting network whose compare-exchange
    propagates NaN (``jnp.minimum``/``jnp.maximum``, the Pallas kernel's)
    returns, and what ``jnp.median`` computes on.  Sorted in blocks of
    columns of about ``SORT_CHUNK`` elements, so that the sort's indices
    (8 bytes an element) and the NaN mask never exist for the whole of a
    large ``u`` (an LM's stacked (K, P) leaf)."""
    step = max(1, SORT_CHUNK // max(1, u[..., 0].numel()))
    if u.shape[-1] <= step:
        srt = torch.sort(u, dim=-2).values
        return torch.where(torch.isnan(u).any(-2, keepdim=True), torch.nan, srt)
    out = torch.empty_like(u)
    for c in range(0, u.shape[-1], step):
        out[..., c:c + step] = sort_columns(u[..., c:c + step])
    return out


def median_and_trim(srt: Tensor, beta: float):
    """Median (mean of the two middles for even K) and beta-trimmed mean of
    columns already sorted along the K axis of ``srt (..., K, D)``."""
    K = srt.shape[-2]
    med = (srt[..., K // 2, :] if K % 2 == 1
           else 0.5 * (srt[..., K // 2 - 1, :] + srt[..., K // 2, :]))
    t = trim_count(K, beta)
    return med, srt[..., t:K - t, :].mean(-2)


def center_stats(u: Tensor, med: Optional[Tensor], trim: Optional[Tensor],
                 prev: Optional[Tensor] = None,
                 center: Optional[Tensor] = None) -> RobustStats:
    """The per-candidate sums of ``u (..., K, D)`` about the median
    ``center (..., D)`` (``med`` unless given), with the temporal tail when
    ``prev`` (``u``'s shape) is given; ``med``/``trim`` are passed through
    to the result."""
    c = (med if center is None else center).unsqueeze(-2)
    diff = u - c
    prev_dist2 = prev_dot = prev_norm2 = None
    if prev is not None:
        pe = prev.to(torch.float32)
        dp = u - pe
        prev_dist2 = (dp * dp).sum(-1)
        prev_dot = (u * pe).sum(-1)
        prev_norm2 = (pe * pe).sum(-1)
    return RobustStats(med, trim, (diff * diff).sum(-1), (u * c).sum(-1),
                       (u * u).sum(-1), (c * c).sum((-2, -1)), prev_dist2, prev_dot,
                       prev_norm2)


def robust_stats_ref(updates: Tensor, beta: float = 0.1,
                     prev: Optional[Tensor] = None) -> RobustStats:
    """Oracle of the single-matrix statistics: sorted median and
    beta-trimmed mean of ``updates (K, D)`` and the statistics about the
    median."""
    u = updates.to(torch.float32)
    med, trim = median_and_trim(torch.sort(u, dim=0).values, beta)
    return center_stats(u, med, trim, prev)


def robust_stats_batch_ref(updates: Tensor, prev: Optional[Tensor] = None,
                           beta: float = 0.1, need_center: bool = True) -> RobustStats:
    """The statistics of every node's gathered candidates ``updates (N, K,
    D)`` (with ``prev (N, K, D)`` the per-edge temporal tail), as the
    batched kernel computes them: every field with a leading N axis,
    ``mednorm2`` (N,), ``med``/``trim`` (N, D) or None without
    ``need_center``.  A column holding a NaN sorts to all NaN, as the
    kernel's network does, so its median and trimmed mean are NaN (unlike
    the reference's ``jnp.sort`` oracle, which sorts a NaN last).  The
    plain version of the batched kernel: the tests and CPU tensors use it."""
    u = updates.to(torch.float32)
    med, trim = median_and_trim(sort_columns(u), beta)
    if not need_center:
        return center_stats(u, None, None, prev, center=med)
    return center_stats(u, med, trim, prev)


NETWORK_MAX_K = 32          # K of csrc/robust_stats.cu's register network; above: the wide path
WIDE_SORT_BYTES = 64 << 10  # the wide path's sort buffer, at most (kWideSortBytes) ...
WIDE_MIN_TILE = 16
WIDE_MAX_TILE = 256


def wide_width(K: int) -> int:
    """The wide path's sort width: K rounded up to a power of two (the rows
    past K hold +inf)."""
    return 1 << (K - 1).bit_length()


def wide_tile(K: int) -> int:
    """Coordinates per tile of the wide path (``wide_tile`` in
    ``csrc/robust_stats.cu``): the widest power of two up to 256 whose
    (width, tile) sort buffer fits ``WIDE_SORT_BYTES`` (16 at K = 1,024)."""
    t = WIDE_MAX_TILE
    while t > WIDE_MIN_TILE and wide_width(K) * t * 4 > WIDE_SORT_BYTES:
        t //= 2
    return t


def wide_group(K: int) -> int:
    """Threads per candidate in the wide path's sums (``wide_group`` in
    ``csrc/robust_stats.cu``): the largest power of two G with G K <=
    256."""
    g = 1
    while 2 * g * K <= 256:
        g *= 2
    return g


def bitonic_sort(wires: Tensor) -> Tensor:
    """Columns of ``wires (..., KP, D)`` (KP a power of two) sorted along
    the KP axis by the wide path's bitonic network: stage (k, j) pairs row
    ``lo = 2j (p // j) + p % j`` with ``lo + j`` for p < KP/2, the smaller
    value to ``lo`` where ``lo & k == 0`` (ascending blocks) and to ``lo +
    j`` otherwise, with ``torch.fmin`` / ``torch.fmax`` (a NaN is dropped,
    as ``fminf`` / ``fmaxf`` drop it).  The kernel runs the same stages,
    those inside a 64-rank run in registers; a network's output does not
    depend on where its compare-exchanges run."""
    KP = wires.shape[-2]
    p = torch.arange(KP // 2, device=wires.device)
    k = 2
    while k <= KP:
        j = k // 2
        while j >= 1:
            lo = 2 * j * (p // j) + p % j
            hi = lo + j
            up = ((lo & k) == 0)[:, None]
            a, b = wires[..., lo, :], wires[..., hi, :]
            mn, mx = torch.fmin(a, b), torch.fmax(a, b)
            out = torch.empty_like(wires)
            out[..., lo, :] = torch.where(up, mn, mx)
            out[..., hi, :] = torch.where(up, mx, mn)
            wires = out
            j //= 2
        k *= 2
    return wires


def network_pairs(K: int) -> list:
    """The compare-exchanges ``(lo, hi)`` of ``csrc/robust_stats.cu``'s
    median network on K <= 32 wires, in its order (``odd_even_sort``):
    Batcher's odd-even merge sort on the template width (8, 16 or 32),
    every one ascending (the smaller value to ``lo``), less those that
    touch a padding wire ``>= K`` (they leave +inf in place)."""
    kp = 8 if K <= 8 else 16 if K <= 16 else 32
    lg = kp.bit_length() - 1
    pairs = []
    for lp in range(lg):
        for lk in range(lp, -1, -1):
            p, k = 1 << lp, 1 << lk
            j0 = k % p
            for lo in range(kp):
                hi = lo + k
                if (lo >= j0 and (lo - j0) % (2 * k) < k and hi < K
                        and lo // (2 * p) == hi // (2 * p)):
                    pairs.append((lo, hi))
    return pairs


def robust_stats_kernel_order(
    updates: Tensor,
    prev: Optional[Tensor] = None,
    beta: float = 0.1,
    need_center: bool = True,
    blocks: int = 1,
) -> RobustStats:
    """``robust_stats_batch_ref`` of ``updates (N, K, D)`` (or ``(K, D)``,
    kernel 4's single matrix, then every field without the N axis)
    computed in the order of the CUDA kernels 4 and 5
    (``csrc/robust_stats.cu``) with ``blocks`` CTAs per node.

    K <= 32, the register path: the median network of ``network_pairs``
    with ``torch.fmin`` / ``torch.fmax`` (a NaN is dropped) and a
    per-column NaN flag that makes ``med`` and ``trim`` NaN; ``trim`` the
    sorted ranks t .. K-t-1 added in rank order and divided; D in tiles of
    256 coordinates, CTA b taking tiles b, b + B, ... (B = min(blocks,
    tiles)); per slot, lane i adding coordinates 4i .. 4i + 3 and 128 + 4i
    .. 128 + 4i + 3 of a tile, each term the float32 value the plain
    version forms, into float32 running sums (no fused multiply-add); the
    32 lanes by an xor butterfly; mednorm2 per thread (one coordinate of
    each tile), by warp butterflies and the 8 warps in order; then the B
    CTAs in block order.

    K > 32, the wide path: each column's K values and ``wide_width(K) -
    K`` rows of +inf through ``bitonic_sort``, the same NaN flag and
    median, the trimmed sum in rank order in float64, divided there and
    rounded to float32 once; D in tiles of ``wide_tile(K)`` coordinates dealt to
    the CTAs as above; per slot, ``wide_group(K)`` = G groups, group g
    adding coordinates g, g + G, ... of each of its CTA's tiles in order into
    one float32 running sum, the G groups by an xor butterfly; mednorm2 per
    thread (thread t the tile's coordinate t), by warp butterflies and the
    warps in order; then the B CTAs in block order.

    Every operation is a float32 (the wide trimmed sum: float64) operation
    the kernel also performs, so on the same inputs the results equal the
    kernel's bit for bit."""
    single = updates.ndim == 2
    u = updates.to(torch.float32)
    pe = None if prev is None else prev.to(torch.float32)
    if single:
        u = u[None]
        pe = None if pe is None else pe[None]
    N, K, D = u.shape
    wide = K > NETWORK_MAX_K

    # the median network (or the bitonic sort) and the NaN flag
    if wide:
        inf = torch.full((N, wide_width(K) - K, D), torch.inf, device=u.device)
        wires = list(bitonic_sort(torch.cat([u, inf], 1)).unbind(1))
    else:
        wires = list(u.unbind(1))
        for lo, hi in network_pairs(K):
            a, b = wires[lo], wires[hi]
            wires[lo], wires[hi] = torch.fmin(a, b), torch.fmax(a, b)
    nan = torch.isnan(u).any(1)                          # (N, D)
    med = wires[K // 2] if K % 2 == 1 else 0.5 * (wires[K // 2 - 1] + wires[K // 2])
    med = torch.where(nan, torch.nan, med)
    trim = None
    if need_center:
        t = trim_count(K, beta)
        # the register path sums in float32, the wide path in double
        acc = torch.float64 if wide else torch.float32
        tsum = torch.zeros_like(med, dtype=acc)
        for r in range(t, K - t):
            tsum = tsum + wires[r].to(acc)
        trim = (tsum / torch.full_like(tsum, K - 2 * t)).float()
        trim = torch.where(nan, torch.nan, trim)

    T = wide_tile(K) if wide else KERNEL_TILE
    n_tiles = -(-D // T)
    B = min(blocks, n_tiles)
    my = -(-n_tiles // B)                                # tiles of CTA 0, the most
    pad = my * B * T - D
    exists = (torch.arange(my)[:, None] * B + torch.arange(B)[None, :]) < n_tiles
    exists = exists.to(u.device)
    tiles = lambda x: torch.nn.functional.pad(x, (0, pad)).reshape(  # noqa: E731
        *x.shape[:-1], my, B, T)
    U, M = tiles(u), tiles(med)                          # (N, K, my, B, T), (N, my, B, T)
    P = None if pe is None else tiles(pe)
    n_fields = 6 if P is not None else 3

    def terms(x, m, p):
        dd = x - m
        out = [dd * dd, x * m, x * x]
        if p is not None:
            dp = x - p
            out += [dp * dp, x * p, p * p]
        return torch.stack(out)

    mn2 = torch.zeros((N, B, T), dtype=torch.float32, device=u.device)
    if wide:
        G = wide_group(K)
        acc = torch.zeros((n_fields, N, K, B, G), dtype=torch.float32, device=u.device)
        for i in range(my):
            live = exists[i][:, None]                    # (B, 1)
            mi = M[:, i]                                 # (N, B, T)
            mn2 = torch.where(live, mn2 + mi * mi, mn2)
            for c in range(0, T, G):
                x, m = U[..., i, :, c:c + G], mi[:, None, :, c:c + G]
                p = None if P is None else P[..., i, :, c:c + G]
                acc = torch.where(live, acc + terms(x, m, p), acc)
        fields = _in_order(_butterfly(acc))              # (n_fields, N, K)
    else:
        lane = lambda X, i, q, e: X[..., i, :, :].reshape(  # noqa: E731
            *X.shape[:-3], B, 2, 32, 4)[..., q, :, e]
        acc = torch.zeros((n_fields, N, K, B, 32), dtype=torch.float32, device=u.device)
        for i in range(my):
            live = exists[i][:, None]                    # (B, 1)
            mi = M[:, i]                                 # (N, B, T)
            mn2 = torch.where(live, mn2 + mi * mi, mn2)
            for q in range(2):
                for e in range(4):
                    x, m = lane(U, i, q, e), lane(M, i, q, e)[:, None]
                    p = None if P is None else lane(P, i, q, e)
                    acc = torch.where(live, acc + terms(x, m, p), acc)
        fields = _in_order(_butterfly(acc))              # (n_fields, N, K)
    if T < 32:                                           # warp 0's other lanes add 0
        mn2 = torch.nn.functional.pad(mn2, (0, 32 - T))
    warps = _butterfly(mn2.reshape(N, B, -1, 32))
    mednorm2 = _in_order(_in_order(warps))
    tail = tuple(fields[3:]) if P is not None else (None, None, None)
    st = RobustStats(med if need_center else None, trim, fields[0], fields[1],
                     fields[2], mednorm2, *tail)
    if single:
        st = RobustStats(*(None if f is None else f[0] for f in st))
    return st
