"""Byzantine-robust all-reduce (port of
``repro.distributed.robust_allreduce``): WFAgg, or a baseline, as a
drop-in for the data-parallel mean-gradient all-reduce, in the
reference's two layouts.

**Flat** (``robust_allreduce``, the reference's default): each candidate
worker holds its own flat gradient.  Phase 1 streams it in chunks of
``cfg.chunk_size``: each chunk is all-gathered as a transient (K, chunk)
block, whose coordinate median, distances, dots, Gram and the worker's
AMS count-sketch (WFAgg-T's state) accumulate; phase 2 turns them into
consensus weights and a second pass over the chunks sums the weighted
candidates.  The candidate axis is either a ``torch.distributed`` process
group with one rank per candidate (rank = candidate index) or
``Emulated(K)``: one process holding all K candidates as a (K, P) tensor,
which computes what every rank would (``jax.vmap(axis_name=...)`` over
the reference is its counterpart).  Every sum over candidates is a
gather and an add in rank order, in both forms, so every rank (and the
emulation) holds the same bits; a reducing ``all_reduce`` would add in
the backend's order.  The sketch's buckets and signs come from
``sketch_hash``, a ``torch.Generator`` seeded by (seed, chunk), not the
reference's ``jax.random`` bits (ROADMAP queue 3); the tests replace it
with the reference's.

**Stacked**: ``robust_allreduce_stacked`` takes the K candidate
gradients (or models) as a dict of tensors whose leaves carry a leading K
axis, the layout of the port's parameter dicts, and returns their robust
aggregate (the K axis dropped).  Backends (``RobustAggConfig.backend``):

  reference         the per-leaf plain PyTorch loop of the reference:
                    coordinate median, distances, dots and the Gram per
                    leaf, exact WFAgg-T metrics against ``state.prev``;
  fused_two_launch  one statistics launch (kernel 4, ``robust_stats``)
                    over the concatenated (K, P) candidates, with ``prev``
                    for the WFAgg-T tail, and the Gram (kernel 6,
                    ``pairwise_gram``) when a rule needs it; the host
                    scoring stage; the combine a plain ``tensordot``, as
                    in the reference;
  fused             for wfagg / alt_wfagg, ONE launch of the gossip round
                    kernel (kernel 1) at N = 1 over the identity slate,
                    with ``alpha=1.0`` and ``mean_fallback=True``: the
                    trust-weighted mean of the candidates, the uniform
                    mean when every candidate is rejected; the other
                    rules as ``fused_two_launch``.

Mean, median and trimmed mean need no statistics.  The WFAgg-T state
(``TreeAggState``) keeps every candidate's previous gradient exactly.
Where the candidates' leaves are views of one (K, P) float32 matrix in
ravel order (the trainer's gradient buffer, ``core.flatten.unravel_rows``;
``init_tree_agg_state``'s ``prev``), the fused routes read that matrix
itself instead of concatenating a copy, and the new state's ``prev`` is
the candidates' own tree, so it stays such a matrix.

**On the model axis** (``model_shards=``, a ``ModelShards``): each rank
holds its tensor-parallel block of every candidate, its leaves views of
two matrices, (K, P_s) of the leaves split over the model axis and (K,
P_r) of the replicated ones (``core.flatten.unravel_rows_split``).  Every
statistic the scoring reads is a sum over coordinates and the median is
taken per coordinate, so (the reference's property: "the (K,)/(K,K)
statistic partials meet in a tiny all-reduce; no unsharded gradient ever
exists"):

  per shard   kernel 4 (``robust_stats``) on the rank's (K, P_s) with its
              ``prev`` block; the replicated (K, P_r) counted on model
              rank 0 only, or every distance and norm would count those
              leaves M times; kernel 6 (``pairwise_gram``) likewise where
              a Krum, Clustering or Alt-WFAgg rule needs the Gram (the
              reference backend: its per-leaf plain statistics);
  psum        ``spmd.psum_stats`` over the model group, summed in rank
              order, so every rank scores on bit-identical statistics;
  scoring     the reference's, on every rank;
  combine     kernel 7 (``weighted_agg``: ``lcoef`` = 0, the normalised
              weights, the uniform mean when every candidate is rejected)
              on each matrix (the reference backend: a ``tensordot``).

``fused`` and ``fused_two_launch`` are the same route there: kernel 1's
in-kernel scoring needs whole-model sums, and kernel 2's thread-block
cluster per node streams N = 1 through 8 SMs (ROADMAP queue 2, B).  Mean,
median and trimmed mean are per coordinate and need no collective.

**On the data axis as processes** (``model_shards=``, a ``GridShards``):
each candidate lives on another rank of a K x M grid, one candidate's
gradient per rank on its model block (``launch.mesh``).  The trainer's
exchange (one ``all_to_all`` over the data group of the gradient in
column-block order, ``core.flatten.pack_fsdp``; an all-gather of the
leaves whole over data) gives each rank its column block of all K
candidates: its FSDP block of every leaf split over data, and every leaf
left whole over it (the reference's ``prune_spec``), as (K, D) matrices
per column group (``core.flatten.unravel_fsdp``).  On them:

  per block   the coordinate-wise attacks (IPM, ALIE, sign flip); noise
              reads each of the rank's coordinates from the whole leaf's
              chunk of normals, as one process draws it (one chunk the
              largest draw); kernel 4 with
              ``prev``'s column block and kernel 6 where a rule needs the
              Gram, on the column groups this rank counts: a coordinate
              more than one rank holds is counted by exactly one of them
              (model-replicated leaves on model rank 0, leaves whole over
              data on data rank 0);
  psum        ``spmd.psum_stats`` over all K x M ranks in rank order;
  scoring     the reference's, on every rank, on bit-identical statistics;
  combine     kernel 7 (``lcoef`` 0, the uniform mean when every candidate
              is rejected) on every column group: the aggregate's block,
              which is the optimizer's FSDP block.

WFAgg-T's ``prev`` is the column block of the K candidates (each rank
holds 1/K of the (K, P) bytes, as the reference's candidate-sharded
``prev``).  ``fused``, ``fused_two_launch`` and ``reference`` behave as on
the model axis, and the model axis is the grid's route at K in one
process (its two column groups, the replicated one counted on model rank
0).

**The flat layout on the model axis or the grid** (``robust_allreduce``'s
``model_shards=``, a ``FlatShards``): each rank's gradient is two buffers,
(P_s,) of its split leaves' blocks and (P_r,) of the replicated leaves
(emulated: (K, P_s) and (K, P_r)), and the result is the values the whole
vector's route gives those coordinates.  The reference ravels the whole
gradient (a model-axis all-gather); here each rank streams its own
coordinates: the (K, chunk) gathers stay over the candidate axis (the data
group on a grid), the statistics and the count-sketch are partial sums
(each coordinate sketched under its whole-vector chunk and position,
``core.flatten.global_index``; the sketch is linear) added over the model
group in rank order in one collective, the replicated buffer counted on
model rank 0; the median, trimmed mean, attacks and the weighted sum are
per coordinate.  ``gather_dtype`` on the stacked routes rounds each block
before the D/C statistics and the Gram (kernels 4 and 6 on a rounded
copy, then kernel 7), WFAgg-T's sums staying float32.

**The noise attack** draws its normals a chunk at a time: chunk c of the
whole vector (flat) or of a candidate's whole leaf (stacked), of
``chunk_size`` values, from a ``torch.Generator`` seeded by the
generator's seed and the chunk's indices (``noise_chunk``), as
``sketch_hash`` seeds its chunks; a rank reads its coordinates' values
from the chunks they fall in.  No draw exceeds one chunk, and ranks equal
one process bit for bit.  These are the port's own draws, not the
reference's ``jax.random`` bits.

**bfloat16 candidates** follow the reference's casts: the statistics and
the count-sketch read them as float32, the median and trimmed mean round
back to the candidates' dtype, and a sum over candidates (the flat
route's weighted sum, the mean, IPM's and ALIE's benign moments) adds in
float32 in rank order and rounds once, as the reference's bf16 ``psum``
does under ``shard_map`` (``_rank_sum``).  The stacked routes read float32
rows.  Pad head slots of a padded layout (``sharding.padded_heads``) have
no place in the whole vector: the flat route's sketch skips them, the
attacks leave them as they are, and their zero columns add nothing to a
statistic or a weighted sum.

``state_from_jax`` turns the reference's state (as numpy arrays) into the
port's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import aggregators as agg_lib
from repro_torch.core import attacks as atk
from repro_torch.core import trust
from repro_torch.core.flatten import tree_leaves as _leaves
from repro_torch.core.flatten import tree_map as _map
from repro_torch.core.flatten import tree_unflatten as _unflatten
from repro_torch.core.flatten import CoordPlace, global_index, unravel_rows
from repro_torch.core.trust import wfagg_scores
from repro_torch.core.wfagg import (
    TemporalState, WFAggConfig, wfagg_t_decide, wfagg_t_select)
from repro_torch.distributed.sharding import as_cut
from repro_torch.distributed.spmd import (
    all_gather_rows, all_reduce_in_rank_order, psum_stats)
from repro_torch.kernels.pairwise_dist.ops import pairwise_gram
from repro_torch.kernels.robust_stats.ops import robust_stats, wfagg_round_indexed
from repro_torch.kernels.robust_stats.ref import RobustStats
from repro_torch.kernels.weighted_agg.ops import weighted_agg
from repro_torch.obs import decision as obs_decision

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RobustAggConfig:
    method: str = "wfagg"        # mean | median | trimmed_mean | krum | multi_krum |
                                 # clustering | wfagg | alt_wfagg
    wfagg: WFAggConfig = WFAggConfig()
    trim_beta: float = 0.1
    multi_krum_m: Optional[int] = None
    chunk_size: int = 1 << 22    # coordinates per streamed chunk (flat layout)
    sketch_dim: int = 4096       # AMS count-sketch width (flat layout's WFAgg-T)
    seed: int = 0
    # "flat" (robust_allreduce) or "stacked" (robust_allreduce_stacked)
    layout: str = "flat"
    gather_dtype: Optional[str] = None   # e.g. "bfloat16": statistics of the
                                         # candidates rounded to it (WFAgg-T
                                         # metrics stay full precision)
    # stacked statistics backend: "reference" | "fused_two_launch" | "fused"
    backend: str = "reference"

    @property
    def needs_stats(self) -> bool:
        return self.method in ("krum", "multi_krum", "clustering", "wfagg", "alt_wfagg")

    @property
    def streaming_output(self) -> bool:
        return self.method in ("median", "trimmed_mean")


class ModelShards(NamedTuple):
    """A candidate tree's place on the model axis: ``axis`` the rank's
    ``launch.mesh.ModelAxis``; ``split_dims``, per leaf in tree order, the
    dim of the unbatched leaf split over the model axis (an int, or a
    ``distributed.sharding.Cut`` where the rank's block is not one plain
    block of it), None for a replicated leaf (``core.flatten.split_dims``,
    ``split_cuts``); ``whole``, per leaf, the whole unbatched leaf's shape
    where a block holds pad head slots (empty: each cut dim is its block's
    times M, no pad slots)."""

    axis: Any
    split_dims: Tuple[Optional[int], ...]
    whole: Tuple[Tuple[int, ...], ...] = ()


class GridShards(NamedTuple):
    """A candidate tree's place on the grid (or the model axis): ``group``
    the ranks whose partial statistics add up to the whole candidates'
    (every rank of the grid); per leaf in tree order its column group
    (``leaf_groups``) and per group whether this rank counts it
    (``counted``); per leaf the cuts of the whole leaf to this rank's
    block: ``cuts``, (dim of the unbatched leaf or its ``sharding.Cut``,
    parts, this rank's part) in the order they apply; ``whole``, per leaf,
    the whole unbatched leaf's shape (empty: each cut dim is its block's
    times its parts).  A padded cut's block holds pad head slots past the
    whole leaf's extent of its dim: they have no place in the whole
    leaf, and the attacks leave them as they are (zero)."""

    group: Any
    leaf_groups: Tuple[int, ...]
    counted: Tuple[bool, ...]
    cuts: Tuple[Tuple[Tuple[int, int, int], ...], ...]
    whole: Tuple[Tuple[int, ...], ...] = ()


def _as_grid(shards) -> GridShards:
    """A ``ModelShards`` as the grid's description: the split leaves the
    first column group, the replicated ones the second (model rank 0's)."""
    if isinstance(shards, GridShards):
        return shards
    axis = shards.axis
    return GridShards(
        group=axis.group,
        leaf_groups=tuple(0 if d is not None else 1 for d in shards.split_dims),
        counted=(True, axis.rank == 0),
        cuts=tuple(() if d is None else ((d, axis.size, axis.rank),)
                   for d in shards.split_dims),
        whole=shards.whole)


class AggState(NamedTuple):
    """Cross-step state of the flat layout: WFAgg-T over gradient sketches."""

    temporal: TemporalState


def init_agg_state(cfg: RobustAggConfig, n_candidates: int, device=None) -> AggState:
    f32 = dict(dtype=torch.float32, device=device)
    return AggState(temporal=TemporalState(
        prev=torch.zeros((n_candidates, cfg.sketch_dim), **f32),
        hist_s=torch.zeros((cfg.wfagg.window, n_candidates), **f32),
        hist_b=torch.zeros((cfg.wfagg.window, n_candidates), **f32),
        count=torch.zeros((), dtype=torch.int32, device=device),
        t=torch.zeros((), dtype=torch.int32, device=device),
    ))


class TreeAggState(NamedTuple):
    """Cross-step state of the stacked layout: ``prev`` holds every
    candidate's previous gradient (the candidates' tree, leading K axis),
    giving WFAgg-T exact round-over-round metrics."""

    prev: Any
    hist_s: Tensor    # (W, K)
    hist_b: Tensor    # (W, K)
    count: Tensor
    t: Tensor


def init_tree_agg_state(cfg: RobustAggConfig, n_candidates: int, grads_like: Any,
                        device=None) -> TreeAggState:
    """Zero state: ``prev`` the candidates' tree (leading K axis) in f32 on
    ``device`` (None: the device of ``grads_like``), its leaves views of one
    (K, P) zero matrix in ravel order."""
    dev = device if device is not None else _leaves(grads_like)[0].device
    P = sum(l.numel() for l in _leaves(grads_like))
    return TreeAggState(
        prev=unravel_rows(torch.zeros((n_candidates, P), dtype=torch.float32, device=dev),
                          grads_like),
        hist_s=torch.zeros((cfg.wfagg.window, n_candidates), device=dev),
        hist_b=torch.zeros((cfg.wfagg.window, n_candidates), device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev),
        t=torch.zeros((), dtype=torch.int32, device=dev),
    )


def state_from_jax(state, device=None):
    """The reference's ``TreeAggState`` or ``AggState`` (its leaves as numpy
    arrays, e.g. ``jax.tree.map(np.asarray, state)``) as the port's, on
    ``device``, so both packages can be fed one state."""
    t = lambda x: torch.as_tensor(np.asarray(x), device=device)  # noqa: E731
    if hasattr(state, "temporal"):
        return AggState(temporal=TemporalState(*(t(x) for x in state.temporal)))
    return TreeAggState(prev=_map(t, state.prev), hist_s=t(state.hist_s),
                        hist_b=t(state.hist_b),
                        count=t(state.count), t=t(state.t))


# ---------------------------------------------------------------------------
# consensus weights from statistics
# ---------------------------------------------------------------------------

class ChunkStats(NamedTuple):
    dist2_med: Tensor   # (K,)  sum ||g_j - med||^2
    dot_med: Tensor     # (K,)  sum <g_j, med>
    med2: Tensor        # ()    ||med||^2
    gram: Tensor        # (K,K) candidate Gram matrix
    sketch: Tensor      # (m,)  local candidate count-sketch (flat layout)


def _krum_scores_from_gram(gram: Tensor, f: int) -> Tensor:
    n = torch.diagonal(gram)
    d2 = torch.clamp(n[:, None] + n[None, :] - 2.0 * gram, min=0.0)
    return agg_lib.krum_scores_from_sq_dists(d2, f)


def _clustering_from_gram(gram: Tensor) -> Tensor:
    n = torch.sqrt(torch.clamp(torch.diagonal(gram), min=1e-24))
    D0 = 1.0 - gram / (n[:, None] * n[None, :])
    return agg_lib.clustering_select_from_dist(D0)


def _weights_from_stats(
    stats: ChunkStats,
    sketches: Optional[Tensor],   # (K, m) gathered candidate sketches
    state: Optional[AggState],
    cfg: RobustAggConfig,
    temporal_mask: Optional[Tensor] = None,   # stacked layout: exact WFAgg-T mask
) -> Tuple[Tensor, Optional[AggState], Dict[str, Tensor]]:
    K = stats.dist2_med.shape[0]
    dev = stats.dist2_med.device
    norm2 = torch.diagonal(stats.gram)
    info: Dict[str, Tensor] = {}
    w = cfg.wfagg

    def mask_d() -> Tensor:
        if cfg.method == "alt_wfagg" or w.distance_filter == "multi_krum":
            scores = _krum_scores_from_gram(stats.gram, w.f)
            # WFAggConfig.multi_krum_m is the filter's own knob; the
            # RobustAggConfig field is the standalone-method fallback
            m = w.multi_krum_m or cfg.multi_krum_m or max(1, K // 4)
            return agg_lib.smallest_k_mask(scores, m)
        return agg_lib.smallest_k_mask(stats.dist2_med, K - w.f - 1)

    def mask_c() -> Tensor:
        if cfg.method == "alt_wfagg" or w.similarity_filter == "clustering":
            return _clustering_from_gram(stats.gram)
        cos_d = 1.0 - stats.dot_med / torch.sqrt(torch.clamp(norm2 * stats.med2,
                                                             min=1e-24))
        return agg_lib.smallest_k_mask(cos_d, K - w.f - 1)

    new_state = state
    if cfg.method in ("wfagg", "alt_wfagg"):
        md, mc = mask_d(), mask_c()
        if temporal_mask is not None:
            mt = temporal_mask
        elif w.use_temporal and state is not None:
            mt, new_t = wfagg_t_select(state.temporal, sketches, w)
            new_state = AggState(temporal=new_t)
        else:
            mt = torch.zeros((K,), dtype=torch.bool, device=dev)
        weights = wfagg_scores(md, mc, mt, w)
        info.update(mask_d=md, mask_c=mc, mask_t=mt)
        # the flight recorder's decision record, as a gossip round emits it
        info["record"] = obs_decision.record_from_masks(
            md, mc, mt, torch.ones(weights.shape, dtype=torch.bool, device=dev),
            weights)
    elif cfg.method == "krum":
        scores = _krum_scores_from_gram(stats.gram, w.f)
        weights = torch.nn.functional.one_hot(torch.argmin(scores), K).to(torch.float32)
    elif cfg.method == "multi_krum":
        scores = _krum_scores_from_gram(stats.gram, w.f)
        m = cfg.multi_krum_m or max(1, K // 4)
        weights = agg_lib.smallest_k_mask(scores, m).to(torch.float32)
    elif cfg.method == "clustering":
        weights = _clustering_from_gram(stats.gram).to(torch.float32)
    elif cfg.method == "mean":
        weights = torch.ones((K,), dtype=torch.float32, device=dev)
    else:
        raise ValueError(cfg.method)

    info["weights"] = weights
    info["n_accepted"] = (weights > 0).sum()
    return weights, new_state, info


# ---------------------------------------------------------------------------
# the stacked layout
# ---------------------------------------------------------------------------

def _gather_dtype(cfg: RobustAggConfig) -> Optional[torch.dtype]:
    return getattr(torch, cfg.gather_dtype) if cfg.gather_dtype else None


def _stacked_stats(stacked: Any, cfg: RobustAggConfig) -> ChunkStats:
    """WFAgg/Krum/Clustering statistics over stacked candidates, leaf by
    leaf in plain PyTorch (the reference backend)."""
    leaves = _leaves(stacked)
    K = leaves[0].shape[0]
    dev = leaves[0].device
    gd = _gather_dtype(cfg)
    f32 = dict(dtype=torch.float32, device=dev)
    dist2 = torch.zeros((K,), **f32)
    dot_med = torch.zeros((K,), **f32)
    med2 = torch.zeros((), **f32)
    gram = torch.zeros((K, K), **f32)
    for leaf in leaves:
        g = (leaf.to(gd) if gd is not None else leaf).to(torch.float32).reshape(K, -1)
        med = agg_lib.coordinate_median(g)
        diff = g - med[None]
        dist2 = dist2 + (diff * diff).sum(-1)
        del diff
        dot_med = dot_med + g @ med
        med2 = med2 + (med * med).sum()
        gram = gram + g @ g.T
    return ChunkStats(dist2_med=dist2, dot_med=dot_med, med2=med2, gram=gram,
                      sketch=torch.zeros((0,), **f32))


def _one_matrix(leaves: List[Tensor]) -> Optional[Tensor]:
    """The (K, P) float32 matrix whose column blocks the stacked leaves are,
    in order (``core.flatten.unravel_rows``), or None if they are not such
    views."""
    first = leaves[0]
    K = first.shape[0]
    P = sum(l.numel() for l in leaves) // K
    ptr, off = first.untyped_storage().data_ptr(), first.storage_offset()
    for l in leaves:
        n = l.numel() // K
        want = (P,) + torch.empty(l.shape[1:], device="meta").stride()
        if (l.dtype != torch.float32 or l.untyped_storage().data_ptr() != ptr
                or l.storage_offset() != off or l.stride() != want):
            return None
        off += n
    return first.as_strided((K, P), (P, 1), first.storage_offset())


def _concat_candidates(tree: Any, dtype=None) -> Tensor:
    """Flatten a stacked candidate tree to one (K, P) float32 matrix: the
    matrix itself, without a copy, when the leaves are views of one in
    ravel order and no ``dtype`` rounding is asked."""
    leaves = _leaves(tree)
    K = leaves[0].shape[0]
    if dtype is None:
        mat = _one_matrix(leaves)
        if mat is not None:
            return mat
    return torch.cat([(l.to(dtype) if dtype is not None else l).to(torch.float32)
                      .reshape(K, -1) for l in leaves], dim=1)


def _split_like(flat: Tensor, stacked: Any) -> Any:
    """Inverse of ``_concat_candidates`` for one aggregated (P,) vector:
    the stacked tree's per-candidate leaf shapes (leading K axis dropped)
    and dtypes."""
    out, off = [], 0
    for leaf in _leaves(stacked):
        shape = leaf.shape[1:]
        n = math.prod(shape)
        out.append(flat[off:off + n].reshape(shape).to(leaf.dtype))
        off += n
    return _unflatten(stacked, out)


def _effective_wfagg_config(cfg: RobustAggConfig, K: int) -> WFAggConfig:
    """The WFAggConfig the trust-derivation stage sees: alt_wfagg swaps in
    the Multi-Krum/Clustering filters, and the Multi-Krum m follows
    ``_weights_from_stats``'s preference order (WFAggConfig.multi_krum_m,
    then RobustAggConfig's, then K // 4)."""
    w = cfg.wfagg
    if cfg.method == "alt_wfagg":
        w = dataclasses.replace(w, distance_filter="multi_krum",
                                similarity_filter="clustering")
    if w.distance_filter == "multi_krum":
        m = w.multi_krum_m or cfg.multi_krum_m or max(1, K // 4)
        w = dataclasses.replace(w, multi_krum_m=m)
    return w


def _stacked_stats_fused(stacked: Any, cfg: RobustAggConfig, prev: Optional[Any] = None):
    """One-pass statistics of the concatenated (K, P) candidates through
    the statistics kernel (kernel 4), with ``prev`` the exact WFAgg-T
    tail; the (K, K) Gram from the Gram kernel (kernel 6) only when a
    Krum/Clustering-family rule needs it.  Returns ``(ChunkStats,
    RobustStats)``; the latter carries the temporal tail."""
    flat = _concat_candidates(stacked, _gather_dtype(cfg))
    pflat = _concat_candidates(prev) if prev is not None else None
    stats = robust_stats(flat, prev=pflat, need_center=False)
    del pflat
    w = cfg.wfagg
    needs_gram = (cfg.method in ("krum", "multi_krum", "clustering", "alt_wfagg")
                  or w.distance_filter == "multi_krum"
                  or w.similarity_filter == "clustering")
    if needs_gram:
        gram, _ = pairwise_gram(flat)
    else:
        # _weights_from_stats only reads the diagonal (norm2) in this case
        gram = torch.diag(stats.norm2)
    chunk = ChunkStats(dist2_med=stats.dist2, dot_med=stats.dotmed,
                       med2=stats.mednorm2, gram=gram,
                       sketch=torch.zeros((0,), dtype=torch.float32, device=flat.device))
    return chunk, stats


def _temporal_sums(leaves: List[Tensor], prev_leaves: List[Tensor]):
    """Per candidate: sum ||g - prev||^2, <g, prev>, ||g||^2, ||prev||^2
    over the leaves, leaf by leaf."""
    K = leaves[0].shape[0]
    f32 = dict(dtype=torch.float32, device=leaves[0].device)
    s = torch.zeros((K,), **f32)
    dot = torch.zeros((K,), **f32)
    n_new = torch.zeros((K,), **f32)
    n_prev = torch.zeros((K,), **f32)
    for g, p in zip(leaves, prev_leaves):
        gf = g.to(torch.float32).reshape(K, -1)
        pf = p.to(torch.float32).reshape(K, -1)
        s = s + ((gf - pf) ** 2).sum(-1)
        dot = dot + (gf * pf).sum(-1)
        n_new = n_new + (gf * gf).sum(-1)
        n_prev = n_prev + (pf * pf).sum(-1)
    return s, dot, n_new, n_prev


def _stacked_temporal_metrics(stacked: Any, prev: Any) -> Tuple[Tensor, Tensor]:
    """Exact per-candidate round-over-round metrics (vectorized over K)."""
    s, dot, n_new, n_prev = _temporal_sums(_leaves(stacked), _leaves(prev))
    b = 1.0 - dot / torch.clamp(torch.sqrt(n_new * n_prev), min=1e-24)
    return s, b


def apply_stacked_attack(
    stacked: Any,
    malicious: Tensor,          # (K,) bool
    attack: str,
    generator: Optional[torch.Generator] = None,
    noise_mu: float = 0.1,
    noise_sigma: float = 0.1,
    alie_zmax: float = 0.5,
    prev: Any = None,
    noise: Any = None,
    in_place: bool = False,
    model_shards: Optional[ModelShards] = None,
    chunk_size: int = 1 << 22,
    dtype: Optional[torch.dtype] = None,
) -> Any:
    """Model-poisoning attacks on stacked candidates, leaf by leaf through
    ``core.attacks.apply_matrix_attack`` (the one copy of the masked-stack
    attack math, shared with ``dfl.engine``).  ``in_place`` writes each
    attacked leaf back into ``stacked`` as it goes (one leaf's transient),
    so candidates that are views of one (K, P) matrix stay so.  ``dtype``
    (e.g. the parameters' bfloat16 where the candidates are float32 rows
    that hold bfloat16 gradients) is the dtype the attack computes in, as
    the reference attacks the parameters' dtype; the result is written in
    the leaves' own.

    The noise attack draws each malicious candidate's normals leaf by leaf
    in chunks of ``chunk_size`` values of the whole leaf's ravel, chunk c
    of candidate k's row of leaf i from a ``torch.Generator`` seeded by
    (``generator``'s seed, i, k, c) (``noise_chunk``), float32, added in
    ``dtype``; or takes them from ``noise`` (a tree like ``stacked``), so
    two packages can be fed the same draws.  ``prev`` optionally carries
    the previous-round stacked candidates (e.g. ``TreeAggState.prev``) so
    the adaptive attacks see a prev-only ``DefenseView`` (band_rider then
    falls back to mimicry, as in the reference).

    On the model axis or the grid (``model_shards``) the coordinate-wise
    attacks (IPM, ALIE, sign flip) act on the rank's block alone; noise
    reads each of the rank's coordinates from its whole-leaf chunk (its
    place in the whole leaf from the cuts), so its draws are one
    process's, one chunk the largest transient.  Pad head slots (a padded
    cut's block past the whole leaf) keep their values.  ``band_rider``
    sees a view without temporal bands, so it takes its ALIE-style
    fallback, which is per coordinate.  ``min_max`` reads whole-leaf sums:
    per leaf its two rounds of partial sums (``core.attacks.
    min_max_direction`` / ``min_max_partials``) are added over
    ``model_shards.group`` in rank order, each rank contributing where it
    counts the leaf's column group (zeros where it does not), so that
    every rank solves the leaf's closed form on the same bits; a group of
    None is one process."""
    if attack in ("none", "label_flip"):
        return stacked
    acfg = atk.AttackConfig(name=attack, noise_mu=noise_mu, noise_sigma=noise_sigma,
                            alie_zmax=alie_zmax)
    leaves = _leaves(stacked)
    reducers = [None] * len(leaves)
    grid = None
    if model_shards is not None and (isinstance(model_shards, GridShards)
                                     or model_shards.axis is not None):
        grid = _as_grid(model_shards)
        if attack == "min_max" and grid.group is not None:
            reducers = [_leaf_reducer(grid.group, grid.counted[g]) for g in grid.leaf_groups]
    cuts = grid.cuts if grid is not None else ((),) * len(leaves)
    wholes = grid.whole if grid is not None and grid.whole else (None,) * len(leaves)
    mal = malicious.to(torch.bool)
    if attack == "noise" and noise is None:
        seed = generator.initial_seed() if generator is not None else torch.initial_seed()
        bad = [k for k, b in enumerate(mal.tolist()) if b]
        out = [_noise_leaf(leaf, bad, c, w, (seed, i), chunk_size, noise_mu, noise_sigma,
                           dtype, in_place)
               for i, (leaf, c, w) in enumerate(zip(leaves, cuts, wholes))]
        return _unflatten(stacked, out)
    prev_leaves = _leaves(prev) if prev is not None else [None] * len(leaves)
    noise_leaves = _leaves(noise) if noise is not None else [None] * len(leaves)
    out = []
    for leaf, pl, z, red, c, w in zip(leaves, prev_leaves, noise_leaves, reducers, cuts,
                                      wholes):
        src = leaf.to(dtype) if dtype is not None else leaf
        m = mal.reshape((-1,) + (1,) * (leaf.ndim - 1))
        if attack == "noise":
            new = torch.where(m, src + noise_mu + noise_sigma * z.to(src.dtype), src)
        elif attack == "min_max" and red is not None:
            c_ = atk.min_max_attack(src.reshape(src.shape[0], -1), mal, acfg, reduce=red)
            new = torch.where(m, c_.reshape(src.shape).to(src.dtype), src)
        else:
            new = atk.apply_matrix_attack(
                attack, src, mal, generator, acfg,
                view=(atk.DefenseView(prev=pl) if pl is not None else None))
        live = _live_mask(leaf, c, w)
        if live is not None:
            new = torch.where(live, new, src)
        if in_place:
            leaf.copy_(new)
            new = leaf
        elif new.dtype != leaf.dtype:
            new = new.to(leaf.dtype)
        out.append(new)
    return _unflatten(stacked, out)


def _leaf_reducer(group, counted: bool):
    """The sum over ``group`` in rank order of a leaf's partial sums, this
    rank's part zero where it does not count the leaf's column group."""
    return lambda x: all_reduce_in_rank_order(x if counted else torch.zeros_like(x), group)


def _seed(*parts: int) -> int:
    """One generator seed from integers (a seed, then indices), mixed as
    ``sketch_hash`` mixes (seed, chunk)."""
    s = 0
    for x in parts:
        s = (s * 1_000_003 + int(x)) % (2 ** 63)
    return s


def noise_chunk(seed: int, n: int, device) -> Tensor:
    """(n,) float32 standard normals from a ``torch.Generator`` on
    ``device`` seeded by ``seed``: one chunk of the noise attack's draws,
    the same on every rank."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n,), generator=g, dtype=torch.float32, device=device)


def _chunk_draws(key: Tuple[int, ...], chunk: int, device):
    """``draw(c)``: chunk c of the noise stream ``key`` (``chunk`` values
    seeded by (*key, c)), the last one kept: a rank's coordinates meet a
    stream's chunks in increasing order."""
    memo: Dict[int, Tensor] = {}

    def draw(c: int) -> Tensor:
        if c not in memo:
            memo.clear()
            memo[c] = noise_chunk(_seed(*key, c), chunk, device)
        return memo[c]
    return draw


def _normals_at(gidx: Tensor, chunk: int, draw) -> Tuple[Tensor, Tensor]:
    """The stream's float32 normals at whole ravel indices ``gidx`` (int64,
    increasing where placed; -1 for a pad slot, which has no place: 0
    there), and the mask of the placed ones."""
    placed = gidx >= 0
    out = torch.zeros(gidx.shape, dtype=torch.float32, device=gidx.device)
    v = gidx[placed]
    ci = torch.div(v, chunk, rounding_mode="floor")
    cis, counts = torch.unique_consecutive(ci, return_counts=True)
    parts, off = [], 0
    for c, n in zip(cis.tolist(), counts.tolist()):
        parts.append(draw(c)[v[off:off + n] - c * chunk])
        off += n
    if parts:
        out[placed] = torch.cat(parts) if len(parts) > 1 else parts[0]
    return out, placed


def _dim_maps(block: Tuple[int, ...], cuts, whole) -> Tuple[List[int], Dict[int, Tensor]]:
    """The whole leaf's shape (``whole``, or each cut dim its block's times
    its parts) and, per cut dim, the whole leaf's index of each of the
    block's entries along it (-1 for a pad slot past the whole extent)."""
    shape = list(whole) if whole is not None else list(block)
    if whole is None:
        for c, parts, _ in cuts:
            shape[as_cut(c).dim] *= parts
    maps = {}
    for c, parts, part in cuts:
        cut = as_cut(c)
        d, nb, n = cut.dim, block[cut.dim], shape[cut.dim]
        j = torch.arange(nb, dtype=torch.int64)
        if cut.runs > 1:
            run = nb // cut.runs
            jr = torch.div(j, run, rounding_mode="floor")
            w = jr * (n // cut.runs) + part * run + (j - jr * run)
        else:
            w = part * nb + j
        maps[d] = torch.where(w < n, w, torch.full_like(w, -1))
    return shape, maps


def _block_index(block: Tuple[int, ...], cuts, whole, a: int, b: int, device) -> Tensor:
    """The whole leaf's ravel index (int64) of entries [a, b) of the ravel
    of a rank's block (unbatched shape ``block``) cut from the whole leaf
    by ``cuts``; -1 at pad head slots.  One transient of b - a ints."""
    e = torch.arange(a, b, dtype=torch.int64, device=device)
    if not cuts:
        return e
    shape, maps = _dim_maps(block, cuts, whole)
    idx = torch.zeros_like(e)
    pad = torch.zeros(e.shape, dtype=torch.bool, device=device)
    bstride = math.prod(block)
    wstride = math.prod(shape)
    rem = e
    for d in range(len(block)):
        bstride //= block[d]
        wstride //= shape[d]
        q = torch.div(rem, bstride, rounding_mode="floor")
        rem = rem - q * bstride
        w = maps[d].to(device)[q] if d in maps else q
        idx += w * wstride
        pad |= w < 0
    return torch.where(pad, torch.full_like(idx, -1), idx)


def _live_mask(leaf: Tensor, cuts, whole) -> Optional[Tensor]:
    """Where a candidate block (K, *block) of a padded cut is live: a mask
    broadcasting along the cut dim (False at the pad head slots), or None
    for a block without pad slots."""
    if whole is None or not any(as_cut(c).padded for c, _, _ in cuts):
        return None
    _, maps = _dim_maps(tuple(leaf.shape[1:]), cuts, whole)
    mask = None
    for d, w in maps.items():
        if bool((w < 0).any()):
            m = (w >= 0).to(leaf.device).reshape((1,) * (d + 1) + (-1,)
                                                 + (1,) * (leaf.ndim - d - 2))
            mask = m if mask is None else mask & m
    return mask


def _noise_leaf(leaf: Tensor, bad: List[int], cuts, whole, key: Tuple[int, ...],
                chunk: int, mu: float, sigma: float, dtype, in_place: bool) -> Tensor:
    """The noise attack on one (K, *block) candidate leaf: row k of each
    malicious candidate plus ``mu + sigma * z``, z its whole-leaf chunks'
    normals at the block's places (``_normals_at``), pad slots kept."""
    out = leaf if in_place else leaf.clone()
    try:
        rows, back = out.view(out.shape[0], -1), None
    except RuntimeError:        # a leaf whose rows do not flatten in place
        rows, back = out.reshape(out.shape[0], -1).clone(), out
    block = tuple(leaf.shape[1:])
    n = rows.shape[1]
    for k in bad:
        draw = _chunk_draws(key + (k,), chunk, leaf.device)
        for a in range(0, n, chunk):
            b = min(n, a + chunk)
            piece = rows[k, a:b]
            src = piece.to(dtype) if dtype is not None else piece
            if cuts:
                z, placed = _normals_at(_block_index(block, cuts, whole, a, b, leaf.device),
                                        chunk, draw)
                new = torch.where(placed, src + mu + sigma * z.to(src.dtype), src)
            else:
                new = src + mu + sigma * draw(a // chunk)[:b - a].to(src.dtype)
            piece.copy_(new)
    if back is not None:
        back.copy_(rows.view(back.shape))
    return out


def robust_allreduce_stacked(
    stacked: Any,
    cfg: RobustAggConfig,
    state: Optional[TreeAggState] = None,
    model_shards: Optional[ModelShards] = None,
) -> Tuple[Any, Optional[TreeAggState], Dict[str, Tensor]]:
    """Robust aggregation over stacked candidate gradients.

    Leaves are (K, *param_shape); the output drops the candidate axis.
    WFAgg-T uses exact metrics against ``state.prev`` (every candidate's
    previous gradient); the new state's ``prev`` is this call's
    candidates (as float32: the same tensors when they already are).
    Returns ``(aggregate, new_state, info)`` with the weights (and for
    wfagg / alt_wfagg the masks and the decision ``record``) in ``info``.
    Runs on the candidates' device.  ``model_shards``: the candidates are
    a model rank's blocks (a ``ModelShards``, the module docstring's
    model-axis route) or a grid rank's column block (a ``GridShards``, the
    data-axis route)."""
    leaves = _leaves(stacked)
    K = leaves[0].shape[0]
    dev = leaves[0].device

    if cfg.method == "mean":
        out = _map(lambda l: l.mean(0), stacked)
        return out, state, {"weights": torch.ones((K,), device=dev),
                            "n_accepted": torch.tensor(K, device=dev)}

    if cfg.streaming_output:
        def one(leaf):
            g = leaf.to(torch.float32).reshape(K, -1)
            if cfg.method == "median":
                o = agg_lib.coordinate_median(g)
            else:
                t = int(cfg.trim_beta * K)
                srt = torch.sort(g, dim=0).values
                o = (srt[t: K - t] if t > 0 else srt).mean(0)
            return o.reshape(leaf.shape[1:]).to(leaf.dtype)
        out = _map(one, stacked)
        return out, state, {"weights": torch.ones((K,), device=dev),
                            "n_accepted": torch.tensor(K, device=dev)}

    fused = cfg.backend in ("fused", "fused_two_launch")
    if cfg.backend not in ("fused", "fused_two_launch", "reference"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    temporal = (cfg.method in ("wfagg", "alt_wfagg") and cfg.wfagg.use_temporal
                and state is not None)
    if isinstance(model_shards, GridShards) or (model_shards is not None
                                                and model_shards.axis is not None):
        return _stacked_sharded(stacked, cfg, state, temporal, _as_grid(model_shards))
    # Single-launch route: statistics, in-kernel weights and the combine in
    # one round-kernel launch.  gather_dtype forces the two-launch shape:
    # the temporal metrics must stay full precision while the D/C
    # statistics quantize, which one candidate read cannot provide.
    if (cfg.backend == "fused" and cfg.method in ("wfagg", "alt_wfagg")
            and cfg.gather_dtype is None):
        return _stacked_one_launch(stacked, cfg, state, temporal)
    fuse_temporal = fused and temporal and cfg.gather_dtype is None
    if fused:
        stats, kstats = _stacked_stats_fused(
            stacked, cfg, prev=state.prev if fuse_temporal else None)
    else:
        stats = _stacked_stats(stacked, cfg)

    new_state = state
    temporal_mask = None
    if temporal:
        if fuse_temporal:
            s_all, b_all = kstats.prev_dist2, kstats.cosine_to_prev()
        else:
            s_all, b_all = _stacked_temporal_metrics(stacked, state.prev)
        temporal_mask, hist_s, hist_b, count, t = wfagg_t_decide(
            state.hist_s, state.hist_b, state.count, state.t, s_all, b_all, cfg.wfagg)
        new_state = TreeAggState(prev=_map(lambda g: g.to(torch.float32), stacked),
                                 hist_s=hist_s, hist_b=hist_b, count=count, t=t)
    weights, _, info = _weights_from_stats(stats, None, None, cfg,
                                           temporal_mask=temporal_mask)

    wsum = torch.clamp(weights.sum(), min=1e-12)
    any_ok = weights.sum() > 0
    w_norm = torch.where(any_ok, weights / wsum, torch.full((K,), 1.0 / K, device=dev))
    # the reference's tensordot: a plain contraction over the K axis
    out = _map(lambda l: torch.tensordot(w_norm, l.to(torch.float32), dims=([0], [0]))
               .to(l.dtype), stacked)
    return out, new_state, info


def _stacked_one_launch(
    stacked: Any,
    cfg: RobustAggConfig,
    state: Optional[TreeAggState],
    temporal: bool,
) -> Tuple[Any, Optional[TreeAggState], Dict[str, Tensor]]:
    """Single-launch stacked wfagg/alt_wfagg: one round-kernel launch on
    the concatenated (K, P) candidates does the statistics, the trust
    weights and the combine (the N = 1, all-valid, identity-table
    instance of the DFL round kernel).  ``alpha=1.0`` and
    ``mean_fallback=True`` turn its WFAgg-E combine into the all-reduce
    convention: the trust-weight-normalized mean of the candidates, the
    uniform mean when every candidate is rejected (a gradient all-reduce
    has no local-model anchor)."""
    K = _leaves(stacked)[0].shape[0]
    w = _effective_wfagg_config(cfg, K)
    flat = _concat_candidates(stacked)                               # (K, P) f32
    nidx = torch.arange(K, dtype=torch.int64, device=flat.device)[None, :]
    prev = tbands = None
    if temporal:
        prev = _concat_candidates(state.prev)                        # (K, P)
        tbands = trust.temporal_bands(state.hist_s, state.hist_b, state.count,
                                      state.t, w)[None]
    local = torch.zeros_like(flat[:1])                               # lcoef = 0
    out_flat, weights, mask_d, mask_c, mask_t, kstats = wfagg_round_indexed(
        local, flat, nidx, None, w, prev=prev, tbands=tbands, alpha=1.0,
        mean_fallback=True)
    del flat, prev
    new_state = state
    if temporal:
        hist_s, hist_b, count, t = trust.push_history(
            state.hist_s, state.hist_b, state.count, state.t,
            kstats.prev_dist2[0], kstats.cosine_to_prev()[0])
        new_state = TreeAggState(prev=_map(lambda g: g.to(torch.float32), stacked),
                                 hist_s=hist_s, hist_b=hist_b, count=count, t=t)
    out = _split_like(out_flat[0], stacked)
    info = {
        "mask_d": mask_d[0], "mask_c": mask_c[0], "mask_t": mask_t[0],
        "weights": weights[0], "n_accepted": (weights[0] > 0).sum(),
        "record": obs_decision.record_from_masks(
            mask_d[0], mask_c[0], mask_t[0],
            torch.ones(weights[0].shape, dtype=torch.bool, device=weights.device),
            weights[0]),
    }
    return out, new_state, info


def _needs_gram(cfg: RobustAggConfig) -> bool:
    w = cfg.wfagg
    return (cfg.method in ("krum", "multi_krum", "clustering", "alt_wfagg")
            or w.distance_filter == "multi_krum" or w.similarity_filter == "clustering")


def _partial_stats(K: int, dev, groups: List[List[Tensor]],
                   prev_groups: Optional[List[List[Tensor]]], cfg: RobustAggConfig,
                   mats: List[Tensor] = (), prevs: List[Optional[Tensor]] = ()
                   ) -> RobustStats:
    """This rank's coordinate sums over its groups of K-candidate leaves
    (each (K, ...)), as one ``RobustStats`` with a leading axis of 1
    (``psum_stats``'s node axis): on ``fused`` and ``fused_two_launch``
    kernels 4 and 6 (their plain versions on the CPU) on each group's (K,
    D) matrix ``mats`` (with ``prevs``); on ``reference`` the reference
    backend's plain sums leaf by leaf (``prev_*``: the exact WFAgg-T sums;
    ``norm2``: the candidates' squared norms).

    With ``cfg.gather_dtype`` the D/C statistics and the Gram are the
    candidates' rounded to it (the fused routes: kernel 4 without ``prev``
    and kernel 6 on a rounded copy of each matrix, the two-launch shape),
    while ``norm2`` and WFAgg-T's sums stay float32, as at M = 1; the Gram
    is then always taken, so that WFAgg-C reads the rounded norms from its
    diagonal."""
    f32 = dict(dtype=torch.float32, device=dev)
    gd = _gather_dtype(cfg)
    fields = ["dist2", "dotmed", "norm2", "mednorm2"]
    if prev_groups is not None:
        fields += ["prev_dist2", "prev_dot", "prev_norm2"]
    if _needs_gram(cfg) or cfg.backend == "reference" or gd is not None:
        fields.append("gram")
    acc = {f: torch.zeros((K, K) if f == "gram" else () if f == "mednorm2" else (K,), **f32)
           for f in fields}
    if cfg.backend == "reference":
        for gi, leaves in enumerate(groups):
            st = _stacked_stats(leaves, cfg) if leaves else None
            if st is None:
                continue
            parts = dict(dist2=st.dist2_med, dotmed=st.dot_med, mednorm2=st.med2,
                         gram=st.gram)
            parts["norm2"] = sum((l.to(torch.float32).reshape(K, -1) ** 2).sum(-1)
                                 for l in leaves)
            if prev_groups is not None:
                s_, dot, _, n_prev = _temporal_sums(leaves, prev_groups[gi])
                parts.update(prev_dist2=s_, prev_dot=dot, prev_norm2=n_prev)
            for f, v in parts.items():
                acc[f] = acc[f] + v
    else:
        for mat, prev in zip(mats, prevs):
            if mat.shape[1] == 0:
                continue
            if gd is None:
                st = robust_stats(mat, prev=prev, need_center=False)
                for f in fields:
                    acc[f] = acc[f] + (pairwise_gram(mat)[0] if f == "gram"
                                       else getattr(st, f))
                continue
            r = mat.to(gd).to(torch.float32)
            st = robust_stats(r, need_center=False)
            parts = dict(dist2=st.dist2, dotmed=st.dotmed, mednorm2=st.mednorm2,
                         gram=pairwise_gram(r)[0])
            del r
            parts.update(_row_sums(mat, prev))
            for f in fields:
                acc[f] = acc[f] + parts[f]
    return RobustStats(med=None, trim=None, **{f: v[None] for f, v in acc.items()})


def _row_sums(mat: Tensor, prev: Optional[Tensor], chunk: int = 1 << 22) -> Dict[str, Tensor]:
    """Per candidate of a (K, D) float32 matrix its squared norm and, with
    ``prev``, WFAgg-T's sums (``_temporal_sums``), in column chunks."""
    K = mat.shape[0]
    names = ["norm2"] + (["prev_dist2", "prev_dot", "prev_norm2"] if prev is not None else [])
    out = {f: torch.zeros((K,), dtype=torch.float32, device=mat.device) for f in names}
    for a in range(0, mat.shape[1], chunk):
        g = mat[:, a:a + chunk]
        out["norm2"] = out["norm2"] + (g * g).sum(-1)
        if prev is not None:
            p = prev[:, a:a + chunk]
            out["prev_dist2"] = out["prev_dist2"] + ((g - p) ** 2).sum(-1)
            out["prev_dot"] = out["prev_dot"] + (g * p).sum(-1)
            out["prev_norm2"] = out["prev_norm2"] + (p * p).sum(-1)
    return out


def _stacked_sharded(
    stacked: Any,
    cfg: RobustAggConfig,
    state: Optional[TreeAggState],
    temporal: bool,
    shards: GridShards,
) -> Tuple[Any, Optional[TreeAggState], Dict[str, Tensor]]:
    """The robust all-reduce of a rank's candidate blocks: a model rank's
    or a grid rank's column block (the module docstring's model-axis and
    data-axis routes)."""
    leaves = _leaves(stacked)
    K = leaves[0].shape[0]
    dev = leaves[0].device
    n_groups = len(shards.counted)
    groups = [[l for l, g in zip(leaves, shards.leaf_groups) if g == i]
              for i in range(n_groups)]
    fused = cfg.backend != "reference"

    def matrix(g):
        return _concat_candidates(g) if g else torch.zeros((K, 0), device=dev)

    # the reference backend needs no (K, P) matrix: it reads the leaves
    mats = [matrix(g) for g in groups] if fused else [None] * n_groups
    prev_groups, prevs = None, [None] * n_groups
    if temporal:
        pl = _leaves(state.prev)
        prev_groups = [[p for p, g in zip(pl, shards.leaf_groups) if g == i]
                       for i in range(n_groups)]
        if fused:
            prevs = [matrix(g) for g in prev_groups]
    # a coordinate several ranks hold counts once: on the rank that counts
    # its group
    mine = [i for i in range(n_groups) if shards.counted[i]]
    stats = psum_stats(_partial_stats(
        K, dev, [groups[i] for i in mine],
        None if prev_groups is None else [prev_groups[i] for i in mine], cfg,
        [mats[i] for i in mine], [prevs[i] for i in mine]), shards.group)
    st = RobustStats(*(None if v is None else v[0] for v in stats))
    # _weights_from_stats reads only the Gram's diagonal (norm2) without it
    gram = st.gram if st.gram is not None else torch.diag(st.norm2)
    chunk = ChunkStats(dist2_med=st.dist2, dot_med=st.dotmed, med2=st.mednorm2, gram=gram,
                       sketch=torch.zeros((0,), dtype=torch.float32, device=dev))
    new_state, temporal_mask = state, None
    if temporal:
        if cfg.backend == "reference":
            b = 1.0 - st.prev_dot / torch.clamp(torch.sqrt(st.norm2 * st.prev_norm2),
                                                min=1e-24)
        else:
            b = st.cosine_to_prev()
        temporal_mask, hist_s, hist_b, count, t = wfagg_t_decide(
            state.hist_s, state.hist_b, state.count, state.t, st.prev_dist2, b, cfg.wfagg)
        new_state = TreeAggState(prev=stacked, hist_s=hist_s, hist_b=hist_b, count=count,
                                 t=t)
    weights, _, info = _weights_from_stats(chunk, None, None, cfg,
                                           temporal_mask=temporal_mask)
    any_ok = weights.sum() > 0
    if not fused:
        wsum = torch.clamp(weights.sum(), min=1e-12)
        w_norm = torch.where(any_ok, weights / wsum, torch.full((K,), 1.0 / K, device=dev))
        out = _map(lambda l: torch.tensordot(w_norm, l.to(torch.float32), dims=([0], [0]))
                   .to(l.dtype), stacked)
        return out, new_state, info
    # kernel 7 with lcoef = 0: alpha 1 over weights that never sum to 0
    w_eff = torch.where(any_ok, weights, torch.ones_like(weights))
    outs = [weighted_agg(torch.zeros((m.shape[1],), dtype=torch.float32, device=dev), m,
                         w_eff, alpha=1.0) if m.shape[1] else m[0] for m in mats]
    parts, offs = [], [0] * n_groups
    for leaf, i in zip(leaves, shards.leaf_groups):
        n = leaf[0].numel()
        parts.append(outs[i][offs[i]:offs[i] + n].view(leaf.shape[1:]).to(leaf.dtype))
        offs[i] += n
    return _unflatten(stacked, parts), new_state, info


# ---------------------------------------------------------------------------
# the flat layout: the candidate axis
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Emulated:
    """The candidate axis of ``size`` workers emulated in one process: every
    local value carries a leading axis of the K candidates (row k is
    candidate k's), as under ``jax.vmap(axis_name=...)``, and every
    collective returns what each rank of a process group would."""

    size: int


# a ``torch.distributed`` process group with one rank per candidate, or Emulated
Axis = Union[Emulated, Any]


def axis_size(axis: Axis) -> int:
    return axis.size if isinstance(axis, Emulated) else dist.get_world_size(axis)


def my_index(axis: Axis, device=None) -> Tensor:
    """This worker's candidate index: the rank, or (K,) ``arange`` emulated."""
    if isinstance(axis, Emulated):
        return torch.arange(axis.size, device=device)
    return torch.tensor(dist.get_rank(axis), device=device)


def _all_gather(x: Tensor, axis: Axis) -> Tensor:
    """(K, ...) of every worker's ``x`` in rank order (emulated: ``x``)."""
    if isinstance(axis, Emulated):
        return x
    return all_gather_rows(x, axis)


def _rank_sum(parts: Tensor) -> Tensor:
    """Sum over the leading candidate axis, one candidate after another in
    rank order (the same float32 adds on every rank and in the emulation).
    Candidates in a narrower float (bfloat16) are added in float32 and the
    sum rounded to their dtype once, as the reference's ``psum`` under
    ``shard_map`` rounds a bfloat16 sum (its ``vmap``ped form rounds at
    each add instead)."""
    wide = torch.float32 if parts.dtype in (torch.bfloat16, torch.float16) else parts.dtype
    acc = parts[0].to(wide)
    for p in parts[1:]:
        acc = acc + p.to(wide)
    return acc.to(parts.dtype)


def pmean(x: Tensor, axis: Axis) -> Tensor:
    """The mean over the candidates of each worker's scalar ``x`` (emulated:
    the (K,) values), summed in rank order."""
    g = x if isinstance(axis, Emulated) else _all_gather(x.reshape(1), axis)[:, 0]
    return _rank_sum(g) / axis_size(axis)


def _pad_chunks(flat: Tensor, chunk: int) -> Iterator[Tuple[int, Tensor]]:
    """(chunk index, chunk) over the last axis in chunks of ``chunk``
    coordinates, the last zero-padded to ``chunk``: the reference's padded
    chunks, without a padded copy of the whole vector."""
    P = flat.shape[-1]
    for ci in range(max(1, -(-P // chunk))):
        part = flat[..., ci * chunk:(ci + 1) * chunk]
        if part.shape[-1] < chunk:
            part = torch.nn.functional.pad(part, (0, chunk - part.shape[-1]))
        yield ci, part


def _psum(flat: Tensor, axis: Axis, chunk: int, scale: Optional[Tensor] = None) -> Tensor:
    """Sum over the candidates of each worker's ``flat`` (times its
    ``scale[k]``), chunk by chunk: one gather of (K, chunk) at a time."""
    P = flat.shape[-1]
    out = torch.empty((P,), dtype=flat.dtype, device=flat.device)
    for a in range(0, P, chunk):
        g = _all_gather(flat[..., a:a + chunk], axis)
        if scale is not None:
            g = g * scale[:, None].to(g.dtype)
        out[a:a + chunk] = _rank_sum(g)
    return out


def sketch_hash(n: int, m: int, seed: int, chunk_idx: int, device) -> Tuple[Tensor, Tensor]:
    """The count-sketch's buckets (n,) in [0, m) and signs (n,) in {-1, +1}
    of chunk ``chunk_idx``: the port's own draws from a ``torch.Generator``
    on ``device`` seeded by (seed, chunk_idx), the same on every rank (the
    reference draws them from ``jax.random``; tests replace this function
    with the reference's bits)."""
    g = torch.Generator(device=device).manual_seed((seed * 1_000_003 + chunk_idx) % (2 ** 63))
    buckets = torch.randint(0, m, (n,), generator=g, device=device)
    signs = torch.randint(0, 2, (n,), generator=g, device=device).to(torch.float32) * 2 - 1
    return buckets, signs


def _count_sketch(chunk: Tensor, chunk_idx: int, m: int, seed: int) -> Tensor:
    """AMS count-sketch (m,) of one worker's chunk (L,): bucket + sign,
    seeded by the chunk index (emulated: a (K, L) chunk, one row at a time)."""
    if chunk.ndim == 2:
        return torch.stack([_count_sketch(row, chunk_idx, m, seed) for row in chunk])
    buckets, signs = sketch_hash(chunk.shape[0], m, seed, chunk_idx, chunk.device)
    out = torch.zeros((m,), dtype=torch.float32, device=chunk.device)
    return out.index_add_(0, buckets, chunk.to(torch.float32) * signs)


# ---------------------------------------------------------------------------
# the flat layout on the model axis: a rank's part of the whole vector
# ---------------------------------------------------------------------------

class FlatShards(NamedTuple):
    """A model rank's part of the whole flat gradient (the flat layout's
    ``model_shards``): ``group`` the model group, over which the partial
    statistics meet (summed in rank order); per buffer of the rank's
    gradient (the split leaves' and the replicated leaves', each in ravel
    order) whether this rank counts it (``counted``: the replicated buffer
    on model rank 0 only, as ``GridShards.counted``) and its leaves'
    places in the whole model's ravel (``places``,
    ``core.flatten.coord_places``); ``size`` the whole model's P."""

    group: Any
    counted: Tuple[bool, ...]
    places: Tuple[Tuple[CoordPlace, ...], ...]
    size: int


def _buffers(flat) -> Tuple[Tensor, ...]:
    return tuple(flat) if isinstance(flat, (tuple, list)) else (flat,)


def _hash_of(cfg: RobustAggConfig, device):
    """``sketch_hash`` of the whole vector's chunk ``ci`` (length
    ``cfg.chunk_size``), the last one kept: a rank's coordinates meet the
    global chunks in increasing order within a buffer."""
    memo: Dict[int, Tuple[Tensor, Tensor]] = {}

    def get(ci: int) -> Tuple[Tensor, Tensor]:
        if ci not in memo:
            memo.clear()
            memo[ci] = sketch_hash(cfg.chunk_size, cfg.sketch_dim, cfg.seed, ci, device)
        return memo[ci]
    return get


def _sketch_coords(piece: Tensor, gidx: Tensor, cfg: RobustAggConfig, hashes) -> Tensor:
    """The count-sketch (m,) (emulated: (K, m)) of a rank's coordinates
    ``piece`` (..., n), each under its whole-vector chunk and in-chunk
    position (``gidx``, their indices in the whole ravel): the terms the
    M = 1 sketch of the whole vector takes from them (it is linear)."""
    placed = gidx >= 0
    if not bool(placed.all()):         # pad head slots: no place, no term
        piece, gidx = piece[..., placed], gidx[placed]
    L = cfg.chunk_size
    ci = torch.div(gidx, L, rounding_mode="floor")
    pos = gidx - ci * L
    out = torch.zeros(piece.shape[:-1] + (cfg.sketch_dim,), dtype=torch.float32,
                      device=piece.device)
    cis, counts = torch.unique_consecutive(ci, return_counts=True)
    off = 0
    for c, n in zip(cis.tolist(), counts.tolist()):
        buckets, signs = hashes(c)
        p = pos[off:off + n]
        part = torch.zeros_like(out).index_add_(
            out.ndim - 1, buckets[p], piece[..., off:off + n].to(torch.float32) * signs[p])
        out = out + part
        off += n
    return out


# ---------------------------------------------------------------------------
# the flat layout, phase 1: streamed statistics
# ---------------------------------------------------------------------------

def _add_chunk(st: ChunkStats, g: Tensor) -> ChunkStats:
    """``st`` plus the statistics of one gathered (K, chunk) block."""
    med = agg_lib.coordinate_median(g)
    diff = g - med[None, :]
    dist2 = st.dist2_med + (diff * diff).sum(1)
    del diff
    return st._replace(dist2_med=dist2, dot_med=st.dot_med + g @ med,
                       med2=st.med2 + (med * med).sum(), gram=st.gram + g @ g.T)


def _zero_stats(K: int, sketch_shape, device) -> ChunkStats:
    f32 = dict(dtype=torch.float32, device=device)
    return ChunkStats(dist2_med=torch.zeros((K,), **f32), dot_med=torch.zeros((K,), **f32),
                      med2=torch.zeros((), **f32), gram=torch.zeros((K, K), **f32),
                      sketch=torch.zeros(tuple(sketch_shape), **f32))


def _stats_scan(flat, axis: Axis, cfg: RobustAggConfig,
                model_shards: Optional[FlatShards] = None) -> ChunkStats:
    """The candidates' statistics over all chunks: each chunk gathered as a
    transient (K, chunk) block; the sketch is the worker's own.  With
    ``model_shards`` (``flat`` the rank's buffers): the chunks of the
    coordinates this rank counts, the sketch taken under each coordinate's
    whole-vector chunk and position, and the partial sums added over the
    model group in rank order in one collective."""
    if model_shards is not None:
        return _stats_scan_sharded(_buffers(flat), axis, cfg, model_shards)
    K = axis_size(axis)
    st = _zero_stats(K, flat.shape[:-1] + (cfg.sketch_dim,), flat.device)
    for ci, chunk in _pad_chunks(flat, cfg.chunk_size):
        g = _all_gather(chunk, axis).reshape(K, -1).to(torch.float32)
        st = _add_chunk(st, g)
        st = st._replace(sketch=st.sketch + _count_sketch(chunk, ci, cfg.sketch_dim,
                                                          cfg.seed))
    return st


def _stats_scan_sharded(bufs: Tuple[Tensor, ...], axis: Axis, cfg: RobustAggConfig,
                        shards: FlatShards) -> ChunkStats:
    K = axis_size(axis)
    dev = bufs[0].device
    st = _zero_stats(K, bufs[0].shape[:-1] + (cfg.sketch_dim,), dev)
    hashes = _hash_of(cfg, dev)
    for buf, counted, places in zip(bufs, shards.counted, shards.places):
        if not counted:
            continue
        n = buf.shape[-1]
        for a in range(0, n, cfg.chunk_size):
            b = min(n, a + cfg.chunk_size)
            piece = buf[..., a:b]
            st = _add_chunk(st, _all_gather(piece, axis).reshape(K, -1).to(torch.float32))
            st = st._replace(sketch=st.sketch + _sketch_coords(
                piece, global_index(places, a, b, dev), cfg, hashes))
    sizes = [x.numel() for x in st]
    summed = all_reduce_in_rank_order(torch.cat([x.reshape(-1) for x in st]), shards.group)
    return ChunkStats(*(v.view(x.shape) for v, x in zip(summed.split(sizes), st)))


def _coordinate_agg(g: Tensor, cfg: RobustAggConfig) -> Tensor:
    if cfg.method == "median":
        return agg_lib.coordinate_median(g)
    K = g.shape[0]
    t = int(cfg.trim_beta * K)
    srt = torch.sort(g, dim=0).values
    return (srt[t: K - t] if t > 0 else srt).mean(0)


def _streaming_coordinate_agg(flat, axis: Axis, cfg: RobustAggConfig,
                              model_shards: Optional[FlatShards] = None):
    """Median / trimmed-mean aggregation: stream output chunks directly
    (with ``model_shards``, over each of the rank's buffers: per coordinate,
    so no collective over the model group)."""
    if model_shards is not None:
        return tuple(_streaming_coordinate_agg(b, axis, cfg) for b in _buffers(flat))
    K = axis_size(axis)
    P = flat.shape[-1]
    out = torch.empty((P,), dtype=flat.dtype, device=flat.device)
    for ci, chunk in _pad_chunks(flat, cfg.chunk_size):
        g = _all_gather(chunk, axis).reshape(K, -1).to(torch.float32)
        o = _coordinate_agg(g, cfg)
        a = ci * cfg.chunk_size
        out[a:a + cfg.chunk_size] = o[:P - a].to(flat.dtype)
    return out


# ---------------------------------------------------------------------------
# the flat layout: public entry points
# ---------------------------------------------------------------------------

def robust_allreduce(
    flat,
    axis: Axis,
    cfg: RobustAggConfig,
    state: Optional[AggState] = None,
    model_shards: Optional[FlatShards] = None,
) -> Tuple[Any, Optional[AggState], Dict[str, Tensor]]:
    """Robust-aggregate the workers' flat gradients across the candidate
    axis: ``flat`` is this worker's (P,) gradient on a process group of one
    rank per candidate, or the (K, P) candidates under ``Emulated(K)``.
    Returns (the aggregated (P,) gradient, identical on every rank,
    new_state, info).

    On the model axis (``model_shards``, a ``FlatShards``) ``flat`` is the
    rank's pair of buffers, (P_s,) and (P_r,) (emulated: (K, P_s) and (K,
    P_r)), and so is the aggregate: the values the whole vector's route
    gives these coordinates, computed without gathering the whole vector.
    The (K, chunk) gathers stay over ``axis``; ``dist2_med``, ``dot_med``,
    ``med2``, the Gram and the sketch are partial sums added over the
    model group once (every rank then derives the same weights from the
    same bits); the median, trimmed mean and the weighted sum are per
    coordinate."""
    K = axis_size(axis)
    bufs = _buffers(flat)
    dev = bufs[0].device
    ones = {"weights": torch.ones((K,), device=dev), "n_accepted": torch.tensor(K, device=dev)}

    def each(fn):
        out = tuple(fn(b) for b in bufs)
        return out if model_shards is not None else out[0]

    if cfg.method == "mean":
        return each(lambda b: _psum(b, axis, cfg.chunk_size) / K), state, ones
    if cfg.streaming_output:
        return _streaming_coordinate_agg(flat, axis, cfg, model_shards), state, ones

    stats = _stats_scan(flat, axis, cfg, model_shards)
    sketches = _all_gather(stats.sketch, axis).reshape(K, -1)
    weights, new_state, info = _weights_from_stats(stats, sketches, state, cfg)

    # phase 2: the weighted mean, each worker's gradient scaled by its
    # weight; every candidate rejected: the mean (the host reads the sum)
    if bool(weights.sum() > 0):
        wsum = torch.clamp(weights.sum(), min=1e-12)
        out = each(lambda b: _psum(b, axis, cfg.chunk_size, scale=weights / wsum))
    else:
        out = each(lambda b: _psum(b, axis, cfg.chunk_size) / K)
    return out, new_state, info


def apply_distributed_attack(
    flat,
    axis: Axis,
    malicious: Tensor,            # (K,) bool: which workers are Byzantine
    attack: str,
    generator: Optional[torch.Generator] = None,
    noise_mu: float = 0.1,
    noise_sigma: float = 0.1,
    alie_zmax: float = 0.5,
    chunk_size: int = 1 << 22,
    in_place: bool = False,
    model_shards: Optional[FlatShards] = None,
):
    """Transform the worker's gradient if it is malicious (``flat`` as in
    ``robust_allreduce``).  The omniscient attacks (ALIE, IPM) take the
    benign cohort's mean (and variance) per coordinate from the gathered
    chunks, summed in rank order (``_rank_sum``: a bfloat16 sum rounded
    once), computed in the gradient's dtype as the reference does.  The
    noise attack adds the same draws on every malicious worker, as the
    reference's shared key does: chunk c of the whole vector (``chunk_size``
    coordinates) from a ``torch.Generator`` seeded by (``generator``'s
    seed, c) (``noise_chunk``), float32, added in the gradient's dtype; seed
    ``generator`` alike on every rank.  One chunk of normals is the largest
    draw.  ``in_place`` writes the result into ``flat`` chunk by chunk (no
    second (K, P)) and returns it.

    On the model axis (``model_shards``, ``flat`` the rank's buffers) every
    attack is per coordinate and acts on the rank's buffers; noise gives
    each of the rank's coordinates its whole-vector chunk's value there
    (``core.flatten.global_index``, a chunk at a time), so the ranks' draws
    are one process's.  Pad head slots (no place in the whole vector) keep
    their values under every attack."""
    if attack in ("none", "label_flip"):
        return flat
    bufs = _buffers(flat)
    dev = bufs[0].device
    K = axis_size(axis)
    mal = malicious.to(device=dev, dtype=torch.bool)
    me = my_index(axis, dev)
    bad = mal[me] if bufs[0].ndim == 1 else mal[me][:, None]
    if attack not in ("noise", "sign_flip") and not (attack.startswith("ipm")
                                                    or attack == "alie"):
        raise ValueError(f"unknown attack {attack!r}")
    draw = None
    if attack == "noise":
        seed = generator.initial_seed() if generator is not None else torch.initial_seed()
        draw = _chunk_draws((seed,), chunk_size, dev)
    benign_w = (~mal).to(bufs[0].dtype)[:, None]
    n_benign = torch.clamp(K - mal.sum(), min=1).to(bufs[0].dtype)
    outs = []
    for i, buf in enumerate(bufs):
        out = buf if in_place else torch.empty_like(buf)
        places = model_shards.places[i] if model_shards is not None else None
        pads = places is not None and any(pl.padded for pl in places)
        P = buf.shape[-1]
        for a in range(0, P, chunk_size):
            b = min(P, a + chunk_size)
            piece = buf[..., a:b]
            hit = bad
            gidx = (global_index(places, a, b, dev)
                    if places is not None and (pads or draw is not None) else None)
            if pads:
                hit = bad & (gidx >= 0)
            if attack == "noise":
                zc = draw(a // chunk_size)[:b - a] if gidx is None else \
                    _normals_at(gidx, chunk_size, draw)[0]
                new = torch.where(hit, piece + noise_mu + noise_sigma * zc.to(piece.dtype),
                                  piece)
            elif attack == "sign_flip":
                new = torch.where(hit, -piece, piece)
            else:
                g = _all_gather(piece, axis)
                mu = _rank_sum(g * benign_w) / n_benign
                if attack.startswith("ipm"):
                    mal_val = -(100.0 if attack == "ipm_100" else 0.5) * mu
                else:
                    var = _rank_sum(benign_w * (g - mu) ** 2) / n_benign
                    mal_val = mu - alie_zmax * torch.sqrt(var)
                del g
                new = torch.where(hit, mal_val, piece)
            out[..., a:b] = new
            del new
        outs.append(out)
    return tuple(outs) if isinstance(flat, (tuple, list)) else outs[0]
