"""WFAgg, the paper's Byzantine-robust aggregation (Section IV) (port of
``repro.core.wfagg``).

Components (each maps to a paper algorithm):
  wfagg_d_select   Alg. 2 - distance filter around the coordinate-wise median
  wfagg_c_select   Alg. 3 - cosine-similarity filter with norm clipping
  wfagg_t_select   Alg. 4 - temporal EWMA filter over round-to-round metrics
  wfagg_e          Eq. 3  - exponential-smoothing weighted aggregation
  wfagg            Alg. 1 - one node: 3 filters -> tau-weighted scoring
                   (accept needs >= 2 filters) -> WFAgg-E aggregation
  alt_wfagg_config paper Section VI-B2 - same scoring, with Multi-Krum as
                   the distance filter and Clustering as the similarity one
  wfagg_batch      all N receiving nodes of a gossip round at once, from
                   the gathered (N, K, d) candidates, or from the (M, d)
                   model matrix and an (N, K) neighbour table (the (N, K,
                   d) gossip tensor never exists on the fused path); with
                   ``prev_idx`` the WFAgg-T ``prev`` rows come through
                   their own table (chaos transport)
  realign_temporal_history
                   re-keys the slot-positional WFAgg-T ring buffers to a
                   new slate by neighbour identity (dynamic topologies)
  wfagg_d_agg, wfagg_c_agg, wfagg_e_agg
                   the standalone filters (Table I's WFAgg-D / -C / -E
                   columns; WFAgg-T is ``wfagg_t_select`` + ``wfagg_e``)
  memory_passes    (K, d)-sized memory passes per aggregation, by backend

The reference-backend filters and the standalone aggregators take one
node's (K, d) candidates or a batch with a leading N axis.

Execution backends (``WFAggConfig.backend``):
  fused      single node (``wfagg``, the CFL server): one statistics
             kernel (``kernels.robust_stats.ops.robust_stats``), the Gram
             kernel when an Alt-WFAgg filter needs it
             (``kernels.pairwise_dist.ops.pairwise_gram``), the scoring
             stage on the host and the combine kernel
             (``kernels.weighted_agg.ops.weighted_agg``).  Indexed gossip
             round: the single-launch round (``kernels.robust_stats.ops.
             wfagg_round_indexed``).  Gathered gossip round: one launch of
             the batched statistics kernel (``kernels.robust_stats.ops.
             robust_stats_batch``), the Alt-WFAgg Gram as a ``torch.bmm``,
             the scoring stage on the host and the batched Eq. 3 combine
             in plain PyTorch (the reference computes the Gram and the
             combine outside Pallas too).  CUDA kernels on CUDA tensors,
             their plain PyTorch versions on CPU tensors.
  reference  plain PyTorch: the per-filter pipeline for one node (or each
             node of a gathered round, batched); for the indexed gossip
             round the valid-aware pipeline (gathered statistics, the same
             trust logic, the Eq. 3 combine).
  fused_two_launch
             single node and gathered round: the same as fused (there is
             no single-launch variant).  Indexed gossip round: two
             launches, the gather-free statistics
             (``kernels.robust_stats.ops.robust_stats_indexed``, the Gram
             riding along for an Alt-WFAgg filter), the scoring stage on
             the host (``_indexed_scoring``) and the gather-free combine
             (``kernels.weighted_agg.ops.weighted_agg_indexed``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import aggregators as agg
from repro_torch.core import trust
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.pairwise_dist.ops import pairwise_gram
from repro_torch.kernels.robust_stats.ops import (
    robust_stats, robust_stats_batch, robust_stats_indexed, wfagg_round_indexed)
from repro_torch.kernels.weighted_agg.ops import weighted_agg, weighted_agg_indexed
from repro_torch.kernels.robust_stats.ref import RobustStats, robust_stats_indexed_ref

Tensor = torch.Tensor
_EPS = 1e-12
_FUSED_BACKENDS = ("fused", "fused_two_launch")


@dataclasses.dataclass(frozen=True)
class WFAggConfig:
    """Hyper-parameters (defaults = paper Section V-A)."""

    f: int = 2                  # estimated number of malicious candidates
    tau1: float = 0.4           # weight of the distance filter (WFAgg-D)
    tau2: float = 0.4           # weight of the similarity filter (WFAgg-C)
    tau3: float = 0.2           # weight of the temporal filter (WFAgg-T)
    alpha: float = 0.8          # WFAgg-E smoothing factor
    window: int = 3             # W - temporal window length
    transient: int = 3          # T_th - rounds before WFAgg-T activates
    ewma_decay: float = 0.5     # lambda of the exponentially weighted window
    use_temporal: bool = True   # disable to drop the prev-model state
    # Alt-WFAgg: swap in filters of the same family
    distance_filter: str = "wfagg_d"     # or "multi_krum"
    similarity_filter: str = "wfagg_c"   # or "clustering"
    multi_krum_m: Optional[int] = None   # Multi-Krum m (default K // 4)
    backend: str = "fused"      # "fused" | "fused_two_launch" | "reference"
    # Non-finite payload sanitizer: a NaN/Inf candidate row is zeroed and
    # its edges demoted to invalid before any filter statistic (a no-op on
    # finite inputs, so it defaults on).
    sanitize: bool = True

    @property
    def accept_threshold(self) -> float:
        """A model must be accepted by >= 2 filters (Alg. 1 line 19)."""
        pairs = (self.tau1 + self.tau2, self.tau1 + self.tau3, self.tau2 + self.tau3)
        return min(pairs)


class TemporalState(NamedTuple):
    """WFAgg-T state (Alg. 4): each node keeps the last model of every
    neighbour and a ring buffer of the last W metrics.

    One node (``wfagg``): ``prev (K, d)``, ``hist_s``/``hist_b (W, K)``,
    ``count``/``t`` scalars.  Gossip round (``wfagg_batch``): a leading N
    axis on the history, and ``prev`` either the previous round's (M, d)
    model matrix (indexed form only: read through the neighbour table, so
    edge (n, k)'s last model is ``prev[idx[n, k]]``) or a per-edge (N, K,
    d) tensor (both forms, every backend).
    """

    prev: Tensor      # (K, d), (M, d) or (N, K, d)
    hist_s: Tensor    # ([N,] W, K) ring buffer of squared-distance metrics
    hist_b: Tensor    # ([N,] W, K) ring buffer of cosine-distance metrics
    count: Tensor     # ([N]) number of metric rounds recorded so far
    t: Tensor         # ([N]) current round index


def init_temporal_state(K: int, d: int, window: int, device=None) -> TemporalState:
    """One node's empty WFAgg-T state: zero ``prev (K, d)`` and history."""
    return TemporalState(
        prev=torch.zeros((K, d), device=device),
        hist_s=torch.zeros((window, K), device=device),
        hist_b=torch.zeros((window, K), device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        t=torch.zeros((), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# filters of one node, on its (K, d) candidate matrix
# ---------------------------------------------------------------------------

def wfagg_d_select(updates: Tensor, f: int) -> Tensor:
    """Alg. 2: keep the K-f-1 candidates closest (L2) to the median model."""
    K = updates.shape[-2]
    med = agg.coordinate_median(updates)
    d2 = ((updates - med.unsqueeze(-2)) ** 2).sum(-1)
    return agg.smallest_k_mask(d2, K - int(f) - 1)


def wfagg_c_stats(updates: Tensor) -> Tuple[Tensor, Tensor]:
    """Cosine distances of norm-clipped candidates to the median model.

    Returns (alpha_j (..., K), clipped updates (..., K, d)).  Positive
    rescaling cannot change a cosine, so clipping affects downstream
    magnitude only.
    """
    med = agg.coordinate_median(updates)
    norms = torch.linalg.norm(updates, dim=-1)
    tau_med = agg.coordinate_median(norms.unsqueeze(-1))       # (..., 1)
    scale = torch.clamp(tau_med / torch.clamp(norms, min=_EPS), max=1.0)
    clipped = updates * scale[..., None]
    med_n = torch.linalg.norm(med, dim=-1, keepdim=True)
    cnorms = torch.linalg.norm(clipped, dim=-1)
    cos = (clipped @ med.unsqueeze(-1))[..., 0] / torch.clamp(cnorms * med_n, min=_EPS)
    return 1.0 - cos, clipped


def wfagg_c_select(updates: Tensor, f: int) -> Tensor:
    """Alg. 3: keep the K-f-1 candidates with smallest cosine distance."""
    K = updates.shape[-2]
    alpha_j, _ = wfagg_c_stats(updates)
    return agg.smallest_k_mask(alpha_j, K - int(f) - 1)


def wfagg_t_decide(hist_s: Tensor, hist_b: Tensor, count: Tensor, t: Tensor,
                   s_t: Tensor, b_t: Tensor, cfg: WFAggConfig):
    """Alg. 4 decision core on precomputed round-over-round metrics,
    batched over N.  Returns (mask, hist_s', hist_b', count', t')."""
    mu_d, sd_d = trust.ewma_mean_std(hist_s, count, cfg.ewma_decay)
    mu_c, sd_c = trust.ewma_mean_std(hist_b, count, cfg.ewma_decay)
    in_d = (s_t >= mu_d - sd_d) & (s_t <= mu_d + sd_d)
    in_c = (b_t >= mu_c - sd_c) & (b_t <= mu_c + sd_c)
    active = ((t > cfg.transient) & (count > 0))[..., None]
    mask = active & in_d & in_c
    return (mask, *trust.push_history(hist_s, hist_b, count, t, s_t, b_t))


def wfagg_t_select(state: TemporalState, updates: Tensor,
                   cfg: WFAggConfig) -> Tuple[Tensor, TemporalState]:
    """Alg. 4 for one node: flag candidates whose round-over-round change
    is abrupt.  Returns (mask, new_state).  During the transient
    (t <= T_th) no candidate passes, but the metric history accumulates
    so the window is warm when the filter activates."""
    prev = state.prev
    s_t = ((updates - prev) ** 2).sum(-1)
    num = (updates * prev).sum(-1)
    den = torch.clamp(torch.linalg.norm(updates, dim=-1)
                      * torch.linalg.norm(prev, dim=-1), min=_EPS)
    mask, hist_s, hist_b, count, t = wfagg_t_decide(
        state.hist_s, state.hist_b, state.count, state.t, s_t, 1.0 - num / den, cfg)
    return mask, TemporalState(prev=updates, hist_s=hist_s, hist_b=hist_b,
                               count=count, t=t)


def wfagg_e(local: Tensor, updates: Tensor, weights: Tensor, alpha: float) -> Tensor:
    """Eq. 3: theta_n <- (1-a)*theta_n + a * sum_k w'_nk u_nk, for one node
    (``local (d,)``, ``updates (K, d)``, ``weights (K,)``) or every node
    of a round (a leading N axis on all three).  A node whose neighbours
    were all rejected keeps its local model."""
    wsum = weights.sum(-1)
    w_norm = weights / torch.clamp(wsum, min=_EPS)[..., None]
    neighbor = torch.einsum("...k,...kd->...d", w_norm, updates)
    zero = torch.zeros_like(wsum)
    eff_alpha = torch.where(wsum > 0, zero + alpha, zero)[..., None]
    return (1.0 - eff_alpha) * local + eff_alpha * neighbor


def _distance_mask(updates: Tensor, cfg: WFAggConfig) -> Tensor:
    if cfg.distance_filter == "wfagg_d":
        return wfagg_d_select(updates, cfg.f)
    if cfg.distance_filter == "multi_krum":
        m = cfg.multi_krum_m or max(1, updates.shape[-2] // 4)
        return agg.smallest_k_mask(agg.krum_scores(updates, cfg.f), m)
    raise ValueError(f"unknown distance filter {cfg.distance_filter!r}")


def _similarity_mask(updates: Tensor, cfg: WFAggConfig) -> Tensor:
    if cfg.similarity_filter == "wfagg_c":
        return wfagg_c_select(updates, cfg.f)
    if cfg.similarity_filter == "clustering":
        return agg.clustering_select(updates)
    raise ValueError(f"unknown similarity filter {cfg.similarity_filter!r}")


def _info(mask_d, mask_c, mask_t, weights) -> dict:
    return {"mask_d": mask_d, "mask_c": mask_c, "mask_t": mask_t,
            "weights": weights, "n_accepted": (weights > 0).sum(-1)}


def _wfagg_fused(local: Tensor, updates: Tensor, state: Optional[TemporalState],
                 cfg: WFAggConfig) -> Tuple[Tensor, Optional[TemporalState], dict]:
    """One node's fused WFAgg: every filter statistic from ONE read of the
    candidates (the robust_stats kernel, without the d-sized centers; the
    Gram kernel too when an Alt-WFAgg filter needs the (K, K) distances),
    the scoring stage on the host, and one more read for the combine
    kernel.  No value comes back to the host on the way."""
    temporal = cfg.use_temporal and state is not None
    prev = state.prev if temporal else None
    stats = robust_stats(updates, prev=prev, need_center=False)
    gram = pairwise_gram(updates)[0] if trust.needs_gram(cfg) else None
    mask_d = trust.fused_distance_mask(stats, gram, cfg)
    mask_c = trust.fused_similarity_mask(stats, gram, cfg)
    if temporal:
        mask_t, hist_s, hist_b, count, t = wfagg_t_decide(
            state.hist_s, state.hist_b, state.count, state.t,
            stats.prev_dist2, stats.cosine_to_prev(), cfg)
        new_state = TemporalState(prev=updates, hist_s=hist_s, hist_b=hist_b,
                                  count=count, t=t)
    else:
        mask_t = torch.zeros_like(mask_d)
        new_state = state
    weights = trust.wfagg_scores(mask_d, mask_c, mask_t, cfg)
    out = weighted_agg(local, updates, weights, alpha=cfg.alpha)
    return out, new_state, _info(mask_d, mask_c, mask_t, weights)


def _wfagg_reference(local: Tensor, updates: Tensor,
                     state: Optional[TemporalState],
                     cfg: WFAggConfig) -> Tuple[Tensor, Optional[TemporalState], dict]:
    """The per-filter pipeline of one node, or of every node of a gathered
    round (a leading N axis on every input and on the state)."""
    mask_d = _distance_mask(updates, cfg)
    mask_c = _similarity_mask(updates, cfg)
    if cfg.use_temporal and state is not None:
        mask_t, new_state = wfagg_t_select(state, updates, cfg)
    else:
        mask_t = torch.zeros_like(mask_d)
        new_state = state
    weights = trust.wfagg_scores(mask_d, mask_c, mask_t, cfg)
    out = wfagg_e(local, updates, weights, cfg.alpha)
    return out, new_state, _info(mask_d, mask_c, mask_t, weights)


def wfagg(local: Tensor, updates: Tensor, state: Optional[TemporalState],
          cfg: WFAggConfig) -> Tuple[Tensor, Optional[TemporalState], dict]:
    """Full WFAgg (Alg. 1) for one node: ``local (d,)`` is the WFAgg-E
    anchor, ``updates (K, d)`` the received models, ``state`` its WFAgg-T
    state (``init_temporal_state``) or None.  Runs on the tensors' device.
    Returns ``(aggregated (d,), new_state, info)`` with the filter masks,
    trust weights and accepted count in ``info``."""
    if cfg.backend in _FUSED_BACKENDS:
        return _wfagg_fused(local, updates, state, cfg)
    if cfg.backend != "reference":
        raise ValueError(f"unknown backend {cfg.backend!r}")
    return _wfagg_reference(local, updates, state, cfg)


def alt_wfagg_config(**kw) -> WFAggConfig:
    """Alt-WFAgg (paper Section VI-B2): Multi-Krum + Clustering as the filters."""
    return WFAggConfig(distance_filter="multi_krum", similarity_filter="clustering", **kw)


def _indexed_scoring(stats: RobustStats, valid_b: Tensor,
                     state: Optional[TemporalState], cfg: WFAggConfig,
                     models: Tensor, neighbor_idx: Tensor):
    """Host-side scoring stage of the two-launch and reference backends:
    trust masks, the WFAgg-T decision + ring-buffer update and the
    tau-weighted scores.
    Returns (mask_d, mask_c, mask_t, weights, new_state)."""
    temporal = cfg.use_temporal and state is not None
    mask_d = trust.fused_distance_mask_valid(stats, valid_b, cfg)
    mask_c = trust.fused_similarity_mask_valid(stats, valid_b, cfg)
    if temporal:
        mask_t, hist_s, hist_b, count, t = wfagg_t_decide(
            state.hist_s, state.hist_b, state.count, state.t,
            stats.prev_dist2, stats.cosine_to_prev(), cfg)
        mask_t = mask_t & valid_b
        new_state = TemporalState(
            prev=models if state.prev.ndim == 2 else models[neighbor_idx],
            hist_s=hist_s, hist_b=hist_b, count=count, t=t)
    else:
        mask_t = torch.zeros_like(valid_b)
        new_state = state
    weights = trust.wfagg_scores(mask_d, mask_c, mask_t, cfg) * valid_b.to(torch.float32)
    return mask_d, mask_c, mask_t, weights, new_state


def _push_temporal_history(state: TemporalState, prev_new: Tensor,
                           s_t: Tensor, b_t: Tensor) -> TemporalState:
    """WFAgg-T ring-buffer push after the single-launch round, which
    takes its masks from the kernel: only the history advances here."""
    hist_s, hist_b, count, t = trust.push_history(
        state.hist_s, state.hist_b, state.count, state.t, s_t, b_t)
    return TemporalState(prev=prev_new, hist_s=hist_s, hist_b=hist_b,
                         count=count, t=t)


def sanitize_rows(models: Tensor, idx: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor]:
    """The non-finite payload sanitizer: ``models (M, d)`` with each row
    holding a NaN or Inf zeroed, and ``valid (N, K)`` with the edges that
    read such a row through ``idx`` demoted."""
    finite = torch.isfinite(models).all(-1)
    return (torch.where(finite[:, None], models, torch.zeros_like(models)),
            valid & finite[idx])


def sanitize_round(models: Tensor, idx: Tensor, valid: Tensor,
                   state: Optional[TemporalState], temporal: bool):
    """``sanitize_rows`` for a round's inputs, and the WFAgg-T ``prev``
    (when ``temporal``) with its non-finite rows zeroed.  The chaos round's
    prev IS the stacked model matrix: it is sanitized once and stays one
    tensor, so the kernel wrappers pass it as one pointer.  Returns
    ``(models, valid, state)``."""
    shared = temporal and state.prev is models
    models, valid = sanitize_rows(models, idx, valid)
    if shared:
        state = state._replace(prev=models)
    elif temporal:
        pf = torch.isfinite(state.prev).all(-1)
        state = state._replace(prev=torch.where(
            pf[..., None], state.prev, torch.zeros_like(state.prev)))
    return models, valid, state


def _wfagg_batch_indexed(local: Tensor, models: Tensor,
                         state: Optional[TemporalState], cfg: WFAggConfig,
                         neighbor_idx: Tensor, valid: Optional[Tensor],
                         prev_idx: Optional[Tensor] = None):
    """Gather-free batched WFAgg (see ``wfagg_batch``)."""
    N, K = neighbor_idx.shape
    idx = neighbor_idx.long()
    valid_b = (torch.ones((N, K), dtype=torch.bool, device=models.device)
               if valid is None else valid.to(torch.bool))
    temporal = cfg.use_temporal and state is not None
    if prev_idx is not None and not (temporal and state.prev.ndim == 2):
        prev_idx = None        # nothing matrix-formed to re-key
    if cfg.sanitize:
        models, valid_b, state = sanitize_round(models, idx, valid_b, state, temporal)
    prev = state.prev if temporal else None

    if cfg.backend == "reference":
        stats = robust_stats_indexed_ref(models, idx, valid_b, prev,
                                         need_gram=trust.needs_gram(cfg),
                                         prev_idx=prev_idx)
        mask_d, mask_c, mask_t, weights, new_state = _indexed_scoring(
            stats, valid_b, state, cfg, models, idx)
        out = wfagg_e(local, models[idx].to(torch.float32), weights, cfg.alpha)
    elif cfg.backend == "fused":
        # one launch: statistics, the scoring stage and the combine.  The
        # WFAgg-T bands are the only precompute (they need the metric
        # history); the ring buffers advance afterwards off the kernel's
        # temporal tail.
        tbands = None
        if temporal:
            tbands = trust.temporal_bands(state.hist_s, state.hist_b,
                                          state.count, state.t, cfg)
        out, weights, mask_d, mask_c, mask_t, stats = wfagg_round_indexed(
            local, models, idx, valid_b if cfg.sanitize else valid, cfg,
            prev=prev, tbands=tbands, prev_idx=prev_idx)
        new_state = state
        if temporal:
            new_state = _push_temporal_history(
                state, models if state.prev.ndim == 2 else models[idx],
                stats.prev_dist2, stats.cosine_to_prev())
    elif cfg.backend == "fused_two_launch":
        # the statistics launch (the Alt-WFAgg Gram rides along in the same
        # pass), the scoring stage on the host, the combine launch
        stats = robust_stats_indexed(models, idx, valid_b if cfg.sanitize else valid,
                                     prev=prev, need_gram=trust.needs_gram(cfg),
                                     prev_idx=prev_idx)
        mask_d, mask_c, mask_t, weights, new_state = _indexed_scoring(
            stats, valid_b, state, cfg, models, idx)
        out = weighted_agg_indexed(local, models, idx, weights, alpha=cfg.alpha)
    else:
        raise ValueError(f"unknown backend {cfg.backend!r}")

    info = {
        "mask_d": mask_d,
        "mask_c": mask_c,
        "mask_t": mask_t,
        "valid": valid_b,
        "weights": weights,
        "n_accepted": (weights > 0).sum(-1),
    }
    return out, new_state, info


def _to_device(x, dev: torch.device):
    if x is None:
        return None
    if isinstance(x, TemporalState):
        return TemporalState(*(t.to(dev) for t in x))
    return x.to(dev)


def _wfagg_batch_gathered(local: Tensor, updates: Tensor,
                          state: Optional[TemporalState],
                          cfg: WFAggConfig) -> Tuple[Tensor, Optional[TemporalState], dict]:
    """Batched WFAgg over the gathered (N, K, d) candidates (see
    ``wfagg_batch``).  No sanitizer and no valid mask, as in the
    reference: a non-finite candidate reaches the statistics."""
    if cfg.backend == "reference":
        return _wfagg_reference(local, updates, state, cfg)
    if cfg.backend not in _FUSED_BACKENDS:
        raise ValueError(f"unknown backend {cfg.backend!r}")
    temporal = cfg.use_temporal and state is not None
    # one launch of the batched statistics kernel, without the centers
    stats = robust_stats_batch(updates, prev=state.prev if temporal else None,
                               need_center=False)
    # one more read of the candidates for the Alt-WFAgg filters: the
    # reference's einsum outside Pallas, a batched matrix product here
    gram = (torch.bmm(updates, updates.transpose(1, 2))
            if trust.needs_gram(cfg) else None)
    mask_d = trust.fused_distance_mask(stats, gram, cfg)
    mask_c = trust.fused_similarity_mask(stats, gram, cfg)
    if temporal:
        mask_t, hist_s, hist_b, count, t = wfagg_t_decide(
            state.hist_s, state.hist_b, state.count, state.t,
            stats.prev_dist2, stats.cosine_to_prev(), cfg)
        new_state = TemporalState(prev=updates, hist_s=hist_s, hist_b=hist_b,
                                  count=count, t=t)
    else:
        mask_t = torch.zeros_like(mask_d)
        new_state = state
    weights = trust.wfagg_scores(mask_d, mask_c, mask_t, cfg)
    # the batched Eq. 3 combine: the second (K, d)-sized pass
    out = wfagg_e(local, updates, weights, cfg.alpha)
    return out, new_state, _info(mask_d, mask_c, mask_t, weights)


def wfagg_batch(
    local: Tensor,
    updates: Tensor,
    state: Optional[TemporalState],
    cfg: WFAggConfig,
    neighbor_idx: Optional[Tensor] = None,
    valid: Optional[Tensor] = None,
    prev_idx: Optional[Tensor] = None,
    device=None,
) -> Tuple[Tensor, Optional[TemporalState], dict]:
    """Batched full WFAgg over all N receiving nodes of a gossip round, in
    one of two forms.  ``local (N, d)`` are the combine anchors; ``state``
    carries the WFAgg-T history with a leading N axis.

    Gathered form (``neighbor_idx`` None): ``updates (N, K, d)`` holds each
    node's K received models.  On ``fused`` / ``fused_two_launch`` (the
    same here) the statistics are one launch of the batched kernel, the
    Alt-WFAgg Gram a ``torch.bmm`` and the combine plain batched Eq. 3;
    ``reference`` runs the per-node pipeline of ``wfagg``, batched.  No
    sanitizer and no valid mask (``valid`` and ``prev_idx`` raise).

    Indexed form (``neighbor_idx (N, K)`` given): ``updates`` is the (M, d)
    MODEL MATRIX the neighbour rows are read from, and the (N, K, d)
    gossip tensor never exists on the fused paths.  ``valid (N, K)`` marks
    the real edges of padded irregular slates (None = regular);
    non-finite rows are zeroed and their edges demoted (``cfg.sanitize``).
    ``prev_idx (N, K)`` reads a matrix ``prev`` through its own table
    (chaos transport: ``state.prev`` is then the stacked matrix, often
    ``updates`` itself); it is dropped when ``prev`` is not a matrix.

    ``state.prev`` is per edge in both forms, (N, K, d): edge (n, k)'s
    last received model, which the new state replaces with this round's
    (``updates`` gathered, ``updates[neighbor_idx]`` indexed); the indexed
    form also takes the previous round's (M, d) model matrix, and then
    keeps a matrix.  Every input moves to ``device`` (None = the card,
    which raises without one).  Returns ``(out (N, d), new_state, info)``
    with the filter masks and trust weights (and, indexed, the valid
    mask) in ``info``.
    """
    if neighbor_idx is None:
        if prev_idx is not None:
            raise ValueError("prev_idx requires neighbor_idx (indexed path)")
        if valid is not None:
            raise ValueError("valid requires neighbor_idx (padded indexed path)")
        if updates.ndim != 3:
            raise ValueError("the gathered form takes updates (N, K, d), got "
                             f"{tuple(updates.shape)}; pass neighbor_idx with "
                             "the (M, d) model matrix")
        dev = resolve_device(device)
        return _wfagg_batch_gathered(local.to(dev), updates.to(dev),
                                     _to_device(state, dev), cfg)
    dev = resolve_device(device)
    return _wfagg_batch_indexed(
        local.to(dev), updates.to(dev), _to_device(state, dev), cfg,
        neighbor_idx.to(dev), _to_device(valid, dev), _to_device(prev_idx, dev))


def realign_temporal_history(state: TemporalState, prev_idx: Tensor,
                             prev_valid: Tensor, idx: Tensor,
                             valid: Tensor) -> TemporalState:
    """Re-key the slot-positional WFAgg-T ring buffers to a new slate.

    ``hist_s``/``hist_b`` are (N, W, K) and keyed by neighbour SLOT; on a
    round-varying topology a neighbour may occupy another slot than last
    round, so without remapping Alg. 4 would score each neighbour against
    another's history.  Column k_new receives the history of the k_old
    with ``idx[n, k_new] == prev_idx[n, k_old]`` (both slots valid); a
    neighbour unseen last round starts with a zeroed column.  The (N, d)
    matrix ``prev`` needs no remap (it is indexed by node id), and on a
    static slate the match is the identity.  The contraction is a float32
    einsum over 0/1 weights (exact), as in the reference, so a neighbour
    seen twice or never behaves the same.
    """
    match = ((idx[:, :, None] == prev_idx[:, None, :])
             & valid.to(torch.bool)[:, :, None]
             & prev_valid.to(torch.bool)[:, None, :])   # (N, K_new, K_old)
    m = match.to(state.hist_s.dtype)
    return state._replace(
        hist_s=torch.einsum("nkj,nwj->nwk", m, state.hist_s),
        hist_b=torch.einsum("nkj,nwj->nwk", m, state.hist_b),
    )


def memory_passes(cfg: WFAggConfig, include_gather: bool = False,
                  indexed: bool = False) -> int:
    """Number of (K, d)-sized memory passes per full-WFAgg aggregation.

    reference: each filter re-reads the candidates: distance filter
    (median sort + distances = 2, or 1 Gram pass for Multi-Krum),
    similarity filter (median + norms/clip + cosine dots = 3, or 1 Gram
    pass for Clustering), temporal metrics (1), WFAgg-E combine (1).
    fused: one statistics read covers D/C/T, plus the combine (+ 1 Gram
    pass when an Alt-WFAgg filter needs the K x K distances).

    ``include_gather`` also counts the gossip exchange a DFL round pays
    before aggregating: building the gathered (N, K, d) tensor is one more
    candidate-sized pass, unless ``indexed`` (the gather-free path, which
    reads neighbour rows from the (N, d) model matrix and also folds the
    Alt-WFAgg Gram into the statistics pass).  Indexed ``fused`` is the
    single-launch round: one streamed read; ``fused_two_launch`` keeps two.
    """
    t = 1 if cfg.use_temporal else 0
    gather = 1 if (include_gather and not indexed) else 0
    if cfg.backend in _FUSED_BACKENDS:
        if indexed and cfg.backend == "fused":
            return 1 + gather
        gram = 1 if (trust.needs_gram(cfg) and not indexed) else 0
        return 2 + gram + gather
    d_passes = 1 if cfg.distance_filter == "multi_krum" else 2
    c_passes = 1 if cfg.similarity_filter == "clustering" else 3
    return d_passes + c_passes + t + 1 + gather


# ---------------------------------------------------------------------------
# standalone filters (Table I columns WFAgg-D / WFAgg-C / WFAgg-E; WFAgg-T
# is wfagg_t_select + wfagg_e), on (K, d) or a batch (N, K, d)
# ---------------------------------------------------------------------------

def wfagg_d_agg(updates: Tensor, f: int = 2,
                backend: str = "reference") -> Tuple[Tensor, Tensor]:
    """WFAgg-D alone: the mean of the K-f-1 candidates closest to the
    median.  ``backend="fused"`` ranks the statistics kernel's distances
    (one matrix only).  Returns ``(aggregate, mask)``."""
    if backend == "fused":
        stats = robust_stats(updates, need_center=False)
        mask = agg.smallest_k_mask(stats.dist2, updates.shape[-2] - int(f) - 1)
    else:
        mask = wfagg_d_select(updates, f)
    return agg.masked_mean(updates, mask), mask


def wfagg_c_agg(updates: Tensor, f: int = 2,
                backend: str = "reference") -> Tuple[Tensor, Tensor]:
    """WFAgg-C alone: the mean of the K-f-1 candidates of smallest cosine
    distance to the median (``backend="fused"`` as in ``wfagg_d_agg``)."""
    if backend == "fused":
        stats = robust_stats(updates, need_center=False)
        mask = agg.smallest_k_mask(stats.cosine_to_median(),
                                   updates.shape[-2] - int(f) - 1)
    else:
        mask = wfagg_c_select(updates, f)
    return agg.masked_mean(updates, mask), mask


def wfagg_e_agg(local: Tensor, updates: Tensor, alpha: float = 0.8) -> Tensor:
    """WFAgg-E alone: uniform weights over all neighbours (no filtering)."""
    weights = torch.ones(updates.shape[:-1], dtype=torch.float32, device=updates.device)
    return wfagg_e(local, updates, weights, alpha)
