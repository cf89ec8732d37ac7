"""WFAgg, the paper's Byzantine-robust aggregation (Section IV): the
gather-free batched gossip path (port of ``repro.core.wfagg``).

All N receiving nodes of a gossip round aggregate at once from the (M, d)
model matrix and an (N, K) neighbour table; the (N, K, d) gossip tensor
never exists on the fused path.

Execution backends (``WFAggConfig.backend``):
  fused      the single-launch round (``kernels.robust_stats.ops.
             wfagg_round_indexed``): the CUDA kernel on CUDA tensors, its
             plain PyTorch version on CPU tensors.
  reference  the valid-aware plain-PyTorch pipeline: gathered statistics
             (``robust_stats_indexed_ref``), the same trust logic on the
             host, the Eq. 3 combine.  With ``valid=None`` it runs with an
             all-true mask, which selects exactly as the static-count
             filters do.
  fused_two_launch
             not ported yet (ROADMAP queue 2, items 2-3).

The single-node ``wfagg()``, the gathered ``wfagg_batch`` and the
standalone filter aggregators are not ported yet (ROADMAP queue 1,
item 10).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import trust
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.robust_stats.ops import wfagg_round_indexed
from repro_torch.kernels.robust_stats.ref import RobustStats, robust_stats_indexed_ref

Tensor = torch.Tensor
_EPS = 1e-12


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
    # Alt-WFAgg filters ("multi_krum" / "clustering") are not ported yet
    distance_filter: str = "wfagg_d"
    similarity_filter: str = "wfagg_c"
    multi_krum_m: Optional[int] = None
    backend: str = "fused"      # "fused" | "reference" (see module doc)
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
    """Per-receiving-node WFAgg-T state (Alg. 4), leading N axis.

    ``prev`` is the previous round's (M, d) model matrix (read through the
    neighbour table, so edge (n, k)'s last model is ``prev[idx[n, k]]``)
    or a per-edge (N, K, d) tensor (reference backend only).
    """

    prev: Tensor      # (M, d) or (N, K, d)
    hist_s: Tensor    # (N, W, K) ring buffer of squared-distance metrics
    hist_b: Tensor    # (N, W, K) ring buffer of cosine-distance metrics
    count: Tensor     # (N,) number of metric rounds recorded so far
    t: Tensor         # (N,) current round index


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


def wfagg_e(local: Tensor, updates: Tensor, weights: Tensor, alpha: float) -> Tensor:
    """Eq. 3 for every node: theta_n <- (1-a)*theta_n + a * sum_k w'_nk u_nk.

    ``local (N, d)``, ``updates (N, K, d)``, ``weights (N, K)``.  A node
    whose neighbours were all rejected keeps its local model."""
    wsum = weights.sum(-1)
    w_norm = weights / torch.clamp(wsum, min=_EPS)[..., None]
    neighbor = torch.einsum("nk,nkd->nd", w_norm, updates)
    zero = torch.zeros_like(wsum)
    eff_alpha = torch.where(wsum > 0, zero + alpha, zero)[..., None]
    return (1.0 - eff_alpha) * local + eff_alpha * neighbor


def _indexed_scoring(stats: RobustStats, valid_b: Tensor,
                     state: Optional[TemporalState], cfg: WFAggConfig,
                     models: Tensor, neighbor_idx: Tensor):
    """Host-side scoring stage of the reference backend: trust masks, the
    WFAgg-T decision + ring-buffer update and the tau-weighted scores.
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


def _wfagg_batch_indexed(local: Tensor, models: Tensor,
                         state: Optional[TemporalState], cfg: WFAggConfig,
                         neighbor_idx: Tensor, valid: Optional[Tensor]):
    """Gather-free batched WFAgg (see ``wfagg_batch``)."""
    N, K = neighbor_idx.shape
    idx = neighbor_idx.long()
    valid_b = (torch.ones((N, K), dtype=torch.bool, device=models.device)
               if valid is None else valid.to(torch.bool))
    temporal = cfg.use_temporal and state is not None
    if cfg.sanitize:
        finite = torch.isfinite(models).all(-1)
        models = torch.where(finite[:, None], models, torch.zeros_like(models))
        valid_b = valid_b & finite[idx]
        if temporal:
            pf = torch.isfinite(state.prev).all(-1)
            state = state._replace(prev=torch.where(
                pf[..., None], state.prev, torch.zeros_like(state.prev)))
    prev = state.prev if temporal else None

    if cfg.backend == "reference":
        stats = robust_stats_indexed_ref(models, idx, valid_b, prev)
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
            prev=prev, tbands=tbands)
        new_state = state
        if temporal:
            new_state = _push_temporal_history(
                state, models if state.prev.ndim == 2 else models[idx],
                stats.prev_dist2, stats.cosine_to_prev())
    elif cfg.backend == "fused_two_launch":
        raise NotImplementedError(
            "backend='fused_two_launch' needs the stats and combine kernels, "
            "not ported yet: ROADMAP queue 2, items 2-3")
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
    """Batched full WFAgg over all N receiving nodes of a gossip round.

    ``local (N, d)`` are the combine anchors; with ``neighbor_idx (N, K)``,
    ``updates`` is the (M, d) MODEL MATRIX the neighbour rows are read
    from.  ``valid (N, K)`` marks the real edges of padded irregular
    slates (None = regular).  ``state`` carries the WFAgg-T history with a
    leading N axis.  Every input moves to ``device`` (None = the card,
    which raises without one).  Returns ``(out (N, d), new_state, info)``
    with the filter masks, valid mask and trust weights in ``info``.
    """
    if neighbor_idx is None:
        raise NotImplementedError(
            "the gathered (N, K, d) wfagg_batch is not ported yet: ROADMAP "
            "queue 1, item 10; pass neighbor_idx with the (M, d) matrix")
    if prev_idx is not None:
        raise NotImplementedError(
            "prev_idx (chaos transport) is not ported yet: ROADMAP queue 1, "
            "item 8")
    dev = resolve_device(device)
    return _wfagg_batch_indexed(
        local.to(dev), updates.to(dev), _to_device(state, dev), cfg,
        neighbor_idx.to(dev), _to_device(valid, dev))
