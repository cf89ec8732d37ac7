"""D-sharded WFAgg gossip rounds on ``torch.distributed`` (port of
``repro.distributed.spmd``).

The one-launch round kernel derives its trust weights from statistics
over the whole model, so it cannot run on a d/S slice alone.  The
two-launch decomposition can, because every statistic the scoring stage
reads is a sum over coordinates (``RobustStats``: dist2, dotmed, norm2,
mednorm2, the prev_* tail and the Gram), and the coordinate-wise median
is computed per coordinate, i.e. inside a shard:

  statistics (per shard)  ``robust_stats_indexed`` (kernel 2) on this
                          rank's (M, d/S) columns, no communication;
  ``psum_stats``          ONE collective of the O(N·K) partials: an
                          ``all_gather``, then a sum in rank order on
                          every rank, so every rank scores on
                          bit-identical statistics;
  scoring (replicated)    ``core.wfagg._indexed_scoring`` on every rank;
  combine (per shard)     ``weighted_agg_indexed`` (kernel 3) on this
                          rank's columns: the WFAgg-E combine never
                          crosses shards.

The port runs one process per shard.  ``torch.distributed`` takes the
place of ``shard_map``: the caller initialises the process group (``gloo``
or ``nccl``; ``torchrun``, or ``init_process_group`` in each spawned
process) and every rank calls the same function with the same replicated
inputs.  d is zero-padded to a multiple of S and split into equal column
blocks, rank r holding block r, as the reference's mesh splits it; a zero
column has median 0 and adds nothing to any statistic or combine.

No (N, K, d) tensor exists, and nothing of d crosses ranks before the
combine.  ``wfagg_batch_sharded`` gathers the combined ``out`` shards
afterwards (the engine's consumer is replicated); ``wfagg_scan_sharded``
keeps each rank's model shard on that rank for all its rounds.

``gloo`` does not take CUDA tensors for every collective; on a ``gloo``
group every collective here stages its tensor through host memory (the
O(N·K) partials, and the gathered ``out``), always.  ``nccl`` stays on
the device.

The reference's ``sharded_round_jit`` / ``sharded_scan_jit`` are lint
entry points for its jaxpr/HLO analyzer and wait with that analyzer's
port (ROADMAP queue 1, item 13).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import wfagg as wf
from repro_torch.core.trust import needs_gram
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.robust_stats.ops import robust_stats_indexed
from repro_torch.kernels.robust_stats.ref import RobustStats
from repro_torch.kernels.weighted_agg.ops import weighted_agg_indexed

Tensor = torch.Tensor
ProcessGroup = dist.ProcessGroup if dist.is_available() else object

# the coordinate sums a shard's statistics hold, in their packed order
SUM_FIELDS = ("dist2", "dotmed", "norm2", "mednorm2", "prev_dist2", "prev_dot",
              "prev_norm2", "gram")


def _resolve_group(group: Optional[ProcessGroup]) -> ProcessGroup:
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            "model-dimension sharding needs an initialised torch.distributed "
            "process group with one rank per shard (torchrun, or "
            "init_process_group in each process)")
    return dist.group.WORLD if group is None else group


def aggregation_group(n_shards: int, group: Optional[ProcessGroup] = None
                      ) -> ProcessGroup:
    """The process group the model dimension shards over: ``group``, or the
    initialised default group.  Raises ValueError when ``torch.distributed``
    is not initialised or the group does not have ``n_shards`` ranks; it
    never runs unsharded in their place."""
    g = _resolve_group(group)
    size = dist.get_world_size(g)
    if size != n_shards:
        raise ValueError(f"the process group has {size} ranks, but the model "
                         f"dimension is to be split into {n_shards} shards")
    return g


def shard_padded_d(d: int, n_shards: int) -> int:
    """d zero-padded up to a multiple of the shard count (exact: zero
    columns contribute nothing to any WFAgg statistic or combine)."""
    return d + (-d) % max(1, n_shards)


def pad_to_shards(x: Tensor, n_shards: int) -> Tensor:
    """Zero-pad the trailing (d) axis to a shard multiple, promote f32."""
    return F.pad(x.to(torch.float32), (0, (-x.shape[-1]) % max(1, n_shards)))


def shard_columns(x: Tensor, rank: int, n_shards: int) -> Tensor:
    """Rank ``rank``'s block of the trailing axis of ``x`` zero-padded to a
    multiple of ``n_shards``, as a contiguous float32 tensor (the full
    matrix is never padded)."""
    d = x.shape[-1]
    w = shard_padded_d(d, n_shards) // n_shards
    lo = min(rank * w, d)
    hi = min(lo + w, d)
    part = x[..., lo:hi].to(torch.float32)
    if hi - lo < w:
        part = F.pad(part, (0, w - (hi - lo)))
    return part.contiguous()


def batched_matrix_state(n: int, k: int, d: int, window: int,
                         device=None) -> wf.TemporalState:
    """Batched matrix-prev temporal state (the engine's layout): the
    (N, d) previous model MATRIX instead of an (N, K, d) per-edge tensor,
    slot-keyed (N, W, K) ring buffers."""
    f32 = dict(dtype=torch.float32, device=device)
    return wf.TemporalState(
        prev=torch.zeros((n, d), **f32),
        hist_s=torch.zeros((n, window, k), **f32),
        hist_b=torch.zeros((n, window, k), **f32),
        count=torch.zeros((n,), dtype=torch.int32, device=device),
        t=torch.zeros((n,), dtype=torch.int32, device=device),
    )


def _check_state(state: Optional[wf.TemporalState]) -> None:
    if state is not None and state.prev.ndim != 2:
        raise NotImplementedError(
            "the sharded round shards the (N, d) matrix-form temporal "
            "state; per-edge (N, K, d) prev would re-materialize the "
            "gossip tensor it exists to avoid")


# ---------------------------------------------------------------------------
# the one collective: the O(N·K) statistic partials
# ---------------------------------------------------------------------------

def _on_wire(x: Tensor, group: ProcessGroup) -> Tensor:
    """``x`` where the group's backend takes it: host memory for ``gloo``
    (always, whatever the collective), the tensor's own device otherwise."""
    if dist.get_backend(group) == dist.Backend.GLOO:
        return x.cpu()
    return x


def all_gather_in_rank_order(x: Tensor, group: ProcessGroup) -> List[Tensor]:
    """Every rank's ``x`` (same shape and dtype on every rank), in rank
    order, on ``x``'s device."""
    w = _on_wire(x.contiguous(), group)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    return [p.to(x.device) for p in parts]


def all_reduce_in_rank_order(x: Tensor, group: ProcessGroup) -> Tensor:
    """The sum of every rank's ``x`` over ``group``: gathered, then added
    in rank order, so that every rank holds the same bits (a reducing
    ``all_reduce`` adds in the backend's order)."""
    parts = all_gather_in_rank_order(x, group)
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def all_gather_rows(x: Tensor, group: ProcessGroup) -> Tensor:
    """Every rank's ``x`` stacked in rank order, (S, *x.shape), on ``x``'s
    device, the output allocated once (``nccl``: one
    ``all_gather_into_tensor``; ``gloo``: through host memory)."""
    S = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((S,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    if dist.get_backend(group) == dist.Backend.GLOO:
        parts = [torch.empty(x.shape, dtype=x.dtype) for _ in range(S)]
        dist.all_gather(parts, x.cpu(), group=group)
        for row, part in zip(out, parts):
            row.copy_(part)
        return out
    dist.all_gather_into_tensor(out.view(-1), x.view(-1), group=group)
    return out


def all_to_all_rows(send: Tensor, group: ProcessGroup) -> Tensor:
    """The rows exchange of a (S, n) matrix over the S ranks of ``group``:
    row j of ``send`` goes to rank j, and row j of the result came from
    rank j (one ``all_to_all_single``; ``gloo`` through host memory)."""
    send = send.contiguous()
    if dist.get_backend(group) == dist.Backend.GLOO:
        host = send.cpu()
        recv = torch.empty_like(host)
        dist.all_to_all_single(recv, host, group=group)
        return recv.to(send.device)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv


def broadcast_from_rank0(x: Tensor, group: ProcessGroup) -> Tensor:
    """Rank 0's ``x`` on every rank (the other ranks pass a buffer of its
    shape and dtype), on ``x``'s device."""
    w = _on_wire(x.contiguous(), group)
    dist.broadcast(w, src=dist.get_global_rank(group, 0), group=group)
    return w.to(x.device)


def sum_in_rank_order(parts: List[RobustStats]) -> RobustStats:
    """The full-d statistics from every shard's partial ``RobustStats``:
    each field added shard by shard in rank order (elementwise float32
    adds, the same on every rank and device)."""
    out = {}
    for name in SUM_FIELDS:
        vals = [getattr(p, name) for p in parts]
        if vals[0] is None:
            out[name] = None
            continue
        acc = vals[0]
        for v in vals[1:]:
            acc = acc + v
        out[name] = acc
    return RobustStats(med=None, trim=None, **out)


def _pack(stats: RobustStats) -> Tensor:
    """The populated sum fields of a shard's statistics as one (N, F)
    tensor, in ``SUM_FIELDS`` order."""
    N = stats.dist2.shape[0]
    return torch.cat([getattr(stats, f).reshape(N, -1) for f in SUM_FIELDS
                      if getattr(stats, f) is not None], dim=1)


def _unpack(flat: Tensor, like: RobustStats) -> RobustStats:
    out, off = {}, 0
    for f in SUM_FIELDS:
        ref = getattr(like, f)
        if ref is None:
            out[f] = None
            continue
        n = ref[0].numel() if ref.ndim > 1 else 1
        out[f] = flat[:, off:off + n].reshape(ref.shape)
        off += n
    return RobustStats(med=None, trim=None, **out)


def psum_stats(stats: RobustStats, group: ProcessGroup) -> RobustStats:
    """Reconstruct full-d ``RobustStats`` from per-shard partials.

    Every populated field is a sum over coordinates of shard-local
    quantities.  The rank's fields go out packed as one (N, F) tensor in
    ONE ``all_gather``; every rank then adds the S partials in rank order,
    so every rank's scoring sees bit-identical statistics (a reducing
    ``all_reduce`` would sum in the backend's order, which need not be
    the same on every rank).  The wire carries S·N·F floats a rank, F =
    3K + 1 (+ 3K with prev, + K² with the Gram): independent of d.
    ``med``/``trim`` are d-sized centers the indexed statistics never emit;
    they must be None (a d-sized center cannot cross shards)."""
    if stats.med is not None or stats.trim is not None:
        raise ValueError(
            "psum_stats only reconstructs the O(N*K) accumulator fields; "
            "d-sized centers (med/trim) must stay shard-local")
    parts = all_gather_in_rank_order(_pack(stats), group)
    return sum_in_rank_order([_unpack(p, stats) for p in parts])


# ---------------------------------------------------------------------------
# the round on one shard
# ---------------------------------------------------------------------------

def _shard_stats(models: Tensor, state: Optional[wf.TemporalState],
                 cfg: wf.WFAggConfig, neighbor_idx: Tensor, valid: Tensor
                 ) -> RobustStats:
    """Kernel 2 on this rank's (M, d/S) columns, with the matrix prev shard
    and the Gram when an Alt-WFAgg filter needs it."""
    temporal = cfg.use_temporal and state is not None
    return robust_stats_indexed(models, neighbor_idx, valid,
                                prev=state.prev if temporal else None,
                                need_gram=needs_gram(cfg))


def _shard_round_body(cfg: wf.WFAggConfig, group: ProcessGroup):
    """Per-shard round body: local stats -> ``psum_stats`` -> replicated
    scoring -> local combine.  ``local``/``models``/``state.prev`` are this
    rank's (., d/S) shards, everything else is replicated (``valid_b`` the
    (N, K) bool mask)."""

    def body(local, models, state, neighbor_idx, valid_b):
        stats = _shard_stats(models, state, cfg, neighbor_idx, valid_b)
        stats = psum_stats(stats, group)
        mask_d, mask_c, mask_t, weights, new_state = wf._indexed_scoring(
            stats, valid_b, state, cfg, models, neighbor_idx)
        out = weighted_agg_indexed(local, models, neighbor_idx, weights,
                                   alpha=cfg.alpha)
        return out, new_state, (mask_d, mask_c, mask_t, weights)

    return body


def _info(mask_d, mask_c, mask_t, valid_b, weights) -> Dict[str, Tensor]:
    return {"mask_d": mask_d, "mask_c": mask_c, "mask_t": mask_t,
            "valid": valid_b, "weights": weights,
            "n_accepted": (weights > 0).sum(-1)}


def _round_inputs(local, models, state, cfg, neighbor_idx, valid, dev):
    """The replicated round inputs on ``dev``, sanitized as the unsharded
    two-launch backend sanitizes them (``cfg.sanitize``: every rank holds
    the whole matrix, so a non-finite row is found without communication).
    Returns ``(local, models, state, idx, valid_b)``."""
    local, models = local.to(dev), models.to(dev)
    idx = neighbor_idx.to(dev).long()
    N, K = idx.shape
    valid_b = (torch.ones((N, K), dtype=torch.bool, device=dev) if valid is None
               else valid.to(dev).to(torch.bool))
    state = wf._to_device(state, dev)
    if cfg.sanitize:
        models, valid_b, state = wf.sanitize_round(
            models, idx, valid_b, state, cfg.use_temporal and state is not None)
    return local, models, state, idx, valid_b


def _shard_state(state: Optional[wf.TemporalState], rank: int, S: int):
    if state is None:
        return None
    return state._replace(prev=shard_columns(state.prev, rank, S))


def wfagg_batch_sharded(
    local: Tensor,
    models: Tensor,
    state: Optional[wf.TemporalState],
    cfg: wf.WFAggConfig,
    neighbor_idx: Tensor,
    valid: Optional[Tensor] = None,
    *,
    group: Optional[ProcessGroup] = None,
    device=None,
) -> Tuple[Tensor, Optional[wf.TemporalState], Dict[str, Tensor]]:
    """Drop-in for ``wfagg_batch(..., neighbor_idx=...)`` with the model
    dimension sharded over the ranks of ``group`` (None: the initialised
    default group; raises ValueError without one).

    Every rank passes the same replicated inputs (the engine's layout),
    takes its own zero-padded column block, runs the shard body (kernel 2,
    ``psum_stats``, the scoring, kernel 3) and ``all_gather``s the combined
    blocks: every rank returns the full ``(out (N, d), new_state, info)``
    with the reference's ``info`` keys.  The new ``prev`` is this round's
    (sanitized) model matrix, which every rank already holds, so it is not
    gathered.  Semantics match ``backend='fused_two_launch'`` up to float
    summation order; the matrix-form prev only (per-edge state raises).
    Inputs move to ``device`` (None = the card)."""
    _check_state(state)
    g = _resolve_group(group)
    S, rank = dist.get_world_size(g), dist.get_rank(g)
    dev = resolve_device(device)
    d = models.shape[-1]
    local, models, state, idx, valid_b = _round_inputs(
        local, models, state, cfg, neighbor_idx, valid, dev)
    out_sh, new_state, (mask_d, mask_c, mask_t, weights) = _shard_round_body(cfg, g)(
        shard_columns(local, rank, S), shard_columns(models, rank, S),
        _shard_state(state, rank, S), idx, valid_b)
    out = torch.cat(all_gather_in_rank_order(out_sh, g), dim=1)[:, :d]
    if new_state is not None:
        new_state = new_state._replace(prev=models.to(torch.float32))
    return out, new_state, _info(mask_d, mask_c, mask_t, valid_b, weights)


def wfagg_batch_sharded_emulated(
    local: Tensor,
    models: Tensor,
    state: Optional[wf.TemporalState],
    cfg: wf.WFAggConfig,
    neighbor_idx: Tensor,
    valid: Optional[Tensor] = None,
    *,
    n_shards: int,
    device=None,
) -> Tuple[Tensor, Optional[wf.TemporalState], Dict[str, Tensor]]:
    """``wfagg_batch_sharded`` over ``n_shards`` shards in one process, with
    no process group: the same kernels on each shard and the partials
    added in rank order, so its results equal every rank's bit for bit.
    The check a sharded run is held to."""
    _check_state(state)
    dev = resolve_device(device)
    d = models.shape[-1]
    local, models, state, idx, valid_b = _round_inputs(
        local, models, state, cfg, neighbor_idx, valid, dev)
    shards = [shard_columns(models, r, n_shards) for r in range(n_shards)]
    stats = sum_in_rank_order([
        _shard_stats(m, _shard_state(state, r, n_shards), cfg, idx, valid_b)
        for r, m in enumerate(shards)])
    mask_d, mask_c, mask_t, weights, new_state = wf._indexed_scoring(
        stats, valid_b, state, cfg, models, idx)
    out = torch.cat([
        weighted_agg_indexed(shard_columns(local, r, n_shards), m, idx, weights,
                             alpha=cfg.alpha)
        for r, m in enumerate(shards)], dim=1)[:, :d]
    if new_state is not None:
        new_state = new_state._replace(prev=models.to(torch.float32))
    return out, new_state, _info(mask_d, mask_c, mask_t, valid_b, weights)


def wfagg_scan_sharded(
    models: Tensor,
    state: Optional[wf.TemporalState],
    cfg: wf.WFAggConfig,
    sched_idx: Tensor,        # (R, N, K)
    sched_valid: Tensor,      # (R, N, K)
    *,
    group: Optional[ProcessGroup] = None,
    device=None,
) -> Tuple[Tensor, Optional[wf.TemporalState]]:
    """A whole dynamic schedule of sharded gossip rounds: each rank takes
    its column block of the (N, d) ``models`` and of ``state.prev`` once
    and keeps it for all R rounds; only the O(N·K) partials cross ranks.
    Per round: the slot-history realignment of
    ``realign_temporal_history`` (with temporal state), shard-local
    statistics, ``psum_stats``, the replicated scoring and the shard-local
    combine.  d must already be a shard multiple (``pad_to_shards``).
    Returns this rank's ``(models (N, d/S), state)`` shard (``prev`` (N,
    d/S), the ring buffers replicated).  As in the reference, no
    sanitizer runs here: a non-finite row reaches the statistics."""
    _check_state(state)
    g = _resolve_group(group)
    S, rank = dist.get_world_size(g), dist.get_rank(g)
    if models.shape[-1] % S:
        raise ValueError(
            f"d={models.shape[-1]} must be a multiple of the shard count "
            f"{S} — pre-pad with pad_to_shards()")
    dev = resolve_device(device)
    sched_idx = sched_idx.to(dev).long()
    sched_valid = sched_valid.to(dev).to(torch.bool)
    m = shard_columns(models.to(dev), rank, S)
    st = _shard_state(wf._to_device(state, dev), rank, S)
    temporal = cfg.use_temporal and st is not None
    body = _shard_round_body(cfg, g)
    prev_idx, prev_val = sched_idx[0], torch.ones_like(sched_valid[0])
    for r in range(sched_idx.shape[0]):
        idx, val = sched_idx[r], sched_valid[r]
        if temporal:
            st = wf.realign_temporal_history(st, prev_idx, prev_val, idx, val)
        m, st, _ = body(m, m, st, idx, val)
        prev_idx, prev_val = idx, val
    return m, st
