"""Mode-A DFL round engine: the paper's experiment (port of
``repro.dfl.engine``).

Each of N nodes owns an independent local model.  One round =
  1. local training: minibatch momentum-SGD on every node at once
     (``torch.func.vmap`` of ``torch.func.grad`` over the stacked
     parameter dicts); Label-Flipping nodes poison their labels,
  2. model-poisoning attacks replace the Byzantine rows of the flat
     (N, d) model matrix,
  3. aggregation, one of
     - gossip (DFL): WFAgg or Alt-WFAgg over each node's K neighbours
       (``core.wfagg.wfagg_batch(neighbor_idx=…)``: on the card one launch
       of the round kernel per round on the default ``fused`` backend, or
       one launch each of the statistics and combine kernels on
       ``fused_two_launch``), keeping per-node temporal state (Alg. 4); or
       any other rule of Table I (``AGGREGATORS``) on the gathered (N, K,
       d) slates, batched over the nodes in plain PyTorch: a baseline of
       ``core.aggregators.AGGREGATORS`` (on padded slates its valid-masked
       form, ``DYN_AGGREGATORS``) or a standalone WFAgg filter (WFAgg-D,
       -C, -E, and WFAgg-T with per-edge state), as the reference does;
     - the centralized baseline (CFL, ``DFLConfig(centralized=True)``):
       one server aggregates all N received models with WFAgg or
       Alt-WFAgg (``core.wfagg.wfagg``: the statistics, Gram and combine
       kernels on the card) or any other rule of Table I, and every node
       starts the next round from the new global model.

Round-varying topologies (``run_dynamic_experiment``): a
``TopologySchedule`` gives every round its own (N, K) neighbour table,
valid mask and Byzantine mask; the tables are uploaded once, and a Python
loop runs the rounds (``build_round_fn(dynamic=True)``), re-keying the
slot-positional WFAgg-T history to each round's slate by neighbour
identity.  With a ``FaultSchedule`` (chaos transport, ``dfl.faults``)
each round also routes the gossip through drop / stale / duplicate /
corrupt / crash delivery over a stacked ring matrix, which the WFAgg
kernels read through the re-keyed table (and their ``prev_idx`` variant
for WFAgg-T); such a run can stop, checkpoint and resume bit-exactly
(``train.checkpoint``).  The baselines run on the post-fault slates
through ``DYN_AGGREGATORS``.  Nothing inside a round reads the card back
to the host.

The adaptive attacks (``band_rider``, ``min_max``) see the defense
through a ``core.attacks.DefenseView`` (``_defense_view``): the WFAgg-T
bands the round's aggregation compares, from the same
``trust.temporal_bands`` call on the pre-round state.

Entry points take ``device=None``, which means the card; without one
they raise.  As in the reference, the standalone WFAgg filters raise on
irregular graphs and on dynamic and chaos schedules (they have no
valid-masked form), and a CFL run records no per-edge telemetry.

Model-dimension sharding (``DFLConfig.mesh_model_shards > 1``) routes the
WFAgg and Alt-WFAgg gossip round of the static and dynamic rounds through
``distributed.spmd.wfagg_batch_sharded`` over the initialised default
process group, which must have that many ranks (one process per shard;
without it ``build_round_fn`` raises).  Every rank runs the same
experiment: rank 0 trains and attacks, and broadcasts the round's sent
models, parameters and momentum, so every rank aggregates, evaluates and
carries bit-identical state.  The chaos round refuses sharding, and CFL
and the other aggregators ignore the field, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.lenet_mnist import PaperDFLConfig
from repro_torch.core import aggregators as agg_lib
from repro_torch.core import attacks as atk
from repro_torch.core import metrics as met
from repro_torch.core import trust
from repro_torch.core import wfagg as wf
from repro_torch.core.topology import Topology, TopologySchedule
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.dfl import faults as flt
from repro_torch.distributed import spmd
from repro_torch.kernels.common import resolve_device
from repro_torch.models.lenet import MODELS, param_count, ravel, unravel
from repro_torch.obs import decision as obs_decision
from repro_torch.train import checkpoint as ckpt

Tensor = torch.Tensor
BASELINES = ("mean", "median", "trimmed_mean", "krum", "multi_krum", "clustering")
FILTERS = ("wfagg_d", "wfagg_c", "wfagg_t", "wfagg_e")   # standalone WFAgg filters
# Table I's columns: static DFL and CFL rounds
AGGREGATORS = BASELINES + FILTERS + ("wfagg", "alt_wfagg")
# the rules with a valid-masked form: irregular graphs, dynamic and chaos rounds
DYNAMIC_AGGREGATORS = BASELINES + ("wfagg", "alt_wfagg")


@dataclasses.dataclass(frozen=True)
class DFLConfig:
    aggregator: str = "wfagg"
    attack: str = "none"
    model: str = "mlp"            # mlp | lenet
    centralized: bool = False     # CFL: one server aggregates all N models
    paper: PaperDFLConfig = PaperDFLConfig()
    batches_per_round: int = 4
    seed: int = 0
    attack_params: atk.AttackConfig = atk.AttackConfig()
    wfagg_backend: str = "fused"  # | "fused_two_launch" | "reference" (core/wfagg.py)
    # > 1: the WFAgg / Alt-WFAgg gossip round d-sharded over a process group
    # of this many ranks (distributed/spmd.py); 0 or 1: unsharded
    mesh_model_shards: int = 0

    def wfagg_config(self, use_temporal=True, backend: Optional[str] = None) -> wf.WFAggConfig:
        p = self.paper
        return wf.WFAggConfig(
            f=p.f, tau1=p.tau1, tau2=p.tau2, tau3=p.tau3, alpha=p.alpha,
            window=p.window, transient=p.transient, use_temporal=use_temporal,
            backend=backend or self.wfagg_backend,
        )


class DFLState(NamedTuple):
    node_params: Dict[str, Tensor]     # leaves with leading axis N
    node_momentum: Dict[str, Tensor]
    temporal: Optional[wf.TemporalState]   # leading axis N (per receiving node)
    rnd: int


_CFL_TELEMETRY = ("telemetry records per-edge gossip verdicts; the CFL baseline "
                  "has one server and no edges (the reference refuses it too)")


def _check_supported(cfg: DFLConfig) -> None:
    if cfg.aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {cfg.aggregator!r} (one of "
                         f"{AGGREGATORS})")
    if cfg.model not in MODELS:
        raise ValueError(f"unknown model {cfg.model!r}")


def init_dfl_state(cfg: DFLConfig, topo: Topology,
                   degree: Optional[int] = None, device=None) -> DFLState:
    """Fresh per-node models (drawn on the CPU from ``cfg.seed``, so every
    device starts from the same weights) and WFAgg-T state on ``device``.
    ``degree`` overrides the neighbour-table width K.  Decentralized WFAgg
    and Alt-WFAgg keep the previous round's (N, d) model matrix as
    ``prev``; the standalone WFAgg-T keeps a per-edge ``prev (N, K, d)``;
    CFL keeps the one server's state with a leading axis of 1, over K = N
    candidates, with a per-edge ``prev (1, N, d)``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    init_fn, _ = MODELS[cfg.model]
    N = topo.n_nodes
    params = {k: v.to(dev) for k, v in
              init_fn(N, torch.Generator().manual_seed(cfg.seed)).items()}
    momentum = {k: torch.zeros_like(v) for k, v in params.items()}
    K = degree if degree is not None else (N if cfg.centralized else topo.degree)
    temporal = None
    if cfg.aggregator == "wfagg_t" or (cfg.centralized and cfg.aggregator in
                                       ("wfagg", "alt_wfagg")):
        # per-edge state: every receiving node (the one CFL server) keeps
        # each of its K neighbours' last model
        t0 = wf.init_temporal_state(K, param_count(params), cfg.paper.window,
                                    device=dev)
        n = 1 if cfg.centralized else N
        temporal = wf.TemporalState(*(x.expand((n,) + x.shape).clone() for x in t0))
    elif cfg.aggregator in ("wfagg", "alt_wfagg"):
        # the temporal ``prev`` is the previous round's (N, d) model
        # matrix, read through the neighbour table: prev[idx[n, k]] is
        # exactly edge (n, k)'s last received model
        W = cfg.paper.window
        temporal = wf.TemporalState(
            prev=torch.zeros((N, param_count(params)), device=dev),
            hist_s=torch.zeros((N, W, K), device=dev),
            hist_b=torch.zeros((N, W, K), device=dev),
            count=torch.zeros((N,), dtype=torch.int32, device=dev),
            t=torch.zeros((N,), dtype=torch.int32, device=dev),
        )
    return DFLState(params, momentum, temporal, 0)


# ---------------------------------------------------------------------------
# local training
# ---------------------------------------------------------------------------

def _local_train(cfg: DFLConfig, data: SyntheticImages, malicious: Tensor,
                 params: Dict[str, Tensor], momentum: Dict[str, Tensor],
                 rnd: int, batches=None):
    """One round of local minibatch momentum-SGD for every node at once.

    ``malicious`` is the (N,) Byzantine mask (Label-Flipping nodes flip
    their labels).  ``batches``, if given, is a sequence of
    ``batches_per_round`` pairs ``(images (N, B, 28, 28, 1), labels
    (N, B))`` used instead of the synthetic draws (the parity tests feed
    the reference's batches through it)."""
    _, fwd = MODELS[cfg.model]
    p = cfg.paper
    N = malicious.shape[0]
    dev = malicious.device

    def loss(pp, imgs, labels):
        return met.cross_entropy(fwd(pp, imgs), labels)

    grad_all = torch.func.vmap(torch.func.grad(loss))
    for b in range(cfg.batches_per_round):
        if batches is None:
            imgs, labels = data.node_batches(N, rnd, b, p.batch_size, dev)
        else:
            imgs, labels = (torch.as_tensor(x, device=dev) for x in batches[b])
        if cfg.attack == "label_flip":
            labels = torch.where(malicious[:, None],
                                 atk.flip_labels(labels, data.n_classes), labels)
        grads = grad_all(params, imgs, labels)
        momentum = {k: p.momentum * momentum[k] + grads[k] for k in params}
        params = {k: params[k] - p.lr * momentum[k] for k in params}
    return params, momentum


def _apply_attacks(cfg: DFLConfig, malicious: Tensor, flat: Tensor, rnd: int,
                   view: Optional[atk.DefenseView] = None) -> Tensor:
    """Replace the Byzantine rows of the (N, d) model matrix; ``view``
    feeds the adaptive attacks the round's filter state
    (``_defense_view``)."""
    gen = None
    if cfg.attack == "noise":
        gen = torch.Generator(device=flat.device)
        gen.manual_seed((cfg.seed + 77) * 1_000_003 + rnd)
    return atk.apply_matrix_attack(cfg.attack, flat, malicious, gen,
                                   cfg.attack_params, view=view)


def _defense_view(cfg: DFLConfig, state: "DFLState", neighbor_idx: Tensor,
                  neighbor_valid: Optional[Tensor]) -> Optional[atk.DefenseView]:
    """The adaptive adversary's ``DefenseView`` for this round (None unless
    the attack reads it; a CFL round has no gossip table).

    The WFAgg-T bands come from ``trust.temporal_bands`` on the pre-round
    temporal state, the call the round's own aggregation makes
    (``core.wfagg._wfagg_batch_indexed``), so the adversary sees bit for
    bit the bands the round kernel compares.  Bands and ``prev`` exist
    only where ``temporal.prev`` is the (N, d) previous model matrix
    (decentralized WFAgg and Alt-WFAgg: static, dynamic and chaos rounds
    all carry it, the chaos round's stacked matrix is built per round);
    other aggregators get a view without bands and the attacks fall back
    to mimicry, as in the reference."""
    if cfg.attack not in atk.ADAPTIVE_ATTACKS or cfg.centralized:
        return None
    tbands = prev = None
    t = state.temporal
    if t is not None and t.prev.ndim == 2 and cfg.aggregator in ("wfagg", "alt_wfagg"):
        wcfg = _wfagg_full_config(cfg, neighbor_idx.shape[1])
        if wcfg.use_temporal:
            tbands = trust.temporal_bands(t.hist_s, t.hist_b, t.count, t.t, wcfg)
            prev = t.prev
    return atk.DefenseView(neighbor_idx=neighbor_idx, valid=neighbor_valid,
                           prev=prev, tbands=tbands, f=cfg.paper.f)


# ---------------------------------------------------------------------------
# aggregation dispatch (one aggregation over K received models)
# ---------------------------------------------------------------------------

def _trained(cfg: DFLConfig, data: SyntheticImages, state: DFLState,
             malicious: Tensor, batches=None, neighbor_idx: Optional[Tensor] = None,
             valid: Optional[Tensor] = None):
    """A round's local training and attacks: ``(params, momentum, flat)``,
    ``flat`` the (N, d) matrix of the models the nodes send.  The round's
    table ``neighbor_idx`` and ``valid`` mask (None: all valid) give the
    adaptive attacks their view of the defense; every round passes them
    (without a table an adaptive attack sees no view)."""
    view = (None if neighbor_idx is None else
            _defense_view(cfg, state, neighbor_idx, valid))
    params, momentum = _local_train(cfg, data, malicious, state.node_params,
                                    state.node_momentum, state.rnd, batches)
    return params, momentum, _apply_attacks(cfg, malicious, ravel(params), state.rnd,
                                            view)


def _shard_group(cfg: DFLConfig):
    """The process group of a sharded gossip round (None: unsharded).  Only
    decentralized WFAgg and Alt-WFAgg shard, as in the reference; raises
    ValueError without an initialised group of ``mesh_model_shards``
    ranks."""
    if (cfg.mesh_model_shards > 1 and not cfg.centralized
            and cfg.aggregator in ("wfagg", "alt_wfagg")):
        return spmd.aggregation_group(cfg.mesh_model_shards)
    return None


def _trained_on(group, cfg: DFLConfig, data: SyntheticImages, state: DFLState,
                malicious: Tensor, batches=None, neighbor_idx: Optional[Tensor] = None,
                valid: Optional[Tensor] = None):
    """``_trained``, replicated over the ranks of a sharded round: rank 0
    trains and attacks, and one broadcast gives every rank its sent models,
    parameters and momentum bit for bit (the other ranks skip the training,
    so no nondeterministic backward kernel can make them drift)."""
    if group is None:
        return _trained(cfg, data, state, malicious, batches, neighbor_idx, valid)
    N = malicious.shape[0]
    if torch.distributed.get_rank(group) == 0:
        params, momentum, flat = _trained(cfg, data, state, malicious, batches,
                                          neighbor_idx, valid)
        buf = torch.cat([flat, ravel(params), ravel(momentum)])
    else:
        d = param_count(state.node_params)
        buf = torch.empty((3 * N, d), dtype=torch.float32, device=malicious.device)
    flat, p, m = spmd.broadcast_from_rank0(buf, group).split(N)
    contiguous = lambda t: {k: v.contiguous() for k, v in t.items()}  # noqa: E731
    return (contiguous(unravel(p, state.node_params)),
            contiguous(unravel(m, state.node_momentum)), flat)


def _gossip(group, wcfg: wf.WFAggConfig, flat: Tensor, temporal, neighbor_idx: Tensor,
            valid: Optional[Tensor], dev: torch.device):
    """The WFAgg / Alt-WFAgg gossip round over the (N, d) matrix: the
    gather-free ``wfagg_batch``, or its d-sharded form over ``group``."""
    if group is not None:
        return spmd.wfagg_batch_sharded(flat, flat, temporal, wcfg, neighbor_idx,
                                        valid, group=group, device=dev)
    return wf.wfagg_batch(flat, flat, temporal, wcfg, neighbor_idx=neighbor_idx,
                          valid=valid, device=dev)


def _wfagg_full_config(cfg: DFLConfig, K: int,
                       backend: Optional[str] = None) -> wf.WFAggConfig:
    """WFAggConfig for the full wfagg/alt_wfagg pipeline at candidate count K."""
    wcfg = cfg.wfagg_config(backend=backend)
    if cfg.aggregator == "alt_wfagg":
        wcfg = dataclasses.replace(
            wcfg, distance_filter="multi_krum", similarity_filter="clustering",
            multi_krum_m=max(1, int(cfg.paper.multi_krum_m_frac * K)))
    return wcfg


def _baseline(cfg: DFLConfig, updates: Tensor) -> Tensor:
    """A baseline rule with the paper's keyword arguments on ``updates (...,
    K, d)``: one node's K received models or a batch of slates."""
    p = cfg.paper
    name = cfg.aggregator
    K = updates.shape[-2]
    kw: Dict[str, Any] = {"f": p.f}
    if name == "trimmed_mean":
        kw = {"beta": p.trim_beta}
    if name == "multi_krum":
        kw["m"] = max(1, int(p.multi_krum_m_frac * K))
    if name == "clustering":
        kw = {}
    return agg_lib.AGGREGATORS[name](updates, **kw)[0]


def _aggregate_one(cfg: DFLConfig, local: Tensor, updates: Tensor,
                   t_state: Optional[wf.TemporalState],
                   wfagg_backend: Optional[str] = None):
    """Aggregate K received models ``updates (K, d)`` for one node (the CFL
    server), anchored at ``local (d,)``, or every node of a gossip round at
    once (``(N, K, d)`` slates, ``(N, d)`` anchors, state with a leading N
    axis; every rule but the full WFAgg).  ``wfagg_backend`` overrides the
    configured WFAgg backend.  Returns ``(new_model, new_temporal_state)``."""
    p = cfg.paper
    name = cfg.aggregator
    K = updates.shape[-2]
    if name in BASELINES:
        return _baseline(cfg, updates), t_state
    if name == "wfagg_d":     # the reference runs these two on its
        return wf.wfagg_d_agg(updates, p.f)[0], t_state    # default backend
    if name == "wfagg_c":
        return wf.wfagg_c_agg(updates, p.f)[0], t_state
    if name == "wfagg_e":
        return wf.wfagg_e_agg(local, updates, p.alpha), t_state
    if name == "wfagg_t":
        mask, new_t = wf.wfagg_t_select(t_state, updates,
                                        cfg.wfagg_config(backend=wfagg_backend))
        return wf.wfagg_e(local, updates, mask.to(torch.float32), p.alpha), new_t
    if name in ("wfagg", "alt_wfagg"):
        out, new_t, _ = wf.wfagg(local, updates, t_state,
                                 _wfagg_full_config(cfg, K, backend=wfagg_backend))
        return out, new_t
    raise ValueError(name)


def _aggregate_one_dyn(cfg: DFLConfig, local: Tensor, updates: Tensor,
                       valid: Tensor) -> Tensor:
    """A baseline over padded slates ``updates (..., K, d)`` with ``valid
    (..., K)``: the valid-masked ``DYN_AGGREGATORS`` rule with the paper's
    arguments (Multi-Krum keeps ``max(int(0.25 * v), 1)`` of each node's v
    valid candidates).  A degree-0 node keeps ``local``: there is nothing
    to aggregate."""
    p = cfg.paper
    name = cfg.aggregator
    valid = valid.to(torch.bool)
    kw: Dict[str, Any] = {"f": p.f}
    if name == "trimmed_mean":
        kw = {"beta": p.trim_beta}
    if name == "clustering":
        kw = {}
    if name == "multi_krum":
        kw["m"] = torch.clamp(agg_lib.fraction_count(p.multi_krum_m_frac, valid.sum(-1)),
                              min=1)
    out, _ = agg_lib.DYN_AGGREGATORS[name](updates, valid, **kw)
    return torch.where(valid.any(-1)[..., None], out, local)


def _masked_form_required(cfg: DFLConfig, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"aggregator {cfg.aggregator!r} has no valid-mask-aware form; {where} "
        "run through the wfagg/alt_wfagg gather-free path or the "
        f"DYN_AGGREGATORS baselines {BASELINES}, as in the reference")


# ---------------------------------------------------------------------------
# the round function
# ---------------------------------------------------------------------------

def build_round_fn(cfg: DFLConfig, topo: Topology, data: SyntheticImages,
                   dynamic: bool = False, telemetry: bool = False,
                   faults: Optional[flt.FaultConfig] = None,
                   device=None) -> Callable:
    """One DFL round on ``device``.

    ``dynamic=False``: ``round_fn(state, batches=None) -> state`` over the
    static topology (``(state, record)`` with ``telemetry``, the per-edge
    ``obs.decision.DecisionRecord``; a CFL round has no edges and takes
    no ``telemetry``).

    ``dynamic=True``: ``round_fn(state, neighbor_idx, valid, mal_mask,
    batches=None)`` takes the round's (N, K) table, (N, K) valid mask and
    (N,) Byzantine mask as tensors on ``device``.  WFAgg / Alt-WFAgg take
    the gather-free route with the round's valid mask; the baselines run
    their valid-masked form, and keep a degree-0 node's own model.  The
    standalone WFAgg filters raise (no valid-masked form, as in the
    reference).  The WFAgg-T ring buffers are keyed by
    slot: a caller driving rounds by hand on a changing slate re-keys them
    first (``wf.realign_temporal_history``), as ``run_dynamic_experiment``
    does.

    ``faults`` (a ``dfl.faults.FaultConfig``, with ``dynamic=True``) gives
    the chaos round: ``round_fn(state, neighbor_idx, valid, mal_mask, ts,
    fr, batches=None, bank=None) -> (state, ts[, record])`` also takes the
    carried ``TransportState`` and the round's ``FaultRound`` (``bank``
    replaces the drawn corrupt bank, for the parity tests).
    """
    if cfg.centralized and telemetry:
        raise NotImplementedError(_CFL_TELEMETRY)
    if faults is not None and not dynamic:
        raise NotImplementedError(
            "fault injection rides the dynamic round form (per-round "
            "inputs); pass dynamic=True")
    _check_supported(cfg)
    if dynamic:
        _check_dynamic(cfg)
        dev = resolve_device(device)
        if faults is not None:
            return _make_chaos_round(cfg, data, telemetry, faults, dev)
        return _make_dynamic_round(cfg, data, telemetry, dev)
    if (not cfg.centralized and not topo.is_regular
            and cfg.aggregator not in DYNAMIC_AGGREGATORS):
        raise _masked_form_required(cfg, "irregular (padded) topologies")
    dev = resolve_device(device)
    table = np.asarray(topo.neighbor_indices)
    if table.size and (table.min() < 0 or table.max() >= topo.n_nodes):
        raise ValueError("neighbor table holds indices outside [0, n_nodes)")
    neighbor_idx = torch.as_tensor(table, dtype=torch.int64, device=dev)
    # None on regular graphs (every slot valid)
    neighbor_valid = (None if topo.is_regular else
                      torch.as_tensor(np.asarray(topo.neighbor_valid), device=dev))
    malicious = torch.as_tensor(np.asarray(topo.malicious), device=dev)
    wcfg = _wfagg_full_config(cfg, neighbor_idx.shape[1])
    group = _shard_group(cfg)

    def round_fn(state: DFLState, batches=None):
        # CFL: the server's WFAgg-E anchor is node 0's model from BEFORE
        # local training (the previous round's global model; node 0's own
        # initial weights in round 1), as the reference takes it
        anchor = (ravel({k: v[:1] for k, v in state.node_params.items()})[0]
                  if cfg.centralized else None)
        params, momentum, flat = _trained_on(group, cfg, data, state, malicious,
                                             batches, neighbor_idx, neighbor_valid)
        record = None
        if cfg.centralized:
            # one server-side aggregation over all N received models
            t0 = (wf.TemporalState(*(x[0] for x in state.temporal))
                  if state.temporal is not None else None)
            new_global, new_t0 = _aggregate_one(cfg, anchor, flat, t0)
            new_flat = new_global.expand(flat.shape)
            new_temporal = (wf.TemporalState(*(x[None] for x in new_t0))
                            if new_t0 is not None else None)
        elif cfg.aggregator in ("wfagg", "alt_wfagg"):
            new_flat, new_temporal, info = _gossip(group, wcfg, flat, state.temporal,
                                                   neighbor_idx, neighbor_valid, dev)
            if telemetry:
                record = obs_decision.record_from_info(info)
        else:   # plain PyTorch on the gathered (N, K, d) slates, no kernel
            gathered = flat[neighbor_idx]
            if state.temporal is not None:     # the standalone WFAgg-T
                new_flat, new_temporal = _aggregate_one(
                    cfg, flat, gathered, state.temporal, wfagg_backend="reference")
            elif neighbor_valid is not None:   # a baseline on padded slates
                new_flat = _aggregate_one_dyn(cfg, flat, gathered, neighbor_valid)
                new_temporal = None
            else:
                new_flat, new_temporal = _aggregate_one(cfg, flat, gathered, None)
            if telemetry:
                record = obs_decision.record_uniform(
                    neighbor_valid if neighbor_valid is not None
                    else torch.ones(neighbor_idx.shape, dtype=torch.bool, device=dev))
        new_params = {k: v.contiguous() for k, v in unravel(new_flat, params).items()}
        new_state = DFLState(new_params, momentum, new_temporal, state.rnd + 1)
        return (new_state, record) if telemetry else new_state

    return round_fn


def _check_dynamic(cfg: DFLConfig) -> None:
    if cfg.centralized:
        raise NotImplementedError("dynamic schedules and chaos transport are a "
                                  "gossip (decentralized) feature; CFL has no "
                                  "slates")
    if cfg.aggregator not in DYNAMIC_AGGREGATORS:
        raise _masked_form_required(cfg, "dynamic schedules and chaos transport")


def _make_dynamic_round(cfg: DFLConfig, data: SyntheticImages, telemetry: bool,
                        dev: torch.device) -> Callable:
    group = _shard_group(cfg)

    def round_fn(state: DFLState, neighbor_idx: Tensor, valid: Tensor,
                 mal_mask: Tensor, batches=None):
        params, momentum, flat = _trained_on(group, cfg, data, state, mal_mask, batches,
                                             neighbor_idx, valid)
        if cfg.aggregator in ("wfagg", "alt_wfagg"):
            wcfg = _wfagg_full_config(cfg, neighbor_idx.shape[1])
            new_flat, new_temporal, info = _gossip(group, wcfg, flat, state.temporal,
                                                   neighbor_idx, valid, dev)
            record = obs_decision.record_from_info(info) if telemetry else None
        else:   # a baseline, on the gathered padded slates
            new_flat = _aggregate_one_dyn(cfg, flat, flat[neighbor_idx.long()], valid)
            new_temporal = None
            record = obs_decision.record_uniform(valid) if telemetry else None
        new_params = {k: v.contiguous() for k, v in unravel(new_flat, params).items()}
        new_state = DFLState(new_params, momentum, new_temporal, state.rnd + 1)
        return (new_state, record) if telemetry else new_state

    return round_fn


def _newest(hist: Tensor, row: Tensor) -> Tensor:
    """``hist (N, W, K)`` with its most recent entry (index 0) replaced."""
    return torch.cat([row[:, None], hist[:, 1:]], dim=1)


class ChaosInputs(NamedTuple):
    """The chaos round up to its aggregation (``chaos_inputs``)."""
    params: Dict[str, Tensor]      # after local training
    momentum: Dict[str, Tensor]    # a down node's kept at last round's
    flat: Tensor                   # (N, d) the models sent; a down node's frozen
    prev_flat: Tensor              # (N, d) the models going into the round
    down: Tensor                   # (N,) bool, the crashed nodes
    tout: flt.TransportOut         # the re-keyed delivery over the stacked matrix


def chaos_inputs(cfg: DFLConfig, data: SyntheticImages, fcfg: flt.FaultConfig,
                 state: DFLState, neighbor_idx: Tensor, valid: Tensor,
                 mal_mask: Tensor, ts: flt.TransportState, fr: flt.FaultRound,
                 batches=None, bank=None) -> ChaosInputs:
    """The chaos round's steps before it aggregates: local training and
    attacks, the crash freeze, and ``faults.apply_transport``.  The chaos
    round runs it; a replay that explains a round's decisions reads the
    aggregation's inputs from it."""
    prev_flat = ravel(state.node_params)
    params, momentum, flat = _trained(cfg, data, state, mal_mask, batches,
                                      neighbor_idx, valid)
    # crash freeze: a down node broadcasts (and keeps) its stored model;
    # its training step and momentum advance are discarded
    down = fr.down.to(torch.bool)
    flat = torch.where(down[:, None], prev_flat, flat)
    momentum = {k: torch.where(down.reshape((-1,) + (1,) * (v.ndim - 1)),
                               state.node_momentum[k], v)
                for k, v in momentum.items()}
    tout = flt.apply_transport(flat, ts, neighbor_idx, valid, fr, fcfg, state.rnd,
                               bank=bank)
    return ChaosInputs(params, momentum, flat, prev_flat, down, tout)


def _make_chaos_round(cfg: DFLConfig, data: SyntheticImages, telemetry: bool,
                      fcfg: flt.FaultConfig, dev: torch.device) -> Callable:
    """The fault-injected round (port of ``_make_chaos_round_core``).

    Differences from the dynamic round, in execution order:
      * crash freeze: a down node neither trains nor transmits; its model
        row and momentum stay at last round's values, and its own slate is
        all-invalid (it keeps its local model);
      * transport: ``faults.apply_transport`` re-keys the table over the
        sanitized stacked ring matrix (fresh / stale / corrupt-bank rows),
        giving the effective table, the surviving valid mask and the
        WFAgg-T ``prev_idx`` re-keying;
      * history hygiene: an edge with no accepted delivery this round
        records the pre-round EWMA mean instead of a metric against a
        payload it never saw.
    """
    if cfg.mesh_model_shards > 1:
        raise NotImplementedError(
            "chaos transport + model-dim sharding: the stacked ring "
            "matrix is not sharded yet (see docs/FAULTS.md)")
    def round_fn(state: DFLState, neighbor_idx: Tensor, valid: Tensor,
                 mal_mask: Tensor, ts: flt.TransportState, fr: flt.FaultRound,
                 batches=None, bank=None):
        params, momentum, flat, prev_flat, down, tout = chaos_inputs(
            cfg, data, fcfg, state, neighbor_idx, valid, mal_mask, ts, fr, batches, bank)
        if cfg.aggregator in ("wfagg", "alt_wfagg"):
            wcfg = _wfagg_full_config(cfg, neighbor_idx.shape[1])
            t_in = state.temporal
            mu_s = mu_b = None
            if wcfg.use_temporal:
                # pre-round EWMA centres: what a no-delivery edge pushes
                # instead of a metric against a payload it never saw
                mu_s, _ = trust.ewma_mean_std(t_in.hist_s, t_in.count, wcfg.ewma_decay)
                mu_b, _ = trust.ewma_mean_std(t_in.hist_b, t_in.count, wcfg.ewma_decay)
            # the carried (N, d) prev is superseded by the stacked matrix +
            # prev_idx (the payload each edge actually served last round)
            t_in = t_in._replace(prev=tout.full)
            new_flat, new_temporal, info = wf.wfagg_batch(
                flat, tout.full, t_in, wcfg, neighbor_idx=tout.eff_idx,
                valid=tout.eff_valid, prev_idx=tout.prev_idx, device=dev)
            hist_s, hist_b = new_temporal.hist_s, new_temporal.hist_b
            if mu_s is not None:
                hist_s = _newest(hist_s, torch.where(tout.eff_valid, hist_s[:, 0], mu_s))
                hist_b = _newest(hist_b, torch.where(tout.eff_valid, hist_b[:, 0], mu_b))
            new_temporal = new_temporal._replace(prev=flat, hist_s=hist_s,
                                                 hist_b=hist_b)
            record = obs_decision.record_from_info(info) if telemetry else None
        else:   # a baseline, on the gathered post-fault slates
            new_flat = _aggregate_one_dyn(cfg, flat, tout.full[tout.eff_idx],
                                          tout.eff_valid)
            new_temporal = None
            record = obs_decision.record_uniform(tout.eff_valid) if telemetry else None
        # a down receiver aggregates nothing (its slate is all-invalid, so
        # this already holds on the WFAgg path; make it explicit)
        new_flat = torch.where(down[:, None], prev_flat, new_flat)
        new_params = {k: v.contiguous() for k, v in unravel(new_flat, params).items()}
        new_ts = flt.advance_ring(ts, flat, tout.served_lag)
        new_state = DFLState(new_params, momentum, new_temporal, state.rnd + 1)
        if telemetry:
            record = obs_decision.with_fault_bits(record, tout.dropped, tout.stale,
                                                  tout.corrupt)
            return new_state, new_ts, record
        return new_state, new_ts

    return round_fn


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def evaluate(cfg: DFLConfig, topo: Topology, data: SyntheticImages,
             state: DFLState, n_test: int = 512,
             malicious: Optional[np.ndarray] = None,
             adjacency: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """Per-node accuracy + consistency snapshot on the held-out set.

    ``malicious``/``adjacency`` override the static topology's: dynamic
    runs pass the schedule's ever-malicious set and the evaluation
    round's graph."""
    _, fwd = MODELS[cfg.model]
    dev = next(iter(state.node_params.values())).device
    imgs, labels = data.test_set(n_test, dev)
    with torch.no_grad():
        logits = torch.func.vmap(fwd, in_dims=(0, None))(state.node_params, imgs)
        accs = met.micro_accuracy(logits, labels[None]).cpu().numpy()
        flat = ravel(state.node_params)
        mal = np.asarray(topo.malicious if malicious is None else malicious)
        benign = ~mal
        r2 = float(met.r_squared(flat[torch.as_tensor(benign, device=dev)]))
    adj = np.asarray(topo.adjacency if adjacency is None else adjacency)
    mal_nb = (adj & mal[None, :]).sum(axis=1)
    by_mn = {}
    for m in range(max(2, int(mal_nb.max(initial=0))) + 1):
        sel = benign & (mal_nb == m)
        by_mn[m] = float(accs[sel].mean()) if sel.any() else float("nan")
    return {
        "acc_benign_mean": float(accs[benign].mean()),
        "acc_by_malicious_neighbors": by_mn,
        "r_squared": r2,
        "acc_all": accs.tolist(),
    }


def _series_from_trace(trace) -> Dict[str, list]:
    """Columnar per-round series from a trace of ``evaluate`` dicts."""
    return {
        "round": [e["round"] for e in trace],
        "acc_benign_mean": [e["acc_benign_mean"] for e in trace],
        "r_squared": [e["r_squared"] for e in trace],
    }


def _telemetry_out(record, neighbor_idx, valid, malicious) -> Dict[str, Any]:
    """Host-side telemetry bundle (numpy only): the stacked (R, …)
    ``DecisionRecord`` fields plus the slate context (``(R, N, K)``
    tables, ``(R, N)`` Byzantine masks) a report needs to split attacker
    from benign edges."""
    return {
        "verdict": record.verdict.cpu().numpy(),
        "accepted": record.accepted.cpu().numpy(),
        "mean_fallback": record.mean_fallback.cpu().numpy(),
        "degree_zero": record.degree_zero.cpu().numpy(),
        "entropy": record.entropy.cpu().numpy(),
        "neighbor_idx": np.asarray(neighbor_idx),
        "valid": np.asarray(valid),
        "malicious": np.asarray(malicious),
    }


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_experiment(cfg: DFLConfig, topo: Topology, data: SyntheticImages,
                   rounds: Optional[int] = None, eval_every: int = 1,
                   telemetry: bool = False, device=None) -> Dict[str, Any]:
    """Run a DFL experiment on ``device``; returns the per-round metric
    trace and the columnar ``series``: accuracy, consistency and
    ``round_seconds`` (the wall time of each round from a synchronised
    start to a synchronised end), and for gossip runs the per-round
    mean-fallback / degree-0 node counts (a CFL run has no edges, so it
    tracks neither, as in the reference).

    ``telemetry=True`` also returns the per-round, per-edge decision
    record under ``out["telemetry"]`` (numpy, ``_telemetry_out``): the
    stacked (R, N, K) verdicts and (R, N) summaries, with the static
    topology's table, valid mask and Byzantine mask broadcast to (R, …)
    so one report path serves this and ``run_dynamic_experiment``.  A CFL
    run has no edges and refuses it, as the reference does."""
    if telemetry and cfg.centralized:
        raise NotImplementedError(_CFL_TELEMETRY)
    dev = resolve_device(device)
    rounds = rounds or cfg.paper.rounds
    track = not cfg.centralized
    state = init_dfl_state(cfg, topo, device=dev)
    round_fn = build_round_fn(cfg, topo, data, telemetry=track, device=dev)
    trace, records = [], []
    fallback_counts, degree_zero_counts, round_seconds = [], [], []
    mf = None
    for r in range(rounds):
        _sync(dev)
        t0 = time.perf_counter()
        if track:
            state, rec = round_fn(state)
        else:
            state = round_fn(state)
        _sync(dev)
        round_seconds.append(time.perf_counter() - t0)
        if track:
            mf = rec.mean_fallback.cpu().numpy()
            fallback_counts.append(int(mf.sum()))
            degree_zero_counts.append(int(rec.degree_zero.sum()))
            if telemetry:
                records.append(rec)
        if (r + 1) % eval_every == 0 or r == rounds - 1:
            e = evaluate(cfg, topo, data, state)
            e["round"] = r + 1
            if mf is not None:
                e["mean_fallback_nodes"] = np.flatnonzero(mf).tolist()
            trace.append(e)
    series = _series_from_trace(trace)
    series["round_seconds"] = round_seconds
    if track:
        series["mean_fallback_count"] = fallback_counts
        series["degree_zero_count"] = degree_zero_counts
    out = {"trace": trace, "final": trace[-1], "series": series,
           "aggregator": cfg.aggregator, "attack": cfg.attack,
           "centralized": cfg.centralized, "device": str(dev)}
    if telemetry:
        record = obs_decision.DecisionRecord(*(torch.stack(x) for x in zip(*records)))
        table = np.asarray(topo.neighbor_indices)
        nv = (np.ones(table.shape, bool) if topo.is_regular
              else np.asarray(topo.neighbor_valid, bool))
        lead = (len(records),)
        out["telemetry"] = _telemetry_out(
            record, np.broadcast_to(table, lead + table.shape),
            np.broadcast_to(nv, lead + nv.shape),
            np.broadcast_to(np.asarray(topo.malicious), lead + (topo.n_nodes,)))
    return out


# ---------------------------------------------------------------------------
# dynamic-topology experiments (round-varying schedules)
# ---------------------------------------------------------------------------

def realign_to_slate(state: DFLState, ts: Optional[flt.TransportState],
                     prev_idx: Tensor, prev_valid: Tensor, idx: Tensor,
                     valid: Tensor):
    """Re-key the slot-keyed carry from the slate ``(prev_idx, prev_valid)``
    to the round's ``(idx, valid)`` by neighbour identity: the WFAgg-T
    history and, with chaos transport (``ts``), the served-lag table.
    Returns ``(state, ts)``."""
    if state.temporal is not None:
        state = state._replace(temporal=wf.realign_temporal_history(
            state.temporal, prev_idx, prev_valid, idx, valid))
    if ts is not None:
        ts = ts._replace(served_lag=flt.realign_served_lag(
            ts.served_lag, prev_idx, prev_valid, idx, valid))
    return state, ts


def _check_schedule(schedule: TopologySchedule) -> None:
    """Validate the schedule's tables once, on the host, before the loop
    (inside it the kernels' table checks run on the device)."""
    t = np.asarray(schedule.neighbor_idx)
    if t.size and (t.min() < 0 or t.max() >= schedule.n_nodes):
        raise ValueError("schedule neighbor_idx holds indices outside "
                         f"[0, {schedule.n_nodes})")


def build_dynamic_scan_fn(cfg: DFLConfig, topo: Topology, data: SyntheticImages,
                          schedule: TopologySchedule, n_test: int = 256,
                          telemetry: bool = False,
                          faults: Optional[flt.FaultSchedule] = None,
                          device=None):
    """The round loop behind ``run_dynamic_experiment`` (port of the
    reference's one-jit scan).

    Returns ``(state, run, sched)``: the initial state, ``run(state,
    neighbor_idx, valid, malicious) -> (state, out)``, and the schedule's
    ``(R, N, K)`` / ``(R, N)`` stacks as tensors on ``device``, uploaded
    here once.  ``run`` loops over the rounds of the stacks it is given;
    before each round it re-keys the WFAgg-T history (and, with faults,
    the served-lag table) to the round's slate by neighbour identity, and
    after it evaluates every node on ``n_test`` held-out images with the
    schedule's ever-malicious nodes out of the benign cohort.  ``out``
    holds ``acc_all (R, N)``, ``acc_benign (R,)``, ``r2 (R,)`` as tensors,
    ``record`` (the stacked ``DecisionRecord`` with ``telemetry``, else
    None) and ``round_seconds`` (each round's wall time, realign included
    and evaluation not, between synchronised ends).  Nothing inside a
    round reads the card back to the host.

    ``faults`` (a ``dfl.faults.FaultSchedule``) gives the chaos form: the
    first return value is the full loop CARRY ``(state, prev_idx,
    prev_val, TransportState)``, ``run(carry, neighbor_idx, valid,
    malicious, drop, lag, dup, corrupt, down)`` takes and returns it (so a
    checkpointed run can stop and resume mid-schedule), and ``sched`` has
    the five fault stacks too.
    """
    if schedule.n_nodes != topo.n_nodes:
        raise ValueError(
            f"schedule is for {schedule.n_nodes} nodes, topology has "
            f"{topo.n_nodes}")
    if faults is not None and faults.rounds != schedule.rounds:
        raise ValueError(
            f"fault schedule has {faults.rounds} rounds, topology "
            f"schedule has {schedule.rounds}")
    _check_schedule(schedule)
    dev = resolve_device(device)
    state = init_dfl_state(cfg, topo, degree=schedule.width, device=dev)
    round_fn = build_round_fn(cfg, topo, data, dynamic=True, telemetry=telemetry,
                              faults=faults.config if faults else None, device=dev)
    _, fwd = MODELS[cfg.model]
    imgs, labels = data.test_set(n_test, dev)
    sched = tuple(torch.as_tensor(np.asarray(a), device=dev) for a in (
        schedule.neighbor_idx, schedule.valid, schedule.malicious))
    if faults is not None:
        sched = sched + faults.xs(dev)
    # the evaluation cohort: a node malicious in ANY round is an attacker
    bw = torch.as_tensor(~schedule.malicious.any(axis=0), device=dev).to(torch.float32)

    def eval_out(st: DFLState):
        with torch.no_grad():
            logits = torch.func.vmap(fwd, in_dims=(0, None))(st.node_params, imgs)
            accs = met.micro_accuracy(logits, labels[None])
            acc_benign = (accs * bw).sum() / torch.clamp(bw.sum(), min=1.0)
            return accs, acc_benign, met.r_squared(ravel(st.node_params), weights=bw)

    def loop(carry, xs):
        st, prev_idx, prev_val, ts = carry
        evals, records, seconds = [], [], []
        for r in range(xs[0].shape[0]):
            idx, val, mal = (x[r] for x in xs[:3])
            _sync(dev)
            t0 = time.perf_counter()
            st, ts = realign_to_slate(st, ts, prev_idx, prev_val, idx, val)
            if ts is None:
                res = round_fn(st, idx, val, mal)
                st, record = res if telemetry else (res, None)
            else:
                res = round_fn(st, idx, val, mal, ts,
                               flt.FaultRound(*(x[r] for x in xs[3:])))
                st, ts, record = res if telemetry else (*res, None)
            _sync(dev)
            seconds.append(time.perf_counter() - t0)
            evals.append(eval_out(st))
            records.append(record)
            prev_idx, prev_val = idx, val
        acc_all, acc_benign, r2 = (torch.stack(x) for x in zip(*evals))
        out = {"acc_all": acc_all, "acc_benign": acc_benign, "r2": r2,
               "round_seconds": seconds,
               "record": (obs_decision.DecisionRecord(
                   *(torch.stack(x) for x in zip(*records))) if telemetry else None)}
        return (st, prev_idx, prev_val, ts), out

    if faults is not None:
        ts0 = flt.init_transport_state(faults.config, topo.n_nodes, schedule.width,
                                       ravel(state.node_params).shape[1], device=dev)
        return ((state, sched[0][0], sched[1][0], ts0),
                lambda carry, *xs: loop(carry, xs), sched)

    def run(state, neighbor_idx, valid, malicious):
        # the round-0 "previous" slate is round 0's own (identity match)
        carry, out = loop((state, neighbor_idx[0], valid[0], None),
                          (neighbor_idx, valid, malicious))
        return carry[0], out

    return state, run, sched


def run_dynamic_experiment(cfg: DFLConfig, topo: Topology, data: SyntheticImages,
                           schedule: TopologySchedule, n_test: int = 256,
                           telemetry: bool = False,
                           faults: Optional[flt.FaultSchedule] = None,
                           stop_after: Optional[int] = None,
                           checkpoint_dir: Optional[str] = None,
                           checkpoint_name: str = "chaos",
                           resume_from: Optional[str] = None,
                           device=None) -> Dict[str, Any]:
    """Run a DFL experiment under a round-varying topology schedule on
    ``device``; returns ``run_experiment``'s shape (trace / final /
    series, with ``series["round_seconds"]`` and
    ``series["degree_min_mean_max"]``).

    ``telemetry=True`` adds the per-round (N, K) verdict bitmasks and
    per-node summaries under ``out["telemetry"]`` (numpy), and the
    mean-fallback / degree-0 / accepted-count series.  Model trajectories
    are the same with telemetry on or off.

    Chaos transport (``faults``, a ``dfl.faults.FaultSchedule``): the loop
    also carries the delivery ring.  Fault runs can be checkpointed:
    ``stop_after=r`` runs only rounds [0, r) and, with ``checkpoint_dir``,
    snapshots the full carry (models, momentum, WFAgg-T ring buffers,
    transport ring and served-lag table, the previous slate, the round
    counter — every random stream is seeded from that counter) plus the
    in-flight schedules (``train.checkpoint``).  ``resume_from=dir``
    restores the snapshot and runs the remaining rounds, reproducing the
    uninterrupted trajectory bit-exactly.  ``out["rounds_run"]`` records
    the [start, end) window a partial run covered.
    """
    if (stop_after is not None or resume_from is not None
            or checkpoint_dir is not None) and faults is None:
        raise NotImplementedError(
            "checkpoint/resume rides the chaos scan form (the run "
            "function must return its carry); pass faults="
            "make_fault_schedule('none', schedule, 0.0) for a "
            "fault-free checkpointable run")
    dev = resolve_device(device)
    state, run, sched = build_dynamic_scan_fn(cfg, topo, data, schedule,
                                              n_test=n_test, telemetry=telemetry,
                                              faults=faults, device=dev)
    ever_mal = schedule.malicious.any(axis=0)
    R = schedule.rounds
    r0, r_end = 0, R
    if faults is None:
        state, res = run(state, *sched)
    else:
        carry = state
        if resume_from is not None:
            # the snapshot carries the schedules too: the resumed loop
            # replays the in-flight fault surface, not a reconstruction
            carry, sched, meta = ckpt.restore_experiment_checkpoint(
                resume_from, checkpoint_name, carry, sched)
            r0 = int(meta["round"])
        r_end = R if stop_after is None else int(stop_after)
        if not r0 < r_end <= R:
            raise ValueError(
                f"round window [{r0}, {r_end}) is empty or exceeds the "
                f"{R}-round schedule")
        carry, res = run(carry, *(a[r0:r_end] for a in sched))
        state = carry[0]
        if checkpoint_dir is not None:
            ckpt.save_experiment_checkpoint(
                checkpoint_dir, checkpoint_name, carry, sched,
                metadata={"round": r_end, "rounds_total": R,
                          "fault_config": dataclasses.asdict(faults.config),
                          "fault_summary": faults.summary()})
    acc_all = res["acc_all"].cpu().numpy()
    acc_benign = res["acc_benign"].cpu().numpy()
    r2 = res["r2"].cpu().numpy()
    trace = [{
        "round": r0 + i + 1,
        "acc_benign_mean": float(acc_benign[i]),
        "r_squared": float(r2[i]),
        "acc_all": acc_all[i].tolist(),
    } for i in range(r_end - r0)]
    # full evaluation (with the malicious-neighbour buckets) under the
    # final round's graph and the ever-malicious cohort
    final = evaluate(cfg, topo, data, state, n_test=n_test, malicious=ever_mal,
                     adjacency=schedule.adjacency[r_end - 1])
    final["round"] = r_end
    series = _series_from_trace(trace)
    series["degree_min_mean_max"] = schedule.degree_stats()[r0:r_end].tolist()
    series["round_seconds"] = res["round_seconds"]
    out = {"trace": trace, "final": final, "series": series,
           "aggregator": cfg.aggregator, "attack": cfg.attack,
           "centralized": cfg.centralized, "device": str(dev)}
    if faults is not None:
        out["faults"] = faults.summary()
        out["rounds_run"] = [r0, r_end]
    record = res["record"]
    if record is not None:
        series["mean_fallback_count"] = (
            record.mean_fallback.sum(1).cpu().numpy().astype(int).tolist())
        series["degree_zero_count"] = (
            record.degree_zero.sum(1).cpu().numpy().astype(int).tolist())
        series["accepted_mean"] = [
            float(x) for x in record.accepted.cpu().numpy().mean(axis=1)]
        out["telemetry"] = _telemetry_out(
            record, schedule.neighbor_idx[r0:r_end], schedule.valid[r0:r_end],
            schedule.malicious[r0:r_end])
    return out
