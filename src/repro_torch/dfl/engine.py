"""Mode-A DFL round engine: the paper's experiment (port of
``repro.dfl.engine``, static rounds).

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
       a baseline rule of ``core.aggregators.AGGREGATORS`` on the gathered
       (N, K, d) slates (plain PyTorch; on irregular graphs only the mean);
     - the centralized baseline (CFL, ``DFLConfig(centralized=True)``):
       one server aggregates all N received models with WFAgg or
       Alt-WFAgg (``core.wfagg.wfagg``: the statistics, Gram and combine
       kernels on the card) or a baseline rule of
       ``core.aggregators.AGGREGATORS``, and every node starts the next
       round from the new global model.

Entry points take ``device=None``, which means the card; without one
they raise.  Not ported yet, and raising: dynamic schedules and chaos
transport (ROADMAP queue 1, items 6 and 8), telemetry export (item 9),
the baselines other than mean on irregular graphs (``DYN_AGGREGATORS``)
and the standalone WFAgg filters (item 10), model-dimension sharding
(item 11).
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
from repro_torch.core import wfagg as wf
from repro_torch.core.topology import Topology
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.kernels.common import resolve_device
from repro_torch.models.lenet import MODELS, param_count, ravel, unravel
from repro_torch.obs import decision as obs_decision

Tensor = torch.Tensor
BASELINES = ("mean", "median", "trimmed_mean", "krum", "multi_krum", "clustering")
AGGREGATORS = BASELINES + ("wfagg", "alt_wfagg")   # DFL and CFL rounds


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
    mesh_model_shards: int = 0    # > 1 not ported yet

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


def _check_supported(cfg: DFLConfig) -> None:
    if cfg.mesh_model_shards > 1:
        raise NotImplementedError(
            "model-dimension sharding is not ported yet: ROADMAP queue 1, "
            "item 11")
    if cfg.aggregator not in AGGREGATORS:
        raise NotImplementedError(
            f"aggregator {cfg.aggregator!r} is not ported yet (ported: "
            f"{AGGREGATORS}): ROADMAP queue 1, item 10")
    if cfg.model not in MODELS:
        raise ValueError(f"unknown model {cfg.model!r}")


def init_dfl_state(cfg: DFLConfig, topo: Topology,
                   degree: Optional[int] = None, device=None) -> DFLState:
    """Fresh per-node models (drawn on the CPU from ``cfg.seed``, so every
    device starts from the same weights) and WFAgg-T state on ``device``.
    ``degree`` overrides the neighbour-table width K.  CFL keeps the one
    server's state with a leading axis of 1, over K = N candidates, with a
    per-edge ``prev (1, N, d)``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    init_fn, _ = MODELS[cfg.model]
    N = topo.n_nodes
    params = {k: v.to(dev) for k, v in
              init_fn(N, torch.Generator().manual_seed(cfg.seed)).items()}
    momentum = {k: torch.zeros_like(v) for k, v in params.items()}
    K = degree if degree is not None else (N if cfg.centralized else topo.degree)
    temporal = None
    if cfg.centralized:
        if cfg.aggregator in ("wfagg", "alt_wfagg"):
            t0 = wf.init_temporal_state(K, param_count(params), cfg.paper.window,
                                        device=dev)
            temporal = wf.TemporalState(*(x[None] for x in t0))
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


def _apply_attacks(cfg: DFLConfig, malicious: Tensor, flat: Tensor, rnd: int) -> Tensor:
    """Replace the Byzantine rows of the (N, d) model matrix."""
    gen = None
    if cfg.attack == "noise":
        gen = torch.Generator(device=flat.device)
        gen.manual_seed((cfg.seed + 77) * 1_000_003 + rnd)
    return atk.apply_matrix_attack(cfg.attack, flat, malicious, gen,
                                   cfg.attack_params)


# ---------------------------------------------------------------------------
# aggregation dispatch (one aggregation over K received models)
# ---------------------------------------------------------------------------

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
                   t_state: Optional[wf.TemporalState]):
    """Aggregate K received models ``updates (K, d)`` for one node (the CFL
    server), anchored at ``local (d,)``.  Returns ``(new_model (d,),
    new_temporal_state)``."""
    name = cfg.aggregator
    K = updates.shape[0]
    if name in BASELINES:
        return _baseline(cfg, updates), t_state
    if name in ("wfagg", "alt_wfagg"):
        out, new_t, _ = wf.wfagg(local, updates, t_state, _wfagg_full_config(cfg, K))
        return out, new_t
    raise ValueError(name)


# ---------------------------------------------------------------------------
# the round function
# ---------------------------------------------------------------------------

def build_round_fn(cfg: DFLConfig, topo: Topology, data: SyntheticImages,
                   dynamic: bool = False, telemetry: bool = False,
                   faults=None, device=None) -> Callable:
    """One DFL round on ``device`` over the static topology:
    ``round_fn(state, batches=None) -> state`` (``(state, record)`` with
    ``telemetry``, the per-edge ``obs.decision.DecisionRecord``; a CFL
    round has no edges and takes no ``telemetry``)."""
    if cfg.centralized and telemetry:
        raise NotImplementedError(
            "telemetry records per-edge gossip verdicts; the CFL baseline has "
            "one server and no edges (the reference raises too; ROADMAP queue "
            "1, item 9)")
    if dynamic:
        raise NotImplementedError(
            "dynamic schedules are not ported yet: ROADMAP queue 1, item 6")
    if faults is not None:
        raise NotImplementedError(
            "fault injection is not ported yet: ROADMAP queue 1, item 8")
    _check_supported(cfg)
    if (not cfg.centralized and not topo.is_regular
            and cfg.aggregator in BASELINES and cfg.aggregator != "mean"):
        raise NotImplementedError(
            f"decentralized {cfg.aggregator!r} on an irregular graph needs the "
            "valid-masked DYN_AGGREGATORS, not ported yet: ROADMAP queue 1, "
            "item 10")
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

    def round_fn(state: DFLState, batches=None):
        # CFL: the server's WFAgg-E anchor is node 0's model from BEFORE
        # local training (the previous round's global model; node 0's own
        # initial weights in round 1), as the reference takes it
        anchor = (ravel({k: v[:1] for k, v in state.node_params.items()})[0]
                  if cfg.centralized else None)
        params, momentum = _local_train(cfg, data, malicious, state.node_params,
                                        state.node_momentum, state.rnd, batches)
        flat = ravel(params)
        flat = _apply_attacks(cfg, malicious, flat, state.rnd)
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
            new_flat, new_temporal, info = wf.wfagg_batch(
                flat, flat, state.temporal, wcfg, neighbor_idx=neighbor_idx,
                valid=neighbor_valid, device=dev)
            if telemetry:
                record = obs_decision.record_from_info(info)
        else:   # a baseline: plain gathered PyTorch, no kernel
            gathered = flat[neighbor_idx]                 # (N, K, d)
            if neighbor_valid is None:
                new_flat = _baseline(cfg, gathered)
            else:   # the mean (the others raised above)
                mean, _ = agg_lib.mean_agg_dyn(gathered, neighbor_valid)
                has_nbr = neighbor_valid.any(-1, keepdim=True)
                new_flat = torch.where(has_nbr, mean, flat)  # degree 0: local
            new_temporal = None
            if telemetry:
                record = obs_decision.record_uniform(
                    neighbor_valid if neighbor_valid is not None
                    else torch.ones(neighbor_idx.shape, dtype=torch.bool, device=dev))
        new_params = {k: v.contiguous() for k, v in unravel(new_flat, params).items()}
        new_state = DFLState(new_params, momentum, new_temporal, state.rnd + 1)
        return (new_state, record) if telemetry else new_state

    return round_fn


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def evaluate(cfg: DFLConfig, topo: Topology, data: SyntheticImages,
             state: DFLState, n_test: int = 512) -> Dict[str, Any]:
    """Per-node accuracy + consistency snapshot on the held-out set."""
    _, fwd = MODELS[cfg.model]
    dev = next(iter(state.node_params.values())).device
    imgs, labels = data.test_set(n_test, dev)
    with torch.no_grad():
        logits = torch.func.vmap(fwd, in_dims=(0, None))(state.node_params, imgs)
        accs = met.micro_accuracy(logits, labels[None]).cpu().numpy()
        flat = ravel(state.node_params)
        mal = np.asarray(topo.malicious)
        benign = ~mal
        r2 = float(met.r_squared(flat[torch.as_tensor(benign, device=dev)]))
    adj = np.asarray(topo.adjacency)
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
    tracks neither, as in the reference)."""
    if telemetry:
        raise NotImplementedError(
            "telemetry export is not ported yet: ROADMAP queue 1, item 9")
    dev = resolve_device(device)
    rounds = rounds or cfg.paper.rounds
    track = not cfg.centralized
    state = init_dfl_state(cfg, topo, device=dev)
    round_fn = build_round_fn(cfg, topo, data, telemetry=track, device=dev)
    trace = []
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
        if (r + 1) % eval_every == 0 or r == rounds - 1:
            e = evaluate(cfg, topo, data, state)
            e["round"] = r + 1
            if mf is not None:
                e["mean_fallback_nodes"] = np.flatnonzero(mf).tolist()
            trace.append(e)
    series = {
        "round": [e["round"] for e in trace],
        "acc_benign_mean": [e["acc_benign_mean"] for e in trace],
        "r_squared": [e["r_squared"] for e in trace],
        "round_seconds": round_seconds,
    }
    if track:
        series["mean_fallback_count"] = fallback_counts
        series["degree_zero_count"] = degree_zero_counts
    return {"trace": trace, "final": trace[-1], "series": series,
            "aggregator": cfg.aggregator, "attack": cfg.attack,
            "centralized": cfg.centralized, "device": str(dev)}
