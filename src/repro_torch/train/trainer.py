"""Training step builders (port of ``repro.train.trainer``).

Two execution modes:

* ``robust_dp`` — the paper's technique as a distributed training
  feature: each of the K candidate workers takes the gradient of the loss
  on its own rows of the batch (rows [k·B/K, (k+1)·B/K), the reference's
  ``shard_map`` split), Byzantine workers optionally poison it, and the
  robust all-reduce of ``distributed.robust_allreduce`` replaces the mean
  all-reduce.  Layouts (``tc.agg.layout``):

    stacked  the K gradients are rows of one (K, P) float32 buffer, the
             per-leaf tensors views of it in ravel order
             (``core.flatten.unravel_rows``); the attack writes into it in
             place; ``robust_allreduce_stacked`` on ``tc.agg.backend``
             reads it without a copy (kernel 1 on ``fused``, kernels 4 and
             6 on ``fused_two_launch``), and its WFAgg-T ``prev`` is the
             last step's buffer;
    flat     ``apply_distributed_attack`` and the chunked
             ``robust_allreduce`` over the mesh's process group (one rank
             per candidate, this process computing its own candidate) or,
             without one, ``Emulated(K)`` (this process computing all K).

  On one card the K candidates run one after another in one process,
  not batched, so activation memory stays at one worker's.

* ``gspmd`` — conventional data-parallel training: the mean gradient
  over the whole batch.

The model's parameters are views of one (P,) buffer in the reference's
ravel order (``core.flatten.layout_flat``), and the optimizer runs on the
reference's stacked tree of views of it (``core.flatten.module_tree``), so
a leaf-wide statistic spans all L layers as in the reference, and
``updates`` are added to the parameters in place.  Parameters are
created without gradients (``requires_grad=False``); a worker's gradient
is taken by enabling them for its backward alone.  The multi-card trainer
(``fsdp_params``, ``multi_pod``, a ``model`` axis above 1, the GSPMD
naming of ``sharding.py`` / ``logical.py``) is ROADMAP queue 1, item 12.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.flatten import (
    layout_flat, module_params, module_tree, tree_leaves, tree_map, unravel_like,
    unravel_rows, vmap_ravel)
from repro_torch.core.topology import spaced_malicious
from repro_torch.distributed import robust_allreduce as ra
from repro_torch.distributed.robust_allreduce import RobustAggConfig, TreeAggState
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import MULTI_CARD, Mesh
from repro_torch.models import model as M
from repro_torch.optim.optimizers import make_optimizer, warmup_cosine

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    mode: str = "robust_dp"                    # robust_dp | gspmd
    agg: RobustAggConfig = RobustAggConfig()
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    attack: str = "none"
    n_malicious: int = 0
    multi_pod: bool = False
    fsdp_params: bool = False
    # split each worker's rows into m microbatches whose gradients are
    # averaged: the candidate gradient is the mean over its microbatches
    microbatches: int = 1


class TrainState(NamedTuple):
    params: Any          # DecoderLM, its parameters views of one (P,) buffer
    opt_state: Any
    agg_state: Optional[Any]   # AggState (flat) | TreeAggState (stacked) | None
    step: Tensor               # int32, on the host


def _check_params(cfg: ArchConfig) -> None:
    if cfg.param_dtype != "float32":
        raise NotImplementedError(
            f"training with {cfg.param_dtype} parameters ({cfg.name}) is not ported yet: "
            "it is Arctic's multi-card plan, whose optimizers and robust all-reduce keep "
            "f32 here (ROADMAP queue 1, item 12)")


def _check(tc: TrainConfig, mesh: Mesh) -> None:
    if tc.multi_pod or tc.fsdp_params or mesh.shape.get("model", 1) != 1:
        raise NotImplementedError(MULTI_CARD)
    if tc.mode not in ("robust_dp", "gspmd"):
        raise ValueError(f"unknown mode {tc.mode!r}")
    if tc.mode == "gspmd" and tc.agg.method != "mean":
        raise ValueError("gspmd mode supports mean aggregation only")


def init_train_state(cfg: ArchConfig, tc: TrainConfig,
                     generator: Optional[torch.Generator] = None,
                     mesh: Optional[Mesh] = None, device=None) -> TrainState:
    """The model (``models.model.init_params`` from ``generator``), laid out
    on one flat buffer, its optimizer state, the all-reduce's state for the
    mesh's K candidates and step 0, on ``device`` (None: the card)."""
    _check_params(cfg)
    dev = resolve_device(device)
    model = M.init_params(cfg, generator, dev)
    layout_flat(model)
    tree = module_tree(model)
    K = mesh.shape["data"] if mesh is not None else 1
    agg_state = None
    if (tc.mode == "robust_dp" and tc.agg.method in ("wfagg", "alt_wfagg")
            and tc.agg.wfagg.use_temporal):
        agg_state = (ra.init_tree_agg_state(tc.agg, K, tree) if tc.agg.layout == "stacked"
                     else ra.init_agg_state(tc.agg, K, device=dev))
    return TrainState(model, make_optimizer(cfg.optimizer).init(tree), agg_state,
                      torch.zeros((), dtype=torch.int32))


def _to_torch(tree, dev):
    """Numpy leaves as tensors: floats on ``dev``, integers on the host."""
    if isinstance(tree, dict):
        return {k: _to_torch(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v, dev) for v in tree)
    arr = np.asarray(tree)
    return torch.as_tensor(arr.copy(), device=dev if arr.dtype.kind == "f" else "cpu")


def state_from_jax(state, cfg: ArchConfig, device=None) -> TrainState:
    """The reference's ``TrainState`` (its leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, state)``) as the port's, on ``device``:
    params through ``params_from_jax``, the optimizer state leaf for leaf,
    the all-reduce's state (a stacked ``prev`` laid out as one (K, P)
    matrix) and the step."""
    _check_params(cfg)
    dev = resolve_device(device)
    model = M.params_from_jax(state.params, cfg, dev)
    layout_flat(model)
    agg = state.agg_state
    if agg is not None:
        agg = ra.state_from_jax(agg, device=dev)
        if isinstance(agg, TreeAggState):
            mat, _ = vmap_ravel(agg.prev)
            agg = agg._replace(prev=unravel_rows(
                mat.contiguous(), tree_map(lambda leaf: leaf[0], agg.prev)))
    return TrainState(model, _to_torch(state.opt_state, dev), agg,
                      torch.tensor(int(np.asarray(state.step)), dtype=torch.int32))


# ---------------------------------------------------------------------------
# a worker's gradient
# ---------------------------------------------------------------------------

def loss_and_grad(cfg: ArchConfig, model, batch: Dict[str, Tensor],
                  out: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """The loss on ``batch`` and its gradient as one (P,) float32 vector in
    ravel order, written into ``out`` when given.  A loss that does not
    reach the parameters (chunked CE over fewer positions than a chunk)
    has gradient 0, as in the reference."""
    params = module_params(model)
    with torch.enable_grad():
        for p in params:
            p.requires_grad_(True)
        try:
            loss, _ = M.loss_fn(cfg, model, batch)
            grads = (torch.autograd.grad(loss, params, allow_unused=True)
                     if loss.requires_grad else [None] * len(params))
        finally:
            for p in params:
                p.requires_grad_(False)
    parts = [(g if g is not None else torch.zeros_like(p)).reshape(-1).to(torch.float32)
             for g, p in zip(grads, params)]
    return loss.detach(), torch.cat(parts, out=out)


def _worker_grad(cfg: ArchConfig, model, batch: Dict[str, Tensor], mb: int,
                 out: Tensor) -> Tensor:
    """One candidate's gradient into ``out`` (P,): the mean over ``mb``
    microbatches of its rows (of every entry of ``batch``), accumulated as
    the reference's scan does; returns its loss, the mean of the
    microbatches' losses."""
    if mb == 1:
        return loss_and_grad(cfg, model, batch, out)[0]
    rows = {k: v.reshape((mb, v.shape[0] // mb) + tuple(v.shape[1:]))
            for k, v in batch.items()}
    out.zero_()
    loss = torch.zeros((), dtype=torch.float32, device=out.device)
    tmp = torch.empty_like(out)
    for m in range(mb):
        lm, _ = loss_and_grad(cfg, model, {k: v[m] for k, v in rows.items()}, tmp)
        out += tmp.div_(mb)
        loss = loss + lm / mb
    return loss


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

Observe = Callable[..., None]


def build_train_step(cfg: ArchConfig, tc: TrainConfig, mesh: Mesh,
                     observe: Optional[Observe] = None) -> Callable:
    """Returns fn(state, batch) -> (state, metrics); ``batch["tokens"]`` is
    the global (B, S) batch on the model's device (every rank passes the
    same one), with an encoder-decoder's ``frames`` or a VLM's
    ``patch_embeds`` beside it; each candidate takes its rows of every
    entry.  The step updates ``state.params`` in place.  ``observe``,
    if given, is called after each phase as ``observe(phase, **values)``:
    "grads" (``candidates``, ``losses``), "attack" (``candidates``, the
    ``agg_state`` going in), "allreduce" (``grads``, ``agg_state``,
    ``info``) and "optimizer" (``params``); the caller may time the phases
    or check them there (the gspmd step has "grads" and "optimizer"
    only)."""
    _check_params(cfg)
    _check(tc, mesh)
    opt = make_optimizer(cfg.optimizer)
    lr_fn = warmup_cosine(tc.lr, tc.warmup, tc.total_steps)
    K = mesh.shape["data"]
    mal_np = spaced_malicious(K, tc.n_malicious)
    see = observe or (lambda phase, **values: None)
    attacking = tc.attack not in ("none", "label_flip") and tc.n_malicious > 0
    flipping = tc.attack == "label_flip" and tc.n_malicious > 0

    def rows_of(batch: Dict[str, Tensor], k: int) -> Dict[str, Tensor]:
        b = batch["tokens"].shape[0] // K
        rows = {name: v[k * b:(k + 1) * b] for name, v in batch.items()}
        if flipping and mal_np[k]:
            # the reference flips the target ids only
            rows["tokens"] = (cfg.vocab_size - 1) - rows["tokens"]
        return rows

    def attack_generator(step: Tensor, dev) -> torch.Generator:
        # the reference's fold_in(PRNGKey(seed + 1), step), from the port's bits
        seed = ((tc.agg.seed + 1) * 1_000_003 + int(step)) % (2 ** 63)
        return torch.Generator(device=dev).manual_seed(seed)

    def finish(state: TrainState, grads, new_agg, info, loss: Tensor, gn: Tensor):
        params = module_tree(state.params)
        lr = lr_fn(state.step)
        updates, new_opt = opt.update(grads, state.opt_state, params, lr)
        with torch.no_grad():
            for p, u in zip(tree_leaves(params), tree_leaves(updates)):
                p.add_(u.to(p.dtype))
        see("optimizer", params=params)
        dev = loss.device
        metrics = {"loss": loss, "lr": lr, "grad_norm": gn,
                   "n_accepted": info.get("n_accepted", torch.tensor(K, device=dev)),
                   "weights": info.get("weights", torch.ones((K,), device=dev))}
        return TrainState(state.params, new_opt, new_agg, state.step + 1), metrics

    def stacked_step(state: TrainState, batch):
        model, tokens = state.params, batch["tokens"]
        P = layout_flat(model).numel()
        G = torch.empty((K, P), dtype=torch.float32, device=tokens.device)
        losses = torch.stack([_worker_grad(cfg, model, rows_of(batch, k),
                                           tc.microbatches, G[k]) for k in range(K)])
        stacked = unravel_rows(G, module_tree(model))
        see("grads", candidates=stacked, losses=losses)
        if attacking:
            mal = torch.as_tensor(mal_np, device=tokens.device)
            ra.apply_stacked_attack(stacked, mal, tc.attack,
                                    attack_generator(state.step, tokens.device),
                                    in_place=True)
        see("attack", candidates=stacked, agg_state=state.agg_state)
        grads, new_agg, info = ra.robust_allreduce_stacked(stacked, tc.agg, state.agg_state)
        see("allreduce", grads=grads, agg_state=new_agg, info=info)
        gn = torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in tree_leaves(grads)))
        return finish(state, grads, new_agg, info, losses.mean(), gn)

    def flat_step(state: TrainState, batch):
        model, tokens = state.params, batch["tokens"]
        P = layout_flat(model).numel()
        group = mesh.group
        axis = ra.Emulated(K) if group is None else group
        mine = range(K) if group is None else [torch.distributed.get_rank(group)]
        G = torch.empty((len(mine), P), dtype=torch.float32, device=tokens.device)
        losses = torch.stack([_worker_grad(cfg, model, rows_of(batch, k), tc.microbatches,
                                           G[i]) for i, k in enumerate(mine)])
        local = G if group is None else G[0]
        see("grads", candidates=local, losses=losses)
        if attacking:
            mal = torch.as_tensor(mal_np, device=tokens.device)
            local = ra.apply_distributed_attack(
                local, axis, mal, tc.attack, attack_generator(state.step, tokens.device),
                chunk_size=tc.agg.chunk_size)
        see("attack", candidates=local, agg_state=state.agg_state)
        agg_flat, new_agg, info = ra.robust_allreduce(local, axis, tc.agg, state.agg_state)
        see("allreduce", grads=agg_flat, agg_state=new_agg, info=info)
        gn = torch.sqrt((agg_flat.to(torch.float32) ** 2).sum())
        loss = ra.pmean(losses if group is None else losses[0], axis)
        return finish(state, unravel_like(agg_flat, module_tree(model)), new_agg, info,
                      loss, gn)

    def gspmd_step(state: TrainState, batch):
        model = state.params
        loss, g = loss_and_grad(cfg, model, batch)
        see("grads", candidates=g, losses=loss[None])
        return finish(state, unravel_like(g, module_tree(model)), None, {}, loss,
                      torch.sqrt((g ** 2).sum()))

    if tc.mode == "gspmd":
        return gspmd_step
    return stacked_step if tc.agg.layout == "stacked" else flat_step
