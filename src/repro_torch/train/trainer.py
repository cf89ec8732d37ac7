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
    flat     ``apply_distributed_attack`` (in place) and the chunked
             ``robust_allreduce`` over the mesh's data group (one rank per
             candidate, this process computing its own candidate) or,
             without one, ``Emulated(K)`` (this process computing all K).
             On the model axis each rank runs it on its two buffers of the
             candidates' blocks (``robust_allreduce.FlatShards``): the
             whole vector's values, the statistics' partial sums added over
             the model group, no whole gradient gathered.

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
is taken by enabling them for its backward alone.

**The model axis.**  On a mesh with ``model`` = M > 1 (a model of any
family) every process is one tensor-parallel rank and runs all K candidates on
its shard of the model (``models.model.cut_model_``), its parameters
views of two buffers (``core.flatten.layout_split``: the split leaves and
the replicated ones), its candidate gradients two (K, P_s) and (K, P_r)
matrices; the stacked all-reduce's model-axis route (kernels 4, 6 and 7,
the statistics summed over the model group) keeps every gradient leaf in
its TP split through aggregation, as the reference's does ("no unsharded
gradient ever exists"), and the optimizer steps each rank's blocks.
``multi_pod`` runs pod x data candidates.  The flat layout there runs
the chunked all-reduce on the rank's (K, P_s) and (K, P_r) buffers with
the K candidates emulated (``flat_step``).

**The grid.**  On a mesh whose data axis is processes (``launch.mesh``:
K x M ranks, the stacked layout or gspmd) every rank computes ONE
candidate's gradient, its data index's rows (``label_flip`` when that
candidate is malicious), on its model block.  With ``fsdp_params`` (and
always under gspmd, as the reference's specs say) the rank holds the FSDP
blocks of its model block and of the optimizer state
(``models.model.shard_data_``): the step gathers the whole model block
once, before the gradient (``models.model.whole_block``; the reference's
"one param all-gather per step at the grad shard_map boundary"), and
frees it after.  The gradient goes out in column-block order
(``core.flatten.pack_fsdp``) through one ``all_to_all`` over the data
group (an all-gather for the leaves whole over data); the stacked
all-reduce's data-axis route aggregates the rank's column block of the K
candidates (``distributed.robust_allreduce``); the aggregate's block is
the optimizer's block, so AdamW steps the blocks with no gradient
all-gather.  Without ``fsdp_params`` the rank holds the whole model block
and the optimizer state, and one all-gather over the data group gives the
whole aggregate.  The loss is the rank-order mean of the K candidates'
losses, ``grad_norm`` the aggregate's squares summed once per coordinate
over the grid.  gspmd on the grid is the mean of the exchanged column
block (the mean gradient, each data rank on its rows).  WFAgg-T's
``prev`` is the column block.  The flat layout at M > 1 on a grid has no
FSDP blocks (the reference's ``fsdp_params`` is the stacked layout's):
each rank takes its candidate's gradient on its whole model block and the
flat all-reduce runs over the data group on the rank's two buffers, the
statistics summed over the model group (``flat_step``).  Adafactor runs
on blocks everywhere (``optim.LeafBlock``: its leaf-wide means add the
block's sums over the cut's group).  Every family runs there, the
encoder-decoder and the VLM too: each candidate takes its rows of the
``frames`` or ``patch_embeds`` beside its tokens.  ``state_shardings`` / ``batch_shardings`` give the reference's specs (plain
tuples, ``distributed.sharding``).

**bfloat16 parameters** (``cfg.param_dtype``, Arctic's plan with
Adafactor) follow the reference's casts: the flat layout's candidates are
the parameters' dtype (the reference ravels bf16 gradients), the stacked
layout's float32 rows holding them (its ``_concat_candidates``), attacked
in the parameters' dtype and their aggregate rounded to it; the
optimizers keep float32 moments and round the update to the leaf's dtype.

**Pad head slots.**  Where M does not divide a padded-head config's query
heads, a rank holds ``pad_heads_to / M`` head slots of the padded layout
(``distributed.sharding.padded_heads``), the last ones pad slots the whole
model does not have.  Their gradients are written as 0
(``loss_and_grad``), the attacks leave them so, they have no place in the
flat layout's whole vector (``core.flatten.coord_places``: no sketch term,
no noise), a zero column adds nothing to the statistics or the weighted
sum, and the optimizer's leaf-wide sums skip them
(``optim.LeafBlock.live``): their parameters stay exactly 0.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import flatten as F
from repro_torch.core.flatten import (
    layout_flat, layout_split, module_params, module_tree, split_dims, split_groups,
    tree_leaves, tree_map, tree_unflatten, unravel_like, unravel_rows, unravel_rows_split,
    vmap_ravel)
from repro_torch.core.topology import spaced_malicious
from repro_torch.distributed import robust_allreduce as ra
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.logical import use_sharding
from repro_torch.distributed.robust_allreduce import RobustAggConfig, TreeAggState
from repro_torch.kernels.common import resolve_device
from repro_torch.distributed.spmd import all_gather_rows, all_to_all_rows
from repro_torch.launch.mesh import Mesh, data_axis, model_size
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim.optimizers import LeafBlock, make_optimizer, warmup_cosine

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

    def candidate_axes(self) -> Tuple[str, ...]:
        return ("pod", "data") if self.multi_pod else ("data",)


class TrainState(NamedTuple):
    params: Any          # DecoderLM, its parameters views of one (P,) buffer
    opt_state: Any
    agg_state: Optional[Any]   # AggState (flat) | TreeAggState (stacked) | None
    step: Tensor               # int32, on the host


def _n_candidates(mesh: Optional[Mesh], tc: TrainConfig) -> int:
    """K: the data axis, times the pods under ``multi_pod``."""
    if mesh is None:
        return 1
    n = mesh.shape["data"]
    if tc.multi_pod:
        n *= mesh.shape.get("pod", 1)
    return int(n)


def _flat(tc: TrainConfig) -> bool:
    return tc.mode == "robust_dp" and tc.agg.layout != "stacked"


def _on_grid(mesh: Optional[Mesh], tc: TrainConfig) -> bool:
    """The step runs the grid: the data axis as processes, with the stacked
    layout, gspmd, or the flat layout at M > 1 (at M = 1 the flat layout
    runs over the data group as its candidate axis, without a grid)."""
    return (data_axis(mesh) is not None
            and (not _flat(tc) or model_size(mesh) > 1))


def _fsdp_state(tc: TrainConfig) -> Optional[bool]:
    """Whether a grid holds FSDP blocks of the train state: under gspmd, or
    with ``fsdp_params`` on the stacked layout (the reference's specs);
    None for the flat layout, which has no FSDP layout (each rank holds
    its whole model block)."""
    if _flat(tc):
        return None
    return tc.mode == "gspmd" or (tc.fsdp_params and tc.agg.layout == "stacked")


def _check(cfg: ArchConfig, tc: TrainConfig, mesh: Mesh) -> None:
    if tc.mode not in ("robust_dp", "gspmd"):
        raise ValueError(f"unknown mode {tc.mode!r}")
    if tc.mode == "gspmd" and tc.agg.method != "mean":
        raise ValueError("gspmd mode supports mean aggregation only")
    if tc.multi_pod and "pod" not in mesh.shape:
        raise ValueError("multi_pod needs a mesh with a pod axis")
    L.check_family(cfg)
    if _on_grid(mesh, tc) and mesh.shape.get("pod") and not tc.multi_pod:
        raise ValueError("a grid with a pod axis runs pod x data candidates: multi_pod")


def _layout(model, mesh: Optional[Mesh]):
    """Lay the model's parameters out (one buffer at M = 1, the split and
    the replicated buffers on the model axis); returns the buffers."""
    if model_size(mesh) == 1:
        return (layout_flat(model),)
    return layout_split(model)


def _column_block(model, K: int, dev) -> dict:
    """A grid rank's zero column block of K candidates, as a tree: per
    column group a (K, D) float32 matrix (``core.flatten.unravel_fsdp``)."""
    return F.unravel_fsdp([torch.zeros((K, w), dtype=torch.float32, device=dev)
                           for w in F.fsdp_widths(model)], model)


def _candidate_rows(model, mesh: Optional[Mesh], K: int, dev) -> Tuple[Any, tuple]:
    """K zero candidate rows of the model in its layout: (the candidate
    tree, its matrices)."""
    mats = tuple(torch.zeros((K, b.numel()), dtype=torch.float32, device=dev)
                 for b in _layout(model, mesh))
    if len(mats) == 1:
        return unravel_rows(mats[0], module_tree(model)), mats
    return unravel_rows_split(mats, model), mats


def init_train_state(cfg: ArchConfig, tc: TrainConfig,
                     generator: Optional[torch.Generator] = None,
                     mesh: Optional[Mesh] = None, device=None,
                     abstract: bool = False) -> TrainState:
    """The model (``models.model.init_params`` from ``generator``; on the
    model axis this rank's blocks of it), laid out on its buffers, its
    optimizer state, the all-reduce's state for the mesh's K candidates
    and step 0, on ``device`` (None: the card).  ``abstract=True`` builds
    it on the ``meta`` device, shapes and dtypes only (the reference's
    ``eval_shape``); on the model axis it then needs the model group only
    for the rank."""
    dev = torch.device("meta") if abstract else resolve_device(device)
    if mesh is not None:
        _check(cfg, tc, mesh)
    grid = _on_grid(mesh, tc)
    model = M.init_params(cfg, generator, dev, mesh=mesh,
                          fsdp=_fsdp_state(tc) if grid else None)
    if not model.fsdp_blocks:
        _layout(model, mesh)
    tree = module_tree(model)
    K = _n_candidates(mesh, tc)
    agg_state = None
    if (tc.mode == "robust_dp" and tc.agg.method in ("wfagg", "alt_wfagg")
            and tc.agg.wfagg.use_temporal):
        if _flat(tc):
            agg_state = ra.init_agg_state(tc.agg, K, device=dev)
        elif grid:
            agg_state = ra.init_tree_agg_state(tc.agg, K, tree)._replace(
                prev=_column_block(model, K, dev))
        else:
            agg_state = ra.init_tree_agg_state(tc.agg, K, tree)._replace(
                prev=_candidate_rows(model, mesh, K, dev)[0])
    opt = make_optimizer(cfg.optimizer, blocks=opt_blocks(model))
    return TrainState(model, opt.init(tree), agg_state, torch.zeros((), dtype=torch.int32))


def state_shardings(cfg: ArchConfig, tc: TrainConfig, mesh: Mesh,
                    state_shape: TrainState) -> TrainState:
    """The reference's specs of the train state under the chosen mode (plain
    tuples, ``distributed.sharding``), from a whole-model state's shapes
    (``init_train_state(abstract=True)`` on a mesh of M = 1): parameters
    by ``param_specs`` (FSDP under gspmd or ``fsdp_params``), optimizer
    leaves as the parameter of their shape, else replicated; a stacked
    ``prev`` its candidate axis over the data axes before the parameter's
    TP spec."""
    data_axes = tc.candidate_axes()
    fsdp = tc.mode == "gspmd" or (tc.fsdp_params and tc.agg.layout == "stacked")
    params = module_tree(state_shape.params)
    pspecs = shd.param_specs(cfg, params, fsdp=fsdp, data_axes=data_axes, mesh=mesh)
    p_shapes = {tuple(l.shape): sp for l, sp in zip(tree_leaves(params), tree_leaves(pspecs))}

    def opt_spec(leaf):
        return p_shapes.get(tuple(leaf.shape), ()) if hasattr(leaf, "shape") else ()

    ospecs = tree_map(opt_spec, state_shape.opt_state)
    if state_shape.agg_state is None:
        aspecs = None
    elif isinstance(state_shape.agg_state, TreeAggState):
        prev_p = shd.param_specs(cfg, params, fsdp=False, data_axes=data_axes, mesh=mesh)
        dax = data_axes if len(data_axes) > 1 else data_axes[0]
        aspecs = TreeAggState(prev=tree_map(lambda sp: (dax,) + tuple(sp), prev_p),
                              hist_s=(), hist_b=(), count=(), t=())
    else:
        aspecs = type(state_shape.agg_state)(*(
            tree_map(lambda _: (), x) for x in state_shape.agg_state))
    return TrainState(params=pspecs, opt_state=ospecs, agg_state=aspecs, step=())


def batch_shardings(tc: TrainConfig, mesh: Mesh, batch_shape: Any) -> Any:
    """The batch's specs over the candidate axes."""
    return shd.batch_specs(batch_shape, data_axes=tc.candidate_axes(), mesh=mesh)


def _model_cuts(model) -> List[Optional[shd.Cut]]:
    """Per leaf (ravel order) its cut over the model axis
    (``distributed.sharding.Cut``, a stacked leaf's L axis counted), None
    for a replicated leaf (or a whole model)."""
    return [None if c is None else c[0] for c in F.split_cuts(model)]


def opt_blocks(model) -> Optional[List[Optional[LeafBlock]]]:
    """Per leaf (ravel order) the optimizer's ``LeafBlock`` where this rank
    holds a block of it: the whole leaf's shape, the groups its model cut
    (the model group) and its FSDP block (the data group) lie over, and
    the block's pad head slots (``core.flatten.pad_tails``); None for a
    leaf held whole, and for a whole model."""
    tp = getattr(model, "tp", None)
    if tp is None and not model.fsdp_blocks:
        return None
    out = []
    for shape, c, ddim, tail in zip(whole_shapes(model), F.split_cuts(model),
                                    _data_dims(model), F.pad_tails(model)):
        cuts = []
        if c is not None:
            cuts.append((c[0].dim, tp.group))
        if ddim is not None:
            cuts.append((ddim, model.dp.group))
        out.append(LeafBlock(shape, tuple(cuts), tail) if cuts else None)
    return out


def whole_shapes(model) -> List[Tuple[int, ...]]:
    """Per leaf (ravel order) the whole leaf's shape, of which a rank holds
    a block: its model cut's dim the whole extent (a padded layout's live
    heads, not its slots), its FSDP dim times the data axis."""
    out = []
    for (path, ps), c, ddim in zip(F.leaf_params(model), F.split_cuts(model),
                                   _data_dims(model)):
        shape = list(F.leaf_shape(path, ps))
        if c is not None:
            shape[c[0].dim] = c[1]
        if ddim is not None:
            shape[ddim] *= model.fsdp.size
        out.append(tuple(shape))
    return out


def _data_dims(model) -> List[Optional[int]]:
    """Per leaf (ravel order) the dim its FSDP block splits over the data
    axis, None for a leaf whole over it (or a model without blocks)."""
    if not model.fsdp_blocks:
        return [None] * len(split_dims(model))
    return [model.fsdp.dims[path] for path, _ in F.leaf_params(model)]


def full_params(model, mesh: Optional[Mesh]) -> dict:
    """The whole model's reference tree (``module_tree``) from a rank's
    blocks, gathered in rank order over the data group (FSDP blocks), then
    over the model group (every rank takes part and gets it); the model's
    own tree at M = 1 without blocks.  A checkpoint of it has today's
    format, whatever grid saved it."""
    tree = module_tree(model)
    if model_size(mesh) == 1 and not model.fsdp_blocks:
        return tree
    dax = ("pod", "data") if mesh.shape.get("pod") else "data"
    out = []
    for leaf, mc, ddim in zip(tree_leaves(tree), F.split_cuts(model), _data_dims(model)):
        mdim = None if mc is None else mc[0].dim
        spec = tuple("model" if i == mdim else dax if i == ddim else None
                     for i in range(leaf.ndim))
        out.append(shd.gather_tensor(leaf, spec, mesh, *(mc or ())) if mdim is not None or
                   ddim is not None else leaf)
    return tree_unflatten(tree, out)


def load_params_(model, tree: dict, mesh: Optional[Mesh]) -> None:
    """Copy a whole model's reference tree (e.g. a restored checkpoint) into
    the model's parameters in place, each rank its blocks (over the model
    axis, then its FSDP blocks over the data axis)."""
    axis = None if model_size(mesh) == 1 else mesh.model_axis()
    if not model.fsdp_blocks:
        _layout(model, mesh)
    lay = model.fsdp
    with torch.no_grad():
        for dst, src, cut, ddim in zip(tree_leaves(module_tree(model)), tree_leaves(tree),
                                       _model_cuts(model), _data_dims(model)):
            src = torch.as_tensor(src)
            if cut is not None:
                src = shd.take_block(src, cut, axis.size, axis.rank)
            if ddim is not None:
                n = src.shape[ddim] // lay.size
                src = src.narrow(ddim, lay.rank * n, n)
            dst.copy_(src)


def _to_torch(tree, dev):
    """Numpy leaves as tensors: floats on ``dev``, integers on the host."""
    if isinstance(tree, dict):
        return {k: _to_torch(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v, dev) for v in tree)
    arr = np.asarray(tree)
    return torch.as_tensor(arr.copy(), device=dev if arr.dtype.kind == "f" else "cpu")


def _cut(tree, params: dict, model, lead: int = 0, data: Optional[List] = None):
    """Every subtree of ``tree`` laid out as the parameter tree ``params``
    cut to this rank's blocks (``lead`` leading axes before the parameter's
    own): its model rank's, then, per leaf, its data rank's block along
    ``data``'s dim (None: whole); the rest as it is."""
    if (lead == 0 and isinstance(tree, dict) and isinstance(tree.get("v"), list)
            and isinstance(params, dict) and "v" not in params):
        return {k: _cut_factors(v, model, data) if k == "v" else v for k, v in tree.items()}
    if isinstance(tree, dict) and isinstance(params, dict) and set(tree) == set(params):
        leaves = []
        ddims = data or [None] * len(split_dims(model))
        for leaf, cut, dd in zip(tree_leaves(tree), _model_cuts(model), ddims):
            if cut is not None:
                leaf = shd.take_block(leaf, cut.shifted(lead), model.tp.size, model.tp.rank)
            if dd is not None:
                n = leaf.shape[lead + dd] // model.fsdp.size
                leaf = leaf.narrow(lead + dd, model.fsdp.rank * n, n)
            leaves.append(leaf.contiguous())
        return tree_unflatten(tree, leaves)
    if isinstance(tree, dict):
        return {k: _cut(v, params, model, lead, data) for k, v in tree.items()}
    return tree


def _cut_factors(vs: List[dict], model, data: Optional[List] = None) -> List[dict]:
    """Adafactor's per-leaf second moments of the whole model (ravel order)
    cut to this rank's blocks: ``v`` as its leaf, ``vr`` (the leaf without
    its last dim) and ``vc`` (without dim -2) along each cut of the leaf
    on a dim they keep, whole along the one they reduce."""
    out = []
    ddims = data or [None] * len(vs)
    for v, (path, ps), cut, dd in zip(vs, F.leaf_params(model), _model_cuts(model), ddims):
        nd = len(F.leaf_shape(path, ps))
        keeps = {"v": list(range(nd)), "vr": list(range(nd - 1)),
                 "vc": list(range(nd - 2)) + [nd - 1]}
        new = {}
        for k, x in v.items():
            keep = keeps[k]
            if cut is not None and cut.dim in keep:
                x = shd.take_block(x, cut._replace(dim=keep.index(cut.dim)), model.tp.size,
                                   model.tp.rank)
            if dd is not None and dd in keep:
                n = x.shape[keep.index(dd)] // model.fsdp.size
                x = x.narrow(keep.index(dd), model.fsdp.rank * n, n)
            new[k] = x.contiguous()
        out.append(new)
    return out


def state_from_jax(state, cfg: ArchConfig, device=None, mesh: Optional[Mesh] = None,
                   tc: Optional[TrainConfig] = None) -> TrainState:
    """The reference's ``TrainState`` (its leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, state)``) as the port's, on ``device``:
    params through ``params_from_jax``, the optimizer state leaf for leaf,
    the all-reduce's state (a stacked ``prev`` laid out as one (K, P)
    matrix) and the step.  On a mesh with ``model`` > 1 each piece is
    this model rank's blocks, laid out as ``init_train_state``'s; on a grid
    the parameters and the optimizer state are also cut to the rank's FSDP
    blocks when ``tc`` holds them so (``fsdp_params``, gspmd), and ``prev``
    to the rank's column block."""
    tc = tc or TrainConfig()
    dev = resolve_device(device)
    model = M.params_from_jax(state.params, cfg, dev, mesh=mesh,
                              fsdp=_fsdp_state(tc) if _on_grid(mesh, tc) else None)
    if not model.fsdp_blocks:
        _layout(model, mesh)
    opt = _to_torch(state.opt_state, dev)
    agg = state.agg_state
    if agg is not None:
        agg = ra.state_from_jax(agg, device=dev)
    tp = model.tp
    if model.fsdp is not None:
        params = module_tree(model)
        opt = _cut(opt, params, model, data=_data_dims(model))
        if isinstance(agg, TreeAggState):
            K = tree_leaves(agg.prev)[0].shape[0]
            prev = _column_block(model, K, dev)
            dims = [model.fsdp.dims[path] for path, _ in F.leaf_params(model)]
            for dst, src in zip(tree_leaves(prev), tree_leaves(
                    _cut(agg.prev, params, model, lead=1, data=dims))):
                dst.copy_(src)
            agg = agg._replace(prev=prev)
    elif tp is not None:
        params = module_tree(model)
        opt = _cut(opt, params, model)
        if isinstance(agg, TreeAggState):
            prev, _ = _candidate_rows(model, mesh, tree_leaves(agg.prev)[0].shape[0], dev)
            for dst, src in zip(tree_leaves(prev), tree_leaves(_cut(agg.prev, params, model,
                                                                    lead=1))):
                dst.copy_(src)
            agg = agg._replace(prev=prev)
    elif isinstance(agg, TreeAggState):
        mat, _ = vmap_ravel(agg.prev)
        agg = agg._replace(prev=unravel_rows(
            mat.contiguous(), tree_map(lambda leaf: leaf[0], agg.prev)))
    return TrainState(model, opt, agg,
                      torch.tensor(int(np.asarray(state.step)), dtype=torch.int32))


# ---------------------------------------------------------------------------
# a worker's gradient
# ---------------------------------------------------------------------------

def _param_groups(model) -> List[List[torch.nn.Parameter]]:
    """The parameters in ravel order: one list at M = 1; on the model axis
    the split ones, then the replicated ones (``layout_split``'s order)."""
    if getattr(model, "tp", None) is None:
        return [module_params(model)]
    return [[p for _, ps in groups for p in ps] for groups in split_groups(model)]


def _pad_slots(model) -> Dict[int, Tuple[int, int]]:
    """Per parameter (by id) whose block holds pad head slots, (dim of the
    parameter, live entries along it) (``core.flatten.pad_tails``)."""
    out = {}
    for (path, ps), tail in zip(F.leaf_params(model), F.pad_tails(model)):
        if tail is not None:
            d = tail[0] - (1 if path[0] in F.STACKED else 0)
            out.update({id(p): (d, tail[1]) for p in ps})
    return out


def loss_and_grad(cfg: ArchConfig, model, batch: Dict[str, Tensor],
                  out=None) -> Tuple[Tensor, Any]:
    """The loss on ``batch`` and its gradient as one (P,) float32 vector in
    ravel order, written into ``out`` when given (in ``out``'s dtype: each
    parameter's gradient copied into its slice, one at a time).  A loss
    that does not reach the parameters (chunked CE over fewer positions
    than a chunk) has gradient 0, as in the reference; so have the pad
    head slots of a padded layout.  On the model axis the gradient is a
    pair, (P_s,) of the split leaves and (P_r,) of the replicated ones
    (``out`` a pair too), each in ravel order."""
    groups = _param_groups(model)
    params = [p for g in groups for p in g]
    with torch.enable_grad():
        for p in params:
            p.requires_grad_(True)
        try:
            loss, _ = M.loss_fn(cfg, model, batch)
            grads = (list(torch.autograd.grad(loss, params, allow_unused=True))
                     if loss.requires_grad else [None] * len(params))
        finally:
            for p in params:
                p.requires_grad_(False)
    dev = params[0].device
    outs = out if isinstance(out, tuple) else (out,) * len(groups)
    outs = tuple(torch.empty((sum(p.numel() for p in g),), dtype=torch.float32, device=dev)
                 if o is None else o for g, o in zip(groups, outs))
    pads = _pad_slots(model)
    i = 0
    for g, o in zip(groups, outs):
        off = 0
        for p in g:
            dst = o[off:off + p.numel()].view(p.shape)
            if grads[i] is None:
                dst.zero_()
            else:
                dst.copy_(grads[i])
                grads[i] = None
            if id(p) in pads:
                d, live = pads[id(p)]
                dst.narrow(d, live, p.shape[d] - live).zero_()
            off += p.numel()
            i += 1
    return loss.detach(), outs[0] if len(outs) == 1 else outs


def _worker_grad(cfg: ArchConfig, model, batch: Dict[str, Tensor], mb: int,
                 out) -> Tensor:
    """One candidate's gradient into ``out`` (P,) (on the model axis a
    pair, ``loss_and_grad``'s): the mean over ``mb`` microbatches of its
    rows (of every entry of ``batch``), accumulated as the reference's scan
    does; returns its loss, the mean of the microbatches' losses."""
    if mb == 1:
        return loss_and_grad(cfg, model, batch, out)[0]
    rows = {k: v.reshape((mb, v.shape[0] // mb) + tuple(v.shape[1:]))
            for k, v in batch.items()}
    outs = out if isinstance(out, tuple) else (out,)
    for o in outs:
        o.zero_()
    loss = torch.zeros((), dtype=torch.float32, device=outs[0].device)
    tmps = tuple(torch.empty_like(o) for o in outs)
    for m in range(mb):
        lm, _ = loss_and_grad(cfg, model, {k: v[m] for k, v in rows.items()},
                              tmps if isinstance(out, tuple) else tmps[0])
        for o, t in zip(outs, tmps):
            o += t.div_(mb)
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
    only).  On a grid the phases are "grads" (``candidates``, the rank's
    gradient in its natural buffers, ``losses``), "exchange"
    (``candidates``, the column block's tree), "attack", "allreduce" and
    "optimizer", for gspmd too."""
    _check(cfg, tc, mesh)
    lr_fn = warmup_cosine(tc.lr, tc.warmup, tc.total_steps)
    K = _n_candidates(mesh, tc)
    tp = mesh.model_axis()
    rules = shd.tp_rules(cfg, shd.activation_rules(tc.mode, tc.multi_pod), mesh)
    mal_np = spaced_malicious(K, tc.n_malicious)
    see = observe or (lambda phase, **values: None)
    attacking = tc.attack not in ("none", "label_flip") and tc.n_malicious > 0
    flipping = tc.attack == "label_flip" and tc.n_malicious > 0
    # the parameters' dtype: the stacked candidates are float32 rows of
    # gradients in it, attacked in it, their aggregate rounded to it
    pdtype = getattr(torch, cfg.param_dtype)

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
        opt = make_optimizer(cfg.optimizer, blocks=opt_blocks(state.params))
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

    def grad_norm(grads, model) -> Tensor:
        """The aggregate's norm; on the model axis the split leaves' squares
        summed over the model group, the replicated leaves' counted once."""
        if tp is None:
            return torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in tree_leaves(grads)))
        sq = [(g.to(torch.float32) ** 2).sum() for g in tree_leaves(grads)]
        dims = split_dims(model)
        part = sum(q for q, d in zip(sq, dims) if d is not None)
        if tp.rank == 0:
            part = part + sum(q for q, d in zip(sq, dims) if d is None)
        return torch.sqrt(L.all_reduce_model(part.reshape(1), tp.group)[0])

    def stacked_step(state: TrainState, batch):
        model, tokens = state.params, batch["tokens"]
        bufs = _layout(model, mesh)
        G = tuple(torch.empty((K, b.numel()), dtype=torch.float32, device=tokens.device)
                  for b in bufs)
        losses = torch.stack([_worker_grad(cfg, model, rows_of(batch, k), tc.microbatches,
                                           G[0][k] if tp is None else (G[0][k], G[1][k]))
                              for k in range(K)])
        shards = None
        if tp is None:
            stacked = unravel_rows(G[0], module_tree(model))
        else:
            stacked = unravel_rows_split(G, model)
            shards = ra.ModelShards(tp, tuple(_model_cuts(model)), tuple(whole_shapes(model)))
        del G
        see("grads", candidates=stacked, losses=losses)
        if attacking:
            mal = torch.as_tensor(mal_np, device=tokens.device)
            ra.apply_stacked_attack(stacked, mal, tc.attack,
                                    attack_generator(state.step, tokens.device),
                                    in_place=True, model_shards=shards,
                                    chunk_size=tc.agg.chunk_size, dtype=pdtype)
        see("attack", candidates=stacked, agg_state=state.agg_state)
        grads, new_agg, info = ra.robust_allreduce_stacked(stacked, tc.agg, state.agg_state,
                                                           model_shards=shards)
        grads = _rounded(grads, pdtype)
        see("allreduce", grads=grads, agg_state=new_agg, info=info)
        return finish(state, grads, new_agg, info, losses.mean(), grad_norm(grads, model))

    def flat_step(state: TrainState, batch):
        model, tokens = state.params, batch["tokens"]
        dev = tokens.device
        bufs = _layout(model, mesh)
        dax = mesh.data_axis()
        axis = ra.Emulated(K) if dax is None else dax.group
        mine = range(K) if dax is None else [dax.rank]
        # the candidates in the parameters' dtype, as the reference ravels them
        G = tuple(torch.empty((len(mine), b.numel()), dtype=b.dtype, device=dev)
                  for b in bufs)
        del bufs
        losses = torch.stack([_worker_grad(cfg, model, rows_of(batch, k), tc.microbatches,
                                           G[0][i] if tp is None else (G[0][i], G[1][i]))
                              for i, k in enumerate(mine)])
        local = tuple(g if dax is None else g[0] for g in G)
        del G
        shards = None
        if tp is None:
            local = local[0]
        else:
            shards = flat_shards(model, mesh)
        see("grads", candidates=local, losses=losses)
        if attacking:
            ra.apply_distributed_attack(
                local, axis, torch.as_tensor(mal_np, device=dev), tc.attack,
                attack_generator(state.step, dev), chunk_size=tc.agg.chunk_size,
                in_place=True, model_shards=shards)
        see("attack", candidates=local, agg_state=state.agg_state)
        agg, new_agg, info = ra.robust_allreduce(local, axis, tc.agg, state.agg_state,
                                                 model_shards=shards)
        del local
        see("allreduce", grads=agg, agg_state=new_agg, info=info)
        loss = ra.pmean(losses if dax is None else losses[0], axis)
        if tp is None:
            return finish(state, unravel_like(agg, module_tree(model)), new_agg, info, loss,
                          torch.sqrt((agg.to(torch.float32) ** 2).sum()))
        grads = tree_map(lambda l: l[0], unravel_rows_split(tuple(v[None] for v in agg), model))
        return finish(state, grads, new_agg, info, loss, grad_norm(grads, model))

    def gspmd_step(state: TrainState, batch):
        model = state.params
        _layout(model, mesh)
        loss, g = loss_and_grad(cfg, model, batch)
        g = _rounded(g, pdtype)
        see("grads", candidates=g, losses=loss[None])
        if tp is None:
            return finish(state, unravel_like(g, module_tree(model)), None, {}, loss,
                          torch.sqrt((g.to(torch.float32) ** 2).sum()))
        grads = tree_map(lambda l: l[0], unravel_rows_split(tuple(v[None] for v in g), model))
        return finish(state, grads, None, {}, loss, grad_norm(grads, model))

    def grid_step(state: TrainState, batch):
        model, tokens = state.params, batch["tokens"]
        dev = tokens.device
        dax = mesh.data_axis()
        with M.whole_block(model):
            bufs = _layout(model, mesh)
            G = tuple(torch.empty((b.numel(),), dtype=torch.float32, device=dev)
                      for b in bufs)
            del bufs
            loss = _worker_grad(cfg, model, rows_of(batch, dax.rank), tc.microbatches,
                                G[0] if tp is None else G)
        # the gathered model block is freed: the gradient alone goes out
        see("grads", candidates=G, losses=loss[None])
        send = F.pack_fsdp(model, G)
        del G
        cols = [(all_to_all_rows(m, dax.group) if split else all_gather_rows(m, dax.group))
                if m.numel() else m.new_zeros((K, 0))
                for m, split in zip(send, F.fsdp_split(model))]
        del send
        cand = F.unravel_fsdp(cols, model)
        del cols
        see("exchange", candidates=cand)
        shards = grid_shards(model, mesh)
        if attacking:
            ra.apply_stacked_attack(cand, torch.as_tensor(mal_np, device=dev), tc.attack,
                                    attack_generator(state.step, dev), in_place=True,
                                    model_shards=shards, chunk_size=tc.agg.chunk_size,
                                    dtype=pdtype)
        see("attack", candidates=cand, agg_state=state.agg_state)
        agg_cfg = RobustAggConfig(method="mean") if tc.mode == "gspmd" else tc.agg
        grads, new_agg, info = ra.robust_allreduce_stacked(cand, agg_cfg, state.agg_state,
                                                           model_shards=shards)
        grads = _rounded(grads, pdtype)
        del cand
        see("allreduce", grads=grads, agg_state=new_agg, info=info)
        gn = grid_norm(grads, shards)
        if not model.fsdp_blocks:
            grads = whole_aggregate(grads, model)
        if tc.mode == "gspmd":
            new_agg, info = None, {}
        return finish(state, grads, new_agg, info, ra.pmean(loss, dax.group), gn)

    def grid_norm(grads, shards) -> Tensor:
        """The aggregate's norm from the rank's blocks: each coordinate's
        square counted by the one rank that counts its column group, summed
        over the grid in rank order."""
        part = torch.zeros((), dtype=torch.float32, device=tree_leaves(grads)[0].device)
        for g, i in zip(tree_leaves(grads), shards.leaf_groups):
            if shards.counted[i]:
                part = part + (g.to(torch.float32) ** 2).sum()
        return torch.sqrt(L.all_reduce_model(part.reshape(1), shards.group)[0])

    def whole_aggregate(grads, model) -> Any:
        """The whole model block's aggregate from every data rank's blocks
        (one all-gather a column group), as the model's natural tree."""
        leaves = tree_leaves(grads)
        where = F.fsdp_leaf_groups(model)
        split = F.fsdp_split(model)
        mats = []
        for i, s_ in enumerate(split):
            mine = [l.reshape(-1) for l, g in zip(leaves, where) if g == i]
            vec = torch.cat(mine) if mine else leaves[0].new_zeros((0,))
            mats.append((all_gather_rows(vec, mesh.group) if vec.numel() else
                         vec.new_zeros((K, 0))) if s_ else vec)
        vecs = F.unpack_fsdp(model, mats)
        if tp is None:
            return unravel_like(vecs[0], module_tree(model))
        return tree_map(lambda l: l[0], unravel_rows_split(tuple(v[None] for v in vecs),
                                                            model))

    step = flat_step if _flat(tc) else grid_step if _on_grid(mesh, tc) else \
        gspmd_step if tc.mode == "gspmd" else stacked_step
    dims = shd.model_dims(cfg, mesh)

    def sharded(state: TrainState, batch):
        with use_sharding(mesh, rules, dims):
            return step(state, batch)

    return step if tp is None else sharded


def flat_shards(model, mesh: Mesh) -> ra.FlatShards:
    """A model rank's part of the whole flat gradient
    (``robust_allreduce.FlatShards``): its split and replicated buffers'
    places in the whole model's ravel, the replicated one counted on model
    rank 0, the partial statistics summed over the model group."""
    axis = mesh.model_axis()
    places, P = F.coord_places(model)
    return ra.FlatShards(group=axis.group, counted=(True, axis.rank == 0),
                         places=tuple(tuple(p) for p in places), size=P)


def grid_shards(model, mesh: Mesh) -> ra.GridShards:
    """A grid rank's column block's place (``robust_allreduce.GridShards``):
    its column groups (``core.flatten.fsdp_groups``), those it counts (the
    model-replicated ones on model rank 0, those whole over data on data
    rank 0), and each leaf's cuts over the model and the data axis."""
    dax = mesh.data_axis()
    maxis = mesh.model_axis()
    mrank = 0 if maxis is None else maxis.rank
    n = len(F.fsdp_split(model))
    counted = tuple((g % 2 == 0 or dax.rank == 0) and (g // 2 == 0 or mrank == 0)
                    for g in range(n))
    cuts = []
    for (path, _), mcut in zip(F.leaf_params(model), _model_cuts(model)):
        c = []
        if mcut is not None:
            c.append((mcut, maxis.size, maxis.rank))
        ddim = model.fsdp.dims[path]
        if ddim is not None:
            c.append((ddim, dax.size, dax.rank))
        cuts.append(tuple(c))
    return ra.GridShards(group=mesh.grid_group(), leaf_groups=tuple(F.fsdp_leaf_groups(model)),
                         counted=counted, cuts=tuple(cuts), whole=tuple(whole_shapes(model)))


def _rounded(tree, dtype: torch.dtype):
    """``tree``'s float32 leaves rounded to ``dtype`` (the parameters'), as
    the reference's gradients and aggregates are in it; the same tree for
    float32."""
    if dtype == torch.float32:
        return tree
    if isinstance(tree, tuple):
        return tuple(_rounded(t, dtype) for t in tree)
    return tree_map(lambda g: g.to(dtype), tree)
