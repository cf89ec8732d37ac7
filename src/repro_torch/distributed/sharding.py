"""Per-architecture partition specs of parameters, caches, batches and
activations (port of ``repro.distributed.sharding``).

A spec is a plain tuple with one entry per dim: a mesh axis name
(``"model"``, ``"data"``), a tuple of names (``("pod", "data")``) or None
(the counterpart of ``jax.sharding.PartitionSpec``).  Specs are derived
from the leaf's *name* (its last dictionary key) and rank, applied to the
TRAILING dims (leading stacked-layer dims fill with None).  Two modes:

  tp_only   parameters split over ``model`` only (replicated across the
            candidates), the robust-DP trainer's;
  fsdp      also the largest remaining big dim over ``data`` (``pod``
            folded in across pods): serving and the gspmd trainer.

The table is Megatron-style tensor parallelism: ``wq``/``wk``/``wv``/
``w_gate``/``w_up`` split by columns, ``wo``/``w_down`` by rows,
``embed`` on the vocab, ``unembed`` on its columns.  A tree is a nesting
of dicts and lists whose leaves have a ``shape`` (tensors, ``meta``
tensors, ``data.specs.TensorSpec``) or are Python numbers.

``shard_tensor`` cuts a rank's block out of a whole tensor and
``gather_tensor`` puts the blocks back together (in rank order, over the
data group, then over the model group); ``fsdp_dim`` names the dim of a
leaf that the FSDP rule splits over the data axes (the grid's training
and serving layout, ``core.flatten.layout_fsdp``).  The reference's ``shard_map_compat`` (a
``jax.shard_map`` shim across jax versions) has no counterpart: the port
runs one process per shard and names its collectives itself.

``tp_layout`` is what the port's layers hold, which is the spec except
where a split would cut a head: KV heads are replicated when ``n_kv_heads
% M != 0``, where the reference's GSPMD may split a head's columns (a
layout it pays for in collectives; the port's explicit collectives sit
at head boundaries).  ``tp_cut`` says how a rank's block sits in the
whole leaf where it is not one contiguous block of the spec's dim (the
port's two other deviations, named in ROADMAP queue 3):

  runs     a Mamba mixer's ``in_proj`` (d, 2 di) holds x's columns, then
           z's; the spec cuts the 2 di columns in M contiguous blocks (at
           M = 2 one rank all of x, the other all of z), the port gives
           rank r its block of x beside its block of z (two runs, each
           split over model), so that the mixer runs on the rank's di/M
           channels without an exchange;
  padded   a padded-head config (``pad_heads_to``) whose query heads M
           does not divide (Arctic's 56 at M = 16): ``wq``/``bq``/``wo``
           are zero-padded to ``pad_heads_to`` heads and each rank holds
           ``pad_heads_to / M`` of them, the live ones in order (the spec
           splits the 56 heads' columns mid-head).

``shard_tensor`` / ``gather_tensor`` / ``take_block`` take the cut and
invert each other bit for bit.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.logical import axis_size as _axis_size

Spec = Tuple[Any, ...]

# trailing-dim specs keyed by leaf name (without the 'model' axis resolved)
_TRAILING: Dict[str, Tuple[Optional[str], ...]] = {
    # attention
    "wq": (None, "model"), "wk": (None, "model"), "wv": (None, "model"),
    "wo": ("model", None),
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    # MLA
    "w_dkv": (None, None), "w_kr": (None, None),
    "w_uk": (None, "model"), "w_uv": (None, "model"), "kv_norm": (None,),
    # embeddings
    "embed": ("model", None), "unembed": (None, "model"),
    # router / norms / scalars
    "router": (None, None), "scale": (None,), "bias": (None,),
    "gnorm": ("model",), "dt_bias": ("model",), "D": ("model",),
    # mamba
    "in_proj": (None, "model"), "out_proj": ("model", None),
    "conv_w": (None, "model"), "conv_b": ("model",),
    "x_proj": ("model", None), "dt_proj": (None, "model"),
    "A_log": ("model", None), "bc_proj": ("model", None),
    # projector (vlm) / encoder input
    "w1": (None, "model"), "w2": ("model", None), "enc_in_proj": (None, None),
}

# dense-MLP vs MoE expert tensors share names; disambiguate by rank below.
_MLP2 = {"w_gate": (None, "model"), "w_up": (None, "model"), "w_down": ("model", None)}
_MOE3 = {"w_gate": ("model", None, None), "w_up": ("model", None, None),
         "w_down": ("model", None, None)}

_FSDP_MIN_DIM = 1024  # only shard dims at least this large over 'data'


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def _map_with_path(fn: Callable, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists; ``path`` the keys
    (str) and indices (int) from the root."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def prune_spec(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """Drop spec entries whose mesh-axis size does not divide the dim (the
    spec padded with None to the rank of ``shape``): a batch of 1 cannot
    split over data = 16, kv_heads = 4 cannot split over model = 16 (the
    KV cache is then replicated across TP shards, the standard GQA
    fallback)."""
    if mesh is None:
        return tuple(spec)
    out = []
    for i, ax in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        out.append(ax if shape[i] % _axis_size(mesh, ax) == 0 else None)
    return tuple(out)


def _leaf_name(path) -> str:
    for k in reversed(path):
        if isinstance(k, str):
            return k
    return ""


def _spec_for(name: str, shape: Tuple[int, ...], n_stack: int) -> Spec:
    """n_stack = how many leading dims are layer/group stacking."""
    trailing_rank = len(shape) - n_stack
    if name in ("w_gate", "w_up", "w_down"):
        tr = _MOE3[name] if trailing_rank == 3 else _MLP2[name]
    elif name in _TRAILING:
        tr = _TRAILING[name]
        tr = tr[-trailing_rank:] if trailing_rank <= len(tr) else \
            (None,) * (trailing_rank - len(tr)) + tr
    else:
        tr = (None,) * trailing_rank
    return (None,) * n_stack + tuple(tr)


def _count_stack_dims(name: str, shape: Tuple[int, ...],
                      cfg: Optional[ArchConfig] = None) -> int:
    """Infer leading stacked dims: total rank minus the natural rank."""
    if name in ("w_gate", "w_up", "w_down"):
        # dense (2) or expert (3): a rank-4 w_gate is stacked expert (1+3);
        # rank-3 is ambiguous (stacked dense (L,d,ff) vs unstacked expert
        # (E,d,ff)) — the config disambiguates: dense archs have no expert
        # tensors, and expert tensors lead with exactly n_experts.
        if len(shape) == 4:
            return 1
        if len(shape) == 3:
            if cfg is not None and cfg.n_experts and shape[0] == cfg.n_experts:
                return 0  # unstacked expert tensor
            return 1      # stacked dense MLP
        return 0
    base = {"scale": 1, "bias": 1, "bq": 1, "bk": 1, "bv": 1, "gnorm": 1,
            "dt_bias": 1, "D": 1, "conv_b": 1, "kv_norm": 1}.get(name, 2)
    return max(0, len(shape) - base)


def _data_axis(data_axes: Tuple[str, ...]):
    return data_axes if len(data_axes) > 1 else data_axes[0]


def leaf_spec(cfg: Optional[ArchConfig], name: str, shape: Tuple[int, ...],
              fsdp: bool = False, data_axes: Tuple[str, ...] = ("data",),
              mesh=None) -> Spec:
    """One parameter leaf's spec (``param_specs``'s per-leaf rule)."""
    n_stack = _count_stack_dims(name, shape, cfg)
    spec = list(_spec_for(name, shape, n_stack))
    if fsdp:
        # put 'data' on the largest unsharded trailing dim
        best, best_size = -1, _FSDP_MIN_DIM - 1
        for i in range(n_stack, len(shape)):
            if spec[i] is None and shape[i] > best_size:
                best, best_size = i, shape[i]
        if best >= 0:
            spec[best] = _data_axis(data_axes)
    return prune_spec(tuple(spec), shape, mesh)


def param_specs(cfg: ArchConfig, params_shape: Any, fsdp: bool = False,
                data_axes: Tuple[str, ...] = ("data",), mesh=None) -> Any:
    """A spec tree mirroring ``params_shape`` (the reference's tree: layers
    stacked on a leading axis, e.g. ``core.flatten.module_tree`` of a
    ``meta``-device model)."""
    return _map_with_path(
        lambda path, leaf: leaf_spec(cfg, _leaf_name(path), _shape(leaf), fsdp, data_axes,
                                     mesh), params_shape)


def cache_specs(cfg: ArchConfig, cache_shape: Any, data_axes: Tuple[str, ...] = ("data",),
                mesh=None) -> Any:
    """Decode-cache specs: batch over data, heads/inner over model."""
    data_axis = _data_axis(data_axes)

    def one(path, leaf) -> Spec:
        name = _leaf_name(path)
        shape = _shape(leaf)
        if name == "idx" or len(shape) == 0:
            return ()
        if name in ("k", "v"):        # (..., B, Hkv, cap, hd)
            lead = (None,) * (len(shape) - 4)
            mdl = "model" if cfg.n_kv_heads > 1 else None
            return lead + (data_axis, mdl, None, None)
        if name in ("ckv", "krope"):  # (..., B, cap, r)
            return (None,) * (len(shape) - 3) + (data_axis, None, None)
        if name == "conv":            # (..., B, kw-1, di)
            return (None,) * (len(shape) - 3) + (data_axis, None, "model")
        if name == "h":
            if cfg.ssm_variant == "mamba2":   # (..., B, Hm, p, n)
                return (None,) * (len(shape) - 4) + (data_axis, "model", None, None)
            return (None,) * (len(shape) - 3) + (data_axis, "model", None)  # (..., B, di, n)
        if name == "enc_out":         # (B, S_enc, d)
            return (data_axis, None, None)
        return (None,) * len(shape)

    return _map_with_path(lambda path, leaf: prune_spec(one(path, leaf), _shape(leaf), mesh),
                          cache_shape)


def batch_specs(batch_shape: Any, data_axes: Tuple[str, ...] = ("data",), mesh=None) -> Any:
    data_axis = _data_axis(data_axes)
    return _map_with_path(
        lambda path, leaf: prune_spec((data_axis,) + (None,) * (len(_shape(leaf)) - 1),
                                      _shape(leaf), mesh), batch_shape)


def activation_rules(mode: str, multi_pod: bool) -> Dict[str, Any]:
    """Logical-axis rules for ``distributed.logical.use_sharding``."""
    batch_axes = ("pod", "data") if multi_pod else "data"
    rules = {
        "heads": "model", "kv_heads": "model", "ff": "model",
        "vocab": "model", "expert": "model", "inner": "model",
        "embed": None, "seq": None,
    }
    if mode == "robust_dp":
        rules["batch"] = None          # batch axis is manual-local per node
    else:
        rules["batch"] = batch_axes
    return rules


# ---------------------------------------------------------------------------
# the port's own: what a rank holds, and moving between whole and shard
# ---------------------------------------------------------------------------

def model_dims(cfg: ArchConfig, mesh=None) -> Dict[str, int]:
    """The global sizes of the logical axes the layers annotate
    (``logical.shard`` checks the local extents against them): the query
    heads are the ``pad_heads_to`` head slots where the ranks hold slots
    (``padded_heads``); ``expert`` the routed experts, ``inner`` a Mamba
    mixer's ``d_inner`` channels."""
    slots = padded_heads(cfg, _axis_size(mesh, "model"))
    dims = {"heads": cfg.pad_heads_to if slots else cfg.n_heads, "kv_heads": cfg.n_kv_heads,
            "ff": cfg.d_ff, "vocab": cfg.vocab_size}
    if cfg.n_experts:
        dims["expert"] = cfg.n_experts
    if cfg.family in ("ssm", "hybrid"):
        dims["inner"] = cfg.d_inner_
    return dims


def tp_rules(cfg: ArchConfig, rules: Dict[str, Any], mesh) -> Dict[str, Any]:
    """``rules`` with every logical axis that the mesh axis it maps to does
    not divide mapped to None, as ``prune_spec`` replicates such dims (KV
    heads over a model axis that does not divide them)."""
    dims = model_dims(cfg, mesh)
    return {a: (None if a in dims and dims[a] % _axis_size(mesh, ax) else ax)
            for a, ax in rules.items()}

_KV = ("wk", "wv", "bk", "bv")
_HEADS = ("wq", "bq", "wo")


def padded_heads(cfg: ArchConfig, M: int) -> bool:
    """Whether a rank holds ``pad_heads_to / M`` head slots of the padded
    layout (``tp_cut``'s ``padded``): a padded-head config whose query
    heads M does not divide."""
    return bool(M > 1 and cfg.pad_heads_to and cfg.n_heads % M)


def tp_layout(cfg: ArchConfig, name: str, shape: Tuple[int, ...], mesh) -> Spec:
    """The spec of the block of a parameter leaf (``name``, whole ``shape``)
    that a rank of the model axis holds: ``param_specs``'s tp_only rule,
    with the KV projections replicated when ``n_kv_heads % M != 0``.  A
    query-head split that would cut a head raises, except for a
    padded-head config (``tp_cut``'s head slots); so does a split of the
    experts that leaves a rank none whole."""
    M = _axis_size(mesh, "model")
    if name in _HEADS and padded_heads(cfg, M):
        # the spec of the padded leaf: its head slots split over model
        hd = shape[1 if name == "wq" else 0] // cfg.n_heads
        shape = tuple(cfg.pad_heads_to * hd if i == (1 if name == "wq" else 0) else n
                      for i, n in enumerate(shape))
    spec = leaf_spec(cfg, name, shape, mesh=mesh)
    if M == 1:
        return spec
    if name in _KV and cfg.n_kv_heads % M:
        return (None,) * len(shape)
    if name in _HEADS and "model" in spec and cfg.n_heads % M and not cfg.pad_heads_to:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.n_heads} query heads do not split over model = {M}")
    if name in ("w_gate", "w_up", "w_down") and len(shape) == 3 and "model" not in spec:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.n_experts} experts do not split over model = {M}")
    return spec


class Cut(NamedTuple):
    """How a rank's block of a leaf split over ``model`` sits in the whole
    leaf: along ``dim``, the dim zero-padded to ``padded`` first (0: not
    padded), then cut into ``runs`` equal runs, each split into M blocks;
    the rank's block is its block of each run, concatenated."""

    dim: int
    runs: int = 1
    padded: int = 0

    def shifted(self, lead: int) -> "Cut":
        return self._replace(dim=self.dim + lead)


def tp_cut(cfg: ArchConfig, param: str, shape: Tuple[int, ...], mesh) -> Optional[Cut]:
    """The cut of a parameter (its dotted module name, e.g.
    ``layers.0.mixer.in_proj``; its whole per-layer ``shape``) on the model
    axis, or None where a rank holds it whole (see the module docstring)."""
    name = param.rsplit(".", 1)[-1]
    spec = tp_layout(cfg, name, shape, mesh)
    if "model" not in spec:
        return None
    dim = spec.index("model")
    runs = 2 if name == "in_proj" and f".{param}".endswith(".mixer.in_proj") else 1
    padded = 0
    if name in _HEADS and padded_heads(cfg, _axis_size(mesh, "model")):
        padded = cfg.pad_heads_to * (shape[dim] // cfg.n_heads)
    return Cut(dim, runs, padded)


def as_cut(cut: Union[int, Cut]) -> Cut:
    return cut if isinstance(cut, Cut) else Cut(cut)


def take_block(full: torch.Tensor, cut: Union[int, Cut], parts: int, part: int
               ) -> torch.Tensor:
    """Block ``part`` of ``parts`` of ``full`` along a ``Cut`` (an int: a
    plain split of that dim), a view where it can be."""
    cut = as_cut(cut)
    d = cut.dim
    if cut.padded and cut.padded != full.shape[d]:
        pad = [0, 0] * (full.ndim - 1 - d) + [0, cut.padded - full.shape[d]]
        full = torch.nn.functional.pad(full, pad)
    n = full.shape[d]
    if n % (cut.runs * parts):
        raise ValueError(f"dim {d} of {tuple(full.shape)} does not split into "
                         f"{cut.runs} x {parts}")
    if cut.runs == 1:
        step = n // parts
        return full.narrow(d, part * step, step)
    runs = full.unflatten(d, (cut.runs, parts, n // (cut.runs * parts)))
    return runs.select(d + 1, part).flatten(d, d + 1)


def join_blocks(blocks: Sequence[torch.Tensor], cut: Union[int, Cut],
                whole: int = 0) -> torch.Tensor:
    """The inverse of ``take_block``: the whole leaf from every rank's block
    in rank order; a padded dim cut back to ``whole``."""
    cut = as_cut(cut)
    d = cut.dim
    if cut.runs == 1:
        out = torch.cat(list(blocks), dim=d)
    else:
        runs = [b.unflatten(d, (cut.runs, b.shape[d] // cut.runs)) for b in blocks]
        out = torch.cat(runs, dim=d + 1).flatten(d, d + 1)
    if cut.padded and whole:
        out = out.narrow(d, 0, whole)
    return out


def _coords(rank: Union[int, Dict[str, int]]) -> Dict[str, int]:
    return {"model": rank} if isinstance(rank, int) else dict(rank)


def _block(axis, mesh, coords: Dict[str, int]) -> Tuple[int, int]:
    """(index, count) of a rank's block along a dim split over ``axis``."""
    names = axis if isinstance(axis, (tuple, list)) else (axis,)
    idx = 0
    for a in names:
        if a not in coords:
            raise ValueError(f"no coordinate on mesh axis {a!r} (given {coords})")
        idx = idx * int(mesh.shape[a]) + coords[a]
    return idx, _axis_size(mesh, axis)


def shard_tensor(full: torch.Tensor, spec: Spec, mesh,
                 rank: Union[int, Dict[str, int]], cut: Optional[Cut] = None
                 ) -> torch.Tensor:
    """The block of ``full`` that ``rank`` holds under ``spec`` (an int: the
    rank's index on the model axis; a dict: its index on each axis), a
    contiguous copy; ``cut`` (``tp_cut``) the model dim's, where it is not
    a plain split."""
    coords = _coords(rank)
    out = full
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        i, n = _block(ax, mesh, coords)
        mine = cut if (ax == "model" and cut is not None) else dim
        if as_cut(mine).padded == 0 and out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not split over {n}")
        out = take_block(out, mine, n, i)
    # a copy even where the block is a contiguous view (a split of the
    # leading dim): a view would keep the whole tensor's storage alive
    return out.clone(memory_format=torch.contiguous_format)


def gather_tensor(local: torch.Tensor, spec: Spec, mesh, cut: Optional[Cut] = None,
                  whole: int = 0) -> torch.Tensor:
    """The whole tensor from every rank's block (``local``, this rank's):
    each dim split over a data axis (``"data"``, ``("pod", "data")``)
    concatenated in rank order over ``mesh.group`` (the data group), then
    each dim split over ``model`` in rank order over ``mesh.model_group``
    (``join_blocks`` along ``cut``, a padded dim cut back to ``whole``);
    every rank gets it.  A dim split over a data axis the mesh runs in one
    process raises."""
    from repro_torch.distributed.spmd import all_gather_in_rank_order

    out = local
    for axes in ("data", "model"):
        for dim, ax in enumerate(spec):
            if ax is None or _axis_size(mesh, ax) == 1 or (ax == "model") != (axes == "model"):
                continue
            group = getattr(mesh, "model_group" if ax == "model" else "group", None)
            if group is None:
                raise ValueError(f"dim {dim} is split over {ax!r}, which the mesh runs in "
                                 "one process")
            mine = cut if (ax == "model" and cut is not None) else dim
            out = join_blocks(all_gather_in_rank_order(out, group), mine, whole)
    return out


def fsdp_dim(cfg: Optional[ArchConfig], name: str, shape: Tuple[int, ...],
             data_axes: Tuple[str, ...], mesh) -> Optional[int]:
    """The dim of a parameter leaf (``name``, its whole ``shape``, layers
    stacked) that ``param_specs(fsdp=True)`` splits over the data axes, or
    None where it leaves the leaf whole over them (no dim of at least
    ``_FSDP_MIN_DIM`` free of ``model``, or one the data size does not
    divide)."""
    spec = leaf_spec(cfg, name, shape, fsdp=True, data_axes=data_axes, mesh=mesh)
    dax = _data_axis(data_axes)
    return spec.index(dax) if dax in spec else None
