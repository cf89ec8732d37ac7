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
at head boundaries).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

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

def model_dims(cfg: ArchConfig) -> Dict[str, int]:
    """The global sizes of the logical axes the dense family's layers
    annotate (``logical.shard`` checks the local extents against them)."""
    return {"heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads, "ff": cfg.d_ff,
            "vocab": cfg.vocab_size}


def tp_rules(cfg: ArchConfig, rules: Dict[str, Any], mesh) -> Dict[str, Any]:
    """``rules`` with every logical axis that the mesh axis it maps to does
    not divide mapped to None, as ``prune_spec`` replicates such dims (KV
    heads over a model axis that does not divide them)."""
    dims = model_dims(cfg)
    return {a: (None if a in dims and dims[a] % _axis_size(mesh, ax) else ax)
            for a, ax in rules.items()}

_KV = ("wk", "wv", "bk", "bv")
_HEADS = ("wq", "bq", "wo")


def tp_layout(cfg: ArchConfig, name: str, shape: Tuple[int, ...], mesh) -> Spec:
    """The spec of the block of a parameter leaf (``name``, whole ``shape``)
    that a rank of the model axis holds: ``param_specs``'s tp_only rule,
    with the KV projections replicated when ``n_kv_heads % M != 0``.  A
    query-head split that would cut a head raises."""
    spec = leaf_spec(cfg, name, shape, mesh=mesh)
    M = _axis_size(mesh, "model")
    if M == 1:
        return spec
    if name in _KV and cfg.n_kv_heads % M:
        return (None,) * len(shape)
    if name in _HEADS and "model" in spec and cfg.n_heads % M:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.n_heads} query heads do not split over model = {M}")
    return spec


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
                 rank: Union[int, Dict[str, int]]) -> torch.Tensor:
    """The block of ``full`` that ``rank`` holds under ``spec`` (an int: the
    rank's index on the model axis; a dict: its index on each axis), a
    contiguous copy."""
    coords = _coords(rank)
    out = full
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        i, n = _block(ax, mesh, coords)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not split over {n}")
        step = out.shape[dim] // n
        out = out.narrow(dim, i * step, step)
    return out.contiguous()


def gather_tensor(local: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block (``local``, this rank's):
    each dim split over a data axis (``"data"``, ``("pod", "data")``)
    concatenated in rank order over ``mesh.group`` (the data group), then
    each dim split over ``model`` in rank order over ``mesh.model_group``;
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
            out = torch.cat(all_gather_in_rank_order(out, group), dim=dim)
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
