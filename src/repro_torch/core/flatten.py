"""Tree <-> flat-vector utilities (port of ``repro.core.flatten``).

A tree is a nesting of dicts and lists whose leaves are tensors.  Its leaf
order is ``jax.tree.leaves``'s (a dict's keys sorted, a list in index
order, depth first), so a raveled tree is ``ravel_pytree``'s vector.  A
``DecoderLM`` stands for the reference's parameter tree (``module_tree``):
each stacked leaf ``layers/<path>`` holds layer 0's tensor, then layer
1's, and so on, the order in which ``models.model.params_from_jax``
unstacks it (an encoder-decoder's ``enc_layers/<path>`` likewise); an
MoE model's ``prefix_layers`` is a list of block trees, after ``layers``
(sorted keys), ordered by their integer index; a hybrid's
``shared_attn`` is one unstacked tree, after ``layers``.  Keys sort as
Python strings, capitals first (a Mamba mixer's ``A_log``, ``D``, then
``bc_proj``, ...), as ``jax.tree.leaves`` sorts them.

``layout_flat`` puts a module's parameters into one (P,) buffer in that
order, each parameter a view of it, so that raveling the model, its
gradient and its optimizer step need no copies: ``module_tree`` of such a
module is a tree of views of the buffer, the stacked leaves included.

On the model axis (a model cut by ``models.model.cut_model_``)
``layout_split`` puts a rank's parameters into two buffers instead, each
in ravel order: the leaves split over the model axis (P_s,) and the
replicated ones (P_r,): norm scales and biases, and the KV projections
where M does not divide the KV heads.  ``module_tree`` then gives views
of both, and ``unravel_rows_split`` lays (K, P_s) and (K, P_r) candidate
matrices out as one candidate tree.  ``coord_places`` says where each
leaf's block sits in the whole model's ravel, and ``global_index`` turns
a range of a buffer's columns into the whole ravel's indices (the flat
all-reduce's count-sketch and noise draws on the model axis).

On the data axis as processes (a grid of K x M ranks) a rank holds its
FSDP blocks (``layout_fsdp``): each leaf split over the data axis at the
dim ``FSDPLayout.dims`` names (``distributed.sharding.fsdp_dim``, the
reference's ``param_specs(fsdp=True)`` rule) keeps its data rank's 1/K
slice, the rest whole.  The leaves fall into column groups
(``fsdp_groups``): per natural buffer (the one buffer at M = 1; the split
and the replicated buffer on the model axis) the leaves split over data,
then those whole over it, each in ravel order.  A group's block buffer
holds, leaf after leaf, each leaf's layers' blocks in layer order, so a
stacked leaf's block is a view (L, *block) of it.  ``pack_fsdp`` turns a
whole model block's values (its natural buffers, e.g. a gradient) into
each group's block order, a (K, D) matrix whose row j is data rank j's
blocks (the ``all_to_all`` send buffer), and ``unpack_fsdp`` the gathered
rows back; ``unravel_fsdp`` lays such matrices (or one rank's (D,) rows)
out as a tree.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# trees of dicts
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> List[Tensor]:
    """The leaves in the reference's order (sorted keys, lists in order,
    depth first)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_unflatten(tree, leaves: List[Tensor]):
    """A tree shaped like ``tree`` with ``leaves`` in ``tree_leaves`` order."""
    return _build(tree, iter(leaves))


def _build(tree, it):
    # a module-level function: a nested recursive closure would form a
    # reference cycle holding the leaves until the garbage collector runs
    if isinstance(tree, dict):
        return {k: _build(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_build(node, it) for node in tree]
    return next(it)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, node, *(r[i] for r in rest)) for i, node in enumerate(tree)]
    return fn(tree, *rest)


def tree_size(tree) -> int:
    return sum(int(x.numel()) for x in tree_leaves(_as_tree(tree)))


def tree_bytes(tree) -> int:
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(_as_tree(tree)))


# ---------------------------------------------------------------------------
# a DecoderLM as the reference's tree
# ---------------------------------------------------------------------------

Path = Tuple[object, ...]     # dict keys (str) and list indices (int)

# the module lists that stand for a stacked leading L axis of the tree
STACKED = ("layers", "enc_layers")


def leaf_params(model: nn.Module) -> List[Tuple[Path, List[nn.Parameter]]]:
    """(reference path, the module's parameters of that leaf) in ravel
    order; a ``layers.<i>.<path>`` parameter joins leaf ``layers/<path>``
    at position i (``enc_layers`` likewise); a ``prefix_layers.<i>.<path>``
    parameter is leaf ``("prefix_layers", i, *path)`` of the list."""
    groups: Dict[Path, Dict[Optional[int], nn.Parameter]] = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] in STACKED and parts[1].isdigit():
            groups.setdefault((parts[0],) + tuple(parts[2:]), {})[int(parts[1])] = p
        elif parts[0] == "prefix_layers":
            groups[("prefix_layers", int(parts[1])) + tuple(parts[2:])] = {None: p}
        else:
            groups[tuple(parts)] = {None: p}
    out = []
    for path in sorted(groups):
        g = groups[path]
        if None not in g and sorted(g) != list(range(len(g))):
            raise ValueError(f"{'/'.join(path)}: layers {sorted(g)} are not 0..L-1")
        out.append((path, [g[i] for i in sorted(g, key=lambda i: -1 if i is None else i)]))
    return out


def leaf_shape(path: Path, params: List[nn.Parameter]) -> Tuple[int, ...]:
    """The reference tree's shape of a leaf of the module's parameters."""
    shape = tuple(params[0].shape)
    return (len(params),) + shape if path[0] in STACKED else shape


def module_params(model: nn.Module) -> List[nn.Parameter]:
    """The module's parameters in the ravel order of the reference's tree."""
    return [p for _, ps in leaf_params(model) for p in ps]


def _run(params: List[Tensor]) -> Optional[Tensor]:
    """The 1-D buffer whose consecutive views ``params`` are, in order, or
    None if they are not."""
    first = params[0]
    ptr, off = first.untyped_storage().data_ptr(), first.storage_offset()
    for p in params:
        if (p.untyped_storage().data_ptr() != ptr or p.storage_offset() != off
                or p.dtype != first.dtype or not p.is_contiguous()):
            return None
        off += p.numel()
    return first.detach().as_strided((off - first.storage_offset(),), (1,),
                                     first.storage_offset())


def flat_buffer(model: nn.Module) -> Optional[Tensor]:
    """The (P,) buffer whose views the module's parameters are, in ravel
    order, or None if they are not laid out so (``layout_flat``)."""
    return _run(module_params(model))


def _lay_out(params: List[nn.Parameter], like: Tensor) -> Tensor:
    """``params`` made consecutive views of one new buffer, in order (an
    empty buffer for none)."""
    flat = (torch.cat([p.detach().reshape(-1) for p in params]) if params
            else torch.empty((0,), dtype=like.dtype, device=like.device))
    off = 0
    for p in params:
        p.data = flat[off:off + p.numel()].view(p.shape)
        off += p.numel()
    return flat


def layout_flat(model: nn.Module) -> Tensor:
    """Lay the module's parameters out in one (P,) buffer in ravel order and
    make each parameter a view of it (one copy, the first time); returns
    the buffer."""
    flat = flat_buffer(model)
    if flat is not None:
        return flat
    params = module_params(model)
    return _lay_out(params, params[0])


def split_groups(model: nn.Module):
    """The reference tree's leaves of a model cut over the model axis, in
    ravel order, as two lists of (path, parameters): the leaves split over
    the model axis, then the replicated ones (``model.tp_specs``); every
    leaf replicated on a whole model."""
    specs = getattr(model, "tp_specs", {})
    split = {id(p) for name, p in model.named_parameters() if "model" in specs.get(name, ())}
    groups = leaf_params(model)
    return ([g for g in groups if id(g[1][0]) in split],
            [g for g in groups if id(g[1][0]) not in split])


def layout_split(model: nn.Module) -> Tuple[Tensor, Tensor]:
    """Lay a model rank's parameters out in two buffers, each in ravel
    order (one copy each, the first time): the split leaves (P_s,) and the
    replicated ones (P_r,); every parameter a view of one of them."""
    out = []
    first = module_params(model)[0]
    for groups in split_groups(model):
        params = [p for _, ps in groups for p in ps]
        run = _run(params) if params else None
        out.append(run if run is not None else _lay_out(params, first))
    return out[0], out[1]


def module_tree(model: nn.Module) -> dict:
    """The reference's parameter tree of a ``DecoderLM`` (layers stacked on
    a leading L axis): each leaf a view of its buffer when its parameters
    are consecutive views of one (``layout_flat``, ``layout_split``), a
    stacked copy otherwise."""
    tree: dict = {}
    for path, ps in leaf_params(model):
        run = _run(ps)
        if run is not None:
            leaf = run.view(leaf_shape(path, ps))
        elif path[0] in STACKED:
            leaf = torch.stack([p.detach() for p in ps])
        else:
            leaf = ps[0].detach()
        _put(tree, path, leaf)
    return _listify(tree)


def split_dims(model: nn.Module) -> List[Optional[int]]:
    """Per leaf of ``module_tree(model)``, in ravel order, the dim split over
    the model axis (a stacked leaf's L axis counted), or None for a
    replicated leaf."""
    specs = getattr(model, "tp_specs", {})
    names = {id(p): name for name, p in model.named_parameters()}
    out = []
    for path, ps in leaf_params(model):
        spec = specs.get(names[id(ps[0])], ())
        dim = spec.index("model") if "model" in spec else None
        out.append(None if dim is None else dim + (1 if path[0] in STACKED else 0))
    return out


def split_cuts(model: nn.Module) -> List[Optional[Tuple[object, int]]]:
    """Per leaf of ``module_tree(model)``, in ravel order, (its cut over the
    model axis, ``distributed.sharding.Cut`` with a stacked leaf's L axis
    counted; the whole extent of that dim) or None for a replicated leaf."""
    cuts = getattr(model, "tp_cuts", {})
    names = {id(p): name for name, p in model.named_parameters()}
    out = []
    for path, ps in leaf_params(model):
        c = cuts.get(names[id(ps[0])])
        if c is not None and path[0] in STACKED:
            c = (c[0]._replace(dim=c[0].dim + 1), c[1])
        out.append(c)
    return out


def pad_tails(model: nn.Module) -> List[Optional[Tuple[int, int]]]:
    """Per leaf of ``module_tree(model)``, in ravel order, (dim, live) where
    this model rank's block of it holds pad head slots of a padded layout
    (``distributed.sharding.padded_heads``): along ``dim`` (a stacked leaf's
    L axis counted) the block's first ``live`` entries are live and the
    rest pad slots, which the whole leaf does not have; None for a leaf
    without pad slots."""
    tp = getattr(model, "tp", None)
    out = []
    for (path, ps), c in zip(leaf_params(model), split_cuts(model)):
        if c is None or not c[0].padded:
            out.append(None)
            continue
        cut, n = c
        nb = leaf_shape(path, ps)[cut.dim]
        live = max(0, min(nb, n - tp.rank * nb))
        out.append((cut.dim, live) if live < nb else None)
    return out


class CoordPlace(NamedTuple):
    """Where a leaf's block, as a model rank holds it in one of its buffers,
    sits in the whole model's ravel (``layout_flat`` order): the block is
    ``buffer[start:start + size]``; the whole leaf's first coordinate is
    ``offset``, its dims collapse to (outer, n, inner) around the cut dim
    of ``n`` values, which is cut into ``runs`` runs each split into
    ``parts`` blocks, and the rank holds block ``part`` of each run (a
    ``distributed.sharding.Cut``); a leaf the rank holds whole has outer
    1, n its size, inner 1, one run, one part.  A padded cut (head slots
    of a padded layout) splits the dim padded to ``padded`` values: the
    block's entries past the n live ones are pad slots, which have no
    place in the whole ravel."""

    start: int
    size: int
    offset: int
    outer: int
    n: int
    inner: int
    runs: int = 1
    parts: int = 1
    part: int = 0
    padded: int = 0


def coord_places(model: nn.Module) -> Tuple[List[List[CoordPlace]], int]:
    """Per natural buffer of a model cut over the model axis (the split and
    the replicated buffer, ``layout_split``), the places of its leaves'
    blocks in the whole model's ravel, in buffer order; and the whole
    model's size P.  Each place is a handful of ints: a coordinate's index
    is computed when it is needed (``global_index``), never stored."""
    axis = model.tp
    split_paths = {path for path, _ in split_groups(model)[0]}
    places: List[List[CoordPlace]] = [[], []]
    starts = [0, 0]
    offset = 0
    for (path, ps), c in zip(leaf_params(model), split_cuts(model)):
        shape = leaf_shape(path, ps)
        size = math.prod(shape)
        b = 0 if path in split_paths else 1
        if (c is None) != (b == 1):
            raise ValueError(f"{'/'.join(map(str, path))}: its cut and its buffer disagree")
        if c is None:
            place = CoordPlace(starts[b], size, offset, 1, size, 1)
        else:
            cut, n = c
            d = cut.dim
            if shape[d] * axis.size != (cut.padded or n):
                raise ValueError(f"{'/'.join(map(str, path))}: a block of {shape[d]} of {n} "
                                 f"values at model = {axis.size}")
            place = CoordPlace(starts[b], size, offset, math.prod(shape[:d]), n,
                               math.prod(shape[d + 1:]), cut.runs, axis.size, axis.rank,
                               cut.padded)
        places[b].append(place)
        starts[b] += size
        offset += place.outer * place.n * place.inner
    return places, offset


def global_index(places: Sequence[CoordPlace], a: int, b: int, device=None) -> Tensor:
    """The whole model's ravel index (int64) of columns [a, b) of a rank's
    buffer whose leaves sit at ``places`` (``coord_places``), computed from
    each leaf's place, -1 for a pad head slot: one transient of b - a
    ints."""
    out = []
    for pl in places:
        lo, hi = max(a, pl.start), min(b, pl.start + pl.size)
        if lo >= hi:
            continue
        e = torch.arange(lo - pl.start, hi - pl.start, dtype=torch.int64, device=device)
        nb = (pl.padded or pl.n) // pl.parts    # the block's extent of the cut dim
        run = nb // pl.runs                     # its extent of one run
        o = torch.div(e, nb * pl.inner, rounding_mode="floor")
        r = e - o * (nb * pl.inner)
        j = torch.div(r, pl.inner, rounding_mode="floor")
        i = r - j * pl.inner
        jr = torch.div(j, run, rounding_mode="floor")
        wj = jr * (pl.n // pl.runs) + pl.part * run + (j - jr * run)
        idx = pl.offset + (o * pl.n + wj) * pl.inner + i
        out.append(torch.where(wj < pl.n, idx, torch.full_like(idx, -1)) if pl.padded else idx)
    if not out:
        return torch.zeros((0,), dtype=torch.int64, device=device)
    return torch.cat(out) if len(out) > 1 else out[0]


def unravel_rows_split(mats: Tuple[Tensor, Tensor], model: nn.Module) -> dict:
    """The candidate tree of a model rank (leading K axis) whose split
    leaves are views of ``mats[0]`` (K, P_s) and whose replicated leaves
    are views of ``mats[1]`` (K, P_r), each in ravel order."""
    tree: dict = {}
    for mat, groups in zip(mats, split_groups(model)):
        K, off = mat.shape[0], 0
        for path, ps in groups:
            shape = leaf_shape(path, ps)
            n = math.prod(shape)
            _put(tree, path, mat[:, off:off + n].view((K,) + shape))
            off += n
        if off != mat.shape[1]:
            raise ValueError(f"the matrix has {mat.shape[1]} columns, the leaves {off}")
    return _listify(tree)


def _put(tree: dict, path: Path, leaf: Tensor) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def _listify(tree):
    """A tree built by ``_put`` with its integer-keyed dicts made lists."""
    if not isinstance(tree, dict):
        return tree
    if tree and all(isinstance(k, int) for k in tree):
        if sorted(tree) != list(range(len(tree))):
            raise ValueError(f"list indices {sorted(tree)} are not 0..n-1")
        return [_listify(tree[i]) for i in range(len(tree))]
    return {k: _listify(v) for k, v in tree.items()}


def _paths(tree, prefix=()) -> List[Tuple[Path, Tensor]]:
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _paths(tree[k], prefix + (k,))]
    if isinstance(tree, list):
        return [pl for i, node in enumerate(tree) for pl in _paths(node, prefix + (i,))]
    return [(prefix, tree)]


def _unravel(vec: Tensor, spec: List[Tuple[Path, Tuple[int, ...]]]) -> dict:
    """The tree of ``spec`` (path, shape) whose leaves are views of ``vec``."""
    sizes = [math.prod(shape) for _, shape in spec]
    tree: dict = {}
    for (path, shape), part in zip(spec, vec.split(sizes)):
        _put(tree, path, part.view(shape))
    return _listify(tree)


def _as_tree(tree):
    return module_tree(tree) if isinstance(tree, nn.Module) else tree


# ---------------------------------------------------------------------------
# ravel
# ---------------------------------------------------------------------------

def tree_ravel(tree) -> Tuple[Tensor, Callable[[Tensor], dict]]:
    """Flatten a tree (or a ``DecoderLM``, as its reference tree) to
    ``(vec, unravel)``: ``vec`` the leaves in order, concatenated;
    ``unravel(v)`` the tree whose leaves are views of ``v``."""
    tree = _as_tree(tree)
    pl = _paths(tree)
    spec = [(p, tuple(leaf.shape)) for p, leaf in pl]
    vec = torch.cat([leaf.reshape(-1) for _, leaf in pl])
    return vec, lambda v: _unravel(v, spec)


def tree_stack_ravel(trees) -> Tuple[Tensor, Callable[[Tensor], dict]]:
    """Stack a list of trees into a (K, d) matrix + the shared unravel."""
    vecs, unravel = [], None
    for t in trees:
        v, unravel = tree_ravel(t)
        vecs.append(v)
    return torch.stack(vecs), unravel


def vmap_ravel(batched_tree) -> Tuple[Tensor, Callable[[Tensor], dict]]:
    """Ravel a tree whose leaves carry a leading axis K -> (K, d), and the
    unravel of one (d,) row into an unbatched tree."""
    pl = _paths(batched_tree)
    K = pl[0][1].shape[0]
    spec = [(p, tuple(leaf.shape[1:])) for p, leaf in pl]
    mat = torch.cat([leaf.reshape(K, -1) for _, leaf in pl], dim=1)
    return mat, lambda v: _unravel(v, spec)


def unravel_like(vec: Tensor, like) -> dict:
    """The tree of ``like`` whose leaves are views of the (P,) vector, in
    ravel order."""
    return _unravel(vec, [(p, tuple(leaf.shape)) for p, leaf in _paths(_as_tree(like))])


def unravel_rows(mat: Tensor, like) -> dict:
    """The tree of ``like`` (unbatched leaves) with a leading K axis, its
    leaves views of the (K, P) matrix's column blocks in ravel order: the
    candidate layout of the trainer's stacked gradients."""
    pl = _paths(_as_tree(like))
    P = sum(leaf.numel() for _, leaf in pl)
    if P != mat.shape[1]:
        raise ValueError(f"the matrix has {mat.shape[1]} columns, the tree {P} values")
    K = mat.shape[0]
    tree: dict = {}
    off = 0
    for path, leaf in pl:
        n = leaf.numel()
        _put(tree, path, mat[:, off:off + n].view((K,) + tuple(leaf.shape)))
        off += n
    return _listify(tree)


# ---------------------------------------------------------------------------
# FSDP blocks over the data axis
# ---------------------------------------------------------------------------

class FSDPLayout(NamedTuple):
    """A model block's place on the data axis: K (``size``), this rank's
    index (``rank``), per leaf path the dim of its stacked leaf split over
    the data axis or None (``dims``), and each leaf's per-layer shape in the
    whole model block (``shapes``)."""

    size: int
    rank: int
    dims: Dict[Path, Optional[int]]
    shapes: Dict[Path, Tuple[int, ...]]


def _layer_dim(path: Path, dim: Optional[int]) -> Optional[int]:
    """A stacked leaf's dim as its per-layer parameter's."""
    if dim is None:
        return None
    return dim - 1 if path[0] in STACKED else dim


def _natural_sets(model: nn.Module) -> List[List[Tuple[Path, List[nn.Parameter]]]]:
    """The leaves of each natural buffer, in ravel order: one at M = 1; the
    split and the replicated leaves on the model axis."""
    if getattr(model, "tp", None) is None:
        return [leaf_params(model)]
    return list(split_groups(model))


def fsdp_groups(model: nn.Module) -> List[List[Tuple[Path, List[nn.Parameter]]]]:
    """The column groups (``model.fsdp``'s): per natural buffer its leaves
    split over the data axis, then those whole over it, in ravel order."""
    dims = model.fsdp.dims
    out = []
    for leaves in _natural_sets(model):
        out.append([(p, ps) for p, ps in leaves if dims[p] is not None])
        out.append([(p, ps) for p, ps in leaves if dims[p] is None])
    return out


def fsdp_split(model: nn.Module) -> List[bool]:
    """Per column group, whether its leaves are split over the data axis."""
    return [g % 2 == 0 for g in range(2 * len(_natural_sets(model)))]


def _block_shape(lay: FSDPLayout, path: Path) -> Tuple[int, ...]:
    shape = list(lay.shapes[path])
    d = _layer_dim(path, lay.dims[path])
    if d is not None:
        shape[d] //= lay.size
    return tuple(shape)


def _point(model: nn.Module, bufs: Sequence[Tensor]) -> None:
    """Every parameter a view of its column group's block buffer."""
    lay = model.fsdp
    for buf, group in zip(bufs, fsdp_groups(model)):
        off = 0
        for path, ps in group:
            shape = _block_shape(lay, path)
            n = math.prod(shape)
            for p in ps:
                p.data = buf[off:off + n].view(shape)
                off += n
        if off != buf.numel():
            raise ValueError(f"a block buffer of {buf.numel()} values, its leaves {off}")
    model.fsdp_blocks = True


def layout_fsdp(model: nn.Module, layout: FSDPLayout) -> Tuple[Tensor, ...]:
    """Keep, of a whole model block, the FSDP blocks of data rank
    ``layout.rank``: each column group's blocks in one new buffer, every
    parameter a view of it (``model.fsdp`` = ``layout``); returns the
    buffers."""
    model.fsdp = layout
    first = module_params(model)[0]
    bufs = []
    for group in fsdp_groups(model):
        parts = []
        for path, ps in group:
            d = _layer_dim(path, layout.dims[path])
            for p in ps:
                x = p.detach()
                if d is not None:
                    n = x.shape[d] // layout.size
                    x = x.narrow(d, layout.rank * n, n)
                parts.append(x.reshape(-1))
        bufs.append(torch.cat(parts) if parts else
                    torch.empty((0,), dtype=first.dtype, device=first.device))
    _point(model, bufs)
    return tuple(bufs)


def fsdp_buffers(model: nn.Module) -> Tuple[Tensor, ...]:
    """The column groups' block buffers whose views the parameters are
    (``layout_fsdp``)."""
    first = module_params(model)[0]
    out = []
    for group in fsdp_groups(model):
        ps = [p for _, g in group for p in g]
        run = _run(ps) if ps else torch.empty((0,), dtype=first.dtype, device=first.device)
        if run is None:
            raise ValueError("the parameters are not views of their FSDP block buffers")
        out.append(run)
    return tuple(out)


def point_fsdp_(model: nn.Module, bufs: Sequence[Tensor]) -> None:
    """Make the parameters views of the block buffers ``bufs`` again."""
    _point(model, bufs)


def _entries(model: nn.Module):
    """Per natural buffer b: its leaves in ravel order as (path, params,
    per-layer dim split over data or None, per-layer shape, column group)."""
    lay = model.fsdp
    for b, leaves in enumerate(_natural_sets(model)):
        yield b, [(path, ps, _layer_dim(path, lay.dims[path]), lay.shapes[path],
                   2 * b + (0 if lay.dims[path] is not None else 1)) for path, ps in leaves]


def fsdp_widths(model: nn.Module) -> List[int]:
    """Per column group, the values of a rank's blocks (D)."""
    K = model.fsdp.size
    split = fsdp_split(model)
    widths = [0] * len(split)
    for _, leaves in _entries(model):
        for path, ps, d, shape, g in leaves:
            widths[g] += math.prod(shape) * len(ps) // (K if split[g] else 1)
    return widths


def pack_fsdp(model: nn.Module, vecs: Sequence[Tensor]) -> List[Tensor]:
    """A whole model block's values in its natural buffers ``vecs`` (one at
    M = 1, split and replicated on the model axis, each in ravel order)
    in block order: per column group a (K, D) matrix whose row j holds data
    rank j's blocks (split groups), or the (D,) values (whole groups)."""
    K = model.fsdp.size
    split = fsdp_split(model)
    widths = fsdp_widths(model)
    v0 = vecs[0]
    out = [torch.empty((K, w) if s else (w,), dtype=v0.dtype, device=v0.device)
           for w, s in zip(widths, split)]
    offs = [0] * len(split)
    for b, leaves in _entries(model):
        off = 0
        for path, ps, d, shape, g in leaves:
            n = math.prod(shape)
            for _ in ps:
                src = vecs[b][off:off + n].view(shape)
                if d is None:
                    out[g][offs[g]:offs[g] + n].copy_(src.reshape(-1))
                    offs[g] += n
                else:
                    m = n // K
                    blk = list(shape)
                    blk[d] //= K
                    out[g][:, offs[g]:offs[g] + m].view([K] + blk).copy_(
                        src.unflatten(d, (K, shape[d] // K)).movedim(d, 0))
                    offs[g] += m
                off += n
    return out


def unpack_fsdp(model: nn.Module, mats: Sequence[Tensor]) -> List[Tensor]:
    """The inverse of ``pack_fsdp``: the natural buffers of the whole model
    block from every column group's gathered rows ((K, D), split groups) or
    values ((D,), whole groups)."""
    K = model.fsdp.size
    m0 = mats[0]
    out = []
    for b, leaves in _entries(model):
        total = sum(math.prod(shape) * len(ps) for _, ps, _, shape, _ in leaves)
        vec = torch.empty((total,), dtype=m0.dtype, device=m0.device)
        out.append(vec)
    offs = [0] * len(mats)
    for b, leaves in _entries(model):
        off = 0
        for path, ps, d, shape, g in leaves:
            n = math.prod(shape)
            for _ in ps:
                dst = out[b][off:off + n].view(shape)
                if d is None:
                    dst.copy_(mats[g][offs[g]:offs[g] + n].view(shape))
                    offs[g] += n
                else:
                    m = n // K
                    blk = list(shape)
                    blk[d] //= K
                    dst.unflatten(d, (K, shape[d] // K)).movedim(d, 0).copy_(
                        mats[g][:, offs[g]:offs[g] + m].view([K] + blk))
                    offs[g] += m
                off += n
    return out


def unpack_fsdp_(model: nn.Module, mats: Sequence[Tensor]) -> List[Tensor]:
    """``unpack_fsdp``, and every parameter made a view of the natural
    buffers it returns (the whole model block, in ravel order)."""
    vecs = unpack_fsdp(model, mats)
    for vec, leaves in zip(vecs, _natural_sets(model)):
        off = 0
        for path, ps in leaves:
            shape = model.fsdp.shapes[path]
            n = math.prod(shape)
            for p in ps:
                p.data = vec[off:off + n].view(shape)
                off += n
    model.fsdp_blocks = False
    return vecs


def unravel_fsdp(mats: Sequence[Tensor], model: nn.Module) -> dict:
    """The tree of the column groups' matrices: (K', D) rows (a leading axis
    of K' candidates) or (D,) values per group, each leaf a view (K', *leaf
    block) or (*leaf block) in the group's block order."""
    lay = model.fsdp
    tree: dict = {}
    for mat, group in zip(mats, fsdp_groups(model)):
        lead = tuple(mat.shape[:-1])
        off = 0
        for path, ps in group:
            blk = _block_shape(lay, path)
            shape = (len(ps),) + blk if path[0] in STACKED else blk
            n = math.prod(shape)
            _put(tree, path, mat[..., off:off + n].view(lead + shape))
            off += n
        if off != mat.shape[-1]:
            raise ValueError(f"the matrix has {mat.shape[-1]} columns, the leaves {off}")
    return _listify(tree)


def fsdp_leaf_groups(model: nn.Module) -> List[int]:
    """Per leaf of ``unravel_fsdp``'s tree (ravel order), its column group."""
    where = {}
    for g, group in enumerate(fsdp_groups(model)):
        for path, _ in group:
            where[path] = g
    return [where[path] for path, _ in leaf_params(model)]
