"""The port's partition specs (``repro_torch.distributed.sharding``) and
launch choices (``repro_torch.launch.specs``) against the reference's, for
every architecture of the reference's registry.

Shapes come from ``jax.eval_shape(init_params)`` / the reference's
``cache_shapes`` on one side and the port's ``meta``-device init /
``cache_shapes`` on the other.  The reference's functions get a stand-in
mesh with only ``.shape``, which is all ``prune_spec`` and ``_axis_size``
read (nothing of the JAX package changes).  Specs compare as tuples
(``PartitionSpec`` is a tuple)."""
import functools

import jax
import pytest
from jax.sharding import PartitionSpec

from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.data import specs as jdata
from repro.distributed import sharding as jshd
from repro.launch import specs as jspecs
from repro.models import model as JM
from repro.train import serve as jsv
from repro_torch.configs import registry as treg
from repro_torch.configs import shapes as tshapes
from repro_torch.core import flatten as F
from repro_torch.data import specs as tdata
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import specs as tspecs
from repro_torch.models import model as TM
from repro_torch.train import serve as tsv


class StandIn:
    """A mesh with only its axis sizes."""

    def __init__(self, **shape):
        self.shape = dict(shape)


MESHES = {"data16_model16": StandIn(data=16, model=16),
          "pod2_data16_model16": StandIn(pod=2, data=16, model=16),
          "data2_model2": StandIn(data=2, model=2)}
ARCHS = sorted(jreg.ARCHS)


def _axes(mesh_name):
    return ("pod", "data") if "pod" in mesh_name else ("data",)


def _flat(tree):
    """(path, leaf) pairs of a reference spec tree, ``PartitionSpec`` a leaf."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in leaves]


def _port_flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_flat(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _port_flat(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    jp = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = F.module_tree(TM.init_params(tcfg, device="meta"))
    return jcfg, tcfg, jp, tp


def _same(got, want, label):
    assert [p for p, _ in got] == [p for p, _ in want], label
    for (path, g), (_, w) in zip(got, want):
        assert g == w, f"{label} {path}: port {g}, reference {w}"


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh_name):
    jcfg, tcfg, jp, tp = _shapes(arch)
    mesh, axes = MESHES[mesh_name], _axes(mesh_name)
    assert [tuple(l.shape) for _, l in _port_flat(tp)] == \
        [tuple(s.shape) for s in jax.tree.leaves(jp)], arch
    for fsdp in (False, True):
        want = _flat(jshd.param_specs(jcfg, jp, fsdp=fsdp, data_axes=axes, mesh=mesh))
        got = _port_flat(tshd.param_specs(tcfg, tp, fsdp=fsdp, data_axes=axes, mesh=mesh))
        _same(got, want, f"{arch} fsdp={fsdp}")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_reference(arch, mesh_name):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    mesh, axes = MESHES[mesh_name], _axes(mesh_name)
    for name in ("decode_32k", "long_500k"):
        jv = jspecs.arch_variant(jcfg, jshapes.SHAPES[name])
        tv = tspecs.arch_variant(tcfg, tshapes.SHAPES[name])
        assert (jv is None) == (tv is None)
        if jv is None:
            continue
        want = _flat(jshd.cache_specs(jv, jsv.cache_shapes(jv, jshapes.SHAPES[name]),
                                      data_axes=axes, mesh=mesh))
        got = _port_flat(tshd.cache_specs(tv, tsv.cache_shapes(tv, tshapes.SHAPES[name]),
                                          data_axes=axes, mesh=mesh))
        _same(got, want, f"{arch} cache {name}")
    for name in ("train_4k", "prefill_32k"):
        want = _flat(jshd.batch_specs(jdata.train_specs(jcfg, jshapes.SHAPES[name]),
                                      data_axes=axes, mesh=mesh))
        got = _port_flat(tshd.batch_specs(tdata.train_specs(tcfg, tshapes.SHAPES[name]),
                                          data_axes=axes, mesh=mesh))
        _same(got, want, f"{arch} batch {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_variant_and_train_config_match_reference(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for name in jshapes.SHAPES:
        jv = jspecs.arch_variant(jcfg, jshapes.SHAPES[name])
        tv = tspecs.arch_variant(tcfg, tshapes.SHAPES[name])
        assert (jv is None) == (tv is None), (arch, name)
        if jv is not None:
            assert tv.sliding_window == jv.sliding_window and tv.name == jv.name
    for multi_pod in (False, True):
        for layout in ("stacked", "flat"):
            j = jspecs.train_config(jcfg, multi_pod, layout=layout)
            t = tspecs.train_config(tcfg, multi_pod, layout=layout)
            for f in ("mode", "multi_pod", "fsdp_params", "microbatches"):
                assert getattr(t, f) == getattr(j, f), (arch, layout, f)
            for f in ("method", "layout"):
                assert getattr(t.agg, f) == getattr(j.agg, f), (arch, layout, f)
            for f in ("f", "use_temporal"):
                assert getattr(t.agg.wfagg, f) == getattr(j.agg.wfagg, f), (arch, layout, f)
            assert t.candidate_axes() == j.candidate_axes()


@pytest.mark.parametrize("mode", ["robust_dp", "gspmd"])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_activation_rules_and_prune_spec_match_reference(mode, multi_pod):
    assert tshd.activation_rules(mode, multi_pod) == jshd.activation_rules(mode, multi_pod)
    for mesh in MESHES.values():
        for spec, shape in [((None, "model"), (64, 48)), (("model", None), (6, 16)),
                            (("data", "model"), (32, 32)), ((("pod", "data"), None), (64, 3)),
                            (("model",), (4, 7, 2)), ((), (5,))]:
            named = {a for ax in spec if ax for a in (ax if isinstance(ax, tuple) else (ax,))}
            if not named <= set(mesh.shape):
                continue
            assert tshd.prune_spec(spec, shape, mesh) == \
                tuple(jshd.prune_spec(PartitionSpec(*spec), shape, mesh)), (spec, shape)


def test_shard_and_gather_roundtrip():
    """``shard_tensor`` cuts the blocks ``tp_layout`` names; the KV
    projections stay whole where M does not divide the KV heads."""
    import dataclasses

    import torch

    cfg = dataclasses.replace(treg.get_config("yi-6b").reduced(), n_heads=4, n_kv_heads=2)
    mesh = StandIn(data=1, model=4)
    assert tshd.tp_layout(cfg, "wk", (256, 128), mesh) == (None, None)
    assert tshd.tp_layout(cfg, "wq", (256, 256), mesh) == (None, "model")
    assert tshd.leaf_spec(cfg, "wk", (256, 128), mesh=mesh) == (None, "model")
    full = torch.arange(8 * 12).reshape(8, 12)
    parts = [tshd.shard_tensor(full, (None, "model"), mesh, r) for r in range(4)]
    assert torch.equal(torch.cat(parts, dim=1), full)
    assert tshd.shard_tensor(full, (("data", "model"), None), mesh,
                             {"data": 0, "model": 3}).tolist() == full[6:8].tolist()
    with pytest.raises(NotImplementedError, match="query heads"):
        tshd.tp_layout(dataclasses.replace(cfg, n_heads=6), "wq", (256, 384),
                       StandIn(data=1, model=4))
    # the data axes: a rank's block by its coordinates on (pod, data), model
    grid = StandIn(pod=2, data=2, model=2)
    blocks = {(p, d, m): tshd.shard_tensor(full, (("pod", "data"), "model"), grid,
                                           {"pod": p, "data": d, "model": m})
              for p in range(2) for d in range(2) for m in range(2)}
    rows = [torch.cat([blocks[(i // 2, i % 2, m)] for m in range(2)], dim=1)
            for i in range(4)]
    assert torch.equal(torch.cat(rows, dim=0), full)
    # the FSDP rule's dim over the data axes, None where it leaves the leaf
    # whole (no dim >= _FSDP_MIN_DIM free of 'model', or one data does not divide)
    big = StandIn(data=4, model=2)
    assert tshd.fsdp_dim(cfg, "wq", (2, 1024, 2048), ("data",), big) == 1
    assert tshd.fsdp_dim(cfg, "bq", (2, 2048), ("data",), big) is None
    assert tshd.fsdp_dim(cfg, "wq", (2, 1026, 2048), ("data",), big) is None
    assert tshd.fsdp_dim(cfg, "scale", (2, 1024), ("pod", "data"),
                         StandIn(pod=2, data=4, model=2)) == 1
    with pytest.raises(ValueError, match="one process"):
        tshd.gather_tensor(full, ("data", None), StandIn(data=2, model=1))


def test_logical_shard_checks_local_extents():
    """``shard`` returns its tensor; inside ``use_sharding`` it checks each
    named axis's local extent against the global size over its mesh axis,
    so a layer that forgot to split (or split twice) raises."""
    import torch

    from repro_torch.distributed import logical

    x = torch.zeros((2, 3, 4, 8))
    assert logical.shard(x, "batch", "seq", "heads", None) is x      # no context: no-op
    rules = tshd.activation_rules("robust_dp", False)
    with logical.use_sharding(StandIn(data=1, model=2), rules, {"heads": 8}):
        assert logical.current_rules() == rules
        assert logical.current_mesh().shape == {"data": 1, "model": 2}
        assert logical.logical_spec("batch", "heads", None) == (None, "model", None)
        assert logical.shard(x, "batch", "seq", "heads", None) is x
        with pytest.raises(ValueError, match="local extent 8, expected 8 / 2"):
            logical.shard(torch.zeros((2, 3, 8, 8)), "batch", "seq", "heads", None)
    assert logical.current_mesh() is None and logical.current_rules() == {}
