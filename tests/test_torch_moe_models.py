"""Port parity of the MoE family: DeepSeek-V2-Lite (MLA + MoE, one dense
prefix block), Moonlight (GQA + MoE, one dense prefix block) and Arctic
(MoE + dense residual, 4 heads padded to 64; also with ``param_dtype``
bf16) in their reduced configs (2 layers, d_model 256, 4 experts top-2,
f32 activations), held against the JAX package with the same weights
carried by ``params_from_jax`` and the same numpy tokens.

Logits, caches and aux within rtol = atol = 1e-4, as
``tests/test_torch_serve.py``: prefill on the dense route and Arctic's
long route (``SDPA_CHUNK_THRESHOLD`` monkeypatched to 128 in both
packages, ``REPRO_FLASH_KERNEL`` 1 and 0: the flash kernel sees 64 padded
heads), the reference's init and forward jitted.  The ravel order with
the ``prefix_layers`` list is ``ravel_pytree``'s bit for bit.  Decode:
``tests/test_torch_moe_decode.py``; the loss, its backward and the
trainer on the MoE family: ``tests/test_torch_moe_train.py``.  No file of
the JAX package changes."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs.registry import ARCHS
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.train.serve import cache_shapes as jcache_shapes
from repro_torch.configs import registry as tregistry
from repro_torch.configs import shapes as tshapes
from repro_torch.core import flatten as F
from repro_torch.kernels.flash_attn import ops as tflash_ops
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.train import serve as tserve

TOL = 1e-4
MOE = ["deepseek-v2-lite-16b", "moonshot-v1-16b-a3b", "arctic-480b"]
NAMES = MOE + ["arctic-480b-bf16"]


def _configs(name, **over):
    base = name.removesuffix("-bf16")
    if name.endswith("-bf16"):
        over = dict(over, param_dtype="bfloat16")
    return (dataclasses.replace(ARCHS[base].reduced(), **over),
            dataclasses.replace(tregistry.get_config(base).reduced(), **over))


@functools.lru_cache(maxsize=None)
def _reference(jcfg, seed):
    """The reference's parameters of a config, made once a module (jitted:
    the eager init takes several seconds)."""
    jparams = jax.jit(functools.partial(JM.init_params, jcfg))(jax.random.PRNGKey(seed))
    return jparams, jax.tree.map(np.asarray, jparams)


def _jax_forward(jcfg, jparams, tok):
    """The reference's ``forward``, jitted anew on each call: a trace reads
    ``SDPA_CHUNK_THRESHOLD`` and ``REPRO_FLASH_KERNEL``, which tests
    monkeypatch."""
    return jax.jit(functools.partial(JM.forward, jcfg))(jparams, {"tokens": jnp.asarray(tok)})


def _models(name, seed=0, **over):
    jcfg, tcfg = _configs(name, **over)
    jparams, tree = _reference(jcfg, seed)
    return jcfg, jparams, tcfg, TM.params_from_jax(tree, tcfg, device="cpu")


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# weights and layout


@pytest.mark.parametrize("name", NAMES)
def test_params_from_jax_carries_every_leaf(name):
    """Every leaf of the reference's pytree (the stacked MoE layers, the
    ``prefix_layers`` list, MLA's leaves, ``shared`` / ``dense_residual``)
    lands at its path, in its type (bf16 stays bf16); none is left over on
    either side."""
    jcfg, jparams, tcfg, model = _models(name)
    state = model.state_dict()
    n = 0
    n_stacked = jcfg.n_layers - (jcfg.first_dense_layers if jcfg.n_experts else 0)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        keys = [str(getattr(p, "key", getattr(p, "idx", None))) for p in path]
        arr = np.asarray(leaf)
        rows = ([(["layers", str(i)] + keys[1:], arr[i]) for i in range(n_stacked)]
                if keys[0] == "layers" else [(keys, arr)])
        for k, a in rows:
            got = state.pop(".".join(k))
            assert str(got.dtype) == f"torch.{a.dtype.name}", k
            assert np.array_equal(got.float().numpy(), a.astype(np.float32)), k
            n += 1
    assert not state, f"port parameters with no reference leaf: {sorted(state)}"
    if name.endswith("-bf16"):
        assert n and all(p.dtype == torch.bfloat16 for p in model.parameters())


def test_params_from_jax_refuses_a_leaf_of_another_type():
    jcfg, tcfg = _configs("arctic-480b-bf16")
    tree = dict(_reference(jcfg, 0)[1])
    tree["final_norm"] = dict(tree["final_norm"])
    tree["final_norm"]["scale"] = tree["final_norm"]["scale"].astype(np.float32)
    with pytest.raises(ValueError, match="final_norm.scale"):
        TM.params_from_jax(tree, tcfg, device="cpu")


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "moonshot-v1-16b-a3b"])
def test_module_ravel_with_prefix_layers_is_ravel_pytree(name):
    """``prefix_layers`` ravels after ``layers`` (sorted keys), its entries in
    index order: ``tree_ravel``, ``layout_flat`` and ``module_tree`` give
    ``ravel_pytree``'s vector and tree, also with 11 prefix blocks (index
    10 after 9, not after 1)."""
    for over in ({}, {"first_dense_layers": 11, "n_layers": 12}):
        jcfg, tcfg = _configs(name, **over)
        tree = _reference(jcfg, 0)[1]
        want = np.asarray(ravel_pytree(tree)[0])
        model = TM.params_from_jax(tree, tcfg, device="cpu")
        assert F.tree_ravel(model)[0].numpy().tobytes() == want.tobytes()
        flat = F.layout_flat(model)
        assert flat.numpy().tobytes() == want.tobytes()
        got = F.module_tree(model)
        assert isinstance(got["prefix_layers"], list)
        assert jax.tree.structure(got) == jax.tree.structure(tree)
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                F.tree_leaves(got)):
            assert g.shape == w.shape and np.array_equal(g.numpy(), w), path
            assert g.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
        # the unravel of rows in ravel order, and the tree utilities over lists
        rows = F.unravel_rows(torch.stack([flat, 2 * flat]), model)
        assert torch.equal(rows["prefix_layers"][0]["attn"]["wo"][1],
                           2 * got["prefix_layers"][0]["attn"]["wo"])
        doubled = F.tree_map(lambda a, b: a + b, got, got)
        assert torch.equal(F.tree_ravel(doubled)[0], 2 * flat)
        assert F.tree_size(model) == want.size


def test_cache_shapes_match_the_reference():
    for name in MOE:
        jcfg, tcfg = _configs(name)
        shape = dataclasses.replace(tshapes.DECODE_32K, global_batch=2, seq_len=64)
        want = jcache_shapes(jcfg, shape)
        got = tserve.cache_shapes(tcfg, shape)
        assert set(got) == set(want)
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(
                {k: v for k, v in want.items() if k != "idx"})[0],
                F.tree_leaves({k: v for k, v in got.items() if k != "idx"})):
            assert tuple(g.shape) == tuple(w.shape), (name, path)
        cache = TM.init_cache(tcfg, 2, 64, device="cpu")
        for g, c in zip(F.tree_leaves({k: v for k, v in got.items() if k != "idx"}),
                        F.tree_leaves({k: v for k, v in cache.items() if k != "idx"})):
            assert tuple(g.shape) == tuple(c.shape)


# ---------------------------------------------------------------------------
# prefill


@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_forward_dense_route(name):
    jcfg, jparams, tcfg, model = _models(name)
    tok = _tokens(tcfg, 2, 32)
    want, waux = _jax_forward(jcfg, jparams, tok)
    got = tserve.build_prefill(tcfg, device="cpu")(model, {"tokens": torch.as_tensor(tok)})
    assert got.shape == (2, 32, tcfg.vocab_size) and got.dtype == torch.float32
    _close(got, want)
    with torch.no_grad():
        _, aux = TM.forward(tcfg, model, {"tokens": torch.as_tensor(tok)})
    assert float(waux) > 0
    np.testing.assert_allclose(float(aux), float(waux), rtol=TOL)


LONG = [("arctic-480b", True), ("arctic-480b", False), ("arctic-480b-bf16", True),
        ("arctic-480b-bf16", False), ("deepseek-v2-lite-16b", True)]


@pytest.mark.parametrize("name,flash", LONG, ids=[f"{n}-{'flash' if f else 'chunked'}"
                                                  for n, f in LONG])
def test_prefill_matches_forward_long_route(name, flash, monkeypatch):
    """S=256 with the threshold at 128.  Arctic: the flash branch at 64
    padded heads (JAX's Pallas kernel in interpret mode, the port's plain
    version once per layer) or the chunked scan.  DeepSeek-V2-Lite: MLA
    never takes the flash branch, in either package."""
    monkeypatch.setattr(jlayers, "SDPA_CHUNK_THRESHOLD", 128)
    monkeypatch.setattr(tlayers, "SDPA_CHUNK_THRESHOLD", 128)
    monkeypatch.setenv("REPRO_FLASH_KERNEL", "1" if flash else "0")
    shapes = []
    plain = tflash_ops.flash_attention_plain
    monkeypatch.setattr(tflash_ops, "flash_attention_plain",
                        lambda q, *a, **k: shapes.append(tuple(q.shape)) or plain(q, *a, **k))
    jcfg, jparams, tcfg, model = _models(name)
    tok = _tokens(tcfg, 1, 256)
    want, _ = _jax_forward(jcfg, jparams, tok)
    got = tserve.build_prefill(tcfg, device="cpu", flash=flash)(
        model, {"tokens": torch.as_tensor(tok)})
    _close(got, want)
    if flash and not tcfg.use_mla:
        assert shapes == [(tcfg.pad_heads_to, 256, tcfg.head_dim_)] * tcfg.n_layers
    else:
        assert shapes == []
