"""Port parity of the SSM and hybrid families: Falcon-Mamba-7B (Mamba-1)
and Zamba2-1.2B (Mamba-2 and one shared attention block) in their reduced
configs (d_model 256, f32), Zamba2 also at 4 layers (``-g2``: two groups,
so that the shared block serves two invocations; ``reduced()`` has 2
layers, one group), held against the JAX package with the same weights
carried by ``params_from_jax`` and the same numpy tokens.

Logits and caches within rtol = atol = 1e-4 (``tests/test_torch_serve.py``):
prefill over 300 positions (three chunks of the scan), decode over 3 steps
(the conv ring, ``h`` and the shared block's K/V ring), a stateful call of
S > 1 tokens (the reference's ``h0`` fold and, in the hybrid, its causal
mask over the ring), decode through a prompt against one prefill, and
Zamba2's long route (``SDPA_CHUNK_THRESHOLD`` monkeypatched to 128 in both
packages, ``REPRO_FLASH_KERNEL`` 1 and 0: one flash call a group).  The
ravel order of both trees is ``ravel_pytree``'s bit for bit, the cache
layout ``jax.eval_shape``'s, and the full configs' parameter counts those
of ``jax.eval_shape(init_params)``.  The loss, its backward, the ported
remat and the trainer: ``tests/test_torch_ssm_train.py``.  No file of the
JAX package changes."""
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
NAMES = ["falcon-mamba-7b", "zamba2-1.2b", "zamba2-1.2b-g2"]


def _configs(name, **over):
    base = name.removesuffix("-g2")
    if name.endswith("-g2"):
        over = dict(over, n_layers=4)
    return (dataclasses.replace(ARCHS[base].reduced(), **over),
            dataclasses.replace(tregistry.get_config(base).reduced(), **over))


@functools.lru_cache(maxsize=None)
def _reference(jcfg, seed):
    """The reference's parameters of a config, made once a module (jitted:
    the eager init of a scanned stack takes several seconds)."""
    jparams = jax.jit(functools.partial(JM.init_params, jcfg))(jax.random.PRNGKey(seed))
    return jparams, jax.tree.map(np.asarray, jparams)


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
# configs, weights and layout


def test_full_configs_resolve_with_the_reference_counts():
    """``get_config`` gives the reference's configs field for field, and the
    port's model (on the meta device) has the parameter count of
    ``jax.eval_shape(init_params)``: Falcon-Mamba-7B 7,272,665,088,
    Zamba2-1.2B 1,188,799,616."""
    for name, n in (("falcon-mamba-7b", 7_272_665_088), ("zamba2-1.2b", 1_188_799_616)):
        jcfg, tcfg = ARCHS[name], tregistry.get_config(name)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        want = jax.eval_shape(lambda c=jcfg: JM.init_params(c, jax.random.PRNGKey(0)))
        assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(want)) == n
        model = TM.DecoderLM(tcfg, torch.Generator(), "meta")
        assert sum(p.numel() for p in model.parameters()) == n


@pytest.mark.parametrize("name", NAMES)
def test_params_from_jax_carries_every_leaf(name):
    """Every leaf of the reference's pytree (the stacked Mamba layers, the
    hybrid's unstacked ``shared_attn``) lands at its path; none is left
    over on either side."""
    jcfg, jparams, tcfg, model = _models(name)
    state = model.state_dict()
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        keys = [str(getattr(p, "key", getattr(p, "idx", None))) for p in path]
        arr = np.asarray(leaf)
        rows = ([(["layers", str(i)] + keys[1:], arr[i]) for i in range(jcfg.n_layers)]
                if keys[0] == "layers" else [(keys, arr)])
        for k, a in rows:
            got = state.pop(".".join(k))
            assert got.dtype == torch.float32 and np.array_equal(got.numpy(), a), k
    assert not state, f"port parameters with no reference leaf: {sorted(state)}"


@pytest.mark.parametrize("name", NAMES)
def test_module_ravel_is_ravel_pytree(name):
    """``tree_ravel``, ``layout_flat`` and ``module_tree`` give
    ``ravel_pytree``'s vector and tree: sorted keys with capitals first
    (``A_log``, ``D``, ``bc_proj`` / ``conv_b``, ...), ``layers`` stacked,
    ``shared_attn`` after it."""
    jcfg, tcfg = _configs(name)
    _, tree = _reference(jcfg, 0)
    want = np.asarray(ravel_pytree(tree)[0])
    model = TM.params_from_jax(tree, tcfg, device="cpu")
    assert F.tree_ravel(model)[0].numpy().tobytes() == want.tobytes()
    flat = F.layout_flat(model)
    assert flat.numpy().tobytes() == want.tobytes()
    got = F.module_tree(model)
    assert jax.tree.structure(got) == jax.tree.structure(tree)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(tree)[0], F.tree_leaves(got)):
        assert g.shape == w.shape and np.array_equal(g.numpy(), w), path
        assert g.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
    assert list(got["layers"]["mixer"])[:2] == ["A_log", "D"]
    if "shared_attn" in got:
        rows = F.unravel_rows(torch.stack([flat, 2 * flat]), model)
        assert torch.equal(rows["shared_attn"]["in_proj"][1], 2 * got["shared_attn"]["in_proj"])
    assert F.tree_size(model) == want.size


def test_cache_shapes_match_the_reference():
    """``cache_shapes`` and ``init_cache`` against the reference's
    ``jax.eval_shape`` cache, shapes and types (``h`` f32, the rest in the
    activations' type), for the reduced and the full configs."""
    shape = dataclasses.replace(tshapes.DECODE_32K, global_batch=2, seq_len=64)
    cases = [_configs(n) for n in NAMES] + [
        (ARCHS[n], tregistry.get_config(n)) for n in ("falcon-mamba-7b", "zamba2-1.2b")]
    for jcfg, tcfg in cases:
        want = {k: v for k, v in jcache_shapes(jcfg, shape).items() if k != "idx"}
        got = tserve.cache_shapes(tcfg, shape)
        assert got["idx"] == 0 and set(got) == {"idx", "layers"}
        got = {k: v for k, v in got.items() if k != "idx"}
        assert jax.tree.structure(want) == jax.tree.structure(
            jax.tree.map(lambda s: 0, got, is_leaf=lambda s: hasattr(s, "shape")))
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                F.tree_leaves(got)):
            assert tuple(g.shape) == w.shape, (tcfg.name, path)
            assert str(g.dtype) == f"torch.{w.dtype.name}", (tcfg.name, path)
        if tcfg.d_model <= 256:
            cache = TM.init_cache(tcfg, 2, 64, device="cpu")
            for g, c in zip(F.tree_leaves(got),
                            F.tree_leaves({k: v for k, v in cache.items() if k != "idx"})):
                assert tuple(g.shape) == tuple(c.shape) and g.dtype == c.dtype


# ---------------------------------------------------------------------------
# prefill


@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_forward(name):
    """300 positions: the scan in three chunks of 128."""
    jcfg, jparams, tcfg, model = _models(name)
    tok = _tokens(tcfg, 2, 300)
    want, waux = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(tok)})
    got = tserve.build_prefill(tcfg, device="cpu")(model, {"tokens": torch.as_tensor(tok)})
    assert got.shape == (2, 300, tcfg.vocab_size) and got.dtype == torch.float32
    _close(got, want)
    with torch.no_grad():
        _, aux = TM.forward(tcfg, model, {"tokens": torch.as_tensor(tok)})
    assert float(aux) == float(waux) == 0.0


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "chunked"])
def test_hybrid_long_route(flash, monkeypatch):
    """Zamba2 at two groups, S=256 with the threshold at 128: the shared
    block's attention takes the flash branch once a group (JAX's Pallas
    kernel in interpret mode, the port's plain version) or the chunked
    online softmax."""
    monkeypatch.setattr(jlayers, "SDPA_CHUNK_THRESHOLD", 128)
    monkeypatch.setattr(tlayers, "SDPA_CHUNK_THRESHOLD", 128)
    monkeypatch.setenv("REPRO_FLASH_KERNEL", "1" if flash else "0")
    shapes = []
    plain = tflash_ops.flash_attention_plain
    monkeypatch.setattr(tflash_ops, "flash_attention_plain",
                        lambda q, *a, **k: shapes.append(tuple(q.shape)) or plain(q, *a, **k))
    jcfg, jparams, tcfg, model = _models("zamba2-1.2b-g2")
    tok = _tokens(tcfg, 1, 256)
    want, _ = JM.forward(jcfg, jparams, {"tokens": jnp.asarray(tok)})
    got = tserve.build_prefill(tcfg, device="cpu", flash=flash)(
        model, {"tokens": torch.as_tensor(tok)})
    _close(got, want)
    G = tcfg.n_layers // tcfg.shared_attn_every
    assert shapes == ([(tcfg.n_heads, 256, tcfg.head_dim_)] * G if flash else [])


# ---------------------------------------------------------------------------
# decode


@functools.lru_cache(maxsize=None)
def _jax_decode_step(jcfg):
    return jax.jit(functools.partial(JM.decode_step, jcfg))


def _jax_steps(jcfg, jparams, B, total, toks):
    cache = JM.init_cache(jcfg, B, total)
    step = _jax_decode_step(jcfg)
    out = []
    for t in toks:
        logits, cache = step(jparams, cache, jnp.asarray(t))
        out.append(np.asarray(logits))
    return out, cache


def _port_steps(tcfg, model, B, total, toks):
    cache = TM.init_cache(tcfg, B, total, device="cpu")
    step = tserve.build_decode_step(tcfg, device="cpu")
    out = []
    for t in toks:
        logits, cache = step(model, cache, torch.as_tensor(t))
        out.append(logits)
    return out, cache


def _hold_caches(tcache, jcache):
    assert tcache["idx"] == int(jcache["idx"])
    assert set(tcache) == set(jcache)
    leaves = jax.tree_util.tree_flatten_with_path({k: v for k, v in jcache.items()
                                                  if k != "idx"})[0]
    ported = F.tree_leaves({k: v for k, v in tcache.items() if k != "idx"})
    assert len(leaves) == len(ported)
    for (path, w), g in zip(leaves, ported):
        assert tuple(g.shape) == w.shape and str(g.dtype) == f"torch.{w.dtype.name}", path
        _close(g, w)


@pytest.mark.parametrize("name", NAMES)
def test_decode_steps_match_decode_step(name):
    """Three decode steps (and a stateful call of 5 tokens after them, the
    reference's ``h0`` fold and, in the hybrid, its ring mask): logits and
    every cache tensor against the reference's ``decode_step``."""
    jcfg, jparams, tcfg, model = _models(name)
    B, total = 2, 16
    toks = [_tokens(tcfg, B, 1, seed=s) for s in range(3)] + [_tokens(tcfg, B, 5, seed=9)]
    want, jcache = _jax_steps(jcfg, jparams, B, total, toks)
    got, tcache = _port_steps(tcfg, model, B, total, toks)
    for g, w, t in zip(got, want, toks):
        assert g.shape == (B, t.shape[1], tcfg.vocab_size)
        _close(g, w)
    _hold_caches(tcache, jcache)
    assert tcache["idx"] == 4
    hs = tcache["layers"]["h"] if tcfg.family == "ssm" else tcache["layers"]["mamba"]["h"]
    assert float(hs.abs().max()) > 0


@pytest.mark.parametrize("name", NAMES)
def test_decode_through_a_prompt_matches_prefill(name):
    """Stepping through a prompt gives, at every position, the logits of one
    prefill of the same tokens; an SSM model also takes the prompt's first
    7 tokens in one stateful call (no positions: the state is all that
    carries), then steps."""
    _, _, tcfg, model = _models(name)
    tok = _tokens(tcfg, 2, 12, seed=5)
    prefill = tserve.build_prefill(tcfg, device="cpu")(model, {"tokens": torch.as_tensor(tok)})
    stepped, cache = _port_steps(tcfg, model, 2, 12, [tok[:, i:i + 1] for i in range(12)])
    _close(torch.cat(stepped, dim=1), prefill)
    assert cache["idx"] == 12
    if tcfg.family == "ssm":
        parts, cache = _port_steps(tcfg, model, 2, 12,
                                   [tok[:, :7]] + [tok[:, i:i + 1] for i in range(7, 12)])
        _close(torch.cat(parts, dim=1), prefill)


def test_hybrid_ring_wraps_like_the_reference():
    """The shared block's K/V ring at 8 slots (``sliding_window`` 8) over 12
    steps at two groups: the reference's masks before and after the wrap."""
    jcfg, jparams, tcfg, model = _models("zamba2-1.2b-g2", sliding_window=8)
    toks = [_tokens(tcfg, 2, 1, seed=20 + s) for s in range(12)]
    want, jcache = _jax_steps(jcfg, jparams, 2, 32, toks)
    got, tcache = _port_steps(tcfg, model, 2, 32, toks)
    assert tcache["layers"]["attn"]["k"].shape[3] == 8
    for g, w in zip(got, want):
        _close(g, w)
    _hold_caches(tcache, jcache)
