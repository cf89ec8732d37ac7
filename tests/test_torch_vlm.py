"""Port parity of the VLM family: LLaVA-NeXT-34B in its reduced config (2
layers, d_model 256, 4 heads of 64 padded to 64, 16 patch embeddings,
f32), on stub patch embeddings through the two-layer GELU projector, held
against the JAX package with the same weights carried by
``params_from_jax`` and the same numpy patches and tokens; the reference's
init, forward, loss and decode run under ``jax.jit``.

Logits and caches within rtol = atol = 1e-4 (``tests/test_torch_serve.py``):
the projector alone (``jax.nn.gelu``'s tanh form, not the exact GELU),
prefill on the dense route and on the long route (``SDPA_CHUNK_THRESHOLD``
monkeypatched to 128 in both packages, ``REPRO_FLASH_KERNEL`` 1 and 0: the
flash branch once a layer at 64 padded heads), decode over 3 steps (the
reference's ``decode_step`` embeds tokens only) and decode through a
text-only prompt against one prefill.  The loss on both of the reference's
VLM branches (chunked: labels after ``n_modal`` zeros, masked below
``n_modal - 1``; unchunked: the text logits) within rtol 1e-5 and its
gradient leaves as ``tests/test_torch_ssm_train.py``'s.  The ravel order
(``embedding``, ``final_norm``, ``layers``, ``projector``) is
``ravel_pytree``'s bit for bit.  No file of the JAX package changes."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs.registry import ARCHS
from repro.data import specs as jspecs
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.train.serve import cache_shapes as jcache_shapes
from repro_torch.configs import registry as tregistry
from repro_torch.configs import shapes as tshapes
from repro_torch.core import flatten as F
from repro_torch.data import specs as tspecs
from repro_torch.kernels.flash_attn import ops as tflash_ops
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.train import serve as tserve
from repro_torch.train import trainer as tr

TOL = 1e-4
NAME = "llava-next-34b"


def _configs(**over):
    return (dataclasses.replace(ARCHS[NAME].reduced(), **over),
            dataclasses.replace(tregistry.get_config(NAME).reduced(), **over))


@functools.lru_cache(maxsize=None)
def _reference(jcfg, seed=0):
    """The reference's parameters of a config, made once a module."""
    jparams = jax.jit(functools.partial(JM.init_params, jcfg))(jax.random.PRNGKey(seed))
    return jparams, jax.tree.map(np.asarray, jparams)


def _models(**over):
    jcfg, tcfg = _configs(**over)
    jparams, tree = _reference(jcfg)
    return jcfg, jparams, tcfg, TM.params_from_jax(tree, tcfg, device="cpu")


def _batch(cfg, B, S_text, seed=1):
    rng = np.random.default_rng(seed)
    n = cfg.n_modal_tokens
    return {"patch_embeds": rng.standard_normal((B, n, TM.MODAL_EMBED_DIM)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, S_text)).astype(np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jax_forward(jcfg, jparams, batch):
    """Jitted anew on each call: a trace reads ``SDPA_CHUNK_THRESHOLD`` and
    ``REPRO_FLASH_KERNEL``, which tests monkeypatch."""
    return jax.jit(functools.partial(JM.forward, jcfg))(jparams, _jax(batch))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# configs, weights and layout


def test_config_resolves_with_the_reference_count():
    """``get_config`` gives the reference's config field for field (and its
    reduced variant, 64 padded heads kept), and the port's model on the
    meta device has the parameter count of ``jax.eval_shape(init_params)``,
    the projector included."""
    jcfg, tcfg = ARCHS[NAME], tregistry.get_config(NAME)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(jcfg.reduced())
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.reduced().pad_heads_to == 64 and tcfg.reduced().n_modal_tokens == 16
    want = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(want))
    model = TM.DecoderLM(tcfg, torch.Generator(), "meta")
    assert sum(p.numel() for p in model.parameters()) == n
    assert tuple(model.projector.w1.shape) == (TM.MODAL_EMBED_DIM, 7168)


def test_params_from_jax_carries_every_leaf():
    """Every leaf (the stacked layers unstacked, the ``projector``) lands at
    its path; none is left over on either side."""
    jcfg, jparams, tcfg, model = _models()
    state = model.state_dict()
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        keys = [str(p.key) for p in path]
        arr = np.asarray(leaf)
        rows = ([(["layers", str(i)] + keys[1:], arr[i]) for i in range(jcfg.n_layers)]
                if keys[0] == "layers" else [(keys, arr)])
        for k, a in rows:
            got = state.pop(".".join(k))
            assert got.dtype == torch.float32 and np.array_equal(got.numpy(), a), k
    assert not state, f"port parameters with no reference leaf: {sorted(state)}"


def test_module_ravel_is_ravel_pytree():
    jcfg, tcfg = _configs()
    tree = _reference(jcfg)[1]
    want = np.asarray(ravel_pytree(tree)[0])
    model = TM.params_from_jax(tree, tcfg, device="cpu")
    assert F.tree_ravel(model)[0].numpy().tobytes() == want.tobytes()
    flat = F.layout_flat(model)
    assert flat.numpy().tobytes() == want.tobytes()
    got = F.module_tree(model)
    assert list(got) == ["embedding", "final_norm", "layers", "projector"]
    assert jax.tree.structure(got) == jax.tree.structure(tree)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(tree)[0], F.tree_leaves(got)):
        assert g.shape == w.shape and np.array_equal(g.numpy(), w), path
        assert g.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
    assert F.tree_size(model) == want.size


def test_cache_shapes_and_specs_match_the_reference():
    """``cache_shapes`` (no ``enc_out``), ``train_specs`` (``patch_embeds``
    (B, n_modal, 1024) and S - n_modal tokens) and ``dummy_batch``
    (``max(seq - n_modal, 8)`` tokens) against the reference's."""
    shape = dataclasses.replace(tshapes.DECODE_32K, global_batch=2, seq_len=64)
    for jcfg, tcfg in (_configs(), (ARCHS[NAME], tregistry.get_config(NAME))):
        want = {k: v for k, v in jcache_shapes(jcfg, shape).items() if k != "idx"}
        got = tserve.cache_shapes(tcfg, shape)
        assert set(got) == {"idx", "layers"}
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                F.tree_leaves(got["layers"])):
            assert tuple(g.shape) == w.shape, (tcfg.name, path)
            assert str(g.dtype) == f"torch.{w.dtype.name}", (tcfg.name, path)
        wspecs = jspecs.train_specs(jcfg, shape)
        gspecs = tspecs.train_specs(tcfg, shape)
        assert set(gspecs) == set(wspecs) == {"patch_embeds", "tokens"}
        for k, w in wspecs.items():
            assert gspecs[k].shape == w.shape and str(gspecs[k].dtype) == f"torch.{w.dtype}"
    jcfg, tcfg = _configs()
    for seq in (40, 20):
        batch = tspecs.dummy_batch(tcfg, 2, seq, torch.Generator().manual_seed(0),
                                   device="cpu")
        jbatch = jspecs.dummy_batch(jcfg, 2, seq)
        assert {k: tuple(v.shape) for k, v in batch.items()} == \
            {k: v.shape for k, v in jbatch.items()}


# ---------------------------------------------------------------------------
# the projector and prefill


def test_projector_is_the_tanh_gelu_mlp():
    """``gelu(pe @ w1) @ w2`` with ``jax.nn.gelu``'s default (tanh) form: the
    reference's values within the tolerance, and the exact GELU's not (the
    two forms differ by up to ~5e-4)."""
    jcfg, jparams, tcfg, model = _models()
    pe = _batch(tcfg, 2, 1, seed=3)["patch_embeds"]
    p = jparams["projector"]
    want = jax.jit(lambda pe: jax.nn.gelu(pe @ p["w1"]) @ p["w2"])(jnp.asarray(pe))
    got = TM._project(tcfg, model, torch.as_tensor(pe))
    assert got.shape == (2, tcfg.n_modal_tokens, tcfg.d_model)
    _close(got, want)
    pr = model.projector
    exact = torch.nn.functional.gelu(torch.as_tensor(pe) @ pr.w1) @ pr.w2
    assert not np.allclose(exact.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_prefill_matches_forward_dense_route():
    """16 patches and 24 tokens: 40 positions, the patches first."""
    jcfg, jparams, tcfg, model = _models()
    batch = _batch(tcfg, 2, 24)
    want, waux = _jax_forward(jcfg, jparams, batch)
    got = tserve.build_prefill(tcfg, device="cpu")(model, _torch(batch))
    assert got.shape == (2, 40, tcfg.vocab_size) and got.dtype == torch.float32
    _close(got, want)
    assert float(waux) == 0.0


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "chunked"])
def test_prefill_matches_forward_long_route(flash, monkeypatch):
    """16 patches and 240 tokens, 256 positions with the threshold at 128:
    the flash branch once a layer at 64 padded heads (JAX's Pallas kernel
    in interpret mode, the port's plain version) or the chunked scan."""
    monkeypatch.setattr(jlayers, "SDPA_CHUNK_THRESHOLD", 128)
    monkeypatch.setattr(tlayers, "SDPA_CHUNK_THRESHOLD", 128)
    monkeypatch.setenv("REPRO_FLASH_KERNEL", "1" if flash else "0")
    shapes = []
    plain = tflash_ops.flash_attention_plain
    monkeypatch.setattr(tflash_ops, "flash_attention_plain",
                        lambda q, *a, **k: shapes.append(tuple(q.shape)) or plain(q, *a, **k))
    jcfg, jparams, tcfg, model = _models()
    batch = _batch(tcfg, 1, 240)
    want, _ = _jax_forward(jcfg, jparams, batch)
    got = tserve.build_prefill(tcfg, device="cpu", flash=flash)(model, _torch(batch))
    _close(got, want)
    assert shapes == ([(tcfg.pad_heads_to, 256, tcfg.head_dim_)] * tcfg.n_layers
                      if flash else [])


# ---------------------------------------------------------------------------
# loss


@pytest.mark.parametrize("chunk", [0, 8], ids=["full", "chunked"])
def test_loss_and_grad_match_reference(chunk):
    """Both VLM branches of the reference's loss, one position apart: the
    loss and every gradient leaf, the projector's included."""
    jcfg, tcfg = _configs(loss_chunk=chunk)
    tree = _reference(jcfg)[1]
    batch = _batch(tcfg, 2, 17, seed=2)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, _jax(batch)), has_aux=True))(tree)
    model = TM.params_from_jax(tree, tcfg, device="cpu")
    F.layout_flat(model)
    lt, gt = tr.loss_and_grad(tcfg, model, _torch(batch))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    with torch.no_grad():
        _, mt = TM.loss_fn(tcfg, model, _torch(batch))
    for k in ("aux", "ce"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5, err_msg=k)
    grads = F.unravel_like(gt, model)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(gj)[0], F.tree_leaves(grads)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * min(1.0, float(np.abs(w).max())),
                                   err_msg=jax.tree_util.keystr(path))
    assert float(grads["projector"]["w1"].abs().max()) > 0


def test_the_two_loss_branches_differ_by_one_position():
    """The chunked branch counts the last patch's prediction of the first
    token, the unchunked one does not: with a chunk of one position the two
    losses differ, and the chunked one equals the mean over positions
    n_modal - 1 .. S - 2 of the full logits' next-token loss."""
    _, _, tcfg, model = _models()
    batch = _torch(_batch(tcfg, 2, 9, seed=6))
    n = tcfg.n_modal_tokens
    with torch.no_grad():
        full = TM.loss_fn(tcfg, model, batch)[0]
        chunked = TM.loss_fn(dataclasses.replace(tcfg, loss_chunk=1), model, batch)[0]
        logits = TM.forward(tcfg, model, batch)[0][:, n - 1:-1]
    lab = batch["tokens"].long()
    want = (torch.logsumexp(logits, -1) - logits.gather(-1, lab[..., None])[..., 0]).mean()
    _close(chunked, want)
    assert abs(float(chunked) - float(full)) > 10 * TOL


# ---------------------------------------------------------------------------
# decode


def test_decode_steps_match_decode_step():
    """Three decode steps (tokens only, as the reference's): logits and the
    stacked K/V cache against the reference's ``decode_step``."""
    jcfg, jparams, tcfg, model = _models()
    B, total = 2, 16
    toks = [_batch(tcfg, B, 1, seed=s)["tokens"] for s in range(3)]
    cache = JM.init_cache(jcfg, B, total)
    step = jax.jit(functools.partial(JM.decode_step, jcfg))
    tcache = TM.init_cache(tcfg, B, total, device="cpu")
    tstep = tserve.build_decode_step(tcfg, device="cpu")
    for t in toks:
        want, cache = step(jparams, cache, jnp.asarray(t))
        got, tcache = tstep(model, tcache, torch.as_tensor(t))
        assert got.shape == (B, 1, tcfg.vocab_size)
        _close(got, want)
    assert tcache["idx"] == int(cache["idx"]) == 3
    for n in ("k", "v"):
        assert tuple(tcache["layers"][n].shape) == cache["layers"][n].shape
        _close(tcache["layers"][n], cache["layers"][n])


def test_decode_through_a_prompt_matches_prefill():
    """Stepping through a text-only prompt gives, at every position, the
    logits of one prefill of the same tokens (no patches)."""
    _, _, tcfg, model = _models()
    tok = _batch(tcfg, 2, 12, seed=5)["tokens"]
    prefill = tserve.build_prefill(tcfg, device="cpu")(model, {"tokens": torch.as_tensor(tok)})
    cache = TM.init_cache(tcfg, 2, 12, device="cpu")
    step = tserve.build_decode_step(tcfg, device="cpu")
    stepped = []
    for i in range(12):
        logits, cache = step(model, cache, torch.as_tensor(tok[:, i:i + 1]))
        stepped.append(logits)
    _close(torch.cat(stepped, dim=1), prefill)
