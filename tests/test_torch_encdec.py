"""Port parity of the encoder-decoder family: SeamlessM4T-medium in its
reduced config (2 encoder + 2 decoder layers, d_model 256, 4 heads of 64,
LayerNorm, f32), on stub frame embeddings, held against the JAX package
with the same weights carried by ``params_from_jax`` and the same numpy
frames and tokens; the reference's init, forward, loss and decode run
under ``jax.jit``.

Logits and caches within rtol = atol = 1e-4 (``tests/test_torch_serve.py``):
prefill on the dense route and on the long route (``SDPA_CHUNK_THRESHOLD``
monkeypatched to 128 in both packages, ``REPRO_FLASH_KERNEL`` 1 and 0: the
decoder's causal self-attention takes the flash branch once a layer, the
encoder's non-causal self-attention and the cross-attention never);
cross-attention and the non-causal encoder attention alone at >= 128 keys;
decode over 3 steps with the encoder output written into both caches, and
decode through a prompt against one prefill.  The loss (never chunked:
``loss_chunk`` is ignored, as in the reference) within rtol 1e-5 and its
gradient leaves as ``tests/test_torch_ssm_train.py``'s; a 3-step stacked
robust-DP trajectory against the reference's composed step
(``tests/test_torch_trainer.py``'s harness, frames beside the tokens).  The
ravel order of the tree (``enc_in_proj``, ``enc_layers``, ``enc_norm``,
the cross blocks' ``ln_x`` / ``xattn``) is ``ravel_pytree``'s bit for bit.
No file of the JAX package changes."""
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
NAME = "seamless-m4t-medium"


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


def _batch(cfg, B, S, S_enc=None, seed=1):
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((B, S_enc or S, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jax_forward(jcfg, jparams, batch):
    """Jitted anew on each call: a trace reads ``SDPA_CHUNK_THRESHOLD`` and
    ``REPRO_FLASH_KERNEL``, which tests monkeypatch."""
    return jax.jit(functools.partial(JM.forward, jcfg))(jparams, _jax(batch))


def _jax_encode(jcfg, jparams, frames):
    """The reference's inline encoder (``src/repro/models/model.py:239-243``)."""
    def enc(p, f):
        h = f @ p["enc_in_proj"]
        pos = jnp.broadcast_to(jnp.arange(f.shape[1]), f.shape[:2])
        h, _, _ = JM._scan_blocks(jcfg, p["enc_layers"], h, pos, "dense", causal=False)
        return jlayers.norm_fwd(jcfg, p["enc_norm"], h)
    return jax.jit(enc)(jparams, jnp.asarray(frames))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


def _record_flash(monkeypatch):
    """The q shape of every call of the flash kernel's plain version."""
    shapes = []
    plain = tflash_ops.flash_attention_plain
    monkeypatch.setattr(tflash_ops, "flash_attention_plain",
                        lambda q, *a, **k: shapes.append(tuple(q.shape)) or plain(q, *a, **k))
    return shapes


# ---------------------------------------------------------------------------
# configs, weights and layout


def test_config_resolves_with_the_reference_count():
    """``get_config`` gives the reference's config field for field (and its
    reduced variant), and the port's model on the meta device has the
    parameter count of ``jax.eval_shape(init_params)``: 978,870,272 (the
    analytic ``param_count`` says 977,743,872)."""
    jcfg, tcfg = ARCHS[NAME], tregistry.get_config(NAME)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(jcfg.reduced())
    assert tcfg.param_count() == jcfg.param_count()
    want = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(want))
    model = TM.DecoderLM(tcfg, torch.Generator(), "meta")
    assert sum(p.numel() for p in model.parameters()) == n == 978_870_272


def test_params_from_jax_carries_every_leaf():
    """Every leaf of the reference's pytree, the stacked ``layers`` (cross
    blocks) and ``enc_layers`` unstacked, lands at its path; none is left
    over on either side."""
    jcfg, jparams, tcfg, model = _models()
    state = model.state_dict()
    stacked = {"layers": jcfg.n_layers, "enc_layers": jcfg.n_enc_layers}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        keys = [str(p.key) for p in path]
        arr = np.asarray(leaf)
        rows = ([([keys[0], str(i)] + keys[1:], arr[i]) for i in range(stacked[keys[0]])]
                if keys[0] in stacked else [(keys, arr)])
        for k, a in rows:
            got = state.pop(".".join(k))
            assert got.dtype == torch.float32 and np.array_equal(got.numpy(), a), k
    assert not state, f"port parameters with no reference leaf: {sorted(state)}"
    assert set(model.layers[0].state_dict()) >= {"ln_x.scale", "ln_x.bias", "xattn.wq"}
    assert not hasattr(model.enc_layers[0], "xattn")


def test_module_ravel_is_ravel_pytree():
    """``tree_ravel``, ``layout_flat`` and ``module_tree`` give
    ``ravel_pytree``'s vector and tree: top-level keys ``embedding``,
    ``enc_in_proj``, ``enc_layers``, ``enc_norm``, ``final_norm``,
    ``layers``; a cross block's ``attn``, ``ffn``, ``ln1``, ``ln2``,
    ``ln_x``, ``xattn``."""
    jcfg, tcfg = _configs()
    tree = _reference(jcfg)[1]
    want = np.asarray(ravel_pytree(tree)[0])
    model = TM.params_from_jax(tree, tcfg, device="cpu")
    assert F.tree_ravel(model)[0].numpy().tobytes() == want.tobytes()
    flat = F.layout_flat(model)
    assert flat.numpy().tobytes() == want.tobytes()
    got = F.module_tree(model)
    assert list(got) == ["embedding", "enc_in_proj", "enc_layers", "enc_norm", "final_norm",
                         "layers"]
    assert sorted(got["layers"]) == ["attn", "ffn", "ln1", "ln2", "ln_x", "xattn"]
    assert jax.tree.structure(got) == jax.tree.structure(tree)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(tree)[0], F.tree_leaves(got)):
        assert g.shape == w.shape and np.array_equal(g.numpy(), w), path
        assert g.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
    rows = F.unravel_rows(torch.stack([flat, 2 * flat]), model)
    assert torch.equal(rows["enc_layers"]["attn"]["wq"][1], 2 * got["enc_layers"]["attn"]["wq"])
    assert F.tree_size(model) == want.size


def test_cache_shapes_and_specs_match_the_reference():
    """``cache_shapes`` (``enc_out`` at ``ENC_LEN_DECODE`` positions),
    ``init_cache(enc_len=)``, ``train_specs`` and ``dummy_batch`` against
    the reference's, shapes and types, reduced and full."""
    shape = dataclasses.replace(tshapes.DECODE_32K, global_batch=2, seq_len=64)
    for jcfg, tcfg in (_configs(), (ARCHS[NAME], tregistry.get_config(NAME))):
        want = {k: v for k, v in jcache_shapes(jcfg, shape).items() if k != "idx"}
        got = tserve.cache_shapes(tcfg, shape)
        assert got["idx"] == 0 and set(got) == {"idx", "enc_out", "layers"}
        got = {k: v for k, v in got.items() if k != "idx"}
        assert got["enc_out"].shape == (2, tspecs.ENC_LEN_DECODE, tcfg.d_model)
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                F.tree_leaves(got)):
            assert tuple(g.shape) == w.shape, (tcfg.name, path)
            assert str(g.dtype) == f"torch.{w.dtype.name}", (tcfg.name, path)
        wspecs = jspecs.train_specs(jcfg, shape)
        gspecs = tspecs.train_specs(tcfg, shape)
        assert set(gspecs) == set(wspecs) == {"frames", "tokens"}
        for k, w in wspecs.items():
            assert gspecs[k].shape == w.shape and str(gspecs[k].dtype) == f"torch.{w.dtype}"
    jcfg, tcfg = _configs()
    cache = TM.init_cache(tcfg, 2, 64, device="cpu", enc_len=12)
    jcache = JM.init_cache(jcfg, 2, 64, enc_len=12)
    assert cache["enc_out"].shape == jcache["enc_out"].shape == (2, 12, tcfg.d_model)
    assert cache["layers"]["k"].shape == jcache["layers"]["k"].shape
    batch = tspecs.dummy_batch(tcfg, 2, 16, torch.Generator().manual_seed(0), device="cpu")
    jbatch = jspecs.dummy_batch(jcfg, 2, 16)
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {k: v.shape for k, v in jbatch.items()}
    assert batch["frames"].dtype == torch.float32 and int(batch["tokens"].max()) < 512


# ---------------------------------------------------------------------------
# attention alone


@pytest.mark.parametrize("mode", ["cross", "encoder", "causal"])
def test_attention_modes_and_the_flash_branch(mode, monkeypatch):
    """``attention_fwd`` of the first cross block at 160 queries with the
    threshold at 128, ``flash=True`` and ``REPRO_FLASH_KERNEL=1``: the
    cross-attention (K and V from a 192-position source, no RoPE, no mask)
    and the encoder's non-causal self-attention take the chunked online
    softmax in both packages and never the flash kernel; the causal
    self-attention (the control) takes it once."""
    monkeypatch.setattr(jlayers, "SDPA_CHUNK_THRESHOLD", 128)
    monkeypatch.setattr(tlayers, "SDPA_CHUNK_THRESHOLD", 128)
    monkeypatch.setenv("REPRO_FLASH_KERNEL", "1")
    shapes = _record_flash(monkeypatch)
    jcfg, jparams, tcfg, model = _models()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 160, tcfg.d_model)).astype(np.float32)
    src = rng.standard_normal((1, 192, tcfg.d_model)).astype(np.float32)
    pos = np.arange(160)[None, :]
    kw = {"cross": dict(causal=False, kv_source=src, use_rope=False),
          "encoder": dict(causal=False), "causal": {}}[mode]
    which = "xattn" if mode == "cross" else "attn"
    jp = jax.tree.map(lambda a: a[0], jparams["layers"][which])
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    want, _ = jax.jit(lambda p, x, pos: jlayers.attention_fwd(jcfg, p, x, pos, **jkw))(
        jp, jnp.asarray(x), jnp.asarray(pos))
    tkw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    got, cache = tlayers.attention_fwd(tcfg, getattr(model.layers[0], which),
                                       torch.as_tensor(x), torch.as_tensor(pos), flash=True,
                                       **tkw)
    assert cache is None and got.shape == (1, 160, tcfg.d_model)
    _close(got, want)
    assert shapes == ([(tcfg.n_heads, 160, tcfg.head_dim_)] if mode == "causal" else [])


# ---------------------------------------------------------------------------
# prefill


def test_prefill_matches_forward_dense_route():
    """Frames of 20 positions, 24 tokens: the encoder's and the decoder's
    own lengths."""
    jcfg, jparams, tcfg, model = _models()
    batch = _batch(tcfg, 2, 24, S_enc=20)
    want, waux = _jax_forward(jcfg, jparams, batch)
    got = tserve.build_prefill(tcfg, device="cpu")(model, _torch(batch))
    assert got.shape == (2, 24, tcfg.vocab_size) and got.dtype == torch.float32
    _close(got, want)
    _close(TM._encode(tcfg, model, torch.as_tensor(batch["frames"])),
           _jax_encode(jcfg, jparams, batch["frames"]))
    assert float(waux) == 0.0


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "chunked"])
def test_prefill_matches_forward_long_route(flash, monkeypatch):
    """S = S_enc = 256 with the threshold at 128: the decoder's causal
    self-attention takes the flash branch once a layer (JAX's Pallas
    kernel in interpret mode, the port's plain version) or the chunked
    scan; the encoder and the cross-attention take the chunked scan."""
    monkeypatch.setattr(jlayers, "SDPA_CHUNK_THRESHOLD", 128)
    monkeypatch.setattr(tlayers, "SDPA_CHUNK_THRESHOLD", 128)
    monkeypatch.setenv("REPRO_FLASH_KERNEL", "1" if flash else "0")
    shapes = _record_flash(monkeypatch)
    jcfg, jparams, tcfg, model = _models()
    batch = _batch(tcfg, 1, 256)
    want, _ = _jax_forward(jcfg, jparams, batch)
    got = tserve.build_prefill(tcfg, device="cpu", flash=flash)(model, _torch(batch))
    _close(got, want)
    assert shapes == ([(tcfg.n_heads, 256, tcfg.head_dim_)] * tcfg.n_layers if flash else [])


# ---------------------------------------------------------------------------
# loss


@pytest.mark.parametrize("chunk", [0, 8])
def test_loss_and_grad_match_reference(chunk):
    """The full-logits loss (an encoder-decoder ignores ``loss_chunk``, in
    both packages) and every gradient leaf, the encoder's included."""
    jcfg, tcfg = _configs(loss_chunk=chunk)
    tree = _reference(jcfg)[1]
    batch = _batch(tcfg, 2, 17, S_enc=13, seed=2)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, _jax(batch)), has_aux=True))(tree)
    model = TM.params_from_jax(tree, tcfg, device="cpu")
    F.layout_flat(model)
    lt, gt = tr.loss_and_grad(tcfg, model, _torch(batch))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    with torch.no_grad():
        _, mt = TM.loss_fn(tcfg, model, _torch(batch))
        want_ce = TM.loss_fn(dataclasses.replace(tcfg, loss_chunk=0), model, _torch(batch))[0]
    assert float(mt["ce"]) == float(want_ce)
    for k in ("aux", "ce"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5, err_msg=k)
    grads = F.unravel_like(gt, model)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(gj)[0], F.tree_leaves(grads)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * min(1.0, float(np.abs(w).max())),
                                   err_msg=jax.tree_util.keystr(path))
    for leaf in (grads["enc_in_proj"], grads["enc_layers"]["attn"]["wq"],
                 grads["layers"]["xattn"]["wk"]):
        assert float(leaf.abs().max()) > 0


# ---------------------------------------------------------------------------
# decode


def _jax_steps(jcfg, jparams, B, total, enc_out, toks):
    cache = JM.init_cache(jcfg, B, total, enc_len=enc_out.shape[1])
    cache["enc_out"] = jnp.asarray(enc_out)
    step = jax.jit(functools.partial(JM.decode_step, jcfg))
    out = []
    for t in toks:
        logits, cache = step(jparams, cache, jnp.asarray(t))
        out.append(np.asarray(logits))
    return out, cache


def _port_steps(tcfg, model, B, total, enc_out, toks):
    cache = TM.init_cache(tcfg, B, total, device="cpu", enc_len=enc_out.shape[1])
    cache["enc_out"].copy_(torch.as_tensor(np.array(enc_out)))
    step = tserve.build_decode_step(tcfg, device="cpu")
    out = []
    for t in toks:
        logits, cache = step(model, cache, torch.as_tensor(t))
        out.append(logits)
    return out, cache


def test_decode_steps_match_decode_step():
    """Three decode steps, every layer cross-attending to the reference's
    encoder output of 10 frames written into both caches: logits and every
    cache tensor (``enc_out`` carried unchanged) against the reference's
    ``decode_step``."""
    jcfg, jparams, tcfg, model = _models()
    B, total = 2, 16
    enc_out = np.asarray(_jax_encode(jcfg, jparams, _batch(tcfg, B, 4, S_enc=10)["frames"]))
    toks = [_batch(tcfg, B, 1, seed=s)["tokens"] for s in range(3)]
    want, jcache = _jax_steps(jcfg, jparams, B, total, enc_out, toks)
    got, tcache = _port_steps(tcfg, model, B, total, enc_out, toks)
    for g, w in zip(got, want):
        assert g.shape == (B, 1, tcfg.vocab_size)
        _close(g, w)
    assert tcache["idx"] == int(jcache["idx"]) == 3
    assert set(tcache) == set(jcache) == {"idx", "enc_out", "layers"}
    assert np.array_equal(tcache["enc_out"].numpy(), enc_out)
    leaves = jax.tree_util.tree_flatten_with_path({k: v for k, v in jcache.items()
                                                  if k != "idx"})[0]
    ported = F.tree_leaves({k: v for k, v in tcache.items() if k != "idx"})
    assert len(leaves) == len(ported)
    for (path, w), g in zip(leaves, ported):
        assert tuple(g.shape) == w.shape, path
        _close(g, w)


def test_decode_through_a_prompt_matches_prefill():
    """Stepping one token at a time through a prompt, with ``_encode``'s
    output of the same frames in the cache, gives at every position the
    logits of one prefill of those frames and tokens."""
    _, _, tcfg, model = _models()
    batch = _batch(tcfg, 2, 12, S_enc=9, seed=5)
    prefill = tserve.build_prefill(tcfg, device="cpu")(model, _torch(batch))
    with torch.no_grad():
        enc_out = TM._encode(tcfg, model, torch.as_tensor(batch["frames"])).numpy()
    tok = batch["tokens"]
    stepped, cache = _port_steps(tcfg, model, 2, 12, enc_out,
                                 [tok[:, i:i + 1] for i in range(12)])
    _close(torch.cat(stepped, dim=1), prefill)
    assert cache["idx"] == 12


# ---------------------------------------------------------------------------
# the trainer


# the trajectory's width: the reduced Seamless narrowed as
# tests/test_torch_trainer.py narrows Qwen
SMALL = dict(d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=128)


def test_robust_dp_matches_reference():
    """Three steps of the trainer on the narrowed Seamless, K=4, each
    candidate's rows of the frames and the tokens, against the reference's
    composed step: robust_dp stacked on the fused backend (its plain
    version here), one candidate under IPM-100: loss, weights, masks and
    every parameter, the encoder's included, after each step."""
    from test_torch_trainer import _hold_trajectory, _tcs

    jcfg, cfg = _configs(**SMALL)
    agg = dict(method="wfagg", layout="stacked", backend="reference")
    jtc, tc = _tcs(4, attack="ipm_100", n_malicious=1, agg=agg)
    tc = dataclasses.replace(tc, agg=dataclasses.replace(tc.agg, backend="fused"))
    frames = np.random.default_rng(7).standard_normal((3, 8, 24, 64)).astype(np.float32)
    st, m = _hold_trajectory(jcfg, cfg, jtc, tc, 4, extra=lambda i: {"frames": frames[i]})
    assert float(m["weights"][2]) == 0.0
    assert "enc_layers" in F.module_tree(st.params)
