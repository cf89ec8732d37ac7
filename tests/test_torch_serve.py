"""The port's serving path for the dense family (prefill and KV-cache
decode) held against the JAX package, with the same weights carried across
by ``params_from_jax`` and the same numpy tokens.

Reduced configs (2 layers, d_model 256, 4 heads of 64, f32 end to end):
Qwen1.5-0.5B (QKV bias, tied embeddings), StableLM-3B (LayerNorm), Yi-6B,
and Yi-6B with 2 KV heads (``reduced()`` clips the KV heads to the heads,
so GQA needs its own variant).  Logits and caches agree within rtol = atol
= 1e-4: the only differences are f32 sums taken in another order (the
routes of the reference agreed within 5.5e-6 of each other on this probe).
The flash branch needs a KV length of ``SDPA_CHUNK_THRESHOLD`` (8192);
the tests lower it to 128 in both packages, by monkeypatch, so that S=256
reaches it.  No file of the JAX package changes.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS
from repro.models import layers as jlayers
from repro.models import model as JM
from repro_torch.configs import registry as tregistry
from repro_torch.configs import shapes as tshapes
from repro_torch.data import specs as tspecs
from repro_torch.kernels.flash_attn import ops as tflash_ops
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.train import serve as tserve

TOL = 1e-4
NAMES = ["qwen1.5-0.5b", "stablelm-3b", "yi-6b", "yi-6b-gqa2"]
DENSE = ["qwen1.5-0.5b", "stablelm-3b", "yi-6b"]
MOE = ["deepseek-v2-lite-16b", "moonshot-v1-16b-a3b", "arctic-480b"]


def _configs(name, **over):
    """The reduced config of ``name`` in both packages."""
    base = name.removesuffix("-gqa2")
    if name.endswith("-gqa2"):
        over = dict(over, n_kv_heads=2)
    return (dataclasses.replace(ARCHS[base].reduced(), **over),
            dataclasses.replace(tregistry.get_config(base).reduced(), **over))


@functools.lru_cache(maxsize=None)
def _reference(jcfg, seed):
    """The reference's parameters of a config, made once a module (jitted)."""
    jparams = jax.jit(functools.partial(JM.init_params, jcfg))(jax.random.PRNGKey(seed))
    return jparams, jax.tree.map(np.asarray, jparams)


def _models(name, seed=0, **over):
    jcfg, tcfg = _configs(name, **over)
    jparams, tree = _reference(jcfg, seed)
    return jcfg, jparams, tcfg, TM.params_from_jax(tree, tcfg, device="cpu")


def _jax_forward(jcfg, jparams, tok):
    """The reference's ``forward``, jitted anew on each call: a trace reads
    ``SDPA_CHUNK_THRESHOLD`` and ``REPRO_FLASH_KERNEL``, which tests
    monkeypatch."""
    return jax.jit(functools.partial(JM.forward, jcfg))(jparams, {"tokens": jnp.asarray(tok)})


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# configs and weights


@pytest.mark.parametrize("name", DENSE + MOE + ["lenet-mnist"])
def test_configs_match_the_reference(name):
    """The port's copies of the configs: every field, the reduced variant
    and the analytic parameter count equal the reference's."""
    from repro.configs.registry import get_config as jget
    jcfg, tcfg = jget(name), tregistry.get_config(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(jcfg.reduced())
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.head_dim_ == jcfg.head_dim_


def test_shapes_specs_and_cache_layout():
    from repro.configs import shapes as jshapes
    from repro.data.specs import ENC_LEN_DECODE
    from repro.train.serve import cache_shapes as jcache_shapes
    assert {n: dataclasses.asdict(s) for n, s in tshapes.SHAPES.items()} == \
        {n: dataclasses.asdict(s) for n, s in jshapes.SHAPES.items()}
    assert tspecs.ENC_LEN_DECODE == ENC_LEN_DECODE
    jcfg, tcfg = _configs("yi-6b-gqa2")
    shape = dataclasses.replace(tshapes.DECODE_32K, global_batch=2, seq_len=64)
    jshape = dataclasses.replace(jshapes.DECODE_32K, global_batch=2, seq_len=64)
    want = jcache_shapes(jcfg, jshape)["layers"]["k"]
    got = tserve.cache_shapes(tcfg, shape)["layers"]["k"]
    assert got.shape == want.shape and str(got.dtype).endswith(str(want.dtype))
    spec = tspecs.train_specs(tcfg, shape)["tokens"]
    assert spec == tspecs.TensorSpec((2, 64), torch.int32)
    batch = tspecs.dummy_batch(tcfg, 2, 16, device="cpu")
    assert batch["tokens"].shape == (2, 16) and int(batch["tokens"].max()) < tcfg.vocab_size


@pytest.mark.parametrize("name", NAMES)
def test_params_from_jax_carries_every_leaf(name):
    """Every leaf of the reference's pytree lands at its path in the
    state dict, the layers unstacked."""
    jcfg, jparams, tcfg, model = _models(name)
    state = model.state_dict()
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    n = 0
    for path, leaf in flat:
        keys = [p.key for p in path]
        if keys[0] == "layers":
            for i in range(jcfg.n_layers):
                assert np.array_equal(state[".".join(["layers", str(i)] + keys[1:])].numpy(),
                                      np.asarray(leaf)[i])
                n += 1
        else:
            assert np.array_equal(state[".".join(keys)].numpy(), np.asarray(leaf))
            n += 1
    assert n == len(state)


# ---------------------------------------------------------------------------
# prefill


@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_forward_dense_route(name):
    jcfg, jparams, tcfg, model = _models(name)
    tok = _tokens(tcfg, 2, 32)
    want, _ = _jax_forward(jcfg, jparams, tok)
    got = tserve.build_prefill(tcfg, device="cpu")(model, {"tokens": torch.as_tensor(tok)})
    assert got.shape == (2, 32, tcfg.vocab_size) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "chunked"])
@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_forward_long_route(name, flash, monkeypatch):
    """S=256 with the threshold at 128: the flash branch.  JAX runs its
    Pallas kernel (REPRO_FLASH_KERNEL=1, interpret mode) or its chunked scan
    (=0); the port runs ``flash=True`` (the kernel's plain version here, once
    per layer) or ``flash=False`` (its chunked online softmax)."""
    monkeypatch.setattr(jlayers, "SDPA_CHUNK_THRESHOLD", 128)
    monkeypatch.setattr(tlayers, "SDPA_CHUNK_THRESHOLD", 128)
    monkeypatch.setenv("REPRO_FLASH_KERNEL", "1" if flash else "0")
    calls = []
    plain = tflash_ops.flash_attention_plain
    monkeypatch.setattr(tflash_ops, "flash_attention_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    jcfg, jparams, tcfg, model = _models(name)
    tok = _tokens(tcfg, 1, 256)
    want, _ = _jax_forward(jcfg, jparams, tok)
    got = tserve.build_prefill(tcfg, device="cpu", flash=flash)(
        model, {"tokens": torch.as_tensor(tok)})
    _close(got, want)
    assert len(calls) == (tcfg.n_layers if flash else 0)


# ---------------------------------------------------------------------------
# decode


def _jax_steps(jcfg, jparams, B, total, toks):
    cache = JM.init_cache(jcfg, B, total)
    step = jax.jit(lambda c, t: JM.decode_step(jcfg, jparams, c, t))
    out = []
    for t in toks:
        logits, cache = step(cache, jnp.asarray(t))
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


@pytest.mark.parametrize("name", NAMES)
def test_decode_steps_match_decode_step(name):
    """Three decode steps: logits and the cache (written in place) against
    the reference's ``decode_step``."""
    jcfg, jparams, tcfg, model = _models(name)
    B, total = 2, 16
    toks = [_tokens(tcfg, B, 1, seed=s) for s in range(3)]
    want, jcache = _jax_steps(jcfg, jparams, B, total, toks)
    got, tcache = _port_steps(tcfg, model, B, total, toks)
    for g, w in zip(got, want):
        assert g.shape == (B, 1, tcfg.vocab_size)
        _close(g, w)
    assert tcache["idx"] == int(jcache["idx"]) == 3
    for n in ("k", "v"):
        assert tcache["layers"][n].shape == jcache["layers"][n].shape
        _close(tcache["layers"][n], jcache["layers"][n])


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "yi-6b-gqa2"])
def test_sliding_window_ring_matches_reference(name):
    """A ring-buffer cache of 8 slots over 16 steps (it wraps twice): every
    step's logits and the final ring against the reference."""
    jcfg, jparams, tcfg, model = _models(name, sliding_window=8)
    B, total = 2, 32
    toks = [_tokens(tcfg, B, 1, seed=10 + s) for s in range(16)]
    want, jcache = _jax_steps(jcfg, jparams, B, total, toks)
    got, tcache = _port_steps(tcfg, model, B, total, toks)
    assert tcache["layers"]["k"].shape[3] == 8
    for g, w in zip(got, want):
        _close(g, w)
    for n in ("k", "v"):
        _close(tcache["layers"][n], jcache["layers"][n])


@pytest.mark.parametrize("name", NAMES)
def test_decode_through_a_prompt_matches_prefill(name):
    """Stepping one token at a time through a prompt gives, at every
    position, the logits of one prefill of the same tokens."""
    _, _, tcfg, model = _models(name)
    tok = _tokens(tcfg, 2, 12, seed=5)
    prefill = tserve.build_prefill(tcfg, device="cpu")(model, {"tokens": torch.as_tensor(tok)})
    stepped, cache = _port_steps(tcfg, model, 2, 12, [tok[:, i:i + 1] for i in range(12)])
    _close(torch.cat(stepped, dim=1), prefill)
    assert cache["idx"] == 12


# ---------------------------------------------------------------------------
# devices and later slices


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tregistry.get_config("qwen1.5-0.5b").reduced()
    for call in (lambda: tserve.build_prefill(cfg),
                 lambda: tserve.build_decode_step(cfg),
                 lambda: TM.init_params(cfg),
                 lambda: TM.init_cache(cfg, 1, 8),
                 lambda: tspecs.dummy_batch(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_other_families_raise():
    """Every architecture of the reference resolves (the encoder-decoder and
    VLM since their slice: tests/test_torch_{encdec,vlm}.py; MoE, MLA and
    head padding since theirs: tests/test_torch_moe*.py; the SSM and
    hybrid families since theirs: tests/test_torch_ssm*.py, and as an
    override of a config without a Mamba variant they raise ValueError),
    and ``NOT_PORTED`` is empty.  What still raises: the paper's CNN as a
    language model, on one card, on the model axis and on a grid.  Every
    other family runs on the model axis and on a grid, the encoder-decoder
    and VLM since ROADMAP queue 1, item 12.8
    (tests/test_torch_tp_encdec.py).  Training with bf16 parameters (item 12.4)
    builds its state and step: tests/test_torch_bf16_train.py holds it to
    the reference."""
    from repro.configs.registry import ARCHS as JARCHS
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train import trainer as tr
    assert tregistry.NOT_PORTED == ()
    for name in JARCHS:
        assert tregistry.get_config(name).name == name
    with pytest.raises(KeyError, match="unknown arch"):
        tregistry.get_config("gpt-2")
    cfg = tregistry.get_config("qwen1.5-0.5b").reduced()
    for over in ({"family": "ssm"}, {"family": "hybrid"}):
        bad = dataclasses.replace(cfg, **over)
        with pytest.raises(ValueError, match="ssm_variant"):
            TM.init_params(bad, device="cpu")
    bad = dataclasses.replace(tregistry.get_config("zamba2-1.2b").reduced(), n_layers=3)
    with pytest.raises(ValueError, match="groups of shared_attn_every"):
        TM.init_cache(bad, 1, 8, device="cpu")
    lenet = tregistry.get_config("lenet-mnist")
    assert lenet.family == "cnn"
    for call in (lambda: TM.init_params(lenet, device="cpu"),
                 lambda: TM.init_cache(lenet, 1, 8, device="cpu")):
        with pytest.raises(NotImplementedError, match="not a language model"):
            call()
    from repro_torch.launch.mesh import DataAxis, Mesh

    class Grid(Mesh):     # the data axis as processes, no live group reached
        def data_axis(self):
            return DataAxis(None, self.shape["data"], 0)

    meshes = (Mesh(shape={"data": 2, "model": 2}), Grid(shape={"data": 2, "model": 2}))
    for name in JARCHS:
        c = tregistry.get_config(name)
        if c.family == "cnn":
            for mesh in meshes:
                with pytest.raises(NotImplementedError, match="not a language model"):
                    tr._check(c, tr.TrainConfig(), mesh)
            continue
        tlayers.check_family(c)
        for mesh in meshes:
            assert tr._check(c, tr.TrainConfig(), mesh) is None
    bf16 = dataclasses.replace(tregistry.get_config("arctic-480b").reduced(),
                               param_dtype="bfloat16")
    st = tr.init_train_state(bf16, tr.TrainConfig(), mesh=make_test_mesh(data=2), device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in st.params.parameters())
    assert callable(tr.build_train_step(bf16, tr.TrainConfig(), make_test_mesh(data=2)))


def test_port_init_is_seeded_and_finite():
    """The port's own init (values need not match JAX's): the same seed
    gives the same weights, the reference's shapes, zero biases, unit
    norms, and finite logits through prefill."""
    cfg = tregistry.get_config("qwen1.5-0.5b").reduced()
    a = TM.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = TM.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    sd = a.state_dict()
    assert sd["layers.1.attn.wq"].shape == (cfg.d_model, cfg.n_heads * cfg.head_dim_)
    assert torch.all(sd["layers.0.attn.bq"] == 0) and torch.all(sd["final_norm.scale"] == 1)
    w = sd["layers.0.ffn.w_up"]
    assert float(w.abs().max()) <= 2.0 / cfg.d_model ** 0.5 + 1e-6
    logits = tserve.build_prefill(cfg, device="cpu")(
        a, {"tokens": torch.as_tensor(_tokens(cfg, 1, 8))})
    assert torch.isfinite(logits).all()
