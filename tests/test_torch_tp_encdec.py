"""The encoder-decoder and VLM families on the model axis and on the grid:
the reduced configs split over ``gloo`` ranks on the CPU
(``tests/_torch_spmd_child.py``'s ``task_fam``, spawned once per mesh for
the whole module: M = 2, M = 4 for the padded heads, and a 2 x 2 grid)
and held to the one-process port and to the JAX package on the same
numpy weights, frames, patch embeddings and tokens.

Configs (reduced, float32): the Seamless-like one (2 encoder + 2 decoder
layers, d 256, 4 heads of 64, LayerNorm: the encoder stack, the cross
blocks' ``ln_x`` / ``xattn``), the LLaVA-like one (2 layers, d 256, 4
heads of 64 padded to 64, 16 patch embeddings through the projector: at
M = 2 a rank pads its 2 heads to 32, the ``Hp`` branch) and, at M = 4
only, a LLaVA-like one with 7 live heads padded to 8 (M does not divide
the live heads: each rank holds 2 head slots of the padded layout, the
``slots`` branch, beside its block of the projector).  The VLM's chunked
loss branch is held at ``loss_chunk`` = 8 (``llava_chunk``).

Tolerances, fixed before the runs (``tests/test_torch_tp_families.py``'s):
  forward, serving   logits within rtol 1e-5 / atol 1e-5 of the
                     one-process port, and within rtol 1e-4 / atol 1e-4 of
                     the JAX package (prefill and decode, the decode's
                     cache holding the encoder output of the prompts'
                     frames);
  gradients          loss rtol 1e-5 of one process and of JAX; gradient
                     leaves within rtol 1e-4 / atol 1e-4 times the leaf's
                     largest magnitude (at most 1e-4) of the JAX package
                     and rtol 1e-5 / atol 1e-5 times the leaf's largest
                     magnitude of one process;
  statistics         the psum'd sums within rtol 1e-5 of the whole
                     candidates' in float64, the Gram with an atol of 1e-5
                     of its largest entry (its float32 products over the
                     3.5e6 coordinates of the Seamless-like model sit 1.7e-5
                     from float64 on the diagonal); a replicated leaf
                     counted twice, such as ``enc_in_proj``, ``enc_norm`` or
                     ``ln_x``, would be off by its share (the smallest, 256
                     coordinates, adds ~256 to a diagonal entry of ~3.5e6,
                     over seven times that atol);
  cut and gather     every leaf's cut and gather round trip bit-equal;
  trajectory         3 steps: params within rtol 1e-4 / atol 1e-5 of the
                     reference's composed step (``ReferenceStep``) and
                     rtol 1e-5 / atol 1e-6 of the one-process trainer,
                     weights and masks equal, loss rtol 1e-5 and 1e-6;
  flat step          one step of the flat layout on the model axis:
                     masks equal, weights within 1e-6, loss rtol 1e-5,
                     params as the trajectory's (``test_torch_flat_tp.py``);
  checkpoints        bit-equal across mesh shapes (saved on the mesh and
                     loaded into one process; saved by one process and
                     loaded onto the mesh).

M = 2 trains K = 4 candidates (WFAgg on the fused route under IPM-100,
one attacker), the 2 x 2 grid its K = 2 candidates with the mean, each
candidate on its rows of the frames or patch embeddings beside its
tokens."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core import wfagg as jwf
from repro.data.synthetic import TokenStream as JTokenStream
from repro.distributed import robust_allreduce as jra
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.train import trainer as jtr
from repro_torch.configs.registry import get_config
from repro_torch.core import flatten as F
from repro_torch.core import wfagg as twf
from repro_torch.core.topology import spaced_malicious
from repro_torch.distributed import robust_allreduce as tra
from repro_torch.launch.mesh import DataAxis, Mesh, ModelAxis, make_test_mesh
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import serve as sv
from repro_torch.train import trainer as tr

from _torch_fixtures import reference_sketch_hash
from _torch_spmd_child import run_ranks, same_on_every_rank
from test_torch_trainer import ReferenceStep, _reference_state

CONFIGS = {
    "seamless": ("seamless-m4t-medium", {}),
    "llava": ("llava-next-34b", {}),
    "llava_chunk": ("llava-next-34b", dict(loss_chunk=8)),
    "llava_padded": ("llava-next-34b",
                     dict(d_model=64, vocab_size=128, n_layers=1, n_heads=7, n_kv_heads=1,
                          pad_heads_to=8, head_dim=16, d_ff=32)),
}
FAMILIES = ["seamless", "llava"]
TRAIN_K = 4
STEPS = 3
CANDS = 4
PROMPT = (2, 136)  # tokens; LLaVA's 16 patches lead them, Seamless encodes 128 frames
PROMPT_FRAMES = 128
DECODE = 12        # prompt tokens decoded before the greedy steps
CHUNK, SKETCH = 1 << 16, 512    # the flat step's chunk and sketch widths
TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _cfgs(key):
    arch, over = CONFIGS[key]
    return (dataclasses.replace(jget_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


@functools.lru_cache(maxsize=None)
def _params(key):
    jcfg, _ = _cfgs(key)
    return jax.tree.map(np.asarray, jax.jit(functools.partial(JM.init_params, jcfg))(
        jax.random.PRNGKey(0)))


def _extra(cfg, B, rng, S_enc):
    """The modal input beside B rows of tokens: ``frames`` (B, S_enc, d) or
    ``patch_embeds`` (B, n_modal, 1024)."""
    if cfg.is_encoder_decoder:
        return {"frames": rng.standard_normal((B, S_enc, cfg.d_model)).astype(np.float32)}
    return {"patch_embeds": rng.standard_normal(
        (B, cfg.n_modal_tokens, TM.MODAL_EMBED_DIM)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _inputs(key):
    cfg = _cfgs(key)[1]
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    extra = _extra(cfg, 2, rng, 20)
    prompts = rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32)
    prompt_extra = _extra(cfg, PROMPT[0], rng, PROMPT_FRAMES)
    crng = np.random.default_rng(2)
    cands = jax.tree.map(lambda p: crng.standard_normal((CANDS,) + p.shape).astype(np.float32),
                         _params(key))
    return tokens, extra, prompts, prompt_extra, cands


def _batch(tokens, extra):
    return {"tokens": torch.as_tensor(tokens).long(),
            **{k: torch.as_tensor(v) for k, v in extra.items()}}


def _jbatch(tokens, extra):
    return {"tokens": jnp.asarray(tokens), **{k: jnp.asarray(v) for k, v in extra.items()}}


def _tcs(method, attack, n_mal, layout="stacked"):
    w = dict(f=1, transient=1, window=2)
    common = dict(method=method, layout=layout, chunk_size=CHUNK, sketch_dim=SKETCH)
    jtc = jtr.TrainConfig(agg=jra.RobustAggConfig(backend="reference",
                                                  wfagg=jwf.WFAggConfig(**w), **common),
                          attack=attack, n_malicious=n_mal, lr=1e-2, warmup=0, donate=False)
    tc = tr.TrainConfig(agg=tra.RobustAggConfig(backend="fused", wfagg=twf.WFAggConfig(**w),
                                                **common),
                        attack=attack, n_malicious=n_mal, lr=1e-2, warmup=0)
    return jtc, tc


def _state_np(sj):
    agg = sj.agg_state
    if agg is not None and hasattr(agg, "temporal"):
        agg = {"temporal": list(agg.temporal)}
    elif agg is not None:
        agg = dict(prev=agg.prev, hist_s=agg.hist_s, hist_b=agg.hist_b, count=agg.count, t=agg.t)
    return {"params": sj.params, "opt_state": sj.opt_state, "step": int(sj.step),
            "agg_state": agg}


def _sketch_table(keys):
    """The reference's count-sketch buckets and signs of every whole-vector
    chunk of the configs ``keys``, as numpy (the ranks' ``sketch_hash``)."""
    n = -(-max(sum(x.size for x in jax.tree.leaves(_params(k))) for k in keys) // CHUNK)
    return {ci: tuple(x.numpy() for x in reference_sketch_hash(CHUNK, SKETCH, 0, ci, "cpu"))
            for ci in range(n)}


class Run:
    """One spawn of ``task_fam`` on a mesh (K, M) over some configs, and the
    inputs it saw."""

    def __init__(self, keys, shape, tmp, parts, train=None, flat=None, launcher=False):
        self.shape, self.keys, self.tmp = shape, keys, str(tmp)
        self.train, self.flat = {}, {}
        runs = []
        for key in keys:
            tokens, extra, prompts, prompt_extra, cands = _inputs(key)
            run = dict(cfg=_cfgs(key)[1], params=_params(key), tokens=tokens, extra=extra,
                       prompts=prompts, prompt_extra=prompt_extra, cands=cands,
                       parts=parts(key), decode_len=DECODE)
            if train and "train" in run["parts"]:
                run["train"] = self._train_inputs(key, train, "stacked", STEPS, self.train)
            if flat and "flat" in run["parts"]:
                run["flat"] = self._train_inputs(key, flat, "flat", 1, self.flat)
            runs.append(run)
        self.inputs = dict(zip(keys, runs))
        kw = {}
        if launcher:
            kw = dict(launcher=("llava-next-34b", f"{self.tmp}/launcher"),
                      launcher_raises="seamless-m4t-medium")
        out = run_ranks("fam", shape[0] * shape[1], tmp, timeout=300, runs=runs,
                        mesh_shape=shape, sketch=_sketch_table(keys) if flat else None, **kw)
        self.ranks = out
        self.out = dict(zip(keys, out[0]))
        self.launcher_error = out[0][-1]["launcher_error"] if launcher else None

    def _train_inputs(self, key, spec, layout, steps, into):
        method, attack, n_mal, K = spec
        jcfg, cfg = _cfgs(key)
        jtc, tc = _tcs(method, attack, n_mal, layout)
        sj = jax.tree.map(np.asarray, _reference_state(jcfg, jtc, K))
        stream = JTokenStream(vocab_size=jcfg.vocab_size, seq_len=32, batch_size=2 * K)
        rng = np.random.default_rng(7)
        batches = [np.asarray(stream.batch(i)["tokens"]) for i in range(steps)]
        extras = [_extra(cfg, 2 * K, rng, 16) for _ in range(steps)]
        d = f"{self.tmp}/{key}"
        if layout == "stacked":
            one = TM.params_from_jax(_params(key), cfg, "cpu")
            F.layout_flat(one)
            ckpt.save_checkpoint(d + "/one", "one", F.module_tree(one))
            into[key] = dict(jtc=jtc, tc=tc, sj=sj, batches=batches, extras=extras, K=K, one=one)
        else:
            into[key] = dict(jtc=jtc, tc=tc, sj=sj, batches=batches, extras=extras, K=K)
        return {"tc": tc, "K": K, "state": _state_np(sj), "batches": batches, "extras": extras,
                "ckpt": d + "/mesh", "load": d + "/one"}


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    return Run(FAMILIES + ["llava_chunk"], (1, 2), tmp_path_factory.mktemp("encdec2"),
               lambda key: (("grads",) if key == "llava_chunk" else
                            ("forward", "grads", "roundtrip", "stats", "train", "flat",
                             "serve")),
               train=("wfagg", "ipm_100", 1, TRAIN_K), flat=("wfagg", "ipm_100", 1, TRAIN_K),
               launcher=True)


@pytest.fixture(scope="module")
def tp4(tmp_path_factory):
    return Run(["llava_padded"], (1, 4), tmp_path_factory.mktemp("encdec4"),
               lambda key: ("forward", "grads", "roundtrip", "serve"))


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return Run(FAMILIES, (2, 2), tmp_path_factory.mktemp("encdecgrid"),
               lambda key: ("forward", "roundtrip", "stats", "train", "serve"),
               train=("mean", "none", 0, 2))


@pytest.fixture(autouse=True)
def _reference_sketch(monkeypatch):
    monkeypatch.setattr(tra, "sketch_hash", functools.lru_cache(maxsize=None)(
        reference_sketch_hash))


RUNS = [("tp2", k) for k in FAMILIES] + [("grid", k) for k in FAMILIES] + \
    [("tp4", "llava_padded")]


def _one(key):
    return TM.params_from_jax(_params(key), _cfgs(key)[1], "cpu")


@functools.lru_cache(maxsize=None)
def _jax_forward(key):
    jcfg = _cfgs(key)[0]
    return jax.jit(lambda p, b: JM.forward(jcfg, p, b)[0])


@pytest.mark.parametrize("which,key", RUNS)
def test_forward_matches_one_process_and_reference(which, key, request):
    run = request.getfixturevalue(which)
    cfg = _cfgs(key)[1]
    tokens, extra = run.inputs[key]["tokens"], run.inputs[key]["extra"]
    want = np.asarray(_jax_forward(key)(_params(key), _jbatch(tokens, extra)))
    one, _ = TM.forward(cfg, _one(key), _batch(tokens, extra))
    got = run.out[key]["logits"]
    np.testing.assert_allclose(got, one.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert same_on_every_rank([r[run.keys.index(key)]["logits"] for r in run.ranks])


@pytest.mark.parametrize("which,key", [("tp2", k) for k in FAMILIES + ["llava_chunk"]] +
                         [("tp4", "llava_padded")])
def test_loss_and_gradients_match_reference(which, key, request):
    """The encoder-decoder's unchunked loss and the VLM's two conventions
    (unchunked: the text logits; chunked: labels after ``n_modal`` zeros)
    over the rank's vocabulary block; every gradient leaf, the replicated
    ``enc_in_proj``, ``enc_norm`` and ``ln_x`` whole on every rank."""
    run = request.getfixturevalue(which)
    jcfg, cfg = _cfgs(key)
    tokens, extra = run.inputs[key]["tokens"], run.inputs[key]["extra"]
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, _jbatch(tokens, extra)), has_aux=True))(_params(key))
    one = _one(key)
    lt, gt = tr.loss_and_grad(cfg, one, _batch(tokens, extra))
    loss, grads = run.out[key]["grads"]
    np.testing.assert_allclose(loss, float(lt), rtol=1e-5)
    np.testing.assert_allclose(loss, float(lj), rtol=1e-5)
    ones = F.tree_leaves(F.unravel_like(gt, F.module_tree(one)))
    for (path, w), g, g1 in zip(jax.tree_util.tree_flatten_with_path(gj)[0], grads, ones):
        label = jax.tree_util.keystr(path)
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=min(TOL, TOL * np.abs(w).max()),
                                   err_msg=label)
        g1 = g1.numpy()
        np.testing.assert_allclose(g, g1, rtol=1e-5, atol=1e-5 * np.abs(g1).max(),
                                   err_msg=label)
    assert same_on_every_rank([r[run.keys.index(key)]["grads"] for r in run.ranks])


@pytest.mark.parametrize("which,key", RUNS)
def test_cut_and_gather_round_trip(which, key, request):
    """Every leaf's cut and gather are inverses, bit for bit; the port's
    own init on the mesh (each block cut as soon as it is drawn, the
    encoder's and the projector's too) is the one-process init, cut."""
    out = request.getfixturevalue(which).out[key]
    assert out["roundtrip"]
    one = TM.init_params(_cfgs(key)[1], torch.Generator().manual_seed(0), "cpu")
    for got, want in zip(out["init"], F.tree_leaves(F.module_tree(one))):
        assert np.array_equal(got, want.numpy())


def test_new_leaves_cut_as_the_specs(tp2, tp4):
    """Each new leaf's model-axis cut: the projector's ``w1`` by columns and
    ``w2`` by rows; ``enc_in_proj``, ``enc_norm`` and the cross blocks'
    ``ln_x`` replicated; the encoder's and the cross-attention's heads split
    as the self-attention's; the padded config's query heads by slots."""
    def cuts(run, key):
        return dict(zip([p for p, _ in F.leaf_params(_one(key))], run.out[key]["split_dims"]))

    sm = cuts(tp2, "seamless")
    assert sm[("enc_in_proj",)] is None and sm[("enc_norm", "scale")] is None
    assert sm[("layers", "ln_x", "scale")] is None and sm[("layers", "ln_x", "bias")] is None
    for stack in ("layers", "enc_layers"):
        assert sm[(stack, "attn", "wq")] == 2 and sm[(stack, "attn", "wo")] == 1
        assert sm[(stack, "ffn", "w_up")] == 2 and sm[(stack, "ffn", "w_down")] == 1
    assert sm[("layers", "xattn", "wk")] == 2 and sm[("layers", "xattn", "wo")] == 1
    for run, key in ((tp2, "llava"), (tp4, "llava_padded")):
        lv = cuts(run, key)
        assert lv[("projector", "w1")] == 1 and lv[("projector", "w2")] == 0
    assert cuts(tp4, "llava_padded")[("layers", "attn", "wq")] == 2
    assert tp4.out["llava_padded"]["cache"]["layers/k"][2] == 1


@pytest.mark.parametrize("which", ["tp2", "grid"])
def test_statistics_count_every_coordinate_once(which, request):
    run = request.getfixturevalue(which)
    for key in FAMILIES:
        whole = np.concatenate([x.reshape(CANDS, -1) for x in
                                jax.tree.leaves(run.inputs[key]["cands"])],
                               axis=1).astype(np.float64)
        med = np.median(whole, axis=0)
        st = run.out[key]["stats"]
        np.testing.assert_allclose(st["dist2"], ((whole - med) ** 2).sum(1), rtol=1e-5,
                                   err_msg=key)
        np.testing.assert_allclose(st["norm2"], (whole ** 2).sum(1), rtol=1e-5, err_msg=key)
        gram = whole @ whole.T
        np.testing.assert_allclose(st["gram"], gram, rtol=1e-5,
                                   atol=1e-5 * np.abs(gram).max(), err_msg=key)


def _one_process_trajectory(t, key):
    cfg = _cfgs(key)[1]
    st = tr.state_from_jax(jax.tree.map(np.asarray, t["sj"]), cfg, device="cpu")
    seen = {}
    step = tr.build_train_step(cfg, t["tc"], make_test_mesh(data=t["K"]),
                               observe=lambda phase, **v: seen.update({phase: v}))
    out = []
    for b, x in zip(t["batches"], t["extras"]):
        st, m = step(st, _batch(b, x))
        info = seen["allreduce"]["info"]
        out.append((m, {k: info[k] for k in ("mask_d", "mask_c", "mask_t") if k in info},
                    [x.clone() for x in F.tree_leaves(F.module_tree(st.params))]))
    return out


@functools.lru_cache(maxsize=None)
def _vg(key):
    """The reference's jitted loss gradient, compiled once a config."""
    jcfg = _cfgs(key)[0]
    return jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(jcfg, p, b), has_aux=True))


def _reference_trajectory(t, key):
    ref = ReferenceStep(_cfgs(key)[0], t["jtc"], t["K"])
    ref.vg = _vg(key)
    sj = t["sj"]
    out = []
    for b, x in zip(t["batches"], t["extras"]):
        sj, mj = ref(sj, _jbatch(b, x))
        out.append((mj, jax.tree.leaves(sj.params)))
    return out


@pytest.mark.parametrize("which,key", [("tp2", k) for k in FAMILIES] +
                         [("grid", k) for k in FAMILIES])
def test_trajectory_matches_one_process_and_reference(which, key, request):
    """3 steps, each candidate on its rows of the frames or patch
    embeddings: at M = 2 IPM-100 on K = 4 (WFAgg, fused route; the
    attacker at weight 0), on the 2 x 2 grid the mean over its K = 2
    data ranks."""
    run = request.getfixturevalue(which)
    t = run.train[key]
    got_steps = run.out[key]["train"]
    for i, (got, (m, masks, params), (mj, wparams)) in enumerate(zip(
            got_steps, _one_process_trajectory(t, key), _reference_trajectory(t, key))):
        label = f"{which} {key} step {i}"
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-6, err_msg=label)
        np.testing.assert_allclose(got["loss"], float(mj["loss"]), rtol=1e-5, err_msg=label)
        np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]), rtol=1e-5,
                                   err_msg=label)
        assert np.array_equal(got["weights"], m["weights"].numpy()), label
        assert np.array_equal(got["weights"], np.asarray(mj["weights"])), label
        for k, v in masks.items():
            assert np.array_equal(got["masks"][k], v.numpy()), (label, k)
            assert np.array_equal(got["masks"][k], np.asarray(mj[k])), (label, k)
        for a, b, w in zip(got["params"], params, wparams):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-5, atol=1e-6, err_msg=label)
            np.testing.assert_allclose(a, np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=label)
    if t["tc"].attack == "ipm_100":
        bad = int(np.flatnonzero(spaced_malicious(t["K"], 1))[0])
        assert all(float(s["weights"][bad]) == 0.0 for s in got_steps)
    assert same_on_every_rank([r[run.keys.index(key)]["train"] for r in run.ranks])


@pytest.mark.parametrize("key", FAMILIES)
def test_flat_step_matches_one_process_and_reference(tp2, key):
    """One step of the flat layout on the model axis (the K = 4 candidates
    emulated on each rank's blocks, the count-sketch the reference's bits)
    against the one-process flat trainer and the reference's composed flat
    step."""
    t = tp2.flat[key]
    got = tp2.out[key]["flat"][0]
    (m, masks, params), = _one_process_trajectory(t, key)
    (mj, wparams), = _reference_trajectory(t, key)
    for k, v in masks.items():
        assert np.array_equal(got["masks"][k], v.numpy()), k
        assert np.array_equal(got["masks"][k], np.asarray(mj[k])), k
    np.testing.assert_allclose(got["weights"], m["weights"].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["weights"], np.asarray(mj["weights"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["loss"], float(mj["loss"]), rtol=1e-5)
    for a, b, w in zip(got["params"], params, wparams):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(a, np.asarray(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("which", ["tp2", "grid"])
def test_checkpoints_cross_mesh_shapes(which, request):
    """Saved on the mesh (gathered to the one-card format) and loaded into
    one process; one process's checkpoint loaded onto the mesh."""
    run = request.getfixturevalue(which)
    for key in FAMILIES:
        model = _one(key)
        F.layout_flat(model)
        tree, meta = ckpt.restore_checkpoint(f"{run.tmp}/{key}/mesh", "fam",
                                             F.module_tree(model))
        assert meta == {"mesh": list(run.shape)}
        tr.load_params_(model, tree, None)
        for got, want in zip(F.tree_leaves(F.module_tree(model)),
                             run.out[key]["train"][-1]["params"]):
            assert np.array_equal(got.numpy(), want), key
        for got, want in zip(run.out[key]["loaded"],
                             F.tree_leaves(F.module_tree(run.train[key]["one"]))):
            assert np.array_equal(got, want.numpy()), key


@functools.lru_cache(maxsize=None)
def _jax_steps(key):
    jcfg = _cfgs(key)[0]
    return jax.jit(functools.partial(JM.decode_step, jcfg))


def _jax_encode(jcfg, params, frames):
    """The reference's inline encoder (``src/repro/models/model.py:239-243``)."""
    def enc(p, f):
        h = f @ p["enc_in_proj"]
        pos = jnp.broadcast_to(jnp.arange(f.shape[1]), f.shape[:2])
        h, _, _ = JM._scan_blocks(jcfg, p["enc_layers"], h, pos, "dense", causal=False)
        return jlayers.norm_fwd(jcfg, p["enc_norm"], h)
    return jax.jit(enc)(params, jnp.asarray(frames))


@pytest.mark.parametrize("which,key", RUNS)
def test_prefill_and_decode_match_one_process_and_reference(which, key, request,
                                                             monkeypatch):
    """The prefill (the flash branch at a lowered threshold: kernel 8's
    plain version on the rank's heads, padded to ``Hp`` or in slots) and
    decode of the prompts' first tokens then 4 greedy steps, an
    encoder-decoder's cache holding the encoded frames of the prompts,
    against one process and, fed the same tokens, the reference's forward
    and ``decode_step`` (its cache given its own encoder output)."""
    run = request.getfixturevalue(which)
    monkeypatch.setattr(TL, "SDPA_CHUNK_THRESHOLD", 128)
    jcfg, cfg = _cfgs(key)
    model = _one(key)
    inp = run.inputs[key]
    pb = _batch(inp["prompts"], inp["prompt_extra"])
    out = run.out[key]
    want = sv.build_prefill(cfg, device="cpu")(model, pb)
    np.testing.assert_allclose(out["prefill"], want.numpy(), rtol=1e-5, atol=1e-5)
    jwant = _jax_forward(key)(_params(key), _jbatch(inp["prompts"], inp["prompt_extra"]))
    np.testing.assert_allclose(out["prefill"], np.asarray(jwant), rtol=TOL, atol=TOL)
    p = pb["tokens"][:, :DECODE]
    B, total = p.shape[0], p.shape[1] + 4
    frames = inp["prompt_extra"].get("frames")
    cache = TM.init_cache(cfg, B, total, device="cpu",
                          enc_len=0 if frames is None else PROMPT_FRAMES)
    jcache = JM.init_cache(jcfg, B, total, enc_len=0 if frames is None else PROMPT_FRAMES)
    if frames is not None:
        with torch.no_grad():
            cache["enc_out"].copy_(TM._encode(cfg, model, torch.as_tensor(frames)))
        jcache["enc_out"] = _jax_encode(jcfg, _params(key), frames)
    dec = sv.build_decode_step(cfg, device="cpu")
    jdec = _jax_steps(key)
    for i in range(p.shape[1]):
        lg, cache = dec(model, cache, p[:, i:i + 1])
        jlg, jcache = jdec(_params(key), jcache, jnp.asarray(p[:, i:i + 1].numpy()))
    for i, got in enumerate(out["decode"]):
        label = f"{key} step {i}"
        np.testing.assert_allclose(got, lg.numpy(), rtol=1e-5, atol=1e-5, err_msg=label)
        np.testing.assert_allclose(got, np.asarray(jlg), rtol=TOL, atol=TOL, err_msg=label)
        tok = torch.as_tensor(got[:, -1].argmax(-1)[:, None])
        lg, cache = dec(model, cache, tok)
        jlg, jcache = jdec(_params(key), jcache, jnp.asarray(tok.numpy()))
    assert same_on_every_rank([r[run.keys.index(key)]["decode"] for r in run.ranks])


def test_caches_hold_a_rank_share(tp2, grid):
    """The decode caches as ``cache_specs`` place them: the KV heads / M,
    the encoder output whole over the model axis; on the grid each data
    rank's B / K rows of the KV heads and of ``enc_out``."""
    B, H = PROMPT[0], _cfgs("seamless")[1].n_kv_heads
    sm = tp2.out["seamless"]["cache"]
    assert sm["layers/k"] == (2, B, H // 2, DECODE + 4, 64)
    assert sm["enc_out"] == (B, PROMPT_FRAMES, 256)
    g = grid.out["seamless"]["cache"]
    assert g["enc_out"] == (B // 2, PROMPT_FRAMES, 256) and g["layers/k"][1] == B // 2
    assert "enc_out" not in tp2.out["llava"]["cache"]


def test_launcher_trains_the_families_on_the_model_axis(tp2):
    """``launch.train --arch llava-next-34b --model-parallel 2`` trains on
    tokens alone (the launcher feeds no patch embeddings, as the
    reference's): model rank 0 writes the gathered model, which one process
    restores.  ``--arch seamless-m4t-medium`` raises ``KeyError: 'frames'``,
    as the reference's launcher does (its forward reads the frames the
    token stream does not have)."""
    cfg = get_config("llava-next-34b").reduced()
    model = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tree, meta = ckpt.restore_checkpoint(f"{tp2.tmp}/launcher", "step_2", F.module_tree(model))
    assert meta["step"] == 2 and np.isfinite(meta["loss"])
    assert all(np.isfinite(x.numpy()).all() for x in F.tree_leaves(tree))
    assert tp2.launcher_error == "KeyError('frames')"


def test_the_families_build_on_the_model_axis_and_the_grid():
    """``build_train_step`` builds both layouts for the encoder-decoder and
    the VLM on the model axis and on a grid, with Adafactor (LLaVA's own
    optimizer) and each option the other families take (no group is
    reached while building); the CNN is still no language model."""
    class TP(Mesh):       # the model axis without a live group
        def model_axis(self):
            return ModelAxis(None, self.shape["model"], 0)

    class Grid(TP):
        def data_axis(self):
            return DataAxis(None, self.shape["data"], 0)

    for key in FAMILIES:
        cfg = dataclasses.replace(_cfgs(key)[1], optimizer="adafactor")
        for mesh in (TP(shape={"data": 4, "model": 2}), Grid(shape={"data": 2, "model": 2})):
            for layout in ("flat", "stacked"):
                for attack in ("min_max", "ipm_100"):
                    agg = tra.RobustAggConfig(layout=layout, gather_dtype="bfloat16")
                    tc = tr.TrainConfig(agg=agg, attack=attack, n_malicious=1)
                    assert callable(tr.build_train_step(cfg, tc, mesh))
    with pytest.raises(NotImplementedError, match="not a language model"):
        TL.check_family(get_config("lenet-mnist"))
