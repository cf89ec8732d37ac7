"""The model (tensor-parallel) axis of the port: a dense model split over M
``gloo`` ranks on the CPU (``tests/_torch_spmd_child.py``'s ``task_tp``,
spawned once per M for the whole module) held to the reference and to
the port at M = 1 on the same numpy weights and tokens.

Tolerances, fixed before the runs:
  forward logits       rtol 1e-5 / atol 1e-5 against M = 1 and the
                       reference (float32 logits of O(1): the M ranks'
                       partial sums add in another order, ~100 ulps);
  loss, gradients      loss rtol 1e-5; gradients rtol 1e-4 / atol 1e-6
                       against ``jax.value_and_grad(loss_fn)`` (the port's
                       M = 1 bound, ``tests/test_torch_loss.py``), rtol 1e-5 /
                       atol 1e-6 against the port at M = 1;
  stacked all-reduce   masks bit-equal, the aggregate and the weights
                       within 3e-5 (``tests/test_one_launch.py:20``) of the
                       reference's ``robust_allreduce_stacked`` on the
                       whole candidates;
  statistics           the psum'd sums within rtol 1e-5 of the whole
                       candidates' (a replicated leaf counted M times
                       would be off by its share);
  noise                bit-equal to M = 1's draws;
  trajectory           params within rtol 1e-4 / atol 1e-5 of the
                       reference's composed step and rtol 1e-5 / atol 1e-6
                       of the M = 1 trainer, weights and masks equal;
  serving              prefill and decode logits within rtol 1e-5 / atol
                       1e-5 of M = 1 (float32, the flash branch's plain
                       version at a lowered threshold);
  checkpoints          bit-equal across M.

M = 2 runs Qwen's reduced form (tied embeddings, QKV biases, RMSNorm);
M = 4 a StableLM form with 4 query and 2 KV heads (LayerNorm, untied),
whose KV projections every rank holds whole (``n_kv_heads % M != 0``)."""
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
from repro.models import model as JM
from repro_torch.configs.registry import get_config
from repro_torch.core import flatten as F
from repro_torch.core import wfagg as twf
from repro_torch.core.topology import spaced_malicious
from repro_torch.distributed import robust_allreduce as tra
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import serve as sv
from repro_torch.train import trainer as tr

from _torch_spmd_child import run_ranks, same_on_every_rank
from test_torch_trainer import ReferenceStep, _reference_state

QWEN = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, vocab_size=128,
            head_dim=32)
STABLELM = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                head_dim=16)
K = 8
BAD = (2, 5)
W = dict(f=2, transient=1, window=2)
METHODS = [(m, b) for m in ("wfagg", "alt_wfagg") for b in ("fused", "fused_two_launch",
                                                             "reference")] + \
    [(m, b) for m in ("multi_krum", "median", "mean") for b in ("fused", "reference")]
TRAIN_K = 4
STEPS = 3
PROMPT = (2, 160)


def _cfgs(arch, small):
    return (dataclasses.replace(jget_config(arch).reduced(), **small),
            dataclasses.replace(get_config(arch).reduced(), **small))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _candidates(params, seed, rounds=3):
    """Per round the K whole candidate trees (leaves (K, ...)) and a prev:
    unit normals around a shared direction, the rows of ``BAD`` pushed the
    other way."""
    rng = np.random.default_rng(seed)

    def draw():
        def leaf(p):
            base = rng.standard_normal(p.shape).astype(np.float32)
            x = 0.5 * rng.standard_normal((K,) + p.shape).astype(np.float32) + base
            x[list(BAD)] = -3.0 * base
            return x
        return jax.tree.map(leaf, params)

    prev = draw()
    out = []
    for _ in range(rounds):
        cur = draw()
        out.append({"tree": cur, "prev": prev})
        prev = cur
    return out


def _train_inputs(jcfg, cfg):
    jtc = __import__("repro.train.trainer", fromlist=["TrainConfig"]).TrainConfig(
        agg=jra.RobustAggConfig(method="wfagg", layout="stacked", backend="reference",
                                wfagg=jwf.WFAggConfig(f=1, transient=1, window=2)),
        attack="ipm_100", n_malicious=1, lr=1e-2, warmup=0, donate=False)
    tc = tr.TrainConfig(agg=tra.RobustAggConfig(method="wfagg", layout="stacked",
                                                backend="fused",
                                                wfagg=twf.WFAggConfig(f=1, transient=1,
                                                                      window=2)),
                        attack="ipm_100", n_malicious=1, lr=1e-2, warmup=0)
    sj = _np_tree(_reference_state(jcfg, jtc, TRAIN_K))
    stream = JTokenStream(vocab_size=jcfg.vocab_size, seq_len=32, batch_size=8)
    batches = [np.asarray(stream.batch(i)["tokens"]) for i in range(STEPS)]
    agg = sj.agg_state
    state = {"params": sj.params, "opt_state": sj.opt_state, "step": int(sj.step),
             "agg_state": None if agg is None else dict(
                 prev=agg.prev, hist_s=agg.hist_s, hist_b=agg.hist_b, count=agg.count,
                 t=agg.t)}
    return jtc, tc, sj, batches, {"tc": tc, "K": TRAIN_K, "state": state,
                                  "batches": batches}


class Run:
    """One spawned run of every part on M ranks, and the inputs it saw."""

    def __init__(self, arch, small, M, tmp, parts):
        self.jcfg, self.cfg = _cfgs(arch, small)
        self.M = M
        self.params = _np_tree(jax.jit(functools.partial(JM.init_params, self.jcfg))(
            jax.random.PRNGKey(0)))
        rng = np.random.default_rng(1)
        self.tokens = rng.integers(0, self.cfg.vocab_size, (2, 24)).astype(np.int32)
        self.prompts = rng.integers(0, self.cfg.vocab_size, PROMPT).astype(np.int32)
        self.cands = _candidates(self.params, seed=M)
        self.ckpt_dir = str(tmp)
        kw = dict(cfg=self.cfg, params=self.params, tokens=self.tokens, parts=parts,
                  cands=self.cands, methods=METHODS if "train" in parts else METHODS[:1],
                  wcfg=twf.WFAggConfig(**W), prompts=self.prompts, ckpt_dir=self.ckpt_dir)
        if "train" in parts:
            self.jtc, self.tc, self.sj, self.batches, kw["train"] = _train_inputs(
                self.jcfg, self.cfg)
            self.m1_model = TM.params_from_jax(self.params, self.cfg, "cpu")
            F.layout_flat(self.m1_model)
            ckpt.save_checkpoint(self.ckpt_dir + "/m1", "m1", F.module_tree(self.m1_model))
        self.ranks = run_ranks("tp", M, tmp, timeout=240, **kw)
        self.out = self.ranks[0]


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    return Run("qwen1.5-0.5b", QWEN, 2, tmp_path_factory.mktemp("tp2"),
               ("forward", "grads", "allreduce", "noise", "train", "launcher", "serve"))


@pytest.fixture(scope="module")
def tp4(tmp_path_factory):
    return Run("stablelm-3b", STABLELM, 4, tmp_path_factory.mktemp("tp4"),
               ("forward", "grads", "allreduce", "serve"))


def _m1(run):
    return TM.params_from_jax(run.params, run.cfg, "cpu")


@pytest.mark.parametrize("which", ["tp2", "tp4"])
def test_forward_matches_reference_and_one_rank(which, request):
    run = request.getfixturevalue(which)
    want = np.asarray(jax.jit(lambda p, t: JM.forward(run.jcfg, p, {"tokens": t})[0])(
        run.params, jnp.asarray(run.tokens)))
    one, _ = TM.forward(run.cfg, _m1(run), {"tokens": torch.as_tensor(run.tokens).long()})
    got = run.out["logits"]
    np.testing.assert_allclose(got, one.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # every rank gathers the same logits
    assert same_on_every_rank([r["logits"] for r in run.ranks])


@pytest.mark.parametrize("which", ["tp2", "tp4"])
def test_loss_and_gradients_match_reference(which, request):
    run = request.getfixturevalue(which)
    b = {"tokens": jnp.asarray(run.tokens)}
    (lj, _), gj = jax.jit(jax.value_and_grad(lambda p: JM.loss_fn(run.jcfg, p, b),
                                             has_aux=True))(run.params)
    lt, gt = tr.loss_and_grad(run.cfg, _m1(run),
                              {"tokens": torch.as_tensor(run.tokens).long()})
    np.testing.assert_allclose(run.out["loss"], float(lj), rtol=1e-5)
    one = F.tree_leaves(F.unravel_like(gt, F.module_tree(_m1(run))))
    for (path, w), g, g1 in zip(jax.tree_util.tree_flatten_with_path(gj)[0],
                                run.out["grads"], one):
        label = jax.tree_util.keystr(path)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6, err_msg=label)
        np.testing.assert_allclose(g, g1.numpy(), rtol=1e-5, atol=1e-6, err_msg=label)


def test_pruned_kv_heads_are_whole_on_every_rank(tp4):
    """n_kv_heads = 2 over M = 4: wk/wv replicated (counted as such), wq,
    wo, the MLP and the vocabulary split; the cache holds both KV heads."""
    cut = dict(zip([p for p, _ in F.leaf_params(_m1(tp4))], tp4.out["split_dims"]))
    assert cut[("layers", "attn", "wk")] is None and cut[("layers", "attn", "wv")] is None
    assert cut[("layers", "attn", "wq")] == 2 and cut[("layers", "attn", "wo")] == 1
    assert cut[("layers", "ffn", "w_down")] == 1 and cut[("embedding", "embed")] == 0
    assert cut[("layers", "ln1", "bias")] is None
    assert tp4.out["cache_heads"] == 2


def _reference_rounds(run, method):
    cfg = jra.RobustAggConfig(method=method, layout="stacked", backend="reference",
                              wfagg=jwf.WFAggConfig(**W))
    fn = jax.jit(jra.robust_allreduce_stacked, static_argnums=(1,))
    state = jra.init_tree_agg_state(cfg, K, run.params)._replace(
        prev=jax.tree.map(jnp.asarray, run.cands[0]["prev"]))
    out = []
    for c in run.cands:
        agg, state, info = fn(jax.tree.map(jnp.asarray, c["tree"]), cfg, state)
        out.append((jax.tree.leaves(_np_tree(agg)), _np_tree(info)))
    return out


@pytest.mark.parametrize("method", ["wfagg", "alt_wfagg", "multi_krum", "median", "mean"])
def test_stacked_allreduce_matches_reference(tp2, method):
    want = _reference_rounds(tp2, method)
    backends = [b for m, b in METHODS if m == method]
    for backend in backends:
        for r, (got, (wout, winfo)) in enumerate(zip(tp2.out["allreduce"][(method, backend)],
                                                      want)):
            label = f"{method} {backend} round {r}"
            for m in ("mask_d", "mask_c", "mask_t"):
                assert (m in got) == (m in winfo), (label, m)
                if m in winfo:
                    assert np.array_equal(got[m], winfo[m]), (label, m)
            np.testing.assert_allclose(got["weights"], winfo["weights"], atol=3e-5,
                                       err_msg=label)
            for a, b in zip(got["out"], wout):
                np.testing.assert_allclose(a, b, atol=3e-5, rtol=0, err_msg=label)
    if method == "wfagg":     # the attackers are rejected
        w = tp2.out["allreduce"][("wfagg", "fused")]
        assert all(float(w[r]["weights"][b]) == 0.0 for r in range(3) for b in BAD)


@pytest.mark.parametrize("which", ["tp2", "tp4"])
def test_replicated_leaves_counted_once(which, request):
    run = request.getfixturevalue(which)
    whole = np.concatenate([x.reshape(K, -1) for x in jax.tree.leaves(run.cands[0]["tree"])],
                           axis=1).astype(np.float64)
    med = np.median(whole, axis=0)
    np.testing.assert_allclose(run.out["stats"]["dist2"], ((whole - med) ** 2).sum(1),
                               rtol=1e-5)
    np.testing.assert_allclose(run.out["stats"]["norm2"], (whole ** 2).sum(1), rtol=1e-5)
    np.testing.assert_allclose(run.out["stats"]["gram"], whole @ whole.T, rtol=1e-5,
                               atol=1e-2)
    # the fused route on M ranks rejects what the reference does
    got = run.out["allreduce"][METHODS[0]][0]
    want = _reference_rounds(run, "wfagg")[0][1]
    assert np.array_equal(got["mask_d"], want["mask_d"])


def test_noise_draws_equal_one_rank(tp2):
    cand = jax.tree.map(lambda x: torch.as_tensor(np.array(x)), tp2.cands[0]["tree"])
    mal = torch.tensor([k % 2 == 1 for k in range(K)])
    want = tra.apply_stacked_attack(cand, mal, "noise", torch.Generator().manual_seed(7))
    for g, w in zip(tp2.out["noise"], F.tree_leaves(want)):
        assert np.array_equal(g, w.numpy())


def test_adaptive_attacks_refused_on_the_model_axis():
    """The adaptive attacks are no longer refused on the model axis
    (``tests/test_torch_flat_tp.py`` holds them over ranks); a
    ``ModelShards`` without an axis is one process: its values."""
    shards = tra.ModelShards(axis=None, split_dims=(None,))
    x = torch.randn((4, 3), generator=torch.Generator().manual_seed(1))
    mal = torch.tensor([False, False, True, False])
    for attack in ("min_max", "band_rider"):
        got = tra.apply_stacked_attack({"w": x.clone()}, mal, attack, model_shards=shards)
        want = tra.apply_stacked_attack({"w": x.clone()}, mal, attack)
        assert torch.equal(got["w"], want["w"]) and not torch.equal(got["w"][2], x[2])


def test_trajectory_matches_reference_and_one_rank(tp2):
    """3 steps of IPM-100 on K = 4 candidates (WFAgg on the fused route):
    the M = 2 trainer against the reference's composed step and the M = 1
    trainer, both from the reference's initial state."""
    ref = ReferenceStep(tp2.jcfg, tp2.jtc, TRAIN_K)
    sj = _reference_state(tp2.jcfg, tp2.jtc, TRAIN_K)
    st = tr.state_from_jax(_np_tree(sj), tp2.cfg, device="cpu")
    seen = {}
    step = tr.build_train_step(tp2.cfg, tp2.tc, make_test_mesh(data=TRAIN_K),
                               observe=lambda phase, **v: seen.update({phase: v}))
    for i, (b, got) in enumerate(zip(tp2.batches, tp2.out["train"])):
        st, mt = step(st, {"tokens": torch.as_tensor(b).long()})
        sj, mj = ref(sj, {"tokens": jnp.asarray(b)})
        label = f"step {i}"
        np.testing.assert_allclose(got["loss"], float(mj["loss"]), rtol=1e-5, err_msg=label)
        np.testing.assert_allclose(got["loss"], float(mt["loss"]), rtol=1e-6, err_msg=label)
        np.testing.assert_allclose(got["grad_norm"], float(mt["grad_norm"]), rtol=1e-5,
                                   err_msg=label)
        assert np.array_equal(got["weights"], mt["weights"].numpy()), label
        assert np.array_equal(got["weights"], np.asarray(mj["weights"])), label
        for m in ("mask_d", "mask_c", "mask_t"):
            assert np.array_equal(got["masks"][m], np.asarray(mj[m])), (label, m)
        for (path, w), g, g1 in zip(jax.tree_util.tree_flatten_with_path(sj.params)[0],
                                    got["params"], F.tree_leaves(F.module_tree(st.params))):
            key = f"{label} {jax.tree_util.keystr(path)}"
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=key)
            np.testing.assert_allclose(g, g1.numpy(), rtol=1e-5, atol=1e-6, err_msg=key)
    bad = int(np.flatnonzero(spaced_malicious(TRAIN_K, 1))[0])
    assert all(float(s["weights"][bad]) == 0.0 for s in tp2.out["train"])
    assert same_on_every_rank([r["train"] for r in tp2.ranks])


def test_checkpoints_cross_model_axis_sizes(tp2):
    """Saved at M = 2 (gathered to today's format) and resumed at M = 1;
    saved at M = 1 and loaded into M = 2's blocks."""
    model = _m1(tp2)
    F.layout_flat(model)
    tree, meta = ckpt.restore_checkpoint(tp2.ckpt_dir, "tp", F.module_tree(model))
    assert meta == {"model": 2}
    tr.load_params_(model, tree, None)
    for got, want in zip(F.tree_leaves(F.module_tree(model)), tp2.out["train"][-1]["params"]):
        assert np.array_equal(got.numpy(), want)
    for got, want in zip(tp2.out["loaded"], F.tree_leaves(F.module_tree(tp2.m1_model))):
        assert np.array_equal(got, want.numpy())


def test_launcher_model_parallel_checkpoint_is_whole(tp2):
    """``--model-parallel 2`` under an initialised group: model rank 0
    writes the gathered model, which a whole (M = 1) model restores."""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(), d_model=64,
                              head_dim=16, d_ff=256, n_layers=2, vocab_size=128)
    model = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tree, meta = ckpt.restore_checkpoint(tp2.ckpt_dir + "/launcher", "step_2",
                                         F.module_tree(model))
    assert meta["step"] == 2 and np.isfinite(meta["loss"])
    assert all(np.isfinite(x.numpy()).all() for x in F.tree_leaves(tree))


@pytest.mark.parametrize("which", ["tp2", "tp4"])
def test_prefill_and_decode_match_one_rank(which, request, monkeypatch):
    run = request.getfixturevalue(which)
    monkeypatch.setattr(TL, "SDPA_CHUNK_THRESHOLD", 128)
    model = _m1(run)
    p = torch.as_tensor(run.prompts).long()
    want = sv.build_prefill(run.cfg, device="cpu")(model, {"tokens": p})
    np.testing.assert_allclose(run.out["prefill"], want.numpy(), rtol=1e-5, atol=1e-5)
    cache = TM.init_cache(run.cfg, p.shape[0], p.shape[1] + 4, device="cpu")
    dec = sv.build_decode_step(run.cfg, device="cpu")
    for i in range(p.shape[1]):
        lg, cache = dec(model, cache, p[:, i:i + 1])
    tok = lg[:, -1].argmax(-1, keepdim=True)
    for i, got in enumerate(run.out["decode"]):
        np.testing.assert_allclose(got, lg.numpy(), rtol=1e-5, atol=1e-5, err_msg=f"step {i}")
        lg, cache = dec(model, cache, tok)
        tok = lg[:, -1].argmax(-1, keepdim=True)


def test_specs_of_the_model_state():
    """``state_shardings`` / ``batch_shardings`` on an abstract (meta) state:
    the reference's specs, as plain tuples."""
    _, cfg = _cfgs("qwen1.5-0.5b", QWEN)
    tc = tr.TrainConfig(agg=tra.RobustAggConfig(method="wfagg", layout="stacked"))
    state = tr.init_train_state(cfg, tc, mesh=make_test_mesh(data=2), abstract=True)
    assert F.module_params(state.params)[0].device.type == "meta"
    mesh = make_test_mesh(data=2)
    specs = tr.state_shardings(cfg, tc, mesh, state)
    assert specs.params["layers"]["attn"]["wq"] == (None, None, "model")
    assert specs.agg_state.prev["layers"]["ffn"]["w_down"] == ("data", None, "model", None)
    assert specs.opt_state["mu"]["embedding"]["embed"] == ("model", None)
    assert tr.batch_shardings(tc, mesh, {"tokens": torch.empty((4, 8), device="meta")}) == \
        {"tokens": ("data", None)}
