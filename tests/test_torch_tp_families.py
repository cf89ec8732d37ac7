"""The MoE, SSM and hybrid families on the model axis and on the grid: the
reduced configs split over ``gloo`` ranks on the CPU
(``tests/_torch_spmd_child.py``'s ``task_fam``, spawned once per mesh for
the whole module: M = 2, M = 4 for the padded heads, and a 2 x 2 grid)
and held to the one-process port and to the JAX package on the same
numpy weights and tokens.

Configs (reduced, float32): a DeepSeek-like one (MLA, the MoE FFN with a
shared expert, one dense prefix block), a Moonlight-like one (GQA MoE, 2
KV heads), a Falcon-Mamba-like one (Mamba-1), a Zamba2-like one (Mamba-2
in two groups, the shared block), and, served only at M = 4, an
Arctic-like one with 7 live heads padded to 8 (M does not divide the
live heads: each rank holds 2 head slots of the padded layout).

Tolerances, fixed before the runs:
  forward, serving   logits within rtol 1e-5 / atol 1e-5 of the
                     one-process port (float32: the ranks' partial sums
                     add in another order), and within rtol 1e-4 / atol
                     1e-4 of the JAX package (``test_torch_moe_models.py``'s
                     and ``test_torch_ssm_models.py``'s tolerance); the aux
                     loss within rtol 1e-5 of one process;
  gradients          loss rtol 1e-5 of one process; gradient leaves within
                     rtol 1e-4 / atol 1e-4 times the leaf's largest
                     magnitude (at most 1e-4) of the JAX package
                     (``test_torch_ssm_train.py``'s bound) and rtol 1e-5 /
                     atol 1e-5 times the leaf's largest magnitude of one
                     process (the MoE combine and the row-split products
                     add the ranks' parts in another order, and a leaf's
                     small entries sum terms of its large ones' size);
  remat              gradients with ``cfg.remat`` bit-equal to without it,
                     one process and on the model axis;
  statistics         the psum'd sums within rtol 1e-5 of the whole
                     candidates' (a replicated or doubly held coordinate
                     counted twice would be off by its share);
  cut and gather     every leaf's cut and gather round trip bit-equal;
  trajectory         3 steps: params within rtol 1e-4 / atol 1e-5 of the
                     reference's composed step (``ReferenceStep``) and
                     rtol 1e-5 / atol 1e-6 of the one-process trainer,
                     weights and masks equal, loss rtol 1e-5 and 1e-6;
  checkpoints        bit-equal across mesh shapes (saved on the mesh and
                     loaded into one process; saved by one process and
                     loaded onto the mesh).

M = 2 trains K = 4 candidates (WFAgg on the fused route under IPM-100,
one attacker); the 2 x 2 grid trains its K = 2 candidates with the mean
(at K = 2 both candidates sit at one distance from their median, so the
robust rules run at K > 2: ``tests/test_torch_grid.py``)."""
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
from repro.train import trainer as jtr
from repro_torch.configs.registry import get_config
from repro_torch.core import flatten as F
from repro_torch.core import wfagg as twf
from repro_torch.core.topology import spaced_malicious
from repro_torch.distributed import robust_allreduce as tra
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import Mesh, make_test_mesh
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import serve as sv
from repro_torch.train import trainer as tr

from _torch_spmd_child import run_ranks, same_on_every_rank
from test_torch_trainer import ReferenceStep, _reference_state

SMALL = dict(d_model=64, vocab_size=128)
CONFIGS = {
    "deepseek": ("deepseek-v2-lite-16b",
                 dict(SMALL, n_layers=3, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=32,
                      kv_lora_rank=16, qk_rope_dim=8, n_experts=4, top_k=2)),
    "moonlight": ("moonshot-v1-16b-a3b",
                  dict(SMALL, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32,
                       n_experts=4, top_k=2)),
    "falcon": ("falcon-mamba-7b",
               dict(SMALL, n_layers=2, d_inner=128, ssm_state=8, dt_rank=8)),
    "zamba": ("zamba2-1.2b",
              dict(SMALL, n_layers=4, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                   d_inner=128, ssm_head_dim=16, ssm_state=8)),
    "padded": ("arctic-480b",
               dict(SMALL, n_layers=1, n_heads=7, n_kv_heads=1, pad_heads_to=8, head_dim=16,
                    d_ff=32, dense_residual_ff=32, n_experts=4, top_k=2)),
}
FAMILIES = ["deepseek", "moonlight", "falcon", "zamba"]
TRAINED = ("deepseek", "zamba")     # also held to ``ReferenceStep`` at M = 2
TRAIN_K = 4
STEPS = 3
CANDS = 4
PROMPT = (2, 144)
DECODE = 12        # prompt tokens decoded before the greedy steps
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


def _inputs(key):
    cfg = _cfgs(key)[1]
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32)
    crng = np.random.default_rng(2)
    cands = jax.tree.map(lambda p: crng.standard_normal((CANDS,) + p.shape).astype(np.float32),
                         _params(key))
    return tokens, prompts, cands


def _tcs(method, attack, n_mal):
    w = dict(f=1, transient=1, window=2)
    jtc = jtr.TrainConfig(agg=jra.RobustAggConfig(method=method, layout="stacked",
                                                  backend="reference",
                                                  wfagg=jwf.WFAggConfig(**w)),
                          attack=attack, n_malicious=n_mal, lr=1e-2, warmup=0, donate=False)
    tc = tr.TrainConfig(agg=tra.RobustAggConfig(method=method, layout="stacked",
                                                backend="fused", wfagg=twf.WFAggConfig(**w)),
                        attack=attack, n_malicious=n_mal, lr=1e-2, warmup=0)
    return jtc, tc


def _state_np(sj):
    agg = sj.agg_state
    return {"params": sj.params, "opt_state": sj.opt_state, "step": int(sj.step),
            "agg_state": None if agg is None else dict(
                prev=agg.prev, hist_s=agg.hist_s, hist_b=agg.hist_b, count=agg.count, t=agg.t)}


class Run:
    """One spawn of ``task_fam`` on a mesh (K, M) over some configs, and the
    inputs it saw."""

    def __init__(self, keys, shape, tmp, parts, train=None, launcher=None):
        self.shape, self.keys, self.tmp = shape, keys, str(tmp)
        self.train = {}
        runs = []
        for key in keys:
            tokens, prompts, cands = _inputs(key)
            run = dict(cfg=_cfgs(key)[1], params=_params(key), tokens=tokens,
                       prompts=prompts, cands=cands, parts=parts(key), decode_len=DECODE)
            if train and "train" in run["parts"]:
                run["train"] = self._train_inputs(key, *train)
            runs.append(run)
        self.inputs = dict(zip(keys, runs))
        out = run_ranks("fam", shape[0] * shape[1], tmp, timeout=300, runs=runs,
                        mesh_shape=shape, remat_check=0,
                        launcher=launcher and (launcher, f"{self.tmp}/launcher"))
        self.ranks = out
        self.out = dict(zip(keys, out[0]))

    def _train_inputs(self, key, method, attack, n_mal, K):
        jcfg, cfg = _cfgs(key)
        jtc, tc = _tcs(method, attack, n_mal)
        sj = jax.tree.map(np.asarray, _reference_state(jcfg, jtc, K))
        stream = JTokenStream(vocab_size=jcfg.vocab_size, seq_len=32, batch_size=2 * K)
        batches = [np.asarray(stream.batch(i)["tokens"]) for i in range(STEPS)]
        one = TM.params_from_jax(_params(key), cfg, "cpu")
        F.layout_flat(one)
        d = f"{self.tmp}/{key}"
        ckpt.save_checkpoint(d + "/one", "one", F.module_tree(one))
        self.train[key] = dict(jtc=jtc, tc=tc, sj=sj, batches=batches, K=K, one=one)
        return {"tc": tc, "K": K, "state": _state_np(sj), "batches": batches,
                "ckpt": d + "/mesh", "load": d + "/one"}


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    return Run(FAMILIES, (1, 2), tmp_path_factory.mktemp("fam2"),
               lambda key: ("forward", "grads", "roundtrip", "stats", "train", "serve"),
               train=("wfagg", "ipm_100", 1, TRAIN_K), launcher="deepseek-v2-lite-16b")


@pytest.fixture(scope="module")
def tp4(tmp_path_factory):
    return Run(["padded"], (1, 4), tmp_path_factory.mktemp("fam4"),
               lambda key: ("forward", "roundtrip", "serve"))


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return Run(FAMILIES, (2, 2), tmp_path_factory.mktemp("famgrid"),
               lambda key: ("forward", "roundtrip", "stats", "train", "serve"),
               train=("mean", "none", 0, 2))


RUNS = [("tp2", k) for k in FAMILIES] + [("grid", k) for k in FAMILIES] + [("tp4", "padded")]


def _one(key):
    return TM.params_from_jax(_params(key), _cfgs(key)[1], "cpu")


@pytest.mark.parametrize("which,key", RUNS)
def test_forward_matches_one_process_and_reference(which, key, request):
    run = request.getfixturevalue(which)
    jcfg, cfg = _cfgs(key)
    tokens = run.inputs[key]["tokens"]
    want = np.asarray(jax.jit(lambda p, t: JM.forward(jcfg, p, {"tokens": t})[0])(
        _params(key), jnp.asarray(tokens)))
    one, aux = TM.forward(cfg, _one(key), {"tokens": torch.as_tensor(tokens).long()})
    got = run.out[key]["logits"]
    np.testing.assert_allclose(got, one.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if which != "grid":     # a grid rank's aux is its rows'
        np.testing.assert_allclose(run.out[key]["aux"], float(aux), rtol=1e-5)
    assert same_on_every_rank([r[run.keys.index(key)]["logits"] for r in run.ranks])


@pytest.mark.parametrize("key", FAMILIES)
def test_loss_and_gradients_match_reference(tp2, key):
    jcfg, cfg = _cfgs(key)
    tokens = tp2.inputs[key]["tokens"]
    b = {"tokens": jnp.asarray(tokens)}
    (lj, _), gj = jax.jit(jax.value_and_grad(lambda p: JM.loss_fn(jcfg, p, b),
                                             has_aux=True))(_params(key))
    one = _one(key)
    lt, gt = tr.loss_and_grad(cfg, one, {"tokens": torch.as_tensor(tokens).long()})
    loss, grads = tp2.out[key]["grads"]
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


def test_remat_gradients_equal_no_remat(tp2):
    """``cfg.remat`` recomputes every block in the backward: the same
    gradients, bit for bit, in one process (each family) and on the model
    axis (the DeepSeek-like config, MLA and MoE blocks and the prefix)."""
    for key in FAMILIES:
        cfg = _cfgs(key)[1]
        batch = {"tokens": torch.as_tensor(tp2.inputs[key]["tokens"]).long()}
        l0, g0 = tr.loss_and_grad(cfg, _one(key), batch)
        l1, g1 = tr.loss_and_grad(dataclasses.replace(cfg, remat=True), _one(key), batch)
        assert float(l0) == float(l1) and torch.equal(g0, g1), key
    out = tp2.out[FAMILIES[0]]
    assert out["grads"][0] == out["grads_remat"][0]
    assert all(np.array_equal(a, b) for a, b in zip(out["grads"][1], out["grads_remat"][1]))


@pytest.mark.parametrize("which,key", RUNS)
def test_cut_and_gather_round_trip(which, key, request):
    """Every leaf's cut and gather are inverses, bit for bit; the port's
    own init on the mesh (each block cut as soon as it is drawn) is the
    one-process init, cut."""
    out = request.getfixturevalue(which).out[key]
    assert out["roundtrip"]
    one = TM.init_params(_cfgs(key)[1], torch.Generator().manual_seed(0), "cpu")
    for got, want in zip(out["init"], F.tree_leaves(F.module_tree(one))):
        assert np.array_equal(got, want.numpy())


def test_new_leaves_cut_as_the_specs(tp2):
    """Each new leaf's model-axis cut: the expert slabs on E, MLA's up
    projections by heads with its down projections, norm and the router
    replicated, the Mamba leaves over ``d_inner`` (Mamba-2's ``A_log``
    replicated), the shared block's ``in_proj`` by columns."""
    def cuts(key):
        return dict(zip([p for p, _ in F.leaf_params(_one(key))],
                        tp2.out[key]["split_dims"]))

    ds = cuts("deepseek")
    assert ds[("layers", "ffn", "w_gate")] == 1 and ds[("layers", "ffn", "w_down")] == 1
    assert ds[("layers", "ffn", "router")] is None
    assert ds[("layers", "attn", "w_uk")] == 2 and ds[("layers", "attn", "wq")] == 2
    assert all(ds[("layers", "attn", n)] is None for n in ("w_dkv", "w_kr", "kv_norm"))
    assert ds[("layers", "ffn", "shared", "w_gate")] == 2
    assert ds[("prefix_layers", 0, "ffn", "w_up")] == 1
    fm = cuts("falcon")
    assert fm[("layers", "mixer", "in_proj")] == 2 and fm[("layers", "mixer", "x_proj")] == 1
    assert fm[("layers", "mixer", "A_log")] == 1 and fm[("layers", "mixer", "dt_proj")] == 2
    zb = cuts("zamba")
    assert zb[("layers", "mixer", "A_log")] is None and zb[("layers", "mixer", "D")] == 1
    assert zb[("layers", "mixer", "bc_proj")] == 1 and zb[("layers", "mixer", "gnorm")] == 1
    assert zb[("shared_attn", "in_proj")] == 1


def test_in_proj_runs_and_padded_slots():
    """``tp_cut``: a Mamba mixer's ``in_proj`` gives rank r its block of x
    beside its block of z; the padded heads' ``wq`` its head slots of the
    padded layout; ``join_blocks`` inverts both bit for bit."""
    cfg = _cfgs("falcon")[1]
    full = torch.arange(4 * 8, dtype=torch.float32).reshape(4, 8)
    mesh = Mesh(shape={"data": 1, "model": 2})
    cut = shd.tp_cut(cfg, "layers.0.mixer.in_proj", (64, 256), mesh)
    assert cut == shd.Cut(1, 2, 0)
    blocks = [shd.take_block(full, cut, 2, r) for r in range(2)]
    assert blocks[1].tolist() == [[2, 3, 6, 7], [10, 11, 14, 15], [18, 19, 22, 23],
                                  [26, 27, 30, 31]]
    assert torch.equal(shd.join_blocks(blocks, cut), full)
    assert shd.tp_cut(_cfgs("zamba")[1], "shared_attn.in_proj", (128, 64), mesh) == shd.Cut(1)
    pcfg = _cfgs("padded")[1]
    mesh4 = Mesh(shape={"data": 1, "model": 4})
    wq = torch.randn(64, 7 * 16)
    cut = shd.tp_cut(pcfg, "layers.0.attn.wq", tuple(wq.shape), mesh4)
    assert cut == shd.Cut(1, 1, 8 * 16)
    blocks = [shd.take_block(wq, cut, 4, r) for r in range(4)]
    assert all(b.shape == (64, 32) for b in blocks) and not blocks[3][:, 16:].any()
    assert torch.equal(shd.join_blocks(blocks, cut, whole=7 * 16), wq)


def test_padded_heads_served_at_four_ranks(tp4):
    """7 live heads over M = 4: each rank 2 head slots of the 8 (the last
    rank one live head and the pad slot), the KV head replicated; the
    logits and decode above equal one process's."""
    assert tp4.out["padded"]["split_dims"][
        [p for p, _ in F.leaf_params(_one("padded"))].index(("layers", "attn", "wq"))] == 2
    assert tp4.out["padded"]["cache"]["layers/k"][2] == 1


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
        np.testing.assert_allclose(st["gram"], whole @ whole.T, rtol=1e-5, atol=1e-2,
                                   err_msg=key)


def _one_process_trajectory(run, key):
    t = run.train[key]
    cfg = _cfgs(key)[1]
    st = tr.state_from_jax(jax.tree.map(np.asarray, t["sj"]), cfg, device="cpu")
    step = tr.build_train_step(cfg, t["tc"], make_test_mesh(data=t["K"]))
    out = []
    for b in t["batches"]:
        st, m = step(st, {"tokens": torch.as_tensor(b).long()})
        out.append((m, [x.clone() for x in F.tree_leaves(F.module_tree(st.params))]))
    return out


@pytest.mark.parametrize("which,key", [("tp2", k) for k in FAMILIES] +
                         [("grid", k) for k in FAMILIES])
def test_trajectory_matches_one_process(which, key, request):
    run = request.getfixturevalue(which)
    for i, (got, (m, params)) in enumerate(zip(run.out[key]["train"],
                                               _one_process_trajectory(run, key))):
        label = f"{key} step {i}"
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-6, err_msg=label)
        np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]), rtol=1e-5,
                                   err_msg=label)
        assert np.array_equal(got["weights"], m["weights"].numpy()), label
        for a, b in zip(got["params"], params):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-5, atol=1e-6, err_msg=label)
    assert same_on_every_rank([r[run.keys.index(key)]["train"] for r in run.ranks])


@pytest.mark.parametrize("key", TRAINED)
def test_trajectory_matches_reference(tp2, key):
    """3 steps of IPM-100 on K = 4 (WFAgg, fused route) at M = 2 against the
    reference's composed step; the attacker at weight 0."""
    t = tp2.train[key]
    jcfg = _cfgs(key)[0]
    ref = ReferenceStep(jcfg, t["jtc"], t["K"])
    sj = _reference_state(jcfg, t["jtc"], t["K"])
    for i, (b, got) in enumerate(zip(t["batches"], tp2.out[key]["train"])):
        sj, mj = ref(sj, {"tokens": jnp.asarray(b)})
        label = f"{key} step {i}"
        np.testing.assert_allclose(got["loss"], float(mj["loss"]), rtol=1e-5, err_msg=label)
        assert np.array_equal(got["weights"], np.asarray(mj["weights"])), label
        for m in ("mask_d", "mask_c", "mask_t"):
            assert np.array_equal(got["masks"][m], np.asarray(mj[m])), (label, m)
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(sj.params)[0],
                                got["params"]):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{label} {jax.tree_util.keystr(path)}")
    bad = int(np.flatnonzero(spaced_malicious(t["K"], 1))[0])
    assert all(float(s["weights"][bad]) == 0.0 for s in tp2.out[key]["train"])


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


@pytest.mark.parametrize("which,key", RUNS)
def test_prefill_and_decode_match_one_process(which, key, request, monkeypatch):
    run = request.getfixturevalue(which)
    monkeypatch.setattr(TL, "SDPA_CHUNK_THRESHOLD", 128)
    cfg = _cfgs(key)[1]
    model = _one(key)
    p = torch.as_tensor(run.inputs[key]["prompts"]).long()
    out = run.out[key]
    want = sv.build_prefill(cfg, device="cpu")(model, {"tokens": p})
    np.testing.assert_allclose(out["prefill"], want.numpy(), rtol=1e-5, atol=1e-5)
    p = p[:, :DECODE]
    cache = TM.init_cache(cfg, p.shape[0], p.shape[1] + 4, device="cpu")
    dec = sv.build_decode_step(cfg, device="cpu")
    for i in range(p.shape[1]):
        lg, cache = dec(model, cache, p[:, i:i + 1])
    tok = lg[:, -1].argmax(-1, keepdim=True)
    for i, got in enumerate(out["decode"]):
        np.testing.assert_allclose(got, lg.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{key} step {i}")
        lg, cache = dec(model, cache, tok)
        tok = lg[:, -1].argmax(-1, keepdim=True)


def test_launcher_trains_a_family_on_the_model_axis(tp2):
    """``launch.train --arch deepseek-v2-lite-16b --model-parallel 2``: model
    rank 0 writes the gathered model, which one process restores."""
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    model = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tree, meta = ckpt.restore_checkpoint(f"{tp2.tmp}/launcher", "step_2", F.module_tree(model))
    assert meta["step"] == 2 and np.isfinite(meta["loss"])
    assert all(np.isfinite(x.numpy()).all() for x in F.tree_leaves(tree))


def test_caches_hold_a_rank_share(tp2, grid):
    """The decode caches as ``cache_specs`` place them: MLA's latent whole,
    an SSM state's d_inner / M channels (Mamba-2: heads), the shared
    block's KV heads / M; on the grid each data rank's B / K rows."""
    B = PROMPT[0]
    ds, fm, zb = (tp2.out[k]["cache"] for k in ("deepseek", "falcon", "zamba"))
    assert ds["layers/ckv"] == (2, B, DECODE + 4, 16)
    assert fm["layers/h"] == (2, B, 64, 8) and fm["layers/conv"][-1] == 64
    assert zb["layers/mamba/h"] == (2, 2, B, 4, 16, 8)
    assert zb["layers/attn/k"][2] == 2
    assert grid.out["zamba"]["cache"]["layers/mamba/h"][2] == B // 2


def test_refusals_name_their_items():
    """Every language-model family runs at M > 1 and on a grid: the
    encoder-decoder and VLM since their slice (ROADMAP queue 1, item 12.8;
    tests/test_torch_tp_encdec.py holds them), as the MoE, SSM and hybrid
    families here.  Training on the head slots of a padded layout builds
    its step (item 12.4: tests/test_torch_pad_slots.py holds it at M = 4).
    What stays refused: the paper's CNN as a language model."""
    from repro_torch.launch.mesh import DataAxis

    class Grid(Mesh):     # the data axis as processes, no live group reached
        def data_axis(self):
            return DataAxis(None, self.shape["data"], 0)

    tc = _tcs("mean", "none", 0)[1]
    meshes = (Mesh(shape={"data": 2, "model": 2}), Grid(shape={"data": 2, "model": 2}))
    cfgs = [get_config(arch).reduced() for arch in ("seamless-m4t-medium", "llava-next-34b")]
    for cfg in cfgs + [_cfgs(key)[1] for key in FAMILIES]:
        TL.check_family(cfg)
        for mesh in meshes:
            assert tr._check(cfg, tc, mesh) is None
    assert tr._check(_cfgs("padded")[1], tc, Mesh(shape={"data": 2, "model": 4})) is None
    for mesh in meshes:
        with pytest.raises(NotImplementedError, match="not a language model"):
            tr._check(get_config("lenet-mnist"), tc, mesh)
