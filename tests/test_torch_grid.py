"""The data axis as processes: a K x M grid of ``gloo`` ranks on the CPU
(``tests/_torch_spmd_child.py``'s ``task_grid``, spawned once per grid
for the whole module), each rank one candidate's gradient on its model
block, FSDP blocks of the parameters and the optimizer state, held to the
reference and to the one-process port on the same numpy weights, tokens
and noise.  The FSDP rule's threshold (``sharding._FSDP_MIN_DIM``, 1024)
is lowered to 64 in the ranks, so that the reduced widths split over the
data axis (the threshold is a size, not a layout: the rule stays the
reference's).

Tolerances, fixed before the runs:
  trajectory   params after 3 steps within rtol 1e-4 / atol 1e-5 of the
               reference's composed step (``ReferenceStep``) and within
               rtol 1e-5 / atol 1e-6 of the one-process port; masks and
               weights equal; loss rtol 1e-5 and 1e-6;
  FSDP         ``fsdp_params`` on and off give the same trajectory within
               rtol 1e-5;
  statistics   the psum'd statistics within rtol 1e-5 of the whole
               candidates' (a coordinate counted twice would be off by
               its share);
  noise        draws bit-equal to one process's;
  serving      prefill and decode logits within rtol 1e-5 / atol 1e-5 of
               one process (float32, the flash branch's plain version at
               a lowered threshold);
  checkpoints  bit-equal across grid shapes; a resume on another grid
               shape gives the one-process next step (rtol 1e-5 / atol
               1e-6);
  gspmd        held to the one-process gspmd step (rtol 1e-5 / atol 1e-6);
  grid layout  the coordinates and group lists at 256 and 512 ranks equal
               ``np.arange(n).reshape(shape)`` (no processes).

K = 2 x M = 2 runs Qwen's reduced form (its QKV biases split over the
model axis and whole over the data axis, its norm scales replicated over
the model axis and split over the data axis: three of the four column
groups; no dense leaf is both replicated and whole) and the StableLM form of ``test_torch_tp.py`` with one KV
head, which M = 2 does not divide (the KV projections replicated);
WFAgg needs K > 2 (at K = 2 both candidates sit at one distance from
their median), so the robust rules run on K = 4 x M = 1."""
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
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import serve as sv
from repro_torch.train import trainer as tr

from _torch_spmd_child import run_ranks, same_on_every_rank
from test_torch_trainer import ReferenceStep, _reference_state

QWEN = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, vocab_size=128,
            head_dim=32)
STABLELM = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab_size=128,
                head_dim=16)
W = dict(f=1, transient=1, window=2)
STEPS = 3
PROMPT = (4, 160)
# (label, method, backend, attack, fsdp_params, mode): the runs of each grid
RUNS4 = [("wfagg fused ipm", "wfagg", "fused", "ipm_100", True, "robust_dp"),
         ("wfagg reference ipm", "wfagg", "reference", "ipm_100", True, "robust_dp"),
         ("alt_wfagg fused ipm", "alt_wfagg", "fused", "ipm_100", True, "robust_dp"),
         ("mean ipm", "mean", "fused", "ipm_100", True, "robust_dp"),
         ("wfagg fused noise", "wfagg", "fused", "noise", True, "robust_dp"),
         ("wfagg fused ipm whole", "wfagg", "fused", "ipm_100", False, "robust_dp"),
         ("gspmd", "mean", "fused", "none", False, "gspmd")]
RUNS22 = [("mean noise", "mean", "fused", "noise", True, "robust_dp"),
          ("median ipm", "median", "fused", "ipm_100", True, "robust_dp"),
          ("gspmd", "mean", "fused", "none", False, "gspmd")]
METHODS = [("wfagg", "fused"), ("wfagg", "reference"), ("alt_wfagg", "fused"),
           ("median", "fused")]


def _cfgs(small):
    arch = "qwen1.5-0.5b" if small is QWEN else "stablelm-3b"
    return (dataclasses.replace(jget_config(arch).reduced(), **small),
            dataclasses.replace(get_config(arch).reduced(), **small))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tcs(K, method, backend, attack, fsdp, mode):
    n_bad = 1 if attack != "none" else 0
    jtc = jtr.TrainConfig(mode=mode, agg=jra.RobustAggConfig(
        method=method, layout="stacked", backend="reference",
        wfagg=jwf.WFAggConfig(**W)), attack=attack, n_malicious=n_bad, lr=1e-2, warmup=0,
        donate=False, fsdp_params=fsdp)
    tc = tr.TrainConfig(mode=mode, agg=tra.RobustAggConfig(
        method=method, layout="stacked", backend=backend, wfagg=twf.WFAggConfig(**W)),
        attack=attack, n_malicious=n_bad, lr=1e-2, warmup=0, fsdp_params=fsdp)
    return jtc, tc


def _state_dict(sj):
    agg = sj.agg_state
    return {"params": sj.params, "opt_state": sj.opt_state, "step": int(sj.step),
            "agg_state": None if agg is None else dict(
                prev=agg.prev, hist_s=agg.hist_s, hist_b=agg.hist_b, count=agg.count,
                t=agg.t)}


def _candidates(params, K, bad, seed, rounds=3):
    """Per round K whole candidate trees and a prev: unit normals around a
    shared direction, the rows of ``bad`` pushed the other way."""
    rng = np.random.default_rng(seed)

    def draw():
        def leaf(p):
            base = rng.standard_normal(p.shape).astype(np.float32)
            x = 0.5 * rng.standard_normal((K,) + p.shape).astype(np.float32) + base
            x[list(bad)] = -3.0 * base
            return x
        return jax.tree.map(leaf, params)

    prev = draw()
    out = []
    for _ in range(rounds):
        cur = draw()
        out.append({"tree": cur, "prev": prev})
        prev = cur
    return out


class Grid:
    """One spawned grid of K x M ranks running every part, and its inputs."""

    def __init__(self, small, K, M, tmp, parts, runs=(), resume=None):
        self.jcfg, self.cfg = _cfgs(small)
        self.K, self.M = K, M
        self.params = _np_tree(jax.jit(functools.partial(JM.init_params, self.jcfg))(
            jax.random.PRNGKey(0)))
        rng = np.random.default_rng(1)
        self.prompts = rng.integers(0, self.cfg.vocab_size, PROMPT).astype(np.int32)
        self.cands = _candidates(self.params, K, (K - 1,), seed=K + M)
        self.ckpt_dir = str(tmp)
        stream = JTokenStream(vocab_size=self.jcfg.vocab_size, seq_len=32, batch_size=8)
        self.batches = [np.asarray(stream.batch(i)["tokens"]) for i in range(STEPS)]
        self.runs = {}
        child_runs = []
        for label, *spec in runs:
            jtc, tc = _tcs(K, *spec)
            sj = _np_tree(_reference_state(self.jcfg, jtc, K))
            self.runs[label] = (jtc, tc, sj)
            child_runs.append({"tc": tc, "state": _state_dict(sj), "batches": self.batches,
                               "save": label == "mean noise"})
        self.labels = [r[0] for r in runs]
        self.ranks = run_ranks("grid", K * M, tmp, timeout=240, K=K, M=M, cfg=self.cfg,
                               params=self.params, parts=parts, runs=child_runs,
                               cands=self.cands, methods=METHODS,
                               wcfg=twf.WFAggConfig(**W), prompts=self.prompts,
                               ckpt_dir=self.ckpt_dir, resume=resume)
        self.out = self.ranks[0]

    def one_process(self, label):
        """The one-process port's trajectory of a run (K candidates in one
        process) from the same reference state: per step the metrics and
        the params' leaves."""
        _, tc, sj = self.runs[label]
        st = tr.state_from_jax(sj, self.cfg, device="cpu")
        seen = {}
        step = tr.build_train_step(self.cfg, tc, tmesh.make_test_mesh(data=self.K),
                                   observe=lambda phase, **v: seen.update({phase: v}))
        out = []
        for b in self.batches:
            st, m = step(st, {"tokens": torch.as_tensor(b).long()})
            info = seen.get("allreduce", {}).get("info", {})
            out.append((m, {k: info[k].numpy() for k in ("mask_d", "mask_c", "mask_t")
                            if k in info},
                        [x.numpy().copy() for x in F.tree_leaves(F.module_tree(st.params))]))
        return out


@pytest.fixture(scope="module")
def grid22(tmp_path_factory):
    return Grid(QWEN, 2, 2, tmp_path_factory.mktemp("grid22"),
                ("stats", "noise", "train", "launcher", "serve"), runs=RUNS22)


@pytest.fixture(scope="module")
def grid22_kv1(tmp_path_factory):
    return Grid(STABLELM, 2, 2, tmp_path_factory.mktemp("grid22kv1"), ("stats", "serve"))


@pytest.fixture(scope="module")
def grid41(tmp_path_factory):
    return Grid(QWEN, 4, 1, tmp_path_factory.mktemp("grid41"),
                ("stats", "allreduce", "noise", "train"), runs=RUNS4)


@pytest.fixture(scope="module")
def grid41_resume(tmp_path_factory, grid22):
    """K = 4 x M = 1 resuming the K = 2 x M = 2 grid's checkpoint."""
    return Grid(QWEN, 4, 1, tmp_path_factory.mktemp("grid41r"), ("resume",),
                runs=[RUNS4[0]], resume=grid22.ckpt_dir)


def test_grid_layout_of_the_production_mesh():
    """The 16 x 16 and 2 x 16 x 16 grids: rank r at the reference's device
    order (``np.arange(n).reshape(shape)``), its data group the ranks with
    its model index, its model group those with its (pod, data)."""
    for shape in ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}):
        dims = tuple(shape.values())
        ranks = np.arange(int(np.prod(dims))).reshape(dims)
        lay = tmesh.grid_layout(shape)
        for r, c in enumerate(lay.coords):
            assert ranks[tuple(c)] == r
        flat = ranks.reshape(-1, 16)
        assert lay.model_groups == flat.tolist()
        assert lay.data_groups == flat.T.tolist()
        assert len(lay.data_groups[0]) == (32 if "pod" in shape else 16)
    assert tmesh.grid_layout({"pod": 0, "data": 4, "model": 2}).data_groups == \
        [[0, 2, 4, 6], [1, 3, 5, 7]]
    with pytest.raises(RuntimeError, match="production mesh needs 256"):
        tmesh.make_production_mesh()


@pytest.mark.parametrize("which", ["grid22", "grid22_kv1", "grid41"])
def test_statistics_count_each_coordinate_once(which, request):
    """The psum'd statistics of the rank's column blocks (kernels 4 and 6's
    plain versions on the groups it counts) are the whole candidates'."""
    g = request.getfixturevalue(which)
    whole = np.concatenate([x.reshape(g.K, -1) for x in jax.tree.leaves(g.cands[0]["tree"])],
                           axis=1).astype(np.float64)
    med = np.median(whole, axis=0)
    st = g.out["stats"]
    np.testing.assert_allclose(st["dist2"], ((whole - med) ** 2).sum(1), rtol=1e-5)
    np.testing.assert_allclose(st["norm2"], (whole ** 2).sum(1), rtol=1e-5)
    np.testing.assert_allclose(st["gram"], whole @ whole.T, rtol=1e-5, atol=1e-2)
    assert same_on_every_rank([r["stats"] for r in g.ranks])
    # each rank counts: the data-split groups everywhere, the whole ones on
    # data rank 0, the model-replicated ones on model rank 0
    for r, res in enumerate(g.ranks):
        d, m = divmod(r, g.M)
        want = [(i % 2 == 0 or d == 0) and (i // 2 == 0 or m == 0)
                for i in range(len(res["groups"]))]
        assert list(res["counted"]) == want
    if which == "grid22":          # three column groups have leaves
        assert [n > 0 for n in g.out["groups"]] == [True, True, True, False]


def test_pruned_kv_heads_and_cache_rows(grid22_kv1, grid22):
    """One KV head over M = 2: the KV projections replicated over the model
    axis (a column group of their own); the cache holds a data rank's rows."""
    assert len(grid22_kv1.out["groups"]) == 4
    assert grid22_kv1.out["cache_rows"] == PROMPT[0] // 2
    assert grid22.out["cache_rows"] == PROMPT[0] // 2


def _reference_rounds(g, method):
    cfg = jra.RobustAggConfig(method=method, layout="stacked", backend="reference",
                              wfagg=jwf.WFAggConfig(**W))
    fn = jax.jit(jra.robust_allreduce_stacked, static_argnums=(1,))
    state = jra.init_tree_agg_state(cfg, g.K, g.params)._replace(
        prev=jax.tree.map(jnp.asarray, g.cands[0]["prev"]))
    out = []
    for c in g.cands:
        agg, state, info = fn(jax.tree.map(jnp.asarray, c["tree"]), cfg, state)
        out.append((jax.tree.leaves(_np_tree(agg)), _np_tree(info)))
    return out


@pytest.mark.parametrize("method", ["wfagg", "alt_wfagg", "median"])
def test_data_axis_route_matches_reference(grid41, method):
    """The stacked all-reduce's data-axis route on each rank's column block,
    gathered: masks bit-equal, weights and the aggregate within 3e-5 of the
    reference's ``robust_allreduce_stacked`` on the whole candidates."""
    want = _reference_rounds(grid41, method)
    for m_, backend in METHODS:
        if m_ != method:
            continue
        for r, (got, (wout, winfo)) in enumerate(zip(grid41.out["allreduce"][(method,
                                                                               backend)], want)):
            label = f"{method} {backend} round {r}"
            for m in ("mask_d", "mask_c", "mask_t"):
                assert (m in got) == (m in winfo), (label, m)
                if m in winfo:
                    assert np.array_equal(got[m], winfo[m]), (label, m)
            np.testing.assert_allclose(got["weights"], winfo["weights"], atol=3e-5,
                                       err_msg=label)
            for a, b in zip(got["out"], wout):
                np.testing.assert_allclose(a, b, atol=3e-5, rtol=0, err_msg=label)
    if method == "wfagg":         # the attacker is rejected
        w = grid41.out["allreduce"][("wfagg", "fused")]
        assert all(float(w[r]["weights"][grid41.K - 1]) == 0.0 for r in range(3))


@pytest.mark.parametrize("which", ["grid22", "grid41"])
def test_noise_draws_equal_one_process(which, request):
    g = request.getfixturevalue(which)
    cand = jax.tree.map(lambda x: torch.as_tensor(np.array(x)), g.cands[0]["tree"])
    mal = torch.tensor([k % 2 == 1 for k in range(g.K)])
    want = tra.apply_stacked_attack(cand, mal, "noise", torch.Generator().manual_seed(7))
    for got, w in zip(g.out["noise"], F.tree_leaves(want)):
        assert np.array_equal(got, w.numpy())


def _hold_one_process(g, label):
    """Every step of a grid run against the one-process port: loss,
    weights, masks, grad_norm and the gathered params."""
    one = g.one_process(label)
    got_run = g.out["train"][g.labels.index(label)]
    for i, (got, (m, masks, leaves)) in enumerate(zip(got_run, one)):
        key = f"{label} step {i}"
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-6, err_msg=key)
        np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]), rtol=1e-5,
                                   err_msg=key)
        assert np.array_equal(got["weights"], m["weights"].numpy()), key
        assert got["masks"].keys() == masks.keys(), key
        for k in masks:
            assert np.array_equal(got["masks"][k], masks[k]), (key, k)
        for a, b in zip(got["params"], leaves):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=key)
    assert same_on_every_rank([r["train"][g.labels.index(label)] for r in g.ranks])
    return got_run


def _hold_reference(g, label, got_run):
    jtc, _, sj = g.runs[label]
    ref = ReferenceStep(g.jcfg, jtc, g.K)
    sj = jax.tree.map(jnp.asarray, sj)
    for i, (b, got) in enumerate(zip(g.batches, got_run)):
        sj, mj = ref(sj, {"tokens": jnp.asarray(b)})
        key = f"{label} step {i}"
        np.testing.assert_allclose(got["loss"], float(mj["loss"]), rtol=1e-5, err_msg=key)
        assert np.array_equal(got["weights"], np.asarray(mj["weights"])), key
        for m in ("mask_d", "mask_c", "mask_t"):
            if m in mj:
                assert np.array_equal(got["masks"][m], np.asarray(mj[m])), (key, m)
        for (path, w), a in zip(jax.tree_util.tree_flatten_with_path(sj.params)[0],
                                got["params"]):
            np.testing.assert_allclose(a, np.asarray(w), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{key} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("label,reference", [
    ("wfagg fused ipm", True), ("wfagg reference ipm", False), ("alt_wfagg fused ipm", True),
    ("mean ipm", True), ("wfagg fused noise", False), ("wfagg fused ipm whole", False),
    ("gspmd", False)])
def test_grid_trajectory_k4(grid41, label, reference):
    """3 steps on K = 4 x M = 1 (each rank one candidate, FSDP blocks unless
    ``whole``) against the one-process port and, where named, the
    reference's composed step (noise draws are the port's own bits)."""
    got = _hold_one_process(grid41, label)
    if reference:
        _hold_reference(grid41, label, got)
    if "ipm" in label and not label.startswith("mean"):
        bad = int(np.flatnonzero(spaced_malicious(grid41.K, 1))[0])
        assert all(float(s["weights"][bad]) == 0.0 for s in got)


def test_fsdp_on_and_off_agree(grid41):
    on = grid41.out["train"][grid41.labels.index("wfagg fused ipm")]
    off = grid41.out["train"][grid41.labels.index("wfagg fused ipm whole")]
    for a, b in zip(on, off):
        assert np.array_equal(a["weights"], b["weights"])
        for x, y in zip(a["params"], b["params"]):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("label", [r[0] for r in RUNS22])
def test_grid_trajectory_model_axis(grid22, label):
    """3 steps on K = 2 x M = 2 (the mean under noise, the median under
    IPM, gspmd) against the one-process port; the mean also against the
    reference (noise excluded: the port's own draws)."""
    _hold_one_process(grid22, label)


def test_checkpoints_cross_grid_shapes(grid22, grid41_resume):
    """Rank 0 of the K = 2 x M = 2 grid writes today's one-card format; a
    whole model restores it bit for bit; K = 4 x M = 1 resumes it and
    takes the next step as one process does."""
    model = TM.params_from_jax(grid22.params, grid22.cfg, "cpu")
    F.layout_flat(model)
    tree, meta = ckpt.restore_checkpoint(grid22.ckpt_dir, "grid", F.module_tree(model))
    assert meta == {"grid": [2, 2]}
    saved = grid22.out["train"][grid22.labels.index("mean noise")][-1]["params"]
    for a, b in zip(F.tree_leaves(tree), saved):
        assert np.array_equal(a.numpy(), b)
    g = grid41_resume
    _, tc, sj = g.runs["wfagg fused ipm"]
    st = tr.state_from_jax(sj, g.cfg, device="cpu")
    tr.load_params_(st.params, tree, None)
    st, m = tr.build_train_step(g.cfg, tc, tmesh.make_test_mesh(data=4))(
        st, {"tokens": torch.as_tensor(g.batches[0]).long()})
    got = g.out["train"][0][0]
    np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-6)
    for a, b in zip(got["params"], F.tree_leaves(F.module_tree(st.params))):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-5, atol=1e-6)


def test_launcher_on_the_grid(grid22):
    """``--model-parallel 2`` on 4 ranks: the data axis is 2 processes; rank
    0 writes the gathered model; ``--candidates`` off W / M raises."""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(), d_model=64,
                              head_dim=16, d_ff=256, n_layers=2, vocab_size=128)
    model = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tree, meta = ckpt.restore_checkpoint(grid22.ckpt_dir + "/launcher", "step_2",
                                         F.module_tree(model))
    assert meta["step"] == 2 and np.isfinite(meta["loss"])
    assert all(np.isfinite(x.numpy()).all() for x in F.tree_leaves(tree))
    assert "4 ranks at --model-parallel 2 run 2 candidates" in grid22.out["mismatch"]


@pytest.mark.parametrize("which", ["grid22", "grid22_kv1"])
def test_prefill_and_decode_match_one_process(which, request, monkeypatch):
    """Serving FSDP over data (each layer's weights gathered just before
    it) and heads over model: every data rank its rows, the logits
    gathered."""
    g = request.getfixturevalue(which)
    monkeypatch.setattr(TL, "SDPA_CHUNK_THRESHOLD", 128)
    model = TM.params_from_jax(g.params, g.cfg, "cpu")
    p = torch.as_tensor(g.prompts).long()
    want = sv.build_prefill(g.cfg, device="cpu")(model, {"tokens": p})
    np.testing.assert_allclose(g.out["prefill"], want.numpy(), rtol=1e-5, atol=1e-5)
    assert g.out["blocks_after"]          # the model holds its blocks again
    cache = TM.init_cache(g.cfg, p.shape[0], p.shape[1] + 4, device="cpu")
    dec = sv.build_decode_step(g.cfg, device="cpu")
    for i in range(p.shape[1]):
        lg, cache = dec(model, cache, p[:, i:i + 1])
    tok = lg[:, -1].argmax(-1, keepdim=True)
    for i, got in enumerate(g.out["decode"]):
        np.testing.assert_allclose(got, lg.numpy(), rtol=1e-5, atol=1e-5, err_msg=f"step {i}")
        lg, cache = dec(model, cache, tok)
        tok = lg[:, -1].argmax(-1, keepdim=True)
    assert same_on_every_rank([r["decode"] for r in g.ranks])


def test_grid_refusals(monkeypatch):
    """What the grid still refuses (the paper's CNN as a language model,
    and a grid without its groups); and what it now runs: the
    encoder-decoder and VLM families (ROADMAP queue 1, item 12.8;
    tests/test_torch_tp_encdec.py holds them), the flat layout at model > 1
    (item 12.2c), Adafactor and band_rider on a rank's column block, which
    takes its per-coordinate fallback (its ``torch.roll`` branch, which
    reads the whole vector, is never reached)."""
    from repro_torch.core import attacks as tatk
    from repro_torch.launch.mesh import Mesh

    class Axis:        # a data axis that is processes, without a live group
        def __init__(self, shape):
            self.shape = shape

        def data_axis(self):
            return tmesh.DataAxis(None, self.shape["data"], 0)

        def model_axis(self):
            return None

    _, cfg = _cfgs(QWEN)
    grid = Axis({"data": 2, "model": 2})
    assert tr._check(cfg, tr.TrainConfig(agg=tra.RobustAggConfig(layout="flat")), grid) is None
    assert tr._check(dataclasses.replace(cfg, optimizer="adafactor"),
                     tr.TrainConfig(agg=tra.RobustAggConfig(layout="stacked")),
                     Axis({"data": 2, "model": 1})) is None
    stacked = tr.TrainConfig(agg=tra.RobustAggConfig(layout="stacked"))
    for arch in ("seamless-m4t-medium", "llava-next-34b"):
        for shape in ({"data": 2, "model": 1}, {"data": 2, "model": 2}):
            assert tr._check(get_config(arch).reduced(), stacked, Axis(shape)) is None
    with pytest.raises(NotImplementedError, match="not a language model"):
        tr._check(get_config("lenet-mnist"), stacked, Axis({"data": 2, "model": 1}))
    shards = tra.GridShards(group=None, leaf_groups=(0,), counted=(True,), cuts=((),))
    x = torch.randn((4, 3), generator=torch.Generator().manual_seed(0))
    mal = torch.tensor([False, True, False, False])

    def no_roll(*a, **k):
        raise AssertionError("band_rider reached its torch.roll branch")

    monkeypatch.setattr(tatk.torch, "roll", no_roll)
    got = tra.apply_stacked_attack({"w": x.clone()}, mal, "band_rider", model_shards=shards,
                                   prev={"w": torch.zeros_like(x)})
    benign = x[~mal]
    want = benign.mean(0) - 0.5 * benign.std(0, correction=0)
    torch.testing.assert_close(got["w"][1], want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got["w"][~mal], x[~mal])
    with pytest.raises(RuntimeError, match="initialised torch.distributed"):
        tmesh.make_grid(2, 2)
    assert Mesh(shape={"data": 2, "model": 1}).data_axis() is None
