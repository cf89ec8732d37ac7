"""Training on a padded layout's head slots and with bf16 parameters on
the model axis and the grid: ``gloo`` ranks on the CPU
(``tests/_torch_spmd_child.py``'s ``task_bf16pad``, spawned once per mesh
for the whole module) held to one process and to the JAX package.

Meshes and configs:
  M = 4        an Arctic-like config with 7 live query heads padded to 8
               and 1 KV head (``tests/test_torch_tp_families.py``'s
               "padded"): each rank holds 2 head slots, rank 3 one live
               and one pad slot.  Adafactor (float32), K = 4, WFAgg under
               noise on the stacked (``fused``: kernels 4, 6 and 7's plain
               versions) and the flat layout; and SGD under IPM-100 on the
               stacked layout against the reference's composed step on
               the 7-head model;
  M = 2        the reduced Arctic in bf16 at d_model 64 (``BF16``), K = 4:
               WFAgg under noise with Adafactor, stacked and flat; AdamW
               under IPM-100 stacked;
  2 x 2 grid   the same bf16 config, K = 2: the median under noise
               with Adafactor (``fsdp_params``), the mean under noise with
               AdamW on the flat layout.

Tolerances, fixed before the runs:
  route       each step's candidates (after the attack) gathered whole
              and aggregated by the one-process M = 1 route (stacked:
              ``fused``, kernel 1's plain version; flat: ``Emulated(K)``)
              from the step's WFAgg-T state: masks equal, weights within
              1e-6, the aggregate within 2e-4 (``test_torch_flat_tp.py``'s
              bound; float32) or one bf16 rounding, ``2^-7 |want|``
              (bf16: both round a float32 sum once);
  pad slots   every rank's pad-slot parameters and candidate gradients
              exactly 0 after every step;
  Adafactor   the padded model's first update within 1e-5 of the leaf's
              largest update of one process's on the whole 7-head leaf
              (``test_torch_flat_tp.py``'s bound);
  reference   (padded, SGD) 3 steps: loss rtol 1e-5, weights and masks
              equal, parameters rtol 1e-4 / atol 1e-5 of the reference's
              composed step (``ReferenceStep``,
              ``test_torch_tp_families.py``'s trajectory rule);
  bf16        the loss within 2e-2 relative of the reference's (the dense
              bf16 rule; its step-1 loss under noise, every step's under
              IPM); given the reference's step-1 aggregate, each rank's
              optimizer on its blocks (Adafactor and AdamW; on the grid
              its FSDP blocks too) updates the parameters to within one
              bf16 rounding of the update and one of the sum of the
              reference's; on the grid, 3 steps within 2e-2 relative of
              one process's loss and parameters (relative rms);
  noise       the noise attack on the ranks' blocks (stacked, and flat on
              the model axis) bit-equal to one process's at M = 2, M = 4
              and on the grid, no draw larger than one chunk."""
import dataclasses
import functools
import types

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
from repro.optim import optimizers as jopt
from repro.train import trainer as jtr
from repro_torch.configs.registry import get_config
from repro_torch.core import flatten as F
from repro_torch.core import wfagg as twf
from repro_torch.distributed import robust_allreduce as tra
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.optim import optimizers as topt
from repro_torch.train import trainer as tr

from _torch_spmd_child import run_ranks
from test_torch_trainer import ReferenceStep

PADDED = dict(d_model=64, vocab_size=128, n_layers=1, n_heads=7, n_kv_heads=1,
              pad_heads_to=8, head_dim=16, d_ff=32, dense_residual_ff=32, n_experts=4,
              top_k=2)
STEPS = 3
CHUNK = 4096
NOISE_CHUNK = 64
ROUTE_ATOL = 2e-4
W_TOL = 1e-6
ADA_TOL = 1e-5
LOSS_RTOL = 2e-2


# the reduced Arctic in bf16, narrowed (4 heads of 16, 4 experts, 2 layers)
BF16 = dict(param_dtype="bfloat16", d_model=64, vocab_size=128, head_dim=16, d_ff=64,
            dense_residual_ff=64)


@functools.lru_cache(maxsize=None)
def _cfgs(key, optimizer=None):
    over = dict(PADDED) if key == "padded" else dict(BF16)
    if optimizer:
        over["optimizer"] = optimizer
    return (dataclasses.replace(jget_config("arctic-480b").reduced(), **over),
            dataclasses.replace(get_config("arctic-480b").reduced(), **over))


def _tcs(method, attack, layout, backend="fused", K=4, fsdp=False):
    w = dict(f=1, transient=1, window=2)
    agg = dict(method=method, layout=layout, chunk_size=CHUNK, sketch_dim=256)
    common = dict(attack=attack, n_malicious=1, lr=1e-2, warmup=0)
    jtc = jtr.TrainConfig(agg=jra.RobustAggConfig(backend="reference",
                                                  wfagg=jwf.WFAggConfig(**w), **agg),
                          donate=False, **common)
    tc = tr.TrainConfig(agg=tra.RobustAggConfig(backend=backend, wfagg=twf.WFAggConfig(**w),
                                                **agg), fsdp_params=fsdp, **common)
    return jtc, tc


def _state_np(sj):
    agg = sj.agg_state
    return {"params": sj.params, "opt_state": sj.opt_state, "step": int(sj.step),
            "agg_state": None if agg is None else (
                dict(temporal=agg.temporal) if hasattr(agg, "temporal") else
                dict(prev=agg.prev, hist_s=agg.hist_s, hist_b=agg.hist_b, count=agg.count,
                     t=agg.t))}


@functools.lru_cache(maxsize=None)
def _ref_state(key, optimizer, method, attack, layout, K):
    """The reference's ``init_train_state`` build (``test_torch_trainer.
    _reference_state``) on the seed-0 parameters, initialised once a
    config."""
    jcfg, _ = _cfgs(key, optimizer)
    jtc, _ = _tcs(method, attack, layout, K=K)
    params = jax.tree.map(jnp.asarray, _jparams(key))
    agg = None
    if method in ("wfagg", "alt_wfagg") and jtc.agg.wfagg.use_temporal:
        agg = (jra.init_tree_agg_state(jtc.agg, K, params) if layout == "stacked"
               else jra.init_agg_state(jtc.agg, K))
    opt = jopt.make_optimizer(jcfg.optimizer)
    return jtr.TrainState(params, opt.init(params), agg, jnp.zeros((), jnp.int32))


def _batches(key, K):
    jcfg, _ = _cfgs(key)
    stream = JTokenStream(vocab_size=jcfg.vocab_size, seq_len=32, batch_size=2 * K)
    return [np.asarray(stream.batch(i)["tokens"]) for i in range(STEPS)]


def _run(key, optimizer, method, attack, layout, K, route=False, fsdp=False,
         backend="fused"):
    _, cfg = _cfgs(key, optimizer)
    _, tc = _tcs(method, attack, layout, backend, K, fsdp)
    sj = jax.tree.map(np.asarray, _ref_state(key, optimizer, method, attack, layout, K))
    state = _state_np(sj)
    if state["agg_state"] is not None and "temporal" in state["agg_state"]:
        t = state["agg_state"]["temporal"]
        state["agg_state"] = {"temporal": tra.TemporalState(*(np.asarray(x) for x in t))}
    return dict(cfg=cfg, tc=tc, K=K, state=state, batches=_batches(key, K), route=route)


@functools.lru_cache(maxsize=None)
def _jparams(key):
    jcfg, _ = _cfgs(key)
    return jax.tree.map(np.asarray, jax.jit(functools.partial(JM.init_params, jcfg))(
        jax.random.PRNGKey(0)))


def _noise_part(key, K):
    _, cfg = _cfgs(key)
    rng = np.random.default_rng(9)
    tree = jax.tree.map(lambda p: rng.standard_normal((K,) + p.shape).astype(np.float32),
                        _jparams(key))
    return dict(cfg=cfg, params=_jparams(key), tree=tree, K=K, chunk=NOISE_CHUNK)


@functools.lru_cache(maxsize=None)
def _ref_step(key, optimizer, method, attack, K):
    """The reference's composed step (``ReferenceStep``, jitted once) with
    the aggregate its optimizer is given captured in ``.seen``."""
    jcfg, _ = _cfgs(key, optimizer)
    jtc, _ = _tcs(method, attack, "stacked", K=K)
    ref = ReferenceStep(jcfg, jtc, K)
    ref.seen = {}
    orig = ref.update

    def capture(g, o, p, lr):
        ref.seen["grads"], ref.seen["lr"] = g, lr
        return orig(g, o, p, lr)
    ref.update = capture
    return ref


@functools.lru_cache(maxsize=None)
def _ref_step1(key, optimizer, method, attack, K):
    """The reference's composed step 1 from its initial state: (its
    aggregate gradient tree as float32 numpy, lr, the updated parameters,
    the loss: the candidates' mean loss, before any attack)."""
    ref = _ref_step(key, optimizer, method, attack, K)
    sj = _ref_state(key, optimizer, method, attack, "stacked", K)
    new, m = ref(sj, {"tokens": jnp.asarray(_batches(key, K)[0])})
    grads = jax.tree.map(lambda g: np.asarray(g, np.float32), ref.seen["grads"])
    return grads, float(ref.seen["lr"]), jax.tree.map(np.asarray, new.params), float(m["loss"])


def _opt_entry(key, optimizer, K, fsdp=False):
    grads, lr, _, _ = _ref_step1(key, optimizer, "wfagg" if K > 2 else "median",
                                 "ipm_100", K)
    _, cfg = _cfgs(key, optimizer)
    _, tc = _tcs("mean", "none", "stacked", K=K, fsdp=fsdp)
    sj = jax.tree.map(np.asarray, _ref_state(key, optimizer, "wfagg" if K > 2 else "median",
                                             "ipm_100", "stacked", K))
    st = _state_np(sj)
    st["agg_state"] = None
    return dict(cfg=cfg, tc=tc, K=K, state=st, grads=grads, lr=lr)


class Spawn:
    def __init__(self, shape, tmp, runs, noise, opt=()):
        self.runs, self.opt = runs, opt
        self.ranks = run_ranks("bf16pad", shape[0] * shape[1], tmp, timeout=300, runs=runs,
                               mesh_shape=shape, noise=noise, opt=[o for _, o in opt])
        self.out = self.ranks[0]


@pytest.fixture(scope="module")
def pad4(tmp_path_factory):
    runs = [("ada stacked", _run("padded", "adafactor", "wfagg", "noise", "stacked", 4,
                                 route=True)),
            ("ada flat", _run("padded", "adafactor", "wfagg", "noise", "flat", 4, route=True)),
            ("sgd ipm", _run("padded", None, "wfagg", "ipm_100", "stacked", 4,
                             backend="reference"))]
    sp = Spawn((1, 4), tmp_path_factory.mktemp("pad4"), [r for _, r in runs],
               _noise_part("padded", 4))
    sp.labels = [k for k, _ in runs]
    return sp


@pytest.fixture(scope="module")
def bf2(tmp_path_factory):
    runs = [("ada stacked", _run("bf16", "adafactor", "wfagg", "noise", "stacked", 4,
                                 route=True)),
            ("ada flat", _run("bf16", "adafactor", "wfagg", "noise", "flat", 4, route=True)),
            ("adamw ipm", _run("bf16", "adamw", "wfagg", "ipm_100", "stacked", 4))]
    opt = [("adafactor", _opt_entry("bf16", "adafactor", 4)),
           ("adamw", _opt_entry("bf16", "adamw", 4))]
    sp = Spawn((1, 2), tmp_path_factory.mktemp("bf2"), [r for _, r in runs],
               _noise_part("bf16", 4), opt)
    sp.labels = [k for k, _ in runs]
    return sp


@pytest.fixture(scope="module")
def grid22(tmp_path_factory):
    runs = [("ada median", _run("bf16", "adafactor", "median", "noise", "stacked", 2,
                                fsdp=True)),
            ("adamw flat mean", _run("bf16", "adamw", "mean", "noise", "flat", 2))]
    opt = [("adafactor", _opt_entry("bf16", "adafactor", 2, fsdp=True)),
           ("adamw", _opt_entry("bf16", "adamw", 2))]
    sp = Spawn((2, 2), tmp_path_factory.mktemp("grid22"), [r for _, r in runs],
               _noise_part("bf16", 2), opt)
    sp.labels = [k for k, _ in runs]
    return sp


def _steps(sp, label, rank=0):
    return sp.ranks[rank]["runs"][sp.labels.index(label)]


def _one_process_route(run, steps):
    """Per step the one-process M = 1 route on the step's gathered whole
    candidates: (aggregate, weights, masks)."""
    tc = run["tc"]
    K = run["K"]
    bf16 = run["cfg"].param_dtype == "bfloat16"
    prev = torch.zeros_like(torch.as_tensor(steps[0]["cands"]))
    out = []
    for s in steps:
        c = torch.as_tensor(s["cands"])
        if tc.agg.layout == "flat":
            state = tra.AggState(tra.TemporalState(*(torch.as_tensor(s["state"][f]) for f in
                                                     tra.TemporalState._fields)))
            o, _, info = tra.robust_allreduce(c.to(torch.bfloat16) if bf16 else c,
                                              tra.Emulated(K), tc.agg, state)
        else:
            st = tra.TreeAggState(prev={"w": prev}, **{f: torch.as_tensor(s["state"][f])
                                                      for f in ("hist_s", "hist_b", "count",
                                                                "t")})
            o, _, info = tra.robust_allreduce_stacked({"w": c}, tc.agg, st)
            o = o["w"].to(torch.bfloat16) if bf16 else o["w"]
            prev = c
        out.append((o.float().numpy(), info["weights"].numpy(),
                    {k: info[k].numpy() for k in ("mask_d", "mask_c", "mask_t") if k in info}))
    return out


def _hold_route(sp, label):
    run = sp.runs[sp.labels.index(label)]
    steps = _steps(sp, label)
    bf16 = run["cfg"].param_dtype == "bfloat16"
    for i, (s, (o, w, masks)) in enumerate(zip(steps, _one_process_route(run, steps))):
        for k, m in masks.items():
            assert np.array_equal(s["masks"][k], m), (label, i, k)
        np.testing.assert_allclose(s["weights"], w, rtol=0, atol=W_TOL, err_msg=f"{label} {i}")
        if bf16:
            assert np.all(np.abs(s["agg"] - o) <= 2.0 ** -7 * np.abs(o) + 1e-30), (label, i)
        else:
            np.testing.assert_allclose(s["agg"], o, rtol=0, atol=ROUTE_ATOL,
                                       err_msg=f"{label} {i}")


@pytest.mark.parametrize("label", ["ada stacked", "ada flat"])
def test_pad_slots_route_matches_one_process(pad4, label):
    _hold_route(pad4, label)


@pytest.mark.parametrize("label", ["ada stacked", "ada flat", "sgd ipm"])
def test_pad_slots_stay_zero(pad4, label):
    """Every rank's pad head slots, parameters and candidate gradients,
    exactly 0 after every step; rank 3 holds one (each rank 2 slots of 8,
    7 live)."""
    for r, res in enumerate(pad4.ranks):
        for i, s in enumerate(res["runs"][pad4.labels.index(label)]):
            assert s["pad"] == (0.0, 0.0), (label, r, i, s["pad"])
            # wq and wo hold pad slots, on rank 3 alone
            assert s["pad_leaves"] == (2 if r == 3 else 0), (r, s["pad_leaves"])
    # the candidates' whole ravel has the 7-head model's P
    jp = _jparams("padded")
    P = sum(np.asarray(x).size for x in jax.tree.leaves(jp))
    if label != "sgd ipm":
        assert _steps(pad4, label)[0]["cands"].shape == (4, P)


def test_pad_slots_adafactor_update_matches_one_process(pad4):
    """Step 1 of the padded model's Adafactor run: one process's update of
    each whole 7-head leaf from the gathered aggregate, against the
    gathered parameters after the step."""
    s = _steps(pad4, "ada stacked")[0]
    jp = _jparams("padded")
    leaves = [np.asarray(x, np.float32) for x in jax.tree.leaves(jp)]
    sizes = [x.size for x in leaves]
    grads = np.split(s["agg"], np.cumsum(sizes)[:-1])
    opt = topt.make_optimizer("adafactor")
    run = pad4.runs[0]
    lr = topt.warmup_cosine(run["tc"].lr, run["tc"].warmup, run["tc"].total_steps)(0)
    for p0, g, got in zip(leaves, grads, s["params"]):
        p = {"x": torch.as_tensor(p0)}
        u, _ = opt.update({"x": torch.as_tensor(g.reshape(p0.shape))}, opt.init(p), p, lr)
        want = (p["x"] + u["x"]).numpy()
        scale = max(float(u["x"].abs().max()), 1e-30)
        assert float(np.abs(got - want).max()) / scale <= ADA_TOL


def test_pad_slots_trajectory_matches_reference(pad4):
    """SGD under IPM-100 on the stacked layout: 3 steps against the
    reference's composed step on the 7-head model."""
    jcfg, _ = _cfgs("padded")
    jtc, _ = _tcs("wfagg", "ipm_100", "stacked", K=4)
    ref = ReferenceStep(jcfg, jtc, 4)
    sj = _ref_state("padded", None, "wfagg", "ipm_100", "stacked", 4)
    for i, (s, b) in enumerate(zip(_steps(pad4, "sgd ipm"), _batches("padded", 4))):
        sj, mj = ref(sj, {"tokens": jnp.asarray(b)})
        np.testing.assert_allclose(s["loss"], float(mj["loss"]), rtol=1e-5)
        assert np.array_equal(s["weights"], np.asarray(mj["weights"])), i
        for k, m in s["masks"].items():
            assert np.array_equal(m, np.asarray(mj[k])), (i, k)
        for got, want in zip(s["params"], jax.tree.leaves(sj.params)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


def _hold_noise(sp, key, K, layouts):
    part = _noise_part(key, K)
    _, cfg = _cfgs(key)
    tree = F.tree_map(lambda x: torch.as_tensor(np.array(x)), part["tree"])
    mal = torch.tensor([k % 2 == 1 for k in range(K)])
    want = tra.apply_stacked_attack(tree, mal, "noise", torch.Generator().manual_seed(7),
                                    chunk_size=NOISE_CHUNK)
    got = sp.out["noise"]
    for g, w in zip(got["stacked"], F.tree_leaves(want)):
        assert np.array_equal(g, w.numpy())
    if "flat" in layouts:
        flat = torch.cat([x.reshape(K, -1) for x in F.tree_leaves(tree)], 1)
        wflat = tra.apply_distributed_attack(flat, tra.Emulated(K), mal, "noise",
                                             torch.Generator().manual_seed(7),
                                             chunk_size=NOISE_CHUNK)
        assert np.array_equal(got["flat"], wflat.numpy())
    for res in sp.ranks:
        assert res["noise"]["largest_draw"] <= NOISE_CHUNK


def test_noise_on_four_ranks_equals_one_process(pad4):
    _hold_noise(pad4, "padded", 4, ("stacked", "flat"))


def test_noise_on_two_ranks_equals_one_process(bf2):
    _hold_noise(bf2, "bf16", 4, ("stacked", "flat"))


def test_noise_on_the_grid_equals_one_process(grid22):
    _hold_noise(grid22, "bf16", 2, ("stacked",))


def test_noise_largest_draw_is_one_chunk(monkeypatch):
    """One process: the noise attack's largest ``torch.randn`` draw is one
    chunk, on both layouts, where the vector is many chunks long."""
    draws = []
    randn = torch.randn

    def counted(*a, **kw):
        x = randn(*a, **kw)
        draws.append(x.numel())
        return x
    x = torch.randn((4, 10 * NOISE_CHUNK + 7), generator=torch.Generator().manual_seed(0))
    mal = torch.tensor([False, True, False, False])
    monkeypatch.setattr(torch, "randn", counted)
    tra.apply_distributed_attack(x.clone(), tra.Emulated(4), mal, "noise",
                                 torch.Generator().manual_seed(1), chunk_size=NOISE_CHUNK)
    tra.apply_stacked_attack({"a": x.clone()}, mal, "noise",
                             torch.Generator().manual_seed(1), chunk_size=NOISE_CHUNK)
    assert draws and max(draws) == NOISE_CHUNK


@pytest.mark.parametrize("label", ["ada stacked", "ada flat"])
def test_bf16_route_matches_one_process_on_two_ranks(bf2, label):
    _hold_route(bf2, label)
    assert _steps(bf2, label)[-1]["dtypes"] == ["torch.bfloat16"]


def test_bf16_loss_matches_reference_on_two_ranks(bf2):
    """The bf16 losses within 2e-2 of the reference's: every step under
    IPM-100 (AdamW), the first under noise (the draws are each package's
    own; a step's loss is taken before the attack)."""
    ref = _ref_step("bf16", "adamw", "wfagg", "ipm_100", 4)
    sj = _ref_state("bf16", "adamw", "wfagg", "ipm_100", "stacked", 4)
    ipm = []
    for b in _batches("bf16", 4):
        sj, m = ref(sj, {"tokens": jnp.asarray(b)})
        ipm.append(float(m["loss"]))
    got = [s["loss"] for s in _steps(bf2, "adamw ipm")]
    np.testing.assert_allclose(got, ipm, rtol=LOSS_RTOL)
    first = _ref_step1("bf16", "adafactor", "wfagg", "ipm_100", 4)[3]
    for label in ("ada stacked", "ada flat"):
        np.testing.assert_allclose(_steps(bf2, label)[0]["loss"], first, rtol=LOSS_RTOL)


def _hold_opt(sp, key):
    for (name, entry), got in zip(sp.opt, sp.out["opt"]):
        _, _, new, _ = _ref_step1(key, name, "wfagg" if entry["K"] > 2 else "median",
                                  "ipm_100", entry["K"])
        before = jax.tree.leaves(entry["state"]["params"])
        for g, w, p0 in zip(got, jax.tree.leaves(new), before):
            w, p0 = np.asarray(w, np.float32), np.asarray(p0, np.float32)
            bound = 2.0 ** -7 * (np.maximum(np.abs(g), np.abs(w)) + np.abs(w - p0)) + 1e-30
            assert np.all(np.abs(g - w) <= bound), (name, float((np.abs(g - w) / bound).max()))


@pytest.mark.parametrize("which", ["bf2", "grid22"])
def test_bf16_optimizer_on_blocks_matches_reference(which, request):
    """Given the reference's step-1 aggregate, Adafactor and AdamW on each
    rank's bf16 blocks (model blocks; on the grid FSDP blocks too)."""
    _hold_opt(request.getfixturevalue(which), "bf16")


def _one_process_trajectory(run):
    """The port's one-process run of ``run`` (its K candidates emulated)."""
    st = tr.state_from_jax(types.SimpleNamespace(**{
        k: (types.SimpleNamespace(**v) if k == "agg_state" and v is not None else v)
        for k, v in run["state"].items()}), run["cfg"], device="cpu")
    step = tr.build_train_step(run["cfg"], run["tc"], make_test_mesh(data=run["K"]))
    out = []
    for b in run["batches"]:
        st, m = step(st, {"tokens": torch.as_tensor(b).long()})
        out.append((float(m["loss"]), [x.float().numpy() for x in
                                       F.tree_leaves(F.module_tree(st.params))]))
    return out


@pytest.mark.parametrize("label", ["ada median", "adamw flat mean"])
def test_bf16_grid_trajectory_matches_one_process(grid22, label):
    """3 bf16 steps on the 2 x 2 grid against one process's: losses and
    parameters within 2e-2 relative; the parameters stay bf16 and the
    ranks agree."""
    run = grid22.runs[grid22.labels.index(label)]
    steps = _steps(grid22, label)
    first = _ref_step1("bf16", run["cfg"].optimizer, "median", "ipm_100", 2)[3]
    np.testing.assert_allclose(steps[0]["loss"], first, rtol=LOSS_RTOL)
    for (loss, params), s in zip(_one_process_trajectory(run), steps):
        np.testing.assert_allclose(s["loss"], loss, rtol=LOSS_RTOL)
        num = sum(float(((g - w) ** 2).sum()) for g, w in zip(s["params"], params))
        den = sum(float((w ** 2).sum()) for w in params)
        assert (num / den) ** 0.5 <= LOSS_RTOL
    assert steps[-1]["dtypes"] == ["torch.bfloat16"]
    for r in range(1, 4):
        assert [s["loss"] for s in _steps(grid22, label, r)] == [s["loss"] for s in steps]
