"""The flat layout, the adaptive attacks, ``gather_dtype`` and Adafactor
on the model axis and on the grid: reduced configs split over ``gloo``
ranks on the CPU (``tests/_torch_spmd_child.py``'s ``task_flatmesh``,
spawned once per mesh for the whole module: M = 2 ranks with the
candidates emulated, and a K = 3 x M = 2 grid, one candidate a rank),
held to the JAX package and to the one-process port on the same numpy
weights, candidates and tokens.

The flat layout's count-sketch takes the reference's bits
(``_torch_fixtures.reference_sketch_hash``), handed to the ranks as a
table per whole-vector chunk; the noise attack's draws are the port's
(a ``torch.Generator``), held bit-equal to one process's and then fed to
the reference's all-reduce.

Configs: Qwen's reduced form (dense; QKV biases split, norms replicated)
and ``tests/test_torch_tp_families.py``'s DeepSeek-like (MoE), Falcon-
Mamba-like (Mamba-1: its ``in_proj`` cut as two runs) and Zamba2-like
(hybrid) configs; for Adafactor a dense form at d = 128, whose ``wq``
(128 x 128, factored) a rank holds as 128 x 64 columns (not factored as
a block).

Tolerances, fixed before the runs:
  flat all-reduce   masks bit-equal to the reference and to one process;
                    weights within 1e-6; the aggregate within 2e-4; the
                    WFAgg-T sketch state within rtol 1e-5 (atol 1e-5 of
                    its largest magnitude: a bucket sums terms of random
                    sign); the attacked candidates within rtol 1e-5 /
                    atol 1e-6 of the reference's and bit-equal to one
                    process's (noise: the same draws);
  trajectory        params within rtol 1e-4 / atol 1e-5 of the
                    reference's composed step (``ReferenceStep``) and rtol
                    1e-5 / atol 1e-6 of the one-process trainer; weights
                    within 1e-6 and masks equal; loss rtol 1e-5;
  min_max,          within rtol 1e-5 / atol 1e-5 of one process's
  band_rider        ``apply_stacked_attack`` on the whole candidates;
  gather_dtype      the psum'd statistics within rtol 1e-5 of the
                    reference's ``_stacked_stats`` on the rounded whole
                    candidates (the Gram atol 1e-2 of entries ~1e4);
                    masks equal, weights within 1e-6 and the aggregate
                    within 3e-5 of the reference's stacked all-reduce;
  Adafactor         the updates and the factors within rtol 1e-6 / atol
                    1e-6 of the leaf's largest magnitude of one process's
                    on the whole leaves."""
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
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.optim import optimizers as topt
from repro_torch.train import trainer as tr

from _torch_fixtures import reference_sketch_hash
from _torch_spmd_child import run_ranks, same_on_every_rank
from test_torch_tp_families import _cfgs as _fam_cfgs
from test_torch_tp_families import _params as _fam_params
from test_torch_trainer import ReferenceStep, _reference_state

QWEN = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, vocab_size=128,
            head_dim=32)
WIDE = dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, d_ff=256, vocab_size=256,
            head_dim=64)
M = 2
K_TP, K_GRID = 4, 3          # candidates: emulated on the model axis, ranks of the grid
W = dict(f=1, transient=1, window=2)
CHUNK, SKETCH = 2048, 128
STEPS = 2
# (config, method, attack) of the flat all-reduce runs, 2 rounds each
FLAT_TP = [("dense", "wfagg", "ipm_100"), ("dense", "alt_wfagg", "alie"),
           ("dense", "multi_krum", "noise"), ("dense", "median", "sign_flip"),
           ("dense", "trimmed_mean", "alie"), ("dense", "mean", "ipm_100"),
           ("deepseek", "wfagg", "alie"), ("falcon", "wfagg", "noise"),
           ("zamba", "alt_wfagg", "sign_flip")]
FLAT_GRID = [("dense", "wfagg", "ipm_100"), ("dense", "median", "noise"),
             ("dense", "mean", "sign_flip"), ("falcon", "alt_wfagg", "alie")]
# (config, method, attack, steps) of the flat trainer runs
TRAIN_TP = [("dense", "wfagg", "ipm_100", 3), ("deepseek", "alt_wfagg", "alie", STEPS),
            ("falcon", "wfagg", "sign_flip", STEPS), ("zamba", "multi_krum", "ipm_100", STEPS)]
TRAIN_GRID = [("dense", "wfagg", "ipm_100", 3)]
# (config, attack) on the stacked candidates' blocks
ATTACKS_TP = [("dense", "min_max"), ("falcon", "min_max"), ("dense", "band_rider")]
ATTACKS_GRID = [("dense", "min_max"), ("dense", "band_rider")]
# (method, backend) of the stacked all-reduce with gather_dtype = bfloat16
GATHER_TP = [("wfagg", "fused"), ("alt_wfagg", "fused"), ("wfagg", "reference")]
GATHER_GRID = [("wfagg", "fused")]


@functools.lru_cache(maxsize=None)
def _cfgs(key):
    if key in ("dense", "wide"):
        small = QWEN if key == "dense" else dict(WIDE, optimizer="adafactor")
        return (dataclasses.replace(jget_config("qwen1.5-0.5b").reduced(), **small),
                dataclasses.replace(get_config("qwen1.5-0.5b").reduced(), **small))
    return _fam_cfgs(key)


@functools.lru_cache(maxsize=None)
def _params(key):
    if key not in ("dense", "wide"):
        return _fam_params(key)
    return jax.tree.map(np.asarray, jax.jit(functools.partial(JM.init_params, _cfgs(key)[0]))(
        jax.random.PRNGKey(0)))


def _size(key):
    return sum(x.size for x in jax.tree.leaves(_params(key)))


def _draw(key, K, rng, bad=()):
    """K candidate trees around a shared direction (leaves (K, ...)), the
    rows of ``bad`` pushed the other way."""
    def leaf(p):
        base = rng.standard_normal(p.shape).astype(np.float32)
        x = 0.5 * rng.standard_normal((K,) + p.shape).astype(np.float32) + base
        x[list(bad)] = -3.0 * base
        return x
    return jax.tree.map(leaf, _params(key))


def _rows(tree):
    leaves = jax.tree.leaves(tree)
    return np.concatenate([x.reshape(x.shape[0], -1) for x in leaves], 1)


def _agg(method, backend="reference", **kw):
    common = dict(method=method, chunk_size=CHUNK, sketch_dim=SKETCH, trim_beta=0.25,
                  backend=backend, **kw)
    return (jra.RobustAggConfig(wfagg=jwf.WFAggConfig(**W), **common),
            tra.RobustAggConfig(wfagg=twf.WFAggConfig(**W), **common))


def _sketch_table():
    """The reference's buckets and signs of every whole-vector chunk the
    largest config needs, as numpy (the ranks' ``sketch_hash``)."""
    n = -(-max(_size(k) for k in ("dense", "deepseek", "falcon", "zamba", "wide")) // CHUNK)
    return {ci: tuple(x.numpy() for x in reference_sketch_hash(CHUNK, SKETCH, 0, ci, "cpu"))
            for ci in range(n)}


def _flat_runs(spec, K, seed):
    rng = np.random.default_rng(seed)
    runs = []
    for key, method, attack in spec:
        runs.append(dict(cfg=_cfgs(key)[1], params=_params(key), agg=_agg(method)[1],
                         attack=attack, malicious=spaced_malicious(K, 1),
                         rounds=[_draw(key, K, rng) for _ in range(2)]))
    return runs


def _tcs(method, attack, layout="flat", **kw):
    jagg, agg = _agg(method, layout=layout, **kw)
    common = dict(attack=attack, n_malicious=1, lr=1e-2, warmup=0)
    return (jtr.TrainConfig(agg=jagg, donate=False, **common),
            tr.TrainConfig(agg=agg, **common))


def _state_np(sj):
    agg = sj.agg_state
    if agg is not None and hasattr(agg, "temporal"):
        agg = {"temporal": list(agg.temporal)}
    elif agg is not None:
        agg = dict(prev=agg.prev, hist_s=agg.hist_s, hist_b=agg.hist_b, count=agg.count, t=agg.t)
    return {"params": sj.params, "opt_state": sj.opt_state, "step": int(sj.step),
            "agg_state": agg}


def _train_runs(spec, K):
    runs, meta = [], []
    for key, method, attack, steps in spec:
        jcfg, cfg = _cfgs(key)
        jtc, tc = _tcs(method, attack)
        sj = jax.tree.map(np.asarray, _reference_state(jcfg, jtc, K))
        stream = JTokenStream(vocab_size=jcfg.vocab_size, seq_len=32, batch_size=2 * K)
        batches = [np.asarray(stream.batch(i)["tokens"]) for i in range(steps)]
        runs.append(dict(cfg=cfg, tc=tc, K=K, state=_state_np(sj), batches=batches))
        meta.append(dict(key=key, jtc=jtc, tc=tc, sj=sj, batches=batches, K=K))
    return runs, meta


def _stacked_runs(attacks, gathers, K, seed):
    rng = np.random.default_rng(seed)
    runs = []
    for key, attack in attacks:
        runs.append(dict(cfg=_cfgs(key)[1], params=_params(key), tree=_draw(key, K, rng),
                         attack=attack, malicious=spaced_malicious(K, 1)))
    for method, backend in gathers:
        bad = [k for k, m in enumerate(spaced_malicious(K, 1)) if m]
        runs.append(dict(cfg=_cfgs("dense")[1], params=_params("dense"),
                         agg=_agg(method, backend, layout="stacked",
                                  gather_dtype="bfloat16")[1],
                         method=method, prev=_draw("dense", K, rng, bad),
                         tree=_draw("dense", K, rng, bad), tree2=_draw("dense", K, rng, bad)))
    return runs


def _adafactor_input(seed, fsdp):
    rng = np.random.default_rng(seed)
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                          _params("wide")) for _ in range(2)]
    return dict(cfg=_cfgs("wide")[1], params=_params("wide"), grads=grads, fsdp=fsdp)


class Run:
    """One spawn of ``task_flatmesh`` on a mesh (K, M) and the inputs it saw."""

    def __init__(self, tmp, K, flat, train, attacks, gathers, fsdp):
        Kc = K_TP if K == 1 else K
        self.K = Kc
        self.flat = _flat_runs(flat, Kc, seed=K)
        train_runs, self.train = _train_runs(train, Kc)
        self.stacked = _stacked_runs(attacks, gathers, Kc, seed=10 + K)
        self.adafactor = _adafactor_input(20 + K, fsdp)
        self.ckpt = f"{tmp}/launcher"
        self.ranks = run_ranks("flatmesh", K * M, tmp, timeout=300, K=K, M=M, flat=self.flat,
                               train=train_runs, stacked=self.stacked,
                               adafactor=self.adafactor, sketch=_sketch_table(),
                               launcher=self.ckpt)
        self.out = self.ranks[0]


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    return Run(tmp_path_factory.mktemp("flat_tp2"), 1, FLAT_TP, TRAIN_TP, ATTACKS_TP, GATHER_TP,
               fsdp=None)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return Run(tmp_path_factory.mktemp("flat_grid"), K_GRID, FLAT_GRID, TRAIN_GRID,
               ATTACKS_GRID, GATHER_GRID, fsdp=True)


@pytest.fixture(autouse=True)
def _reference_sketch(monkeypatch):
    monkeypatch.setattr(tra, "sketch_hash", functools.lru_cache(maxsize=None)(
        reference_sketch_hash))


@functools.lru_cache(maxsize=None)
def _jax_flat(jagg, attack, K):
    """The reference's flat attack and all-reduce over K emulated workers,
    jitted once."""
    mal = jnp.asarray(spaced_malicious(K, 1))
    att = jax.jit(jax.vmap(lambda f, key: jra.apply_distributed_attack(
        f, "data", mal, attack, key), in_axes=(0, None), axis_name="data"))
    red = jax.jit(jax.vmap(lambda f, s: jra.robust_allreduce(f, "data", jagg, s),
                           in_axes=(0, None), axis_name="data"))
    return att, red


def _hold_round(got, want, label):
    for k in ("mask_d", "mask_c", "mask_t"):
        if k in want:
            assert np.array_equal(got[k], np.asarray(want[k])), f"{label}: {k}"
    np.testing.assert_allclose(got["weights"], np.asarray(want["weights"]), rtol=0, atol=1e-6,
                               err_msg=label)
    np.testing.assert_allclose(got["out"], np.asarray(want["out"]), rtol=0, atol=2e-4,
                               err_msg=label)
    if want.get("prev") is not None:
        w = np.asarray(want["prev"])
        np.testing.assert_allclose(got["state"]["prev"], w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=label)


FLAT_CASES = [("tp2", i) for i in range(len(FLAT_TP))] + \
    [("grid", i) for i in range(len(FLAT_GRID))]


@pytest.mark.parametrize("which,i", FLAT_CASES,
                         ids=[f"{w}-{'-'.join((FLAT_TP if w == 'tp2' else FLAT_GRID)[i])}"
                              for w, i in FLAT_CASES])
def test_flat_allreduce_matches_reference_and_one_process(which, i, request):
    """The rank's blocks through ``apply_distributed_attack`` and
    ``robust_allreduce`` with ``FlatShards``: the whole vector's values,
    against the reference's vmapped flat route on the whole candidates and
    the port's one-process route, over 2 rounds (WFAgg-T's sketch state
    carried)."""
    run = request.getfixturevalue(which)
    spec = run.flat[i]
    key, method, attack = (FLAT_TP if which == "tp2" else FLAT_GRID)[i]
    K = run.K
    jagg, agg = _agg(method)
    att, red = _jax_flat(jagg, attack, K)
    mal = torch.as_tensor(spaced_malicious(K, 1))
    jstate = jra.init_agg_state(jagg, K)
    tstate = tra.init_agg_state(agg, K)
    for r, (tree, got) in enumerate(zip(spec["rounds"], run.out["flat"][i])):
        label = f"{which} {key} {method} {attack} round {r}"
        X = torch.as_tensor(_rows(tree))
        Xa = tra.apply_distributed_attack(X, tra.Emulated(K), mal, attack,
                                          torch.Generator().manual_seed(7 + r),
                                          chunk_size=CHUNK)
        if "attacked" in got:
            assert np.array_equal(got["attacked"], Xa.numpy()), label
        if attack != "noise":
            ja = np.asarray(att(jnp.asarray(X.numpy()), jax.random.PRNGKey(0)))
            np.testing.assert_allclose(Xa.numpy(), ja, rtol=1e-5, atol=1e-6, err_msg=label)
        o, tstate, info = tra.robust_allreduce(Xa, tra.Emulated(K), agg, tstate)
        jo, jst, jinfo = red(jnp.asarray(Xa.numpy()), jstate)
        jstate = None if jst is None else jax.tree.map(lambda a: a[0], jst)
        want = {k: np.asarray(v[0]) for k, v in jinfo.items() if k != "record"}
        want["out"] = np.asarray(jo[0])
        if jstate is not None:
            want["prev"] = jstate.temporal.prev
        _hold_round(got, want, label + " vs the reference")
        one = {k: v.numpy() for k, v in info.items() if k != "record"}
        one["out"] = o.numpy()
        if tstate is not None:
            one["prev"] = tstate.temporal.prev.numpy()
        _hold_round(got, one, label + " vs one process")
    if method != "mean" and attack == "ipm_100":
        bad = int(np.flatnonzero(spaced_malicious(K, 1))[0])
        assert all(float(g["weights"][bad]) == 0.0 for g in run.out["flat"][i])
    assert same_on_every_rank([rk["flat"][i] for rk in run.ranks[:M]])


@functools.lru_cache(maxsize=None)
def _vg(jcfg):
    return jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(jcfg, p, b), has_aux=True))


TRAIN_CASES = [("tp2", i) for i in range(len(TRAIN_TP))] + \
    [("grid", i) for i in range(len(TRAIN_GRID))]


@pytest.mark.parametrize("which,i", TRAIN_CASES,
                         ids=[f"{w}-{(TRAIN_TP if w == 'tp2' else TRAIN_GRID)[i][0]}"
                              for w, i in TRAIN_CASES])
def test_flat_trainer_matches_reference_and_one_process(which, i, request):
    """``build_train_step`` with the flat layout on the model axis (the
    candidates emulated) and on the grid (one a rank), from the
    reference's initial state: each step against the reference's composed
    flat step on the whole gradient and against the one-process trainer."""
    run = request.getfixturevalue(which)
    meta = run.train[i]
    jcfg, cfg = _cfgs(meta["key"])
    K = meta["K"]
    ref = ReferenceStep(jcfg, meta["jtc"], K)
    ref.vg = _vg(jcfg)
    sj = meta["sj"]
    st = tr.state_from_jax(sj, cfg, device="cpu")
    seen = {}
    step = tr.build_train_step(cfg, meta["tc"], make_test_mesh(data=K),
                               observe=lambda phase, **v: seen.update({phase: v}))
    for s, (b, got) in enumerate(zip(meta["batches"], run.out["train"][i])):
        label = f"{which} {meta['key']} step {s + 1}"
        sj, jm = ref(sj, {"tokens": jnp.asarray(b)})
        st, m = step(st, {"tokens": torch.as_tensor(b).long()})
        info = seen["allreduce"]["info"]
        for k in ("mask_d", "mask_c", "mask_t"):
            if k in info:
                assert np.array_equal(got["masks"][k], info[k].numpy()), f"{label}: {k}"
                assert np.array_equal(got["masks"][k], np.asarray(jm[k])), f"{label}: {k}"
        np.testing.assert_allclose(got["weights"], m["weights"].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["weights"], np.asarray(jm["weights"]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(got["loss"], float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], float(m["grad_norm"]), rtol=1e-5)
        ones = F.tree_leaves(F.module_tree(st.params))
        for g, o, w in zip(got["params"], ones, jax.tree.leaves(sj.params)):
            np.testing.assert_allclose(g, o.numpy(), rtol=1e-5, atol=1e-6, err_msg=label)
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=label)
        if got["agg"] is not None:
            w = st.agg_state.temporal.prev.numpy()
            np.testing.assert_allclose(got["agg"]["prev"], w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(), err_msg=label)
    if meta["tc"].attack == "ipm_100":
        bad = int(np.flatnonzero(spaced_malicious(K, 1))[0])
        assert all(float(g["weights"][bad]) == 0.0 for g in run.out["train"][i])


ATTACK_CASES = [("tp2", i) for i in range(len(ATTACKS_TP))] + \
    [("grid", i) for i in range(len(ATTACKS_GRID))]


@pytest.mark.parametrize("which,i", ATTACK_CASES,
                         ids=[f"{w}-{'-'.join((ATTACKS_TP if w == 'tp2' else ATTACKS_GRID)[i])}"
                              for w, i in ATTACK_CASES])
def test_adaptive_attacks_on_blocks_equal_one_process(which, i, request):
    """``min_max`` (its two rounds of partial sums added over the leaf's
    ranks) and ``band_rider`` (its per-coordinate fallback) on the rank's
    blocks: one process's ``apply_stacked_attack`` on the whole
    candidates."""
    run = request.getfixturevalue(which)
    spec = run.stacked[i]
    cand = jax.tree.map(lambda x: torch.as_tensor(np.array(x)), spec["tree"])
    want = tra.apply_stacked_attack(cand, torch.as_tensor(spec["malicious"]), spec["attack"])
    bad = np.asarray(spec["malicious"])
    for g, w, x in zip(run.out["stacked"][i], F.tree_leaves(want),
                       jax.tree.leaves(spec["tree"])):
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-5, atol=1e-5)
        assert np.array_equal(g[~bad], x[~bad])        # only the attackers change
        assert not np.array_equal(g[bad], x[bad])


GATHER_CASES = [("tp2", i) for i in range(len(GATHER_TP))] + \
    [("grid", i) for i in range(len(GATHER_GRID))]


@pytest.mark.parametrize("which,i", GATHER_CASES,
                         ids=[f"{w}-{'-'.join((GATHER_TP if w == 'tp2' else GATHER_GRID)[i])}"
                              for w, i in GATHER_CASES])
def test_gather_dtype_on_blocks_matches_reference(which, i, request):
    """``gather_dtype = "bfloat16"`` on the stacked all-reduce's model-axis
    and grid routes: the D/C statistics and the Gram of the rounded
    candidates, WFAgg-T's sums in f32, held to the reference's
    ``_stacked_stats`` and ``robust_allreduce_stacked`` with the same
    ``gather_dtype`` over two rounds."""
    run = request.getfixturevalue(which)
    n_att = len(ATTACKS_TP if which == "tp2" else ATTACKS_GRID)
    spec = run.stacked[n_att + i]
    got = run.out["stacked"][n_att + i]
    method, backend = (GATHER_TP if which == "tp2" else GATHER_GRID)[i]
    jagg, _ = _agg(method, "reference", layout="stacked", gather_dtype="bfloat16")
    st = jra._stacked_stats(jax.tree.map(jnp.asarray, spec["tree"]), jagg)
    np.testing.assert_allclose(got["stats"]["dist2"], np.asarray(st.dist2_med), rtol=1e-5)
    np.testing.assert_allclose(got["stats"]["dotmed"], np.asarray(st.dot_med), rtol=1e-5)
    np.testing.assert_allclose(got["stats"]["mednorm2"], np.asarray(st.med2), rtol=1e-5)
    np.testing.assert_allclose(got["stats"]["gram"], np.asarray(st.gram), rtol=1e-5, atol=1e-2)
    whole, prev = _rows(spec["tree"]), _rows(spec["prev"])
    # WFAgg-T's sums and the norms stay float32
    np.testing.assert_allclose(got["stats"]["norm2"], (whole ** 2).sum(1), rtol=1e-5)
    np.testing.assert_allclose(got["stats"]["prev_dist2"], ((whole - prev) ** 2).sum(1),
                               rtol=1e-5)
    rounded = np.asarray(jnp.asarray(whole).astype(jnp.bfloat16).astype(jnp.float32))
    assert not np.allclose(got["stats"]["norm2"], (rounded ** 2).sum(1), rtol=1e-6)
    K = whole.shape[0]
    state = jra.init_tree_agg_state(jagg, K, _params("dense"))._replace(
        prev=jax.tree.map(jnp.asarray, spec["prev"]))
    fn = jax.jit(jra.robust_allreduce_stacked, static_argnums=(1,))
    for r, tree in enumerate((spec["tree"], spec["tree2"])):
        o, state, info = fn(jax.tree.map(jnp.asarray, tree), jagg, state)
        g = got["rounds"][r]
        label = f"{which} {method} {backend} round {r}"
        for k in ("mask_d", "mask_c", "mask_t"):
            assert np.array_equal(g[k], np.asarray(info[k])), f"{label}: {k}"
        np.testing.assert_allclose(g["weights"], np.asarray(info["weights"]), rtol=0, atol=1e-6)
        for a, b in zip(g["out"], jax.tree.leaves(o)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=3e-5, err_msg=label)


@pytest.mark.parametrize("which", ["tp2", "grid"])
def test_adafactor_on_blocks_equals_one_process(which, request):
    """Adafactor on the rank's blocks (the model axis; the grid's FSDP
    blocks, cut over data too), 2 steps from a zero state: the updates and
    the factors of one process's Adafactor on the whole leaves; a leaf is
    factored by its whole shape (``wq``: 128 x 128 whole, 128 x 64 on a
    rank)."""
    run = request.getfixturevalue(which)
    a = run.adafactor
    out = run.out["adafactor"]
    cfg = a["cfg"]
    from repro_torch.models import model as TM
    model = TM.params_from_jax(a["params"], cfg, "cpu")
    tree = F.module_tree(model)
    opt = topt.make_optimizer("adafactor")
    state = opt.init(tree)
    lr = torch.tensor(1e-2)
    paths = [p for p, _ in F.leaf_params(model)]
    wq = paths.index(("layers", "attn", "wq"))
    assert out["factored"][wq] and "vr" in state["v"][wq]
    assert out["factored"] == [("vr" in v) for v in state["v"]]
    for s, g in enumerate(a["grads"]):
        upd, state = opt.update(jax.tree.map(lambda x: torch.as_tensor(np.array(x)), g), state,
                                tree, lr)
        for got, want, path in zip(out["updates"][s], F.tree_leaves(upd), paths):
            w = want.numpy()
            np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6 * np.abs(w).max(),
                                       err_msg=f"step {s + 1} {path}")
    for got, want, path in zip(out["factors"], state["v"], paths):
        for k, w in want.items():
            w = w.numpy()
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-6 * np.abs(w).max(),
                                       err_msg=f"{path} {k}")


@pytest.mark.parametrize("which", ["tp2", "grid"])
def test_launcher_trains_the_flat_layout_on_blocks(which, request):
    """``launch.train --layout flat --model-parallel 2``: with M ranks the
    candidates emulated on each, with K x M ranks the grid; rank 0 writes
    the gathered model, which one process restores."""
    from repro_torch.models import model as TM
    from repro_torch.train import checkpoint as ckpt

    run = request.getfixturevalue(which)
    cfg = get_config("qwen1.5-0.5b").reduced()
    cfg = dataclasses.replace(cfg, d_model=64, head_dim=64 // cfg.n_heads, d_ff=256,
                              n_layers=2, vocab_size=128)
    model = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tree, meta = ckpt.restore_checkpoint(run.ckpt, "step_2", F.module_tree(model))
    assert meta["step"] == 2 and np.isfinite(meta["loss"])
    assert all(np.isfinite(x.numpy()).all() for x in F.tree_leaves(tree))


def test_flat_layout_runs_every_family_and_option_on_blocks():
    """``build_train_step`` builds the flat layout on the model axis and on
    a grid, and ``min_max``, ``band_rider``, ``gather_dtype`` and Adafactor
    there, for the dense, MoE, SSM and hybrid families (no group is
    reached while building)."""
    from repro_torch.launch.mesh import DataAxis, Mesh, ModelAxis

    class TP(Mesh):       # the model axis without a live group
        def model_axis(self):
            return ModelAxis(None, self.shape["model"], 0)

    class Grid(TP):
        def data_axis(self):
            return DataAxis(None, self.shape["data"], 0)

    for key in ("dense", "deepseek", "falcon", "zamba"):
        cfg = _cfgs(key)[1]
        for mesh in (TP(shape={"data": 4, "model": 2}), Grid(shape={"data": 3, "model": 2})):
            for layout in ("flat", "stacked"):
                for attack in ("min_max", "band_rider", "ipm_100"):
                    agg = tra.RobustAggConfig(layout=layout, gather_dtype="bfloat16")
                    tc = tr.TrainConfig(agg=agg, attack=attack, n_malicious=1)
                    assert callable(tr.build_train_step(
                        dataclasses.replace(cfg, optimizer="adafactor"), tc, mesh))
