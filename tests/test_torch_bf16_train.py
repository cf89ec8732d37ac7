"""bfloat16 parameters on the port's robust-DP trainer (Arctic's plan:
bf16 parameters and Adafactor), held to the JAX package.

**The aggregation alone.**  The same bf16 candidates (numpy, from a seed)
go through each package's attack and all-reduce at bf16, stacked and
flat, under WFAgg, Multi-Krum, the median and the mean, after noise,
IPM-100 and ALIE.  The all-reduces are fed the reference's attacked
candidates, so that each route is held on the same inputs: masks and
weights equal, the aggregate within the bf16 rule below.  The attacks are
held apart: noise on the port's own draws (one chunk of
``robust_allreduce.noise_chunk`` per whole-vector chunk, added in bf16),
IPM and ALIE against the reference's within the bf16 rule.

**The bf16 sum rule.**  The reference's flat route sums bf16 values with
``psum``.  Under ``shard_map`` (its trainer) jax 0.9 on the CPU adds them
in float32 and rounds the sum to bf16 once (checked on 4 host devices:
every value of a 4-rank sum equals one rounding of the float32 sum); its
``vmap``ped form, which the tests run, rounds at each add instead.  The
port does what ``shard_map`` does: its rank-order sum (``_rank_sum``) adds
in float32 and rounds once, so its flat aggregate is bit-equal to
``bf16(sum_k bf16(g_k * bf16(w_k / wsum)))`` with the float32 sum in rank
order (held exactly here), and within ``K * 2^-8 * sum_k |term_k|`` of the
``vmap``ped reference (each of its K roundings moves a partial sum by at
most 2^-8 of its magnitude).  The stacked routes cast the candidates to
float32 and round the aggregate once, in both packages: within one bf16
rounding, ``2^-7 |want|`` (their float32 sums differ in order only).

**The whole step** (``test_bf16_step_matches_reference``): the reduced
Arctic in bf16, narrowed to d_model 64, at M = 1 with Adafactor and AdamW, from the reference's
state before each step, against the reference's step composed from its
pieces (``tests/test_torch_trainer.py``'s ``ReferenceStep``): the loss
within 2e-2 relative (the dense bf16 rule of the serving tests), and,
given the reference's own aggregate, the port's optimizer's updated
parameters within one bf16 rounding of the reference's.  The model axis
and the grid are in ``tests/test_torch_pad_slots.py``.

Also the checkpoint of a bf16 train state (bit-equal after restore) and
the launcher on the bf16 reduced Arctic with a checkpoint."""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core import wfagg as jwf
from repro.core.topology import spaced_malicious
from repro.data.synthetic import TokenStream as JTokenStream
from repro.distributed import robust_allreduce as jra
from repro.train import trainer as jtr
from repro_torch.configs.registry import get_config
from repro_torch.core import flatten as F
from repro_torch.core import wfagg as twf
from repro_torch.distributed import robust_allreduce as tra
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.optim import optimizers as topt
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import trainer as tr

from test_torch_trainer import ReferenceStep, _reference_state

K = 5
SHAPES = (("a", (24, 40)), ("b", (40,)), ("c", (3, 8, 16)))
CHUNK = 512
MAL = spaced_malicious(K, 1)
METHODS = ("wfagg", "multi_krum", "median", "mean")
ATTACKS = ("noise", "ipm_100", "alie")
LOSS_RTOL = 2e-2


def _bf16(x):
    """numpy float32 -> the reference's bf16 array (ml_dtypes)."""
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16))


def _t(x, dtype=torch.bfloat16):
    """A numpy array (bf16 or float) as a torch tensor of ``dtype``."""
    return torch.as_tensor(np.asarray(x, np.float32)).to(dtype)


@functools.lru_cache(maxsize=None)
def _cands():
    """K bf16 candidate trees: a benign cluster around one direction, the
    malicious row as benign (the attack makes it otherwise)."""
    rng = np.random.default_rng(11)
    out = {}
    for name, shape in SHAPES:
        base = rng.standard_normal(shape).astype(np.float32)
        rows = base[None] + 0.3 * rng.standard_normal((K,) + shape).astype(np.float32)
        out[name] = _bf16(rows)
    return out


def _flat(tree):
    return np.concatenate([np.asarray(tree[k], np.float32).reshape(K, -1)
                           for k, _ in SHAPES], 1)


def _agg_cfgs(method, layout):
    wk = dict(f=1)
    common = dict(method=method, layout=layout, chunk_size=CHUNK, sketch_dim=64,
                  multi_krum_m=3)
    return (jra.RobustAggConfig(wfagg=jwf.WFAggConfig(**wk), **common),
            tra.RobustAggConfig(wfagg=twf.WFAggConfig(**wk), **common))


@functools.lru_cache(maxsize=None)
def _jit_flat_attack(attack):
    mal = jnp.asarray(MAL)
    return jax.jit(jax.vmap(lambda f, key: jra.apply_distributed_attack(
        f, "data", mal, attack, key), in_axes=(0, None), axis_name="data"))


@functools.lru_cache(maxsize=None)
def _jit_flat_allreduce(method):
    jc, _ = _agg_cfgs(method, "flat")
    return jax.jit(jax.vmap(lambda f: jra.robust_allreduce(f, "data", jc, None),
                            axis_name="data"))


@functools.lru_cache(maxsize=None)
def _jit_stacked(method):
    jc, _ = _agg_cfgs(method, "stacked")
    return jax.jit(lambda t: jra.robust_allreduce_stacked(t, jc, None))


_jit_stacked_attack = jax.jit(jra.apply_stacked_attack, static_argnums=(2,))


def _ref_attacked(layout, attack):
    """The reference's attacked candidates (numpy bf16): the flat (K, P) or
    the stacked tree."""
    key = jax.random.PRNGKey(3)
    if layout == "flat":
        return np.asarray(_jit_flat_attack(attack)(jnp.asarray(_flat_bf16()), key))
    tree = {k: jnp.asarray(v) for k, v in _cands().items()}
    out = _jit_stacked_attack(tree, jnp.asarray(MAL), attack, key)
    return {k: np.asarray(v) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _flat_bf16():
    return _bf16(_flat(_cands()))


def _sum_bound(terms):
    """``K * 2^-8 * sum_k |term_k|`` per coordinate (float32 terms (K, P))."""
    return terms.shape[0] * 2.0 ** -8 * np.abs(terms).sum(0)


def _flat_once(x, weights):
    """The port's stated flat aggregate: ``bf16(sum_k bf16(x_k *
    bf16(w_k / wsum)))``, the float32 sum in rank order (the mean
    fallback and the mean: ``bf16(sum_k x_k) / K`` in bf16)."""
    xb = _t(x)
    w = torch.as_tensor(np.array(weights, np.float32))
    if float(w.sum()) > 0:
        terms = xb * (w / torch.clamp(w.sum(), min=1e-12))[:, None].to(torch.bfloat16)
        acc = terms[0].float()
        for t in terms[1:]:
            acc = acc + t.float()
        return acc.to(torch.bfloat16), terms.float().numpy()
    acc = xb[0].float()
    for t in xb[1:]:
        acc = acc + t.float()
    return acc.to(torch.bfloat16) / K, xb.float().numpy() / K


@pytest.mark.parametrize("method", METHODS)
def test_flat_bf16_allreduce_matches_reference(method):
    """The flat route at bf16 on the reference's attacked candidates: masks
    and weights equal, the aggregate the port's one-rounding sum exactly
    and within the sum rule of the ``vmap``ped reference."""
    _, tc = _agg_cfgs(method, "flat")
    for attack in ATTACKS:
        x = _ref_attacked("flat", attack)
        out, _, info = _jit_flat_allreduce(method)(jnp.asarray(x))
        want = np.asarray(out[0], np.float32)
        got, _, tinfo = tra.robust_allreduce(_t(x), tra.Emulated(K), tc)
        assert got.dtype == torch.bfloat16
        w = np.asarray(info["weights"][0])
        assert np.array_equal(tinfo["weights"].numpy(), w), (method, attack)
        for m in ("mask_d", "mask_c", "mask_t"):
            if m in info:
                assert np.array_equal(tinfo[m].numpy(), np.asarray(info[m][0])), (attack, m)
        g = got.float().numpy()
        if method == "median":
            assert np.array_equal(g, want), attack
            continue
        exact, terms = _flat_once(x, w if method != "mean" else np.ones(K, np.float32))
        if method == "mean":
            exact, terms = _flat_once(x, np.zeros(K, np.float32))
        assert np.array_equal(g, exact.float().numpy()), (method, attack)
        assert np.all(np.abs(g - want) <= _sum_bound(terms) + 1e-30), (method, attack)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_stacked_bf16_allreduce_matches_reference(method, backend):
    """The stacked route on float32 rows holding the reference's attacked
    bf16 candidates (the trainer's buffers), its aggregate rounded to bf16
    as the trainer does: masks and weights equal, the aggregate within one
    bf16 rounding of the reference's (the median exactly)."""
    _, tc = _agg_cfgs(method, "stacked")
    tc = dataclasses.replace(tc, backend=backend)
    for attack in ATTACKS:
        x = _ref_attacked("stacked", attack)
        out, _, info = _jit_stacked(method)({k: jnp.asarray(v) for k, v in x.items()})
        cand = {k: _t(v, torch.float32) for k, v in x.items()}
        got, _, tinfo = tra.robust_allreduce_stacked(cand, tc, None)
        assert np.array_equal(tinfo["weights"].numpy(), np.asarray(info["weights"])), \
            (method, attack)
        for m in ("mask_d", "mask_c", "mask_t"):
            if m in info:
                assert np.array_equal(tinfo[m].numpy(), np.asarray(info[m])), (attack, m)
        for k in x:
            g = got[k].to(torch.bfloat16).float().numpy()
            want = np.asarray(out[k], np.float32)
            if method == "median":
                assert np.array_equal(g, want), (attack, k)
            else:
                assert np.all(np.abs(g - want) <= 2.0 ** -7 * np.abs(want) + 1e-30), \
                    (method, attack, k, float(np.abs(g - want).max()))


@pytest.mark.parametrize("layout", ["flat", "stacked"])
@pytest.mark.parametrize("attack", ["ipm_100", "alie"])
def test_bf16_attacks_match_reference(layout, attack):
    """IPM-100 and ALIE at bf16: benign rows untouched, the malicious row
    within the bf16 sum rule of the reference's (its benign mean and
    variance are rank sums: K roundings of the ``vmap``ped reference, one
    of the port's), scaled by the attack's factor."""
    x = _flat_bf16() if layout == "flat" else _cands()
    want = _ref_attacked(layout, attack)
    mal = torch.as_tensor(MAL)
    if layout == "flat":
        got = tra.apply_distributed_attack(_t(x), tra.Emulated(K), mal, attack,
                                           chunk_size=CHUNK).float().numpy()
        pairs = [(got, np.asarray(want, np.float32), np.asarray(x, np.float32))]
    else:
        rows = {k: _t(v, torch.float32) for k, v in x.items()}
        out = tra.apply_stacked_attack(rows, mal, attack, dtype=torch.bfloat16)
        pairs = [(out[k].numpy(), np.asarray(want[k], np.float32).reshape(out[k].shape),
                  np.asarray(x[k], np.float32)) for k in x]
    for g, w, x0 in pairs:
        g, w, x0 = (a.reshape(K, -1) for a in (g, w, x0))
        assert np.array_equal(g[~MAL], x0[~MAL])
        assert np.array_equal(g, _bf16(g).astype(np.float32))   # bf16 values
        scale = 100.0 if attack == "ipm_100" else 1.0
        bound = scale * K * 2.0 ** -7 * np.abs(x0[~MAL]).sum(0) / (~MAL).sum()
        assert np.all(np.abs(g[MAL] - w[MAL]) <= bound + 2.0 ** -7 * np.abs(w[MAL])), \
            (layout, attack, float(np.abs(g[MAL] - w[MAL]).max()))


@pytest.mark.parametrize("layout", ["flat", "stacked"])
def test_bf16_noise_adds_the_ports_draws_in_bf16(layout):
    """The noise attack at bf16 adds ``mu + sigma * z`` in bf16 to the
    malicious row, z the port's float32 chunk draws cast to bf16 (flat:
    one stream over the whole vector; stacked: one per leaf and row)."""
    mal = torch.as_tensor(MAL)
    g = torch.Generator().manual_seed(5)
    k = int(np.flatnonzero(MAL)[0])
    if layout == "flat":
        x = _t(_flat_bf16())
        got = tra.apply_distributed_attack(x, tra.Emulated(K), mal, "noise", g,
                                           chunk_size=CHUNK)
        P = x.shape[1]
        z = torch.cat([tra.noise_chunk(tra._seed(5, c), CHUNK, "cpu")
                       for c in range(-(-P // CHUNK))])[:P]
        want = x[k] + 0.1 + 0.1 * z.to(torch.bfloat16)
        assert torch.equal(got[k], want) and torch.equal(got[~mal], x[~mal])
        return
    rows = {n: _t(v, torch.float32) for n, v in _cands().items()}
    got = tra.apply_stacked_attack({n: v.clone() for n, v in rows.items()}, mal, "noise", g,
                                   chunk_size=CHUNK, dtype=torch.bfloat16)
    for i, (n, _) in enumerate(SHAPES):
        r = rows[n][k].reshape(-1)
        z = torch.cat([tra.noise_chunk(tra._seed(5, i, k, c), CHUNK, "cpu")
                       for c in range(-(-r.numel() // CHUNK))])[:r.numel()]
        want = (r.to(torch.bfloat16) + 0.1 + 0.1 * z.to(torch.bfloat16)).float()
        assert torch.equal(got[n][k].reshape(-1), want), n
        assert torch.equal(got[n][~mal], rows[n][~mal])


# ---------------------------------------------------------------------------
# the whole step at M = 1
# ---------------------------------------------------------------------------

STEPS = 3


def _arctic(optimizer):
    """The reduced Arctic in bf16 with ``optimizer``, narrowed to d_model 64
    (4 heads of 16, 4 experts, 2 layers): bf16 products are slow on the
    CPU."""
    over = dict(param_dtype="bfloat16", optimizer=optimizer, d_model=64, vocab_size=128,
                head_dim=16, d_ff=64, dense_residual_ff=64)
    return (dataclasses.replace(jget_config("arctic-480b").reduced(), **over),
            dataclasses.replace(get_config("arctic-480b").reduced(), **over))


def _step_tcs(layout, K_):
    wk = dict(f=1, transient=1, window=2)
    agg = dict(method="wfagg", layout=layout, chunk_size=4096, sketch_dim=256,
               backend="reference" if layout == "stacked" else "reference")
    common = dict(lr=1e-2, warmup=0, attack="ipm_100", n_malicious=1)
    return (jtr.TrainConfig(agg=jra.RobustAggConfig(wfagg=jwf.WFAggConfig(**wk), **agg),
                            donate=False, **common),
            tr.TrainConfig(agg=tra.RobustAggConfig(wfagg=twf.WFAggConfig(**wk), **agg),
                           **common))


def _np_state(sj):
    return jax.tree.map(np.asarray, sj)


def _ulp_close(got, want, upd):
    """Within one bf16 rounding of the update and one of the sum:
    |got - want| <= 2^-7 * (max(|got|, |want|) + |upd|), a unit of the last
    place of each (an update whose float32 value differs in its last bits,
    e.g. by ``b ** t``, rounds to either neighbour, and so does the sum)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = 2.0 ** -7 * (np.maximum(np.abs(got), np.abs(want)) + np.abs(upd)) + 1e-30
    ok = np.abs(got - want) <= bound
    return bool(ok.all()), float((np.abs(got - want) / bound).max())


@pytest.mark.parametrize("optimizer", ["adafactor", "adamw"])
@pytest.mark.parametrize("layout", ["flat", "stacked"])
def test_bf16_step_matches_reference(optimizer, layout, monkeypatch):
    """3 steps of the bf16 reduced Arctic at M = 1, K = 4 under IPM-100:
    each step from the reference's state before it, the loss within 2e-2
    relative; given the reference's aggregate, the port's optimizer updates
    the parameters to within one bf16 rounding of the reference's; the
    port's parameters stay bf16 and finite."""
    from _torch_fixtures import reference_sketch_hash

    monkeypatch.setattr(tra, "sketch_hash", functools.lru_cache(maxsize=None)(
        reference_sketch_hash))
    jcfg, cfg = _arctic(optimizer)
    K_ = 4
    jtc, tc = _step_tcs(layout, K_)
    ref = ReferenceStep(jcfg, jtc, K_)
    seen = {}
    orig = ref.update

    def capture(g, o, p, lr):
        seen["grads"], seen["lr"] = g, lr
        return orig(g, o, p, lr)
    ref.update = capture
    sj = _reference_state(jcfg, jtc, K_)
    stream = JTokenStream(vocab_size=jcfg.vocab_size, seq_len=32, batch_size=8)
    step = tr.build_train_step(cfg, tc, make_test_mesh(data=K_))
    for i in range(STEPS):
        tokens = np.asarray(stream.batch(i)["tokens"])
        st = tr.state_from_jax(_np_state(sj), cfg, device="cpu")
        new, mt = step(st, {"tokens": torch.as_tensor(tokens).long()})
        before = _np_state(sj)
        sj, mj = ref(sj, {"tokens": jnp.asarray(tokens)})
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=LOSS_RTOL,
                                   err_msg=f"step {i}")
        leaves = F.tree_leaves(F.module_tree(new.params))
        assert all(x.dtype == torch.bfloat16 and torch.isfinite(x).all() for x in leaves)
        # the port's optimizer on the reference's aggregate and state
        st = tr.state_from_jax(before, cfg, device="cpu")
        params = F.module_tree(st.params)
        grads = F.tree_unflatten(params, [
            torch.as_tensor(np.asarray(g, np.float32)).to(torch.bfloat16)
            for g in jax.tree.leaves(seen["grads"])])
        opt = topt.make_optimizer(cfg.optimizer)
        upd, _ = opt.update(grads, st.opt_state, params,
                            torch.as_tensor(float(seen["lr"]), dtype=torch.float32))
        for (path, w), p, u in zip(jax.tree_util.tree_flatten_with_path(sj.params)[0],
                                   F.tree_leaves(params), F.tree_leaves(upd)):
            got = (p + u.to(p.dtype)).float().numpy()
            ok, worst = _ulp_close(got, np.asarray(w, np.float32), u.float().numpy())
            assert ok, (i, jax.tree_util.keystr(path), worst)


def test_bf16_train_state_checkpoint_round_trip(tmp_path):
    """A bf16 train state (parameters bf16, Adafactor's float32 factors)
    saved and restored bit-equal, in its dtypes; the manifest stores the
    bf16 leaves as float32 (numpy has no bfloat16), as the reference."""
    _, cfg = _arctic("adafactor")
    tc = tr.TrainConfig(agg=tra.RobustAggConfig(layout="flat"))
    st = tr.init_train_state(cfg, tc, torch.Generator().manual_seed(1),
                             make_test_mesh(data=2), device="cpu")
    tree = {"params": F.module_tree(st.params), "opt": st.opt_state}
    ckpt.save_checkpoint(str(tmp_path), "bf16", tree, {"step": 0})
    back, meta = ckpt.restore_checkpoint(str(tmp_path), "bf16", tree)
    for a, b in zip(F.tree_leaves(tree), F.tree_leaves(back)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
    man = json.load(open(os.path.join(str(tmp_path), "bf16.json")))
    assert any(k.startswith("params") for k in man["dtypes"])
    assert all(v != "bfloat16" for v in man["dtypes"].values())
    assert meta["step"] == 0


def test_launcher_trains_and_checkpoints_bf16_arctic(tmp_path, capsys):
    """``launch.train --arch arctic-480b --reduced --param-dtype bfloat16
    --optimizer adafactor --layout flat``: 2 steps under noise, a
    checkpoint restored into bf16 parameters."""
    from repro_torch.launch import train as T
    from repro_torch.models import model as TM

    T.main(["--arch", "arctic-480b", "--reduced", "--param-dtype", "bfloat16",
            "--optimizer", "adafactor", "--layout", "flat", "--candidates", "4",
            "--steps", "2", "--seq-len", "32", "--global-batch", "4",
            "--chunk-size", "4096", "--sketch-dim", "128", "--attack", "noise",
            "--n-malicious", "1", "--log-every", "1", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"], device="cpu")
    assert "done: 2 steps" in capsys.readouterr().out
    cfg = dataclasses.replace(get_config("arctic-480b").reduced(), param_dtype="bfloat16")
    model = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tree, meta = ckpt.restore_checkpoint(str(tmp_path), "step_2", F.module_tree(model))
    assert meta["step"] == 2 and np.isfinite(meta["loss"])
    assert all(x.dtype == torch.bfloat16 and torch.isfinite(x).all()
               for x in F.tree_leaves(tree))
