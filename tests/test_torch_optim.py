"""Port parity of the optimizers and schedules: ``repro_torch.optim.
optimizers`` against ``repro.optim.optimizers`` on the same numpy trees,
5 steps each, within rtol 1e-5 / atol 1e-7.  The trees hold a factored
stacked leaf (L, 128, 128) whose Adafactor update clip binds (its RMS is
taken over all L layers at once, as the reference's stacked leaf), a
non-factored leaf and a scalar.  Mirrors ``tests/test_infra.py``'s
optimizer and schedule tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch.core.flatten import tree_leaves
from repro_torch.optim import optimizers as topt

RTOL, ATOL = 1e-5, 1e-7
STEPS = 5


def _tree(rng, scale=1.0):
    return {"layers": {"w": (scale * rng.standard_normal((3, 128, 128))).astype(np.float32),
                       "b": (scale * rng.standard_normal((3, 40))).astype(np.float32)},
            "scale": np.asarray(scale * rng.standard_normal(), np.float32)}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return {k: _t(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else torch.as_tensor(np.asarray(tree))


def _close(label, got, want):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=label)


@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
def test_optimizer_steps_match_reference(name):
    rng = np.random.default_rng(3)
    params = _tree(rng)
    oj, ot = jopt.make_optimizer(name), topt.make_optimizer(name)
    pj, pt = _j(params), _t(params)
    sj, st = oj.init(pj), ot.init(pt)
    lr_j = jopt.warmup_cosine(1e-2, warmup=2, total=10)
    lr_t = topt.warmup_cosine(1e-2, warmup=2, total=10)
    for step in range(STEPS):
        # large gradients on the stacked leaf: Adafactor's clip binds there
        grads = _tree(rng, scale=10.0 if step % 2 else 1.0)
        uj, sj = oj.update(_j(grads), sj, pj, lr_j(step))
        ut, st = ot.update(_t(grads), st, pt, lr_t(step))
        _close(f"{name} step {step} updates", ut, uj)
        pj = jax.tree.map(lambda p, u: p + u, pj, uj)
        pt = _add(pt, ut)
        _close(f"{name} step {step} params", pt, pj)


def _add(p, u):
    if isinstance(p, dict):
        return {k: _add(p[k], u[k]) for k in p}
    return p + u


def test_adafactor_clip_spans_the_stacked_leaf():
    """The update clip takes one RMS over a whole reference leaf, all L
    layers of a stacked leaf at once.  With layers whose RMS differ (a
    dense layer, a sparse one) the stacked update equals the reference's
    and differs from clipping each layer alone."""
    rng = np.random.default_rng(5)
    g = rng.standard_normal((3, 128, 128)).astype(np.float32)
    g[1] *= (rng.random((128, 128)) < 0.01)
    g[1] *= 50.0
    params = {"w": np.zeros((3, 128, 128), np.float32)}
    oj, ot = jopt.adafactor(), topt.adafactor()
    uj, _ = oj.update(_j({"w": g}), oj.init(_j(params)), _j(params), 1.0)
    ut, _ = ot.update(_t({"w": g}), ot.init(_t(params)), _t(params), torch.tensor(1.0))
    _close("stacked adafactor", ut, uj)
    per_layer = {str(i): torch.as_tensor(g[i]) for i in range(3)}
    zeros = {k: torch.zeros_like(v) for k, v in per_layer.items()}
    up, _ = ot.update(per_layer, ot.init(zeros), zeros, torch.tensor(1.0))
    got = torch.stack([up[str(i)] for i in range(3)])
    assert not torch.allclose(got, ut["w"], rtol=1e-2, atol=0)


def test_adafactor_state_follows_the_reference_leaf_order():
    params = _tree(np.random.default_rng(0))
    sj = jopt.adafactor().init(_j(params))
    st = topt.adafactor().init(_t(params))
    assert [sorted(v) for v in st["v"]] == [sorted(v) for v in sj["v"]]
    for a, b in zip(st["v"], sj["v"]):
        for k in a:
            assert tuple(a[k].shape) == tuple(b[k].shape)


def test_schedules_match_reference():
    for args in ((1e-3, 10, 100), (3e-4, 100, 10_000), (1e-2, 0, 50)):
        fj, ft = jopt.warmup_cosine(*args), topt.warmup_cosine(*args)
        got = np.array([float(ft(s)) for s in range(121)], np.float32)
        want = np.array([float(fj(s)) for s in range(121)], np.float32)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, err_msg=str(args))
        assert ft(5).dtype == torch.float32
    assert float(topt.constant_lr(0.25)(7)) == float(jopt.constant_lr(0.25)(7))


@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
def test_optimizers_descend_quadratic(name):
    """tests/test_infra.py::test_optimizers_descend_quadratic."""
    opt = topt.make_optimizer(name)
    params = {"w": torch.full((8,), 5.0)}
    state = opt.init(params)
    loss = lambda p: (p["w"] ** 2).sum()   # noqa: E731
    for _ in range(60):
        g = {"w": 2.0 * params["w"]}
        upd, state = opt.update(g, state, params, 0.1)
        params = {"w": params["w"] + upd["w"]}
    assert float(loss(params)) < float((torch.full((8,), 5.0) ** 2).sum()) * 0.2


def test_warmup_cosine_schedule():
    """tests/test_infra.py::test_warmup_cosine_schedule."""
    fn = topt.warmup_cosine(1e-3, warmup=10, total=100)
    assert float(fn(0)) < 2e-4
    assert float(fn(10)) == pytest.approx(1e-3, rel=1e-3)
    assert float(fn(99)) < float(fn(50)) < float(fn(10))
