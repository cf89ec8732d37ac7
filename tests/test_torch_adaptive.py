"""Port parity of the defense-aware adaptive attacks: ``repro_torch``'s
``band_rider_attack``, ``min_max_attack``, ``apply_model_attack`` and
``_sender_band_limits`` against ``repro.core.attacks`` on the same numpy
inputs, and the port's mirror of ``tests/test_adaptive_robustness.py``'s
attack tests.

* ``band_rider`` with a hand-built ``DefenseView``: active, inactive
  (``(+inf, -inf)``) and infeasible bands, a padded ``valid`` mask and a
  sender with no constrained edge; ``min_max`` with several Byzantine
  counts, one of them leaving a single benign row; ``apply_model_attack``
  for every deterministic attack name: within rtol = 1e-5, atol = 1e-6.
  ``_sender_band_limits`` exactly (``scatter_reduce`` min/max is exact).
* The port's engine: band_rider's sent models land inside the WFAgg-T
  bands they ride; without a view it is ALIE mimicry; min_max stays
  under the distance-filter radii; the three WFAgg backends agree under
  every adaptive attack on an eclipse schedule; the attack registry is
  one tuple, equal to the reference's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attacks as jatk
from repro_torch.core import attacks as atk
from repro_torch.core.topology import make_topology
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.dfl import dynamics as dyn
from repro_torch.dfl import engine as eng
from repro_torch.models.lenet import ravel

from _torch_fixtures import models, ring_slate

RTOL, ATOL = 1e-5, 1e-6
ENGINE_ATOL = 3e-5        # tests/test_adaptive_robustness.py:28


def _view_inputs(seed, N=10, K=4, d=96):
    """Models, prev, a padded ring slate (node n reads n+1 .. n+4) and
    (N, 4K) bands holding every band kind, around each sender's own
    metric: active bands; an inactive ``(+inf, -inf)`` row (a transient
    receiver, which makes malicious sender 3 infeasible); infeasible rows
    (``lo_d > hi_d``, ``hi_d <= 0``).  Malicious sender 6 rides, and
    malicious sender 9 has no constrained edge (no benign receiver's slot
    for it is valid)."""
    rng = np.random.default_rng(seed)
    x = models(N, d, seed)
    prev = x + 0.4 * rng.standard_normal((N, d)).astype(np.float32)
    idx = ring_slate(N, K)
    valid = np.ones((N, K), bool)
    for n in (4, 7):                    # padded slots repeat the node itself
        idx[n, 3], valid[n, 3] = n, False
    mal = np.isin(np.arange(N), (3, 6, 9))
    valid &= ~((idx == 9) & ~mal[:, None])
    s = ((x[idx] - prev[idx]) ** 2).sum(-1)            # (N, K), per sender
    lo_d = s * rng.uniform(0.3, 0.8, (N, K))
    hi_d = s * rng.uniform(1.2, 2.0, (N, K))
    lo_c = rng.uniform(0.0, 0.02, (N, K))
    hi_c = rng.uniform(0.05, 0.3, (N, K))
    tb = np.stack([lo_d, hi_d, lo_c, hi_c], 1).astype(np.float32)   # (N, 4, K)
    tb[0] = np.array([np.inf, -np.inf, np.inf, -np.inf], np.float32)[:, None]
    tb[1, 0] = tb[1, 1] + 1.0                           # lo_d > hi_d
    tb[8, 1] = -1.0                                     # hi_d <= 0
    return x, prev, idx, valid, mal, tb.reshape(N, 4 * K)


def _views(x, prev, idx, valid, mal, tb):
    jview = jatk.DefenseView(neighbor_idx=jnp.asarray(idx), valid=jnp.asarray(valid),
                             prev=jnp.asarray(prev), tbands=jnp.asarray(tb))
    view = atk.DefenseView(neighbor_idx=torch.as_tensor(idx),
                           valid=torch.as_tensor(valid),
                           prev=torch.as_tensor(prev), tbands=torch.as_tensor(tb))
    return jview, view


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sender_band_limits_equal_reference(seed):
    x, prev, idx, valid, mal, tb = _view_inputs(seed)
    jview, view = _views(x, prev, idx, valid, mal, tb)
    want = jatk._sender_band_limits(jview, jnp.asarray(mal), x.shape[0])
    got = atk._sender_band_limits(view, torch.as_tensor(mal), x.shape[0])
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    lo_d, hi_d = got[0].numpy(), got[1].numpy()
    assert hi_d[9] == np.inf and lo_d[9] == -np.inf     # unconstrained
    assert hi_d[3] == -np.inf                           # an inactive band
    assert np.isfinite(hi_d[6]) and lo_d[6] <= hi_d[6]  # rides


@pytest.mark.parametrize("margin", [0.05, 0.2])
@pytest.mark.parametrize("seed", [0, 1])
def test_band_rider_matches_reference(seed, margin):
    x, prev, idx, valid, mal, tb = _view_inputs(seed)
    jview, view = _views(x, prev, idx, valid, mal, tb)
    jcfg = jatk.AttackConfig(name="band_rider", adaptive_margin=margin)
    cfg = atk.AttackConfig(name="band_rider", adaptive_margin=margin)
    want = np.asarray(jatk.band_rider_attack(jnp.asarray(x), jnp.asarray(mal), jview, jcfg))
    got = atk.band_rider_attack(torch.as_tensor(x), torch.as_tensor(mal), view, cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # rows that ride and rows that fall back to mimicry are both present
    fallback = np.asarray(jatk.band_rider_attack(jnp.asarray(x), jnp.asarray(mal), None,
                                                 jcfg))
    rides = ~np.isclose(want, fallback).all(1)
    assert list(np.flatnonzero(rides & mal)) == [6]
    # through apply_matrix_attack, only the Byzantine rows change
    out = atk.apply_matrix_attack("band_rider", torch.as_tensor(x), torch.as_tensor(mal),
                                  cfg=cfg, view=view).numpy()
    np.testing.assert_allclose(out[mal], want[mal], rtol=RTOL, atol=ATOL)
    assert np.array_equal(out[~mal], x[~mal])


@pytest.mark.parametrize("n_mal", [1, 3, 7])
def test_min_max_matches_reference(n_mal):
    x = models(8, 80, seed=n_mal, shift=0.1)
    mal = np.arange(8) < n_mal          # 7 of 8 leaves one benign row: no deviation
    want = np.asarray(jatk.min_max_attack(jnp.asarray(x), jnp.asarray(mal),
                                          jatk.AttackConfig(name="min_max")))
    got = atk.min_max_attack(torch.as_tensor(x), torch.as_tensor(mal),
                             atk.AttackConfig(name="min_max"))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if n_mal == 7:
        np.testing.assert_allclose(got.numpy()[0], x[7], rtol=RTOL, atol=ATOL)


def test_masked_coordinate_median_matches_reference():
    x = models(9, 33, seed=4)
    for benign in (np.arange(9) % 2 == 0, np.arange(9) < 4, np.zeros(9, bool)):
        want = np.asarray(jatk._masked_coordinate_median(jnp.asarray(x),
                                                          jnp.asarray(benign)))
        got = atk._masked_coordinate_median(torch.as_tensor(x), torch.as_tensor(benign))
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", [n for n in atk.ATTACK_NAMES if n != "noise"])
def test_apply_model_attack_matches_reference(name):
    x = models(7, 64, seed=11)
    update, benign = x[0], x[1:]
    want = np.asarray(jatk.apply_model_attack(name, jnp.asarray(update),
                                              jnp.asarray(benign), jax.random.PRNGKey(0)))
    got = atk.apply_model_attack(name, torch.as_tensor(update), torch.as_tensor(benign))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# mirrors of tests/test_adaptive_robustness.py (the port's engine alone)
# ---------------------------------------------------------------------------

def _close_topo(n=10, degree=4, n_mal=2, seed=0):
    return make_topology(n_nodes=n, degree=degree, n_malicious=n_mal, kind="ring",
                         seed=seed, placement="close")


def test_band_rider_inside_temporal_bands():
    """Past the WFAgg-T transient, replay the attack step by hand: every
    (benign victim, malicious sender) edge with an active band sees the
    sent model inside the band, s_t and b_t both, and a real deviation."""
    topo = _close_topo()
    data = SyntheticImages(seed=0)
    cfg = eng.DFLConfig(aggregator="wfagg", attack="band_rider", model="mlp", seed=0,
                        batches_per_round=1)
    state = eng.init_dfl_state(cfg, topo, device="cpu")
    round_fn = eng.build_round_fn(cfg, topo, data, device="cpu")
    for _ in range(6):                      # transient=3: bands active now
        state = round_fn(state)

    mal = torch.as_tensor(topo.malicious)
    nidx = torch.as_tensor(topo.neighbor_indices, dtype=torch.int64)
    params, _ = eng._local_train(cfg, data, mal, state.node_params,
                                 state.node_momentum, state.rnd)
    view = eng._defense_view(cfg, state, nidx, None)
    assert view is not None and view.tbands is not None
    attacked = eng._apply_attacks(cfg, mal, ravel(params), state.rnd, view).numpy()

    tb = view.tbands.numpy().reshape(topo.n_nodes, 4, -1)
    prev = view.prev.numpy()
    malv, idx = topo.malicious, topo.neighbor_indices
    checked = 0
    for n in range(topo.n_nodes):
        if malv[n]:
            continue
        for k in range(idx.shape[1]):
            j = idx[n, k]
            lo_d, hi_d, lo_c, hi_c = tb[n, :, k]
            if not malv[j] or not np.isfinite(hi_d):
                continue
            p, c = prev[j], attacked[j]
            s = float(((c - p) ** 2).sum())
            b = 1.0 - float((c * p).sum() / max(np.linalg.norm(c) * np.linalg.norm(p),
                                                1e-12))
            tol_d = 1e-3 * max(1.0, abs(hi_d))
            assert lo_d - tol_d <= s <= hi_d + tol_d, (n, k, s, lo_d, hi_d)
            assert lo_c - 1e-4 <= b <= hi_c + 1e-4, (n, k, b, lo_c, hi_c)
            assert s > 0.0                  # a ride, not a replay
            checked += 1
    assert checked > 0                      # bands were actually active


def test_band_rider_falls_back_without_view():
    rng = np.random.default_rng(3)
    u = torch.as_tensor(rng.normal(size=(8, 32)).astype(np.float32))
    mal = torch.as_tensor(np.array([1, 0, 0, 0, 1, 0, 0, 0], bool))
    cfg = atk.AttackConfig(name="band_rider")
    for view in (None, atk.DefenseView(prev=u)):
        out = atk.apply_matrix_attack("band_rider", u, mal, cfg=cfg, view=view).numpy()
        assert np.isfinite(out).all()
        ben = u.numpy()[~mal.numpy()]
        expect = ben.mean(0) - cfg.alie_zmax * ben.std(0)
        assert np.allclose(out[0], expect, atol=1e-5)
        assert np.allclose(out[4], expect, atol=1e-5)
        assert np.array_equal(out[1], u.numpy()[1])      # benign rows untouched


def test_min_max_under_filter_radii():
    rng = np.random.default_rng(7)
    u = torch.as_tensor(rng.normal(size=(10, 64)).astype(np.float32))
    mal = torch.as_tensor(np.arange(10) < 3)
    out = atk.apply_matrix_attack("min_max", u, mal).numpy()
    ben = u.numpy()[3:]
    c = out[0]
    assert np.array_equal(out[0], out[1])   # colluders send one model
    dmax = max(np.linalg.norm(a - b) for a in ben for b in ben)
    assert max(np.linalg.norm(c - b) for b in ben) <= dmax + 1e-3
    med = np.median(ben, axis=0)
    rmed = max(np.linalg.norm(b - med) for b in ben)
    assert np.linalg.norm(c - med) <= rmed + 1e-3
    assert np.linalg.norm(c - ben.mean(0)) > 0.1 * dmax    # it actually deviates


@pytest.mark.parametrize("attack", atk.ADAPTIVE_ATTACKS + ("ipm",))
def test_backend_parity_under_adaptive_attacks(attack):
    """fused / fused_two_launch / reference give the same models under each
    adaptive attack (the view is built from shared state)."""
    topo = _close_topo(n=8, degree=4, n_mal=2)
    data = SyntheticImages(seed=0)
    sched = dyn.make_schedule("eclipse", topo, 3, seed=2)
    finals = {}
    for backend in ("fused", "fused_two_launch", "reference"):
        cfg = eng.DFLConfig(aggregator="wfagg", attack=attack, model="mlp", seed=0,
                            batches_per_round=1, wfagg_backend=backend)
        out = eng.run_dynamic_experiment(cfg, topo, data, sched, n_test=64, device="cpu")
        finals[backend] = np.asarray(out["final"]["acc_all"])
    assert np.allclose(finals["fused"], finals["fused_two_launch"], atol=ENGINE_ATOL)
    assert np.allclose(finals["fused"], finals["reference"], atol=1e-3)


def test_attack_names_single_source():
    """Every attack-choice surface derives from ATTACK_NAMES, the
    reference's tuple; ``chip_smoke.py``'s copy of the gate grid is the
    reference benchmark's."""
    import chip_smoke
    from benchmarks.robustness_matrix import GATE_GRID

    assert atk.ATTACK_NAMES == jatk.ATTACK_NAMES
    assert atk.ADAPTIVE_ATTACKS == jatk.ADAPTIVE_ATTACKS
    assert "ipm" in atk.ATTACK_NAMES
    assert set(atk.ADAPTIVE_ATTACKS) <= set(atk.ATTACK_NAMES)
    assert chip_smoke.GATE_GRID == GATE_GRID
    assert set(chip_smoke.GATE_GRID["attacks"]) <= set(atk.ATTACK_NAMES)
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]  # noqa: E731
    assert fields(atk.AttackConfig) == fields(jatk.AttackConfig)
