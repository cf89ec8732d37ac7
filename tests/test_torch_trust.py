"""Port parity: the WFAgg scoring stage (``repro_torch.core.trust``)
against the JAX package's ``core.trust`` on hand-built statistics with
exact ties, +-inf bands, all-invalid rows and keep counts v - f - 1 < 0.
Masks must be bit-equal; weights and bands agree within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro.core import trust as jtrust
from repro.core import wfagg as jwf
from repro.kernels.robust_stats.ref import RobustStats as JStats
from repro_torch.core import aggregators as tagg
from repro_torch.core import trust as ttrust
from repro_torch.core import wfagg as twf
from repro_torch.kernels.robust_stats.ref import RobustStats as TStats

TOL = 1e-6
N, K, W = 8, 6, 3


def _stats(seed):
    """Per-candidate statistics drawn from tiny integer sets, so exact
    ties are common; slot 4 duplicates slot 1 bit for bit (two attackers
    sending the same model)."""
    rng = np.random.default_rng(seed)
    f = lambda lo, hi: rng.integers(lo, hi, (N, K)).astype(np.float32)  # noqa: E731
    s = {"dist2": f(0, 4), "dotmed": f(-2, 3), "norm2": f(1, 4),
         "prev_dist2": f(0, 4), "prev_dot": f(-2, 3), "prev_norm2": f(0, 4)}
    for v in s.values():
        v[:, 4] = v[:, 1]
    s["mednorm2"] = rng.integers(0, 3, (N,)).astype(np.float32)
    return s


def _valid(seed):
    rng = np.random.default_rng(seed)
    valid = rng.random((N, K)) < 0.75
    valid[0] = True            # full slate
    valid[1] = False           # degree 0
    valid[2] = [True, True, False, False, False, False]   # v - f - 1 < 0
    return valid


def _bands(stats, seed):
    """Finite bands, some edges placed exactly on the metric (inclusive
    compares), one inactive node (+inf, -inf) and one open band."""
    rng = np.random.default_rng(seed)
    lo_d = stats["prev_dist2"] - rng.integers(0, 2, (N, K))
    hi_d = stats["prev_dist2"] + rng.integers(-1, 2, (N, K))
    b_t = np.asarray(TStats(None, None, *(torch.as_tensor(stats[k]) for k in (
        "dist2", "dotmed", "norm2", "mednorm2", "prev_dist2", "prev_dot",
        "prev_norm2"))).cosine_to_prev())
    lo_c = b_t - rng.choice([0.0, 0.5], (N, K)).astype(np.float32)
    hi_c = b_t + rng.choice([0.0, 0.5, -0.25], (N, K)).astype(np.float32)
    tb = np.concatenate([lo_d, hi_d, lo_c, hi_c], axis=1).astype(np.float32)
    tb[3] = np.repeat([np.inf, -np.inf, np.inf, -np.inf], K)   # inactive
    tb[5, :K], tb[5, K:2 * K] = -np.inf, np.inf                 # open s_t band
    return tb


def _jax_derive(stats, valid, tbands, cfg):
    js = JStats(None, None, *(jnp.asarray(stats[k]) for k in (
        "dist2", "dotmed", "norm2", "mednorm2", "prev_dist2", "prev_dot",
        "prev_norm2")))
    fn = lambda s, v, tb: jtrust.derive_trust_weights(  # noqa: E731
        s, None, v, None if tb is None else tb.reshape(4, K), cfg)
    if tbands is None:
        return jax.jit(jax.vmap(lambda s, v: fn(s, v, None)))(
            js, jnp.asarray(valid, jnp.float32))
    return jax.jit(jax.vmap(fn))(js, jnp.asarray(valid, jnp.float32),
                                 jnp.asarray(tbands))


@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("temporal", [False, True])
def test_derive_trust_weights_bit_equal_masks(temporal, f):
    stats = _stats(seed=10 + f)
    valid = _valid(seed=20 + f)
    tb = _bands(stats, seed=30 + f) if temporal else None
    cfg = jwf.WFAggConfig(f=f)
    want = _jax_derive(stats, valid, tb, cfg)
    ts = TStats(None, None, *(torch.as_tensor(stats[k]) for k in (
        "dist2", "dotmed", "norm2", "mednorm2", "prev_dist2", "prev_dot",
        "prev_norm2")))
    got = ttrust.derive_trust_weights(
        ts, torch.as_tensor(valid), None if tb is None else torch.as_tensor(tb),
        twf.WFAggConfig(f=f))
    for name, g, w in zip(("mask_d", "mask_c", "mask_t"), got[:3], want[:3]):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=TOL)
    assert not got[0][1].any() and not got[3][1].any()   # degree 0
    assert not got[0][2].any() and not got[1][2].any()   # keep count < 0
    if temporal:
        assert got[2].any() and not got[2][3].any()       # bands fire; inactive node


@pytest.mark.parametrize("mean_fallback", [False, True])
def test_combine_coefficients(mean_fallback):
    rng = np.random.default_rng(3)
    w = rng.choice([0.0, 0.6, 0.8, 1.0], (N, K)).astype(np.float32)
    valid = _valid(seed=4)
    w = w * valid
    w[3] = 0.0                  # all rejected, valid neighbours exist
    want = jax.vmap(lambda ww, vv: jtrust.combine_coefficients(
        ww, 0.8, vv, mean_fallback))(jnp.asarray(w), jnp.asarray(valid, jnp.float32))
    got = ttrust.combine_coefficients(torch.as_tensor(w), 0.8,
                                      torch.as_tensor(valid), mean_fallback)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=TOL)
    assert float(got[1][1]) == 1.0          # degree 0 keeps its local model


def test_temporal_bands_and_push_history():
    rng = np.random.default_rng(7)
    hist_s = rng.random((N, W, K)).astype(np.float32) * 3
    hist_b = rng.random((N, W, K)).astype(np.float32)
    count = np.array([0, 1, 2, 3, 3, 2, 1, 3], np.int32)
    t = np.array([0, 1, 2, 3, 4, 5, 9, 2], np.int32)
    cfg = jwf.WFAggConfig(transient=2)
    want = jax.vmap(lambda hs, hb, c, tt: jtrust.temporal_bands(hs, hb, c, tt, cfg))(
        *map(jnp.asarray, (hist_s, hist_b, count, t)))
    got = ttrust.temporal_bands(*map(torch.as_tensor, (hist_s, hist_b, count, t)),
                                twf.WFAggConfig(transient=2))
    want = np.asarray(want)
    assert np.array_equal(np.isinf(got.numpy()), np.isinf(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert np.isinf(got.numpy()[[0, 1, 2, 7]]).all()     # transient / empty
    assert np.isfinite(got.numpy()[[3, 4, 5, 6]]).all()

    s_t = rng.random((N, K)).astype(np.float32)
    b_t = rng.random((N, K)).astype(np.float32)
    want = jax.vmap(jtrust.push_history)(
        *map(jnp.asarray, (hist_s, hist_b, count, t, s_t, b_t)))
    got = ttrust.push_history(*map(torch.as_tensor, (hist_s, hist_b, count, t, s_t, b_t)))
    for g, x in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(x))


@pytest.mark.parametrize("k", [-1, 0, 2, 5, 9])
def test_smallest_k_masks_break_ties_by_index(k):
    """Both mask helpers select as the reference's: ``lax.top_k`` order
    for the static count, stable argsort for the per-row count."""
    scores = np.random.default_rng(k + 5).integers(0, 3, (N, K)).astype(np.float32)
    scores[1] = np.inf                       # an all-invalid row
    want = jax.vmap(lambda s: jagg.smallest_k_mask(s, k))(jnp.asarray(scores))
    got = tagg.smallest_k_mask(torch.as_tensor(scores), k)
    assert np.array_equal(got.numpy(), np.asarray(want))
    ks = np.arange(N) - 2                    # per-row counts from -2 to N-3
    want = jax.vmap(jagg.smallest_k_mask_dyn)(jnp.asarray(scores), jnp.asarray(ks))
    got = tagg.smallest_k_mask_dyn(torch.as_tensor(scores), torch.as_tensor(ks))
    assert np.array_equal(got.numpy(), np.asarray(want))
