"""Port parity of the single-matrix aggregation rules
(``repro_torch.core.aggregators``) and of the Alt-WFAgg branches of the
scoring stage (``repro_torch.core.trust``) against the JAX package.

The same numpy inputs go to both: random candidates, and tie-heavy ones
(small integers, so distances are exact and equal, with duplicated rows).
Participation masks must be bit-equal, including every index tie-break;
aggregates agree within rtol 1e-5 / atol 1e-5 (d = 64)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro.core import trust as jtrust
from repro.core.wfagg import alt_wfagg_config as jalt_config
from repro.kernels.robust_stats.ref import RobustStats as JStats
from repro_torch.core import aggregators as tagg
from repro_torch.core import trust as ttrust
from repro_torch.core.wfagg import alt_wfagg_config as talt_config
from repro_torch.kernels.robust_stats.ref import RobustStats as TStats

TOL = 1e-5
D = 64


def _updates(kind, K, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        u = rng.standard_normal((K, D)).astype(np.float32)
        u[-1] = u[0] = -3.0 * u[1:-1].mean(0)    # two IPM attackers
        return u
    u = rng.integers(-2, 3, (K, D)).astype(np.float32)
    u[2] = u[0]
    u[K - 1] = u[1]
    return u


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("K", [5, 10, 20])
@pytest.mark.parametrize("rule", sorted(jagg.AGGREGATORS))
def test_aggregators_match_reference(rule, K, kind):
    u = _updates(kind, K, seed=K)
    kw = {"f": 2, "m": 3} if rule == "multi_krum" else (
        {"f": 1} if rule == "krum" else ({"beta": 0.2} if rule == "trimmed_mean" else {}))
    jout, jmask = jagg.AGGREGATORS[rule](jnp.asarray(u), **kw)
    tout, tmask = tagg.AGGREGATORS[rule](torch.as_tensor(u), **kw)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=TOL, atol=TOL)


def test_matrix_helpers_match_reference():
    u = _updates("random", 9, seed=1)
    for name in ("coordinate_median", "pairwise_sq_dists", "cosine_distance_matrix"):
        np.testing.assert_allclose(getattr(tagg, name)(torch.as_tensor(u)).numpy(),
                                   np.asarray(getattr(jagg, name)(jnp.asarray(u))),
                                   rtol=TOL, atol=1e-4, err_msg=name)


def _dist_matrices(N, K, seed):
    """(N, K, K) symmetric distance matrices of small integers (exact ties
    everywhere) with a zero diagonal, and valid masks including a full
    slate, a slate of 2 and one of up to 3 (every other slot)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, (N, K, K)).astype(np.float32)
    d = np.triu(a, 1)
    d = d + np.swapaxes(d, 1, 2)
    valid = rng.random((N, K)) < 0.7
    valid[0] = True
    valid[1] = False
    valid[1, :2] = True
    valid[2] = False
    valid[2, np.arange(0, K, 2)[:3]] = True
    return d, valid


@pytest.mark.parametrize("K", [2, 6, 10])
def test_clustering_merge_matches_reference(K):
    d, valid = _dist_matrices(6, K, seed=K)
    want_dyn = jax.vmap(jagg.clustering_select_from_dist_dyn)(jnp.asarray(d),
                                                              jnp.asarray(valid))
    want = jax.vmap(jagg.clustering_select_from_dist)(jnp.asarray(d))
    td, tv = torch.as_tensor(d), torch.as_tensor(valid)
    np.testing.assert_array_equal(
        tagg.clustering_select_from_dist_dyn(td, tv).numpy(), np.asarray(want_dyn))
    np.testing.assert_array_equal(tagg.clustering_select_from_dist(td).numpy(),
                                  np.asarray(want))
    for n in range(d.shape[0]):     # one matrix at a time, as the CFL server calls it
        np.testing.assert_array_equal(
            tagg.clustering_select_from_dist_dyn(td[n], tv[n]).numpy(),
            np.asarray(want_dyn[n]))


@pytest.mark.parametrize("f", [0, 2])
def test_krum_scores_match_reference(f):
    d, valid = _dist_matrices(5, 8, seed=3 + f)
    jd, td = jnp.asarray(d), torch.as_tensor(d)
    np.testing.assert_allclose(
        tagg.krum_scores_from_sq_dists(td, f).numpy(),
        np.asarray(jax.vmap(lambda x: jagg.krum_scores_from_sq_dists(x, f))(jd)),
        rtol=0, atol=0)
    vpair = valid[:, :, None] & valid[:, None, :]
    dm = np.where(vpair, d, np.inf).astype(np.float32)
    nv = valid.sum(-1)
    want = jax.vmap(lambda x, v: jagg.krum_scores_from_sq_dists_dyn(x, f, v))(
        jnp.asarray(dm), jnp.asarray(nv))
    got = tagg.krum_scores_from_sq_dists_dyn(torch.as_tensor(dm), f, torch.as_tensor(nv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _stats_and_gram(u):
    """Statistics and Gram of candidate rows ``u (..., K, D)`` for both
    packages, computed once in numpy (float64 rounded to float32) so both
    see the same numbers."""
    u64 = u.astype(np.float64)
    med = np.median(u64, axis=-2)
    fields = {
        "dist2": ((u64 - med[..., None, :]) ** 2).sum(-1),
        "dotmed": (u64 * med[..., None, :]).sum(-1),
        "norm2": (u64 * u64).sum(-1),
        "mednorm2": (med * med).sum(-1),
    }
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    gram = np.einsum("...kd,...jd->...kj", u64, u64).astype(np.float32)
    order = ("dist2", "dotmed", "norm2", "mednorm2")
    js = JStats(None, None, *(jnp.asarray(fields[k]) for k in order))
    ts = TStats(None, None, *(torch.as_tensor(fields[k]) for k in order))
    return js, ts, gram


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_gram_helpers_and_single_node_masks(kind):
    u = _updates(kind, 12, seed=21)
    js, ts, gram = _stats_and_gram(u)
    jg, tg = jnp.asarray(gram), torch.as_tensor(gram)
    # the port's norms are the Gram's own diagonal (exact 0 between
    # bit-identical candidates); the expansion is the reference's
    np.testing.assert_allclose(ttrust.sq_dists_from_gram(tg).numpy(),
                               np.asarray(jtrust.sq_dists_from_gram(
                                   jg, jnp.diagonal(jg, axis1=-2, axis2=-1))),
                               rtol=0, atol=0)
    np.testing.assert_allclose(ttrust.cosine_dist_from_gram(tg, ts.norm2).numpy(),
                               np.asarray(jtrust.cosine_dist_from_gram(jg, js.norm2)),
                               rtol=1e-6, atol=1e-6)
    for m in (None, 4):
        jcfg, tcfg = jalt_config(f=2, multi_krum_m=m), talt_config(f=2, multi_krum_m=m)
        np.testing.assert_array_equal(
            ttrust.fused_distance_mask(ts, tg, tcfg).numpy(),
            np.asarray(jtrust.fused_distance_mask(js, jg, jcfg)))
        np.testing.assert_array_equal(
            ttrust.fused_similarity_mask(ts, tg, tcfg).numpy(),
            np.asarray(jtrust.fused_similarity_mask(js, jg, jcfg)))


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_valid_masks_read_the_gram(kind):
    """The batched, valid-aware Alt-WFAgg masks (``stats.gram`` (N, K, K))
    against the reference's per-node masks, vmapped."""
    N, K = 5, 8
    u = np.stack([_updates(kind, K, seed=30 + n) for n in range(N)])
    js, ts, gram = _stats_and_gram(u)
    valid = np.random.default_rng(4).random((N, K)) < 0.7
    valid[0] = True
    valid[1] = False
    valid[1, :2] = True
    jcfg, tcfg = jalt_config(f=1), talt_config(f=1)
    jv, tv = jnp.asarray(valid), torch.as_tensor(valid)
    ts = ts._replace(gram=torch.as_tensor(gram))
    for jfn, tfn in ((jtrust.fused_distance_mask_valid, ttrust.fused_distance_mask_valid),
                     (jtrust.fused_similarity_mask_valid,
                      ttrust.fused_similarity_mask_valid)):
        want = jax.vmap(lambda s, g, v: jfn(s, g, v, jcfg))(js, jnp.asarray(gram), jv)
        np.testing.assert_array_equal(tfn(ts, tv, tcfg).numpy(), np.asarray(want))
