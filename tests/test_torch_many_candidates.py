"""Port parity of kernels 4, 5 and 6 at more than 32 candidates: the plain
versions of ``kernels/robust_stats/csrc/robust_stats.cu`` (its wide path)
and ``kernels/pairwise_dist/csrc/pairwise_gram.cu`` (its output tiles),
and ``ref.robust_stats_kernel_order``, the emulation of the wide path's
summation order, against the JAX package on the same numpy inputs.

* ``robust_stats`` and ``robust_stats_batch`` at K = 33 and 40 against the
  Pallas kernel in interpret mode.  Its compile grows with K (~12 s at 33,
  ~22 s at 40), so it is jitted once per K: the single-matrix launch at K =
  33 and the gathered launch (two nodes) at K = 40, with ``prev`` and the
  centers.  One Pallas body serves both launches, so the port's gathered
  function is held to the single launch (one node) and its single-matrix
  function to each node of the gathered launch; the port's calls without
  ``prev`` or the centers are held to the same fields.
* K in {64, 100, 257, 1024}: against the JAX oracle ``robust_stats_ref``.
* ``pairwise_gram`` at K in {33, 64, 100, 257} against the reference's
  ``pairwise_gram`` (Pallas, interpret mode) and ``pairwise_dist_ref``.
* ``robust_stats_kernel_order`` at K = 33 against the Pallas kernel and at
  K = 100 against the oracle, over several CTAs per node.
* The median's permutation invariance and translation equivariance
  (``tests/test_kernels.py:99-133``) at K up to 100, on the plain version
  and on the emulated kernel order.

Tolerances: those of ``tests/test_torch_robust_stats_single.py`` (the
median bit-equal; the trimmed mean and the statistics rtol 1e-5 / atol
1e-4 at d = 300; the WFAgg-D and WFAgg-C masks bit-equal, twin rows
tied) and of ``tests/test_torch_gram_combine.py`` for the Gram (rtol 1e-5
/ atol 1e-4; squared distances atol 2e-3); the kernel order's sums rtol
1e-4 / atol 1e-3, the chip check's statistics tolerance."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import trust as jtrust
from repro.core.wfagg import WFAggConfig as JConfig
from repro.kernels.pairwise_dist.ops import pairwise_gram as jpairwise_gram
from repro.kernels.pairwise_dist.ops import pairwise_sq_dists as jpairwise_sq_dists
from repro.kernels.pairwise_dist.ref import pairwise_dist_ref as jpairwise_dist_ref
from repro.kernels.robust_stats import ops as jops
from repro.kernels.robust_stats.ref import robust_stats_ref as jrobust_stats_ref
from repro_torch.core import trust as ttrust
from repro_torch.core.wfagg import WFAggConfig as TConfig
from repro_torch.kernels.pairwise_dist import kernel as pkernel
from repro_torch.kernels.pairwise_dist import ops as pops
from repro_torch.kernels.robust_stats import kernel as tkernel
from repro_torch.kernels.robust_stats import ops as tops
from repro_torch.kernels.robust_stats import ref as tref

from _torch_fixtures import models

RTOL, ATOL = 1e-5, 1e-4
ORDER_RTOL, ORDER_ATOL = 1e-4, 1e-3
D = 300
FIELDS = ("dist2", "dotmed", "norm2", "mednorm2", "prev_dist2", "prev_dot",
          "prev_norm2")


def _candidates(N, K, seed):
    """(u (N, K, D), prev): rows 1 and K-1 of every node bit-identical (two
    attackers sending one model) and their prev rows too, and a few
    repeated values in every column so the sort meets ties."""
    u = models(N * K, D, seed).reshape(N, K, D)
    u[:, K - 1] = u[:, 1]
    u[:, 0, ::7] = u[:, K // 2, ::7]
    prev = u + np.float32(0.2) * models(N * K, D, seed + 100, shift=0.0).reshape(N, K, D)
    prev[:, K - 1] = prev[:, 1]
    return u, prev


@functools.lru_cache(maxsize=None)
def _pallas(K):
    """(u (N, K, D), prev, the reference's statistics with a leading N axis)
    from its Pallas kernel in interpret mode, compiled once per K: the
    single-matrix launch at K = 33 (N = 1), the gathered one at K = 40."""
    if K == 33:
        u, prev = _candidates(1, K, seed=K)
        r = jops.robust_stats(jnp.asarray(u[0]), prev=jnp.asarray(prev[0]), need_center=True)
        want = jax.tree.map(lambda x: np.asarray(x)[None], r)
    else:
        u, prev = _candidates(2, K, seed=K)
        want = jax.tree.map(np.asarray, jops.robust_stats_batch(
            jnp.asarray(u), prev=jnp.asarray(prev), need_center=True))
    return u, prev, want


def _node(stats, n):
    """Node n's fields of batched statistics (None stays None)."""
    return type(stats)(*(None if x is None else x[n] for x in stats))


def _assert_node(got, want, with_prev, need_center, rtol=RTOL, atol=ATOL):
    """One node's port statistics against the reference's (numpy) fields."""
    if need_center:
        np.testing.assert_array_equal(got.med.numpy(), want.med)
        np.testing.assert_allclose(got.trim.numpy(), want.trim, rtol=rtol, atol=atol)
    else:
        assert got.med is None and got.trim is None
    for name in FIELDS:
        g = getattr(got, name)
        if not with_prev and name.startswith("prev"):
            assert g is None, name
            continue
        np.testing.assert_allclose(g.numpy(), getattr(want, name), rtol=rtol, atol=atol,
                                   err_msg=name)


def _assert_masks_and_ties(got, want, K):
    """WFAgg-D's and WFAgg-C's masks bit-equal to the reference's, with
    their index tie-break, and the twin rows 1 and K-1 with equal sums."""
    jcfg, tcfg = JConfig(f=1), TConfig(f=1)
    for jfn, tfn in ((jtrust.fused_distance_mask, ttrust.fused_distance_mask),
                     (jtrust.fused_similarity_mask, ttrust.fused_similarity_mask)):
        np.testing.assert_array_equal(tfn(got, None, tcfg).numpy(),
                                      np.asarray(jfn(want, None, jcfg)))
    for name in ("dist2", "dotmed", "norm2"):
        v = getattr(got, name)
        assert torch.equal(v[1], v[K - 1]), name


def _t(x):
    return None if x is None else torch.as_tensor(x)


@pytest.mark.parametrize("need_center", [True, False])
@pytest.mark.parametrize("with_prev", [True, False])
@pytest.mark.parametrize("K", [33, 40])
def test_robust_stats_matches_pallas_kernel(K, with_prev, need_center):
    u, prev, want = _pallas(K)
    before = tkernel.robust_stats_launches
    for n in range(u.shape[0]):
        got = tops.robust_stats(torch.as_tensor(u[n]),
                                prev=_t(prev[n]) if with_prev else None,
                                need_center=need_center)
        w = _node(want, n)
        _assert_node(got, w, with_prev, need_center)
        _assert_masks_and_ties(got, w, K)
    assert tkernel.robust_stats_launches == before       # CPU: plain version


@pytest.mark.parametrize("need_center", [True, False])
@pytest.mark.parametrize("with_prev", [True, False])
@pytest.mark.parametrize("K", [33, 40])
def test_robust_stats_batch_matches_pallas_kernel(K, with_prev, need_center):
    u, prev, want = _pallas(K)
    before = tkernel.batch_launches
    got = tops.robust_stats_batch(torch.as_tensor(u), prev=_t(prev) if with_prev else None,
                                  need_center=need_center)
    assert tkernel.batch_launches == before              # CPU: plain version
    assert got.dist2.shape == (u.shape[0], K) and got.mednorm2.shape == (u.shape[0],)
    for n in range(u.shape[0]):
        _assert_node(_node(got, n), _node(want, n), with_prev, need_center)
        _assert_masks_and_ties(_node(got, n), _node(want, n), K)


@pytest.mark.parametrize("K", [64, 100, 257, 1024])
@pytest.mark.parametrize("batched", [False, True])
def test_many_candidates_match_reference_oracle(K, batched):
    """The single-matrix and gathered statistics at K far above a warp,
    with prev and the centers, against the JAX oracle (``jnp.sort``)."""
    u, prev = _candidates(2 if batched else 1, K, seed=K + 1)
    if batched:
        got = tops.robust_stats_batch(torch.as_tensor(u), prev=torch.as_tensor(prev))
        nodes = [_node(got, n) for n in range(2)]
    else:
        nodes = [tops.robust_stats(torch.as_tensor(u[0]), prev=torch.as_tensor(prev[0]))]
    for n, g in enumerate(nodes):
        want = jax.tree.map(np.asarray, jrobust_stats_ref(
            jnp.asarray(u[n]), beta=0.1, prev=jnp.asarray(prev[n])))
        _assert_node(g, want, True, True)
        _assert_masks_and_ties(g, want, K)


@pytest.mark.parametrize("K", [33, 64, 100, 257])
def test_pairwise_gram_matches_reference(K):
    """The Gram at K > 32 against the Pallas Gram and the difference-based
    oracle, exactly symmetric with the twin rows tied (G[a,a] == G[a,b] ==
    G[b,b], squared distance exactly 0) as the tiled kernel keeps them."""
    u = models(K, 1000, seed=K)
    a, b = 1, K - 1
    u[b] = u[a]
    jg, jn = jpairwise_gram(jnp.asarray(u))
    before = pkernel.launches
    g, n = pops.pairwise_gram(torch.as_tensor(u))
    assert pkernel.launches == before                    # CPU: plain version
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), rtol=RTOL, atol=ATOL)
    assert torch.equal(g, g.T)
    assert torch.equal(g[a], g[b])
    assert len({float(g[i, j]) for i in (a, b) for j in (a, b)}) == 1
    d2 = pops.pairwise_sq_dists(torch.as_tensor(u))
    assert float(d2[a, b]) == 0.0 and torch.equal(torch.diagonal(d2), torch.zeros(K))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jpairwise_sq_dists(jnp.asarray(u))),
                               rtol=RTOL, atol=2e-3)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jpairwise_dist_ref(jnp.asarray(u))),
                               rtol=1e-4, atol=2e-3)


def test_gram_plan_bounds_the_partials():
    """The tiled path's splits of D share the card's resident CTAs among
    the 64 x 64 tile pairs, so its partials (splits x K^2 floats) stay a
    few MB at any K, where one K^2 row per CTA of the stream would be ~1
    GB at K = 1,024; at K <= 32 the plan is the stream's as before."""
    sms = 132
    assert pkernel.gram_plan(32, 1 << 22, sms) == dict(path="blocked", blocks=2 * sms)
    assert pkernel.gram_plan(7, 37, sms)["blocks"] == 1
    for K, D in ((33, 50890), (100, 50890), (1024, 50890), (1024, 1 << 22), (100, 37)):
        p = pkernel.gram_plan(K, D, sms)
        nt = -(-K // pkernel.TILE_K)
        assert p["path"] == "tiles" and p["tile_pairs"] == nt * (nt + 1) // 2
        assert 1 <= p["blocks"] <= -(-D // pkernel.CHUNK)
        assert p["blocks"] * p["tile_pairs"] < p["tile_pairs"] + 4 * sms
        assert p["blocks"] * K * K * 4 <= 20 << 20, (K, D, p)


def test_wide_plan_arithmetic():
    """The wide path's sort width and tile, as ``csrc/robust_stats.cu``
    computes them: K rounded up to a power of two; the widest power of two
    up to 256 coordinates whose sort buffer fits 64 KB (16 at K = 1,024)."""
    assert [tref.wide_width(K) for K in (33, 64, 65, 100, 257, 1024)] == \
        [64, 64, 128, 128, 512, 1024]
    assert [tref.wide_tile(K) for K in (33, 64, 100, 128, 200, 257, 1024)] == \
        [256, 256, 128, 128, 64, 32, 16]
    assert tkernel.MAX_K == 1024 and tkernel.INDEXED_MAX_K == 1024


@pytest.mark.parametrize("KP", [64, 128, 1024])
def test_bitonic_network_sorts_every_column(KP):
    """The wide path's network sorts every 0/1 column (so, by the 0-1
    principle, every column) and every column of random values with
    repeats, the +inf rows past K staying last."""
    rng = np.random.default_rng(KP)
    x = torch.as_tensor(rng.integers(0, 2, (3, KP, 1024)).astype(np.float32))
    assert torch.equal(tref.bitonic_sort(x), torch.sort(x, dim=1).values)
    K = KP - KP // 3
    y = torch.as_tensor(rng.integers(-9, 9, (2, KP, 257)).astype(np.float32))
    y[:, K:] = torch.inf
    assert torch.equal(tref.bitonic_sort(y), torch.sort(y, dim=1).values)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("with_prev,centers", [(True, True), (False, False)])
def test_kernel_order_matches_pallas_kernel_at_33(with_prev, centers, B):
    """The wide path's order (tiles of 256 coordinates at K = 33, the
    bitonic sort of 64 wires) against the Pallas kernel, on the inputs of
    the K = 33 parity test."""
    u, prev, want = _pallas(33)
    got = tref.robust_stats_kernel_order(torch.as_tensor(u[0]),
                                         _t(prev[0]) if with_prev else None, 0.1, centers,
                                         blocks=B)
    _assert_node(got, _node(want, 0), with_prev, centers, ORDER_RTOL, ORDER_ATOL)
    _assert_masks_and_ties(got, _node(want, 0), 33)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("batched", [False, True])
def test_kernel_order_matches_reference_oracle_at_100(batched, B):
    """At K = 100 (tiles of 128 coordinates, 128 wires) the kernel order
    against the JAX oracle, with prev and the centers, single and
    gathered."""
    K = 100
    u, prev = _candidates(2 if batched else 1, K, seed=7)
    x, p = (u, prev) if batched else (u[0], prev[0])
    got = tref.robust_stats_kernel_order(torch.as_tensor(x), torch.as_tensor(p), 0.1, True,
                                         blocks=B)
    for n in range(u.shape[0]):
        want = jax.tree.map(np.asarray, jrobust_stats_ref(
            jnp.asarray(u[n]), beta=0.1, prev=jnp.asarray(prev[n])))
        g = _node(got, n) if batched else got
        _assert_node(g, want, True, True, ORDER_RTOL, ORDER_ATOL)
        _assert_masks_and_ties(g, want, K)


@pytest.mark.parametrize("K", [33, 100])
def test_kernel_order_nan_and_overflow_rows(K):
    """At K > 32 a NaN value makes its column's centers NaN and, through
    the median, its node's distance sums, as the plain version; a row
    whose squared norm overflows float32 keeps norm2 = +inf without NaN;
    every other value is the plain version's (median bit-equal)."""
    u, prev = _candidates(3, K, seed=K + 5)
    u[1, 3, 17] = np.nan
    u[2, 4] = 3e19
    got = tref.robust_stats_kernel_order(torch.as_tensor(u), torch.as_tensor(prev), 0.1,
                                         True, blocks=2)
    plain = tref.robust_stats_batch_ref(torch.as_tensor(u), torch.as_tensor(prev), 0.1)
    assert torch.isnan(got.med[1, 17]) and torch.isnan(got.trim[1, 17])
    assert torch.isnan(got.med[1]).sum() == 1
    for name in ("dist2", "dotmed", "mednorm2"):
        assert torch.isnan(getattr(got, name)[1]).all(), name
    assert torch.isinf(got.norm2[2, 4]) and not torch.isnan(got.norm2[2]).any()
    assert torch.equal(torch.isnan(got.med), torch.isnan(plain.med))
    keep = [0, 2]
    assert torch.equal(got.med[keep], plain.med[keep])
    for name in ("trim",) + FIELDS:
        g, w = getattr(got, name), getattr(plain, name)
        assert torch.equal(torch.isnan(g), torch.isnan(w)), name
        big = torch.isinf(w)
        assert torch.equal(g[big], w[big]), name
        fin = torch.isfinite(w)
        np.testing.assert_allclose(g[fin].numpy(), w[fin].numpy(), rtol=ORDER_RTOL,
                                   atol=ORDER_ATOL, err_msg=name)


# ------------------------- hypothesis property tests -------------------------
# mirrors of tests/test_kernels.py:99-133 at more than 32 candidates

def _stats_both(u, blocks):
    """The plain version's and the emulated kernel order's statistics."""
    x = torch.as_tensor(u)
    return (tops.robust_stats(x, beta=0.1),
            tref.robust_stats_kernel_order(x, None, 0.1, True, blocks=blocks))


@settings(max_examples=8, deadline=None)
@given(
    K=st.integers(min_value=33, max_value=100),
    D=st.integers(min_value=1, max_value=300),
    seed=st.integers(min_value=0, max_value=2**31 - 1),
)
def test_median_permutation_invariance_many(K, D, seed):
    """Candidate order moves no center and permutes the per-candidate
    statistics with the rows, exactly: the median and trimmed mean read
    sorted columns, and every slot's sum is one expression tree."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((K, D)).astype(np.float32)
    perm = rng.permutation(K)
    for a, b in zip(_stats_both(u, 1 + seed % 3), _stats_both(u[perm], 1 + seed % 3)):
        assert torch.equal(a.med, b.med) and torch.equal(a.trim, b.trim)
        for name in ("dist2", "dotmed", "norm2"):
            assert torch.equal(getattr(a, name)[perm], getattr(b, name)), name


@settings(max_examples=8, deadline=None)
@given(
    K=st.integers(min_value=33, max_value=100),
    seed=st.integers(min_value=0, max_value=2**31 - 1),
    shift=st.floats(min_value=-5.0, max_value=5.0, allow_nan=False),
)
def test_median_translation_equivariance_many(K, seed, shift):
    """median(u + c) == median(u) + c."""
    u = np.random.default_rng(seed).standard_normal((K, 256)).astype(np.float32)
    for a, b in zip(_stats_both(u, 2), _stats_both(u + np.float32(shift), 2)):
        np.testing.assert_allclose(a.med.numpy() + shift, b.med.numpy(), rtol=1e-4,
                                   atol=1e-4)
