"""Port parity of the pairwise Gram and the single-node WFAgg-E combine
(the plain versions of ``kernels/pairwise_dist/csrc/pairwise_gram.cu``
and ``kernels/weighted_agg/csrc/weighted_agg.cu``) against the JAX
package's ``pairwise_gram`` / ``pairwise_sq_dists`` / ``weighted_agg``
with their Pallas kernels in interpret mode, and of the oracles
``pairwise_dist_ref`` / ``weighted_agg_ref`` against the JAX oracles.

Tolerances: the Gram is a sum of d = 1000 products of order 1 taken in
another order, within rtol 1e-5 / atol 1e-4; squared distances through
the Gram expansion cancel, so against the difference-based oracle they
hold within atol 2e-3; the combine within 3e-5
(``tests/test_one_launch.py:20``), and exactly ``local`` when every
weight is 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pairwise_dist.ops import pairwise_gram as jpairwise_gram
from repro.kernels.pairwise_dist.ops import pairwise_sq_dists as jpairwise_sq_dists
from repro.kernels.pairwise_dist.ref import pairwise_dist_ref as jpairwise_dist_ref
from repro.kernels.weighted_agg.ops import weighted_agg as jweighted_agg
from repro.kernels.weighted_agg.ref import weighted_agg_ref as jweighted_agg_ref
from repro_torch.core import trust as ttrust
from repro_torch.kernels.pairwise_dist import kernel as pkernel
from repro_torch.kernels.pairwise_dist import ops as pops
from repro_torch.kernels.pairwise_dist.ref import pairwise_dist_ref
from repro_torch.kernels.weighted_agg import kernel as wkernel
from repro_torch.kernels.weighted_agg import ops as wops
from repro_torch.kernels.weighted_agg.ref import weighted_agg_ref

from _torch_fixtures import models

D = 1000
COMBINE_TOL = 3e-5


def _candidates(K, seed):
    u = models(K, D, seed)
    u[K - 1] = u[1]            # two bit-identical rows
    return u


@pytest.mark.parametrize("K", [5, 20, 32])
def test_pairwise_gram_matches_pallas_kernel(K):
    u = _candidates(K, seed=K)
    jg, jn = jpairwise_gram(jnp.asarray(u))
    before = pkernel.launches
    g, n = pops.pairwise_gram(torch.as_tensor(u))
    assert pkernel.launches == before                    # CPU: plain version
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), rtol=1e-5, atol=1e-4)
    # identical rows: identical Gram rows apart from their own two columns
    others = [j for j in range(K) if j not in (1, K - 1)]
    assert torch.equal(g[1, others], g[K - 1, others])
    d2 = pops.pairwise_sq_dists(torch.as_tensor(u))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jpairwise_sq_dists(jnp.asarray(u))),
                               rtol=1e-5, atol=2e-3)
    assert torch.equal(torch.diagonal(d2), torch.zeros(K))
    assert (d2 >= 0).all()


@pytest.mark.parametrize("K,D", [(20, 44426), (7, 37), (32, 1001)])
def test_plain_gram_keeps_twin_rows_tied(K, D):
    """The plain route (the CPU's) at D % 4 != 0 keeps the tie invariant
    that the CUDA kernel keeps by summing every entry in one order: two
    bit-identical rows a, b give G[a,a] == G[a,b] == G[b,b], bit-identical
    Gram rows, equal squared norms and a squared distance of exactly 0
    (``core.trust.sq_dists_from_gram``); against the JAX Gram within the
    module's tolerance."""
    u = models(K, D, seed=K + D)
    a, b = 0, K - 1
    u[b] = u[a]
    before = pkernel.launches
    g, n = pops.pairwise_gram(torch.as_tensor(u))
    assert pkernel.launches == before                    # CPU: plain version
    assert len({float(g[i, j]) for i in (a, b) for j in (a, b)}) == 1
    assert torch.equal(g[a], g[b]) and torch.equal(g, g.T)
    assert float(n[a]) == float(n[b])
    d2 = pops.pairwise_sq_dists(torch.as_tensor(u))
    assert float(d2[a, b]) == 0.0 and float(d2[b, a]) == 0.0
    jg, _ = jpairwise_gram(jnp.asarray(u))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-4)


def test_pairwise_dist_ref_matches_reference_oracle():
    u = _candidates(6, seed=3)
    want = np.asarray(jpairwise_dist_ref(jnp.asarray(u)))
    np.testing.assert_allclose(pairwise_dist_ref(torch.as_tensor(u)).numpy(), want,
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(pops.pairwise_sq_dists(torch.as_tensor(u)).numpy(),
                               want, rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("weights", ["random", "zero", "one_hot", "uniform"])
def test_weighted_agg_matches_pallas_kernel(weights):
    K = 20
    rng = np.random.default_rng(7)
    u = _candidates(K, seed=11)
    local = models(1, D, seed=12)[0]
    w = {"random": rng.random(K), "zero": np.zeros(K),
         "one_hot": np.eye(K)[3] * 0.6,
         "uniform": np.full(K, 0.8)}[weights].astype(np.float32)
    want = np.asarray(jweighted_agg(jnp.asarray(local), jnp.asarray(u),
                                    jnp.asarray(w), alpha=0.8))
    before = wkernel.launches
    got = wops.weighted_agg(torch.as_tensor(local), torch.as_tensor(u),
                            torch.as_tensor(w), alpha=0.8)
    assert wkernel.launches == before                    # CPU: plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=COMBINE_TOL, atol=COMBINE_TOL)
    oracle = weighted_agg_ref(torch.as_tensor(local), torch.as_tensor(u),
                              torch.as_tensor(w), 0.8)
    np.testing.assert_allclose(
        oracle.numpy(), np.asarray(jweighted_agg_ref(jnp.asarray(local), jnp.asarray(u),
                                                     jnp.asarray(w), 0.8)),
        rtol=COMBINE_TOL, atol=COMBINE_TOL)
    if weights == "zero":          # every candidate rejected: keep the anchor
        assert np.array_equal(got.numpy(), local)
        assert np.array_equal(want, local)


def test_limits_and_device_dispatch():
    """A Gram of 33 candidates computes, and so does the gather-free
    combine (kernel 3) over 33 neighbours: on the CPU its plain version
    (the kernel on the card); kernel 3 refuses 1,025 neighbours, naming
    where its limit is lifted next."""
    u = torch.as_tensor(models(33, 64, seed=1))
    g, n = pops.pairwise_gram(u)
    assert g.shape == (33, 33) and torch.equal(g, g.T)
    idx = torch.arange(33, dtype=torch.int32).repeat(2, 1)
    w = torch.rand((2, 33), generator=torch.Generator().manual_seed(2))
    got = wops.weighted_agg_indexed(u[:2], u, idx, w)
    wvec, lcoef = ttrust.combine_coefficients(w, 0.8)
    assert torch.equal(got, wops.weighted_agg_indexed_plain(wvec, lcoef, u[:2], u, idx))
    with pytest.raises(ValueError, match=r"K=1025.*\(ROADMAP queue 2, item E\)"):
        wkernel.weighted_agg_indexed_cuda(torch.ones((1, 1025)), torch.ones(1), u[:1], u,
                                          torch.zeros((1, 1025), dtype=torch.int32))
    with pytest.raises(ValueError, match="cuda or cpu"):
        pops.pairwise_gram(u[:4].to("meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pkernel.pairwise_gram_cuda(u[:4])
    with pytest.raises(ValueError, match="updates"):
        wops.weighted_agg(u[0], u[:4], torch.ones(3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        wkernel.weighted_agg_cuda(torch.ones(4), torch.ones(1), u[0], u[:4])
