"""Port parity of the single-matrix robust statistics (the plain version of
``kernels/robust_stats/csrc/robust_stats.cu``) against the JAX package's
``robust_stats`` with its Pallas kernel in interpret mode, and of the
oracle ``robust_stats_ref`` against the JAX oracle.

The same numpy candidates go to both, at K in {3, 7, 20, 32} (20 is the
CFL server's K), with and without ``prev``, with ``need_center`` both
ways, and with two bit-identical rows (two attackers sending one model).
The median is a selection and must be bit-equal; the trimmed mean and the
statistics are sums taken in another order, within rtol 1e-5 / atol 1e-4
(d = 300, values of order 1); the WFAgg-D and WFAgg-C masks derived from
them, with their index tie-break, must be bit-equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import trust as jtrust
from repro.core.wfagg import WFAggConfig as JConfig
from repro.kernels.robust_stats.ops import robust_stats as jrobust_stats
from repro.kernels.robust_stats.ref import robust_stats_ref as jrobust_stats_ref
from repro_torch.core import trust as ttrust
from repro_torch.core.wfagg import WFAggConfig as TConfig
from repro_torch.kernels.robust_stats import kernel as tkernel
from repro_torch.kernels.robust_stats import ops as tops
from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref
from repro_torch.kernels.robust_stats.ref import robust_stats_ref as trobust_stats_ref

from _torch_fixtures import models

RTOL, ATOL = 1e-5, 1e-4
D = 300
FIELDS = ("dist2", "dotmed", "norm2", "mednorm2", "prev_dist2", "prev_dot",
          "prev_norm2")


def _candidates(K, seed):
    """(u, prev): rows 1 and K-1 bit-identical, a few repeated values in
    every column so the sort meets ties too."""
    u = models(K, D, seed)
    if K >= 3:
        u[K - 1] = u[1]
    u[0, ::7] = u[K // 2, ::7]
    prev = u + np.float32(0.2) * models(K, D, seed + 100, shift=0.0)
    return u, prev


def _assert_stats(got, want, need_center):
    if need_center:
        np.testing.assert_array_equal(got.med.numpy(), np.asarray(want.med))
        np.testing.assert_allclose(got.trim.numpy(), np.asarray(want.trim),
                                   rtol=RTOL, atol=ATOL)
    else:
        assert got.med is None and got.trim is None
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("need_center", [True, False])
@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("K", [3, 7, 20, 32])
def test_robust_stats_matches_pallas_kernel(K, with_prev, need_center):
    u, prev = _candidates(K, seed=K)
    p = prev if with_prev else None
    want = jrobust_stats(jnp.asarray(u), prev=None if p is None else jnp.asarray(p),
                         need_center=need_center)
    before = tkernel.robust_stats_launches
    got = tops.robust_stats(torch.as_tensor(u),
                            prev=None if p is None else torch.as_tensor(p),
                            need_center=need_center)
    assert tkernel.robust_stats_launches == before      # CPU: plain version
    _assert_stats(got, want, need_center)
    if K >= 3:   # the identical rows got identical sums
        for name in ("dist2", "dotmed", "norm2"):
            v = getattr(got, name)
            assert torch.equal(v[1], v[K - 1]), name
    # the filter masks of the fused single-node path, with their tie-break
    jcfg, tcfg = JConfig(f=1), TConfig(f=1)
    for jfn, tfn in ((jtrust.fused_distance_mask, ttrust.fused_distance_mask),
                     (jtrust.fused_similarity_mask, ttrust.fused_similarity_mask)):
        np.testing.assert_array_equal(tfn(got, None, tcfg).numpy(),
                                      np.asarray(jfn(want, None, jcfg)))


@pytest.mark.parametrize("K", [4, 7])
def test_robust_stats_ref_matches_reference_oracle(K):
    u, prev = _candidates(K, seed=40 + K)
    want = jrobust_stats_ref(jnp.asarray(u), beta=0.25, prev=jnp.asarray(prev))
    got = trobust_stats_ref(torch.as_tensor(u), beta=0.25, prev=torch.as_tensor(prev))
    _assert_stats(got, want, need_center=True)
    # the plain version agrees with the oracle on finite inputs
    plain = tops.robust_stats_plain(torch.as_tensor(u), torch.as_tensor(prev), beta=0.25)
    for name in ("med", "trim") + FIELDS:
        assert torch.equal(getattr(plain, name), getattr(got, name)), name


def test_nan_column_propagates_like_the_pallas_network():
    """A NaN candidate makes its column's median and trimmed mean NaN, as
    the Pallas kernel's jnp.minimum/maximum network does; the other
    columns stay finite and equal."""
    u, _ = _candidates(9, seed=3)
    u[4, 17] = np.nan
    want = jax.device_get(jrobust_stats(jnp.asarray(u)))
    got = tops.robust_stats(torch.as_tensor(u))
    med, trim = got.med.numpy(), got.trim.numpy()
    assert np.isnan(med[17]) and np.isnan(trim[17])
    assert np.isnan(np.asarray(want.med)[17])
    keep = np.arange(D) != 17
    np.testing.assert_array_equal(med[keep], np.asarray(want.med)[keep])
    np.testing.assert_allclose(trim[keep], np.asarray(want.trim)[keep],
                               rtol=RTOL, atol=ATOL)
    assert np.isnan(got.mednorm2.item()) and np.isnan(float(want.mednorm2))


def test_limits_and_device_dispatch():
    """More than 32 candidates compute (the plain version on the CPU; the
    kernel's wide path on the card), and so do the gather-free statistics
    of the gossip round (on the CPU their plain version, kernel 2's wide
    route on the card); kernel 2 refuses 1,025 neighbours, naming where its
    limit is lifted next."""
    u = torch.as_tensor(models(33, 64, seed=1))
    st = tops.robust_stats(u)
    assert st.dist2.shape == (33,) and torch.isfinite(st.med).all()
    idx = torch.arange(33, dtype=torch.int32).repeat(2, 1)
    got = tops.robust_stats_indexed(u, idx, need_gram=True)
    want = robust_stats_indexed_ref(u, idx, None, None, need_gram=True)
    for name in ("dist2", "dotmed", "norm2", "mednorm2", "gram"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    with pytest.raises(ValueError, match=r"K=1025 \(ROADMAP queue 2, item E\)"):
        tkernel.robust_stats_indexed_cuda(u, torch.zeros((1, 1025), dtype=torch.int32),
                                          torch.ones((1, 1025), dtype=torch.bool), None,
                                          False)
    with pytest.raises(ValueError, match="prev has shape"):
        tops.robust_stats(u[:4], prev=u[:3])
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.robust_stats(u[:4].to("meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.robust_stats_cuda(u[:4], None, 0.1, True)
