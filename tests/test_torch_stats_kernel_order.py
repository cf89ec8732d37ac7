"""Port parity of the order of the CUDA kernels 4 and 5
(``kernels/robust_stats/csrc/robust_stats.cu``), emulated in plain
PyTorch by ``ref.robust_stats_kernel_order``, against the JAX package's
``robust_stats`` and ``robust_stats_batch`` (their Pallas kernels in
interpret mode) on the same numpy inputs.

The order: B CTAs per node split D into 256-coordinate tiles, CTA b taking
tiles b, b + B, ...; each coordinate's K values through an odd-even merge
network of fmin / fmax with a NaN flag; per slot, each lane adds eight
coordinates of a tile, each term the float32 value the plain version
forms, into float32 running sums, the lanes by an xor butterfly;
mednorm2 per thread; then the CTAs in block order.  Shapes: K in {7, 8,
16, 20, 32} (7 padded to 8; 20 the CFL server's), D below a tile, D % 4
== 2 (the paper's d = 44,426 has it; kernel 4 copies 8 bytes there) and
several tiles, with and without prev and the centers, B in {1, 3}.

Tolerances: the median bit-equal (a selection); the trimmed mean and the
statistics rtol 1e-4 / atol 1e-3, the statistics' tolerance of the chip
check (float32 sums in another order).  Bit-identical candidates keep
bit-identical sums, a NaN makes its column's centers and its node's sums
NaN, and a row whose squared norm overflows float32 keeps norm2 = +inf
with no NaN, as the plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.robust_stats import ops as jops
from repro_torch.kernels.robust_stats import ref as tref

from _torch_fixtures import models

RTOL, ATOL = 1e-4, 1e-3
FIELDS = ("dist2", "dotmed", "norm2", "mednorm2", "prev_dist2", "prev_dot",
          "prev_norm2")


def _candidates(N, K, D, seed):
    """(u (N, K, D), prev): rows 1 and K-1 of every node bit-identical (two
    attackers sending one model), their prev rows too."""
    u = models(N * K, D, seed).reshape(N, K, D)
    u[:, K - 1] = u[:, 1]
    prev = u + np.float32(0.2) * models(N * K, D, seed + 100, shift=0.0).reshape(N, K, D)
    prev[:, K - 1] = prev[:, 1]
    return u, prev


# (K, D, B, prev, centers, N): N None is kernel 4's single matrix
CASES = [
    (7, 200, 1, True, True, None),      # below a tile, K padded to 8
    (7, 1002, 3, False, False, 2),      # D % 4 == 2, 4 tiles over 3 CTAs
    (8, 1002, 3, True, False, 3),       # the paper's K
    (8, 1536, 1, False, True, None),    # 6 whole tiles, one CTA
    (16, 1536, 3, False, True, 2),      # 6 whole tiles over 3 CTAs
    (16, 1002, 3, True, True, None),
    (20, 1002, 3, True, False, None),   # the CFL server's K
    (20, 200, 1, False, True, 2),
    (32, 2050, 3, True, True, None),    # 9 tiles over 3 CTAs, D % 4 == 2
    (32, 600, 1, False, False, 2),
]


@pytest.mark.parametrize("K,D,B,with_prev,centers,N", CASES)
def test_kernel_order_matches_pallas_kernel(K, D, B, with_prev, centers, N):
    u, prev = _candidates(N or 1, K, D, seed=K + D)
    if N is None:
        u, prev = u[0], prev[0]
    p = prev if with_prev else None
    got = tref.robust_stats_kernel_order(torch.as_tensor(u),
                                         None if p is None else torch.as_tensor(p),
                                         0.1, centers, blocks=B)
    jfn = jops.robust_stats if N is None else jops.robust_stats_batch
    want = jfn(jnp.asarray(u), None if p is None else jnp.asarray(p), beta=0.1,
               need_center=centers)
    if centers:
        np.testing.assert_array_equal(got.med.numpy(), np.asarray(want.med))
        np.testing.assert_allclose(got.trim.numpy(), np.asarray(want.trim),
                                   rtol=RTOL, atol=ATOL)
    else:
        assert got.med is None and got.trim is None
    for name in FIELDS:
        g = getattr(got, name)
        if not with_prev and name.startswith("prev"):
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("K", [7, 8, 16, 20, 32])
def test_network_sorts_every_column(K):
    """The compare-exchanges of the kernel's median network (the same loops
    as ``odd_even_sort`` in the CUDA source, padding wires dropped) sort
    every 0/1 column of K wires (so, by the 0-1 principle, every column),
    with fewer compare-exchanges than the padded bitonic network."""
    if K <= 20:
        x = (np.arange(2 ** K)[:, None] >> np.arange(K)) & 1
    else:
        x = np.random.default_rng(K).integers(0, 2, (1 << 18, K))
    w = [x[:, i].copy() for i in range(K)]
    pairs = tref.network_pairs(K)
    for lo, hi in pairs:
        assert lo < hi < K
        w[lo], w[hi] = np.minimum(w[lo], w[hi]), np.maximum(w[lo], w[hi])
    assert (np.diff(np.stack(w, 1), axis=1) >= 0).all()
    kp = 8 if K <= 8 else 16 if K <= 16 else 32
    lg = kp.bit_length() - 1
    assert len(pairs) < kp // 2 * lg * (lg + 1) // 2


@pytest.mark.parametrize("K,D,B", [(7, 1002, 3), (20, 1002, 3), (32, 2050, 3)])
def test_kernel_order_keeps_ties(K, D, B):
    """Two bit-identical rows get bit-identical sums, whichever warp owns
    them; a row equal to its prev row gets prev_dist2 == 0 and prev_dot ==
    norm2 == prev_norm2 (a cosine of exactly 1)."""
    u, prev = _candidates(2, K, D, seed=K)
    prev[:, 2] = u[:, 2]
    st = tref.robust_stats_kernel_order(torch.as_tensor(u), torch.as_tensor(prev), 0.1,
                                        False, blocks=B)
    for name in FIELDS[:3] + FIELDS[4:]:
        x = getattr(st, name)
        assert torch.equal(x[:, 1], x[:, K - 1]), name
    assert (st.prev_dist2[:, 2] == 0).all()
    assert torch.equal(st.prev_dot[:, 2], st.norm2[:, 2])
    assert torch.equal(st.prev_norm2[:, 2], st.norm2[:, 2])
    assert (st.cosine_to_prev()[:, 2] == 0).all()


@pytest.mark.parametrize("K", [8, 20])
def test_kernel_order_nan_row(K):
    """A NaN value makes its column's median and trimmed mean NaN, as the
    Pallas kernel's NaN-propagating network does, and through the median
    every sum of its node; the other columns and nodes are the plain
    version's (median bit-equal)."""
    D = 1002
    u, prev = _candidates(3, K, D, seed=5)
    u[1, 3, 17] = np.nan
    got = tref.robust_stats_kernel_order(torch.as_tensor(u), torch.as_tensor(prev), 0.1,
                                         True, blocks=3)
    plain = tref.robust_stats_batch_ref(torch.as_tensor(u), torch.as_tensor(prev), 0.1)
    want = jops.robust_stats_batch(jnp.asarray(u), jnp.asarray(prev), need_center=True)
    assert np.isnan(np.asarray(want.med)[1, 17])
    for med in (got.med, got.trim, plain.med):
        assert torch.isnan(med[1, 17])
        assert torch.isnan(med).sum() == 1
    for name in ("dist2", "dotmed", "mednorm2"):
        assert torch.isnan(getattr(got, name)[1]).all(), name
    assert torch.isnan(got.norm2[1, 3]) and torch.isnan(got.prev_dot[1, 3])
    keep = [0, 2]
    assert torch.equal(got.med[keep], plain.med[keep])
    for name in ("trim",) + FIELDS:
        g, w = getattr(got, name), getattr(plain, name)
        assert torch.equal(torch.isnan(g), torch.isnan(w)), name
        np.testing.assert_allclose(g[keep].numpy(), w[keep].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_kernel_order_overflow_stays_inf():
    """A candidate row whose squared norm overflows float32 (a corrupt
    payload) has norm2 = +inf as in the plain version, not NaN: its float32
    terms overflow to +inf as the plain version's do."""
    K, D = 20, 1002
    u, prev = _candidates(1, K, D, seed=9)
    u[0, 4] = 3e19
    got = tref.robust_stats_kernel_order(torch.as_tensor(u[0]), torch.as_tensor(prev[0]),
                                         0.1, True, blocks=3)
    plain = tref.robust_stats_ref(torch.as_tensor(u[0]), 0.1, torch.as_tensor(prev[0]))
    for name in ("med", "trim") + FIELDS:
        g, w = getattr(got, name), getattr(plain, name)
        assert not torch.isnan(g).any(), name
        big = ~torch.isfinite(w)
        assert torch.equal(g[big], w[big]), name
        np.testing.assert_allclose(g[~big].numpy(), w[~big].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert torch.isinf(got.norm2[4]) and torch.isinf(got.dist2[4])
    assert torch.isfinite(got.norm2[torch.arange(K) != 4]).all()
