"""Port parity of the summation order of the CUDA kernels 1 and 2
(``kernels/robust_stats/csrc/indexed_phase0.cuh``), emulated in plain
PyTorch by ``ref.robust_stats_indexed_kernel_order``, against the JAX
package's ``robust_stats_indexed`` and ``wfagg_round_indexed`` (their
Pallas kernels in interpret mode) on the same numpy inputs.

The order: a cluster of C CTAs per node splits D into 256-coordinate
tiles, rank r taking tiles r, r + C, ...; per slot, each lane adds eight
coordinates of a tile, each term the float32 value the plain version
forms, into running float64 sums, the lanes by an xor butterfly; mednorm2 per thread; the Gram
in 4 x 4 register blocks over S slices of the tile; then the ranks in
order.  Shapes: D % 4 == 2 (as the paper's d = 44,426; the kernels' copies
narrow to 8 bytes), tile counts C does not divide, K = 7 (padded to 8) and
K = 32 (the largest, 36 block pairs in 7 slices).

Tolerances: statistics rtol = atol = 1e-5 and the Gram rtol 1e-5 / atol
1e-4, float32 sums in another order (``test_torch_robust_stats.py``,
``test_torch_gram_combine.py``); the round's masks bit-equal and ``out``
within rtol = atol = 3e-5 (``tests/test_one_launch.py:20``).  Bit-identical
candidates keep bit-identical statistics and Gram rows, and a row whose
squared norm overflows float32 keeps norm2 = +inf, as the plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import trust as jtrust
from repro.core import wfagg as jwf
from repro.kernels.robust_stats import ops as jops
from repro_torch.core import trust
from repro_torch.core import wfagg as twf
from repro_torch.kernels.robust_stats import ref as tref
from repro_torch.kernels.weighted_agg.ops import weighted_agg_indexed_plain

from _torch_fixtures import irregular_slate, models, ring_slate, with_degree_zero

TOL = 1e-5
GRAM_RTOL, GRAM_ATOL = 1e-5, 1e-4
ATOL = 3e-5
FIELDS = ("dist2", "dotmed", "norm2", "mednorm2", "prev_dist2", "prev_dot",
          "prev_norm2")
MASKS = ("mask_d", "mask_c", "mask_t")


def _inputs(K, D, prev_form, seed):
    """A slate with a degree-0 row, models, and prev in ``prev_form``:
    None, "matrix" (through the table), "prev_idx" or "per_edge"."""
    N = max(9, K + 2)
    idx, valid = with_degree_zero(*irregular_slate(N, K, seed=seed, min_degree=1))
    m = models(N, D, seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    prev = pidx = None
    if prev_form in ("matrix", "prev_idx"):
        prev = models(N, D, seed=seed + 3, shift=0.1)
    if prev_form == "prev_idx":
        pidx = rng.integers(0, N, (N, K)).astype(np.int32)
    if prev_form == "per_edge":
        prev = rng.standard_normal((N, K, D)).astype(np.float32)
    return idx, valid, m, prev, pidx


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.as_tensor(x)


# (K, D, cluster, prev form, Gram): D % 4 == 2 with 4 tiles over 3 ranks,
# 9 tiles over 8 ranks, 3 tiles over 2, and D a whole number of tiles
STATS_CASES = [
    (7, 1002, 3, "matrix", True),
    (32, 1002, 3, "prev_idx", True),
    (32, 2050, 8, "per_edge", False),
    (16, 602, 2, None, True),
    (8, 512, 1, "matrix", False),
]


@pytest.mark.parametrize("K,D,C,prev_form,gram", STATS_CASES)
def test_kernel_order_stats_match_reference(K, D, C, prev_form, gram):
    idx, valid, m, prev, pidx = _inputs(K, D, prev_form, seed=K + D)
    got = tref.robust_stats_indexed_kernel_order(_t(m), _t(idx), _t(valid), _t(prev),
                                                 gram, _t(pidx), cluster=C)
    want = jops.robust_stats_indexed(_j(m), _j(idx), _j(valid), _j(prev),
                                     need_gram=gram, prev_idx=_j(pidx))
    for name in FIELDS:
        g = getattr(got, name)
        if prev is None and name.startswith("prev"):
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)
    if gram:
        assert torch.equal(got.gram, got.gram.transpose(1, 2))
        np.testing.assert_allclose(got.gram.numpy(), np.asarray(want.gram),
                                   rtol=GRAM_RTOL, atol=GRAM_ATOL)
    else:
        assert got.gram is None


def _round_in_kernel_order(local, m, idx, valid, cfg, prev, tbands, pidx, C):
    """The round kernel's outputs from the statistics in its order: its
    epilogue is ``derive_trust_weights`` operation for operation, then the
    combine."""
    st = tref.robust_stats_indexed_kernel_order(m, idx, valid, prev, trust.needs_gram(cfg),
                                                pidx, cluster=C)
    mask_d, mask_c, mask_t, w = trust.derive_trust_weights(st, valid, tbands, cfg)
    wcomb, lcoef = trust.combine_coefficients(w, cfg.alpha)
    return weighted_agg_indexed_plain(wcomb, lcoef, local, m, idx), w, mask_d, mask_c, mask_t


@pytest.mark.parametrize("K,D,C,prev_form,filters", [
    (7, 1002, 3, "matrix", "alt_wfagg"),
    (32, 1002, 3, "prev_idx", "wfagg"),
    (16, 2050, 8, "per_edge", "alt_wfagg"),
])
def test_kernel_order_round_matches_pallas_kernel(K, D, C, prev_form, filters):
    idx, valid, m, prev, pidx = _inputs(K, D, prev_form, seed=3 * K + D)
    N = idx.shape[0]
    kw = dict(transient=1, f=1)
    if filters == "alt_wfagg":
        kw.update(distance_filter="multi_krum", similarity_filter="clustering",
                  multi_krum_m=2)
    jcfg, tcfg = jwf.WFAggConfig(**kw), twf.WFAggConfig(**kw)
    # bands around this round's own temporal metrics: mask_t accepts and rejects
    st = jops.robust_stats_indexed(_j(m), _j(idx), _j(valid), _j(prev),
                                   prev_idx=_j(pidx), use_kernel=False)
    rng = np.random.default_rng(1)
    jit = lambda x: (np.asarray(x)[:, None, :] * (  # noqa: E731
        1 + 0.05 * rng.standard_normal((N, 3, K)))).astype(np.float32)
    tbands = np.array(jax.vmap(lambda hs, hb: jtrust.temporal_bands(
        hs, hb, jnp.int32(3), jnp.int32(5), jcfg))(
            jnp.asarray(jit(st.prev_dist2)), jnp.asarray(jit(st.cosine_to_prev()))))
    local = models(N, D, seed=7)
    want = jops.wfagg_round_indexed(_j(local), _j(m), _j(idx), _j(valid), jcfg,
                                    prev=_j(prev), tbands=_j(tbands), prev_idx=_j(pidx))
    got = _round_in_kernel_order(_t(local), _t(m), _t(idx), _t(valid), tcfg, _t(prev),
                                 _t(tbands.reshape(N, 4 * K)), _t(pidx), C)
    for i, name in enumerate(MASKS):
        assert np.array_equal(got[2 + i].numpy(), np.asarray(want[2 + i])), name
    assert got[4].any() and not got[4][_t(valid)].all()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("K,D,C", [(7, 1002, 3), (20, 44426, 8), (32, 1003, 8)])
def test_kernel_order_keeps_ties(K, D, C):
    """Two slots reading one row, and two bit-identical rows, get
    bit-identical statistics and Gram rows, G[a,a] == G[a,b] == G[b,b],
    and a squared distance of exactly 0 (Multi-Krum's distances from the
    Gram); a row re-served as its own prev gets prev_dist2 == 0 and
    prev_dot == norm2 == prev_norm2, a cosine of exactly 1 (WFAgg-T's
    zero-width bands rely on it); at D % 4 != 0 and C ranks that do not
    divide the tiles."""
    N = 6
    rng = np.random.default_rng(K)
    m = models(N, D, seed=K + 1)
    m[4] = m[0]                                      # two bit-identical rows
    idx = rng.integers(0, N, (N, K)).astype(np.int32)
    idx[:, 1] = 2                                    # one row read twice
    idx[:, K - 1] = 2
    idx[:, 2], idx[:, 3] = 0, 4
    prev = models(N, D, seed=K + 2, shift=0.1)
    prev[2] = m[2]                                   # row 2 re-served unchanged
    st = tref.robust_stats_indexed_kernel_order(_t(m), _t(idx), None, _t(prev), True,
                                                cluster=C)
    assert (st.prev_dist2[:, 1] == 0).all()
    assert torch.equal(st.prev_dot[:, 1], st.norm2[:, 1])
    assert torch.equal(st.prev_norm2[:, 1], st.norm2[:, 1])
    assert (st.cosine_to_prev()[:, 1] == 0).all()
    for a, b in ((1, K - 1), (2, 3)):
        for name in ("dist2", "dotmed", "norm2"):
            x = getattr(st, name)
            assert torch.equal(x[:, a], x[:, b]), (a, b, name)
        g = st.gram
        others = [j for j in range(K) if j not in (a, b)]
        assert torch.equal(g[:, a, others], g[:, b, others])
        assert torch.equal(g[:, a, a], g[:, a, b]) and torch.equal(g[:, a, b], g[:, b, b])
        assert (trust.sq_dists_from_gram(g)[:, a, b] == 0).all()
    assert torch.equal(st.gram, st.gram.transpose(1, 2))


def test_kernel_order_overflow_stays_inf():
    """A candidate row whose squared norm overflows float32 (a corrupt
    payload) has norm2 = +inf as in the plain version, not NaN: its float32
    terms overflow to +inf as the plain version's do; the other slots' sums
    are the plain version's within the tolerance."""
    N, K, D = 5, 7, 1002
    m = models(N, D, seed=3)
    m[1] = 3e19                                      # (3e19)^2 D overflows
    idx = ring_slate(N, K % N + 2)
    st = tref.robust_stats_indexed_kernel_order(_t(m), _t(idx), None, None, True,
                                                cluster=3)
    plain = tref.robust_stats_indexed_ref(_t(m), _t(idx), None, None, True)
    big = _t(idx) == 1
    assert torch.isinf(st.norm2[big]).all() and torch.isinf(plain.norm2[big]).all()
    assert not torch.isnan(st.norm2).any()
    np.testing.assert_allclose(st.norm2[~big].numpy(), plain.norm2[~big].numpy(),
                               rtol=TOL, atol=TOL)
