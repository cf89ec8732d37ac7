"""Port parity of kernels 1, 2 and 3 above 32 neighbours: the plain
versions of the gossip round (``ops.wfagg_round_indexed_plain``), its
gather-free statistics (``ref.robust_stats_indexed_ref``) and combine
(``weighted_agg.ops.weighted_agg_indexed_plain``), which the CPU takes at
any K and the card's wide routes (K = 33 .. 1,024) are held to, against
the JAX package on the same numpy inputs.

* K = 33 and 40 against the Pallas kernels in interpret mode
  (``robust_stats_indexed``, ``wfagg_round_indexed``,
  ``weighted_agg_indexed``): matrix, ``prev_idx`` and per-edge prev,
  WFAgg-T bands, WFAgg and Alt-WFAgg, an irregular slate with a degree-0
  row and two bit-identical rows.  Each Pallas launch compiles ~10 s at K
  = 33, so each (K, form) is launched once.
* K = 100 and 1,024 against the reference's plain functions
  (``robust_stats_indexed(use_kernel=False)``, the per-node
  ``trust.derive_trust_weights`` and ``weighted_agg_indexed(use_kernel=
  False)``); Clustering at K = 100 (its K - 2 merges are a Python loop in
  the plain version), Multi-Krum at both.
* ``robust_allreduce_stacked(backend="fused")`` (kernel 1 at N = 1) over K
  = 40 candidates against the port's ``reference`` backend over three
  rounds with state.
* The wrappers on CPU tensors take the plain versions at K > 32, and the
  kernels' wrappers refuse K = 1,025 naming ROADMAP queue 2, item E.

Tolerances: statistics rtol = atol = 1e-5 and the Gram rtol 1e-5 / atol
1e-4 (float32 sums in another order, ``test_torch_phase0_order.py``);
masks bit-equal; weights within 1e-6; ``out`` within rtol = atol = 3e-5
(``tests/test_one_launch.py:20``); the combine within 3e-5
(``test_torch_combine_order.py``).  The DFL rounds at a degree above 32
are in ``test_torch_many_neighbours_dfl.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import trust as jtrust
from repro.core import wfagg as jwf
from repro.kernels.robust_stats import ops as jops
from repro.kernels.weighted_agg import ops as jwops
from repro_torch.core import trust
from repro_torch.core import wfagg as twf
from repro_torch.distributed import robust_allreduce as tra
from repro_torch.kernels.robust_stats import kernel as tkernel
from repro_torch.kernels.robust_stats import ops as tops
from repro_torch.kernels.robust_stats import ref as tref
from repro_torch.kernels.weighted_agg import kernel as wkernel
from repro_torch.kernels.weighted_agg import ops as wops

from _torch_fixtures import irregular_slate, models, with_degree_zero

TOL = 1e-5
GRAM_RTOL, GRAM_ATOL = 1e-5, 1e-4
ATOL = 3e-5
COMBINE_TOL = 3e-5
FIELDS = ("dist2", "dotmed", "norm2", "mednorm2", "prev_dist2", "prev_dot",
          "prev_norm2")
MASKS = ("mask_d", "mask_c", "mask_t")


def _inputs(K, D, prev_form, seed, M=None):
    """An irregular slate of N = K + 3 nodes (degrees K - 6 .. K, node 1 of
    degree 0), M model rows with rows 0 and 4 bit-identical (two attackers
    sending one model; every slate reading both ties them), and prev in
    ``prev_form``: None, "matrix", "prev_idx" or "per_edge"."""
    N = K + 3
    idx, valid = with_degree_zero(*irregular_slate(N, K, seed=seed, min_degree=K - 6))
    M = N if M is None else M
    m = models(M, D, seed=seed + 1)
    m[4] = m[0]
    rng = np.random.default_rng(seed + 2)
    prev = pidx = None
    if prev_form in ("matrix", "prev_idx"):
        prev = m + np.float32(0.1) * models(M, D, seed=seed + 3, shift=0.0)
    if prev_form == "prev_idx":
        pidx = rng.integers(0, M, (N, K)).astype(np.int32)
    if prev_form == "per_edge":
        prev = (m[idx] + np.float32(0.1) * rng.standard_normal((N, K, D))).astype(np.float32)
    return idx, valid, m, prev, pidx


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.as_tensor(x)


def _assert_stats(got, want, prev, gram):
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


def _tied(st, idx):
    """Slots reading the bit-identical rows 0 and 4 of one node got
    bit-identical statistics (and Gram rows)."""
    n_tied = 0
    for n in range(idx.shape[0]):
        a, b = np.flatnonzero(idx[n] == 0), np.flatnonzero(idx[n] == 4)
        if len(a) and len(b):
            for name in ("dist2", "dotmed", "norm2"):
                x = getattr(st, name)[n]
                assert x[a[0]] == x[b[0]], (n, name)
            if st.gram is not None:
                assert torch.equal(st.gram[n, a[0]], st.gram[n, b[0]])
            n_tied += 1
    assert n_tied, "no slate read both tied rows"


@pytest.mark.parametrize("K,D,prev_form", [(33, 300, "prev_idx"), (40, 302, "per_edge")])
def test_stats_plain_matches_pallas_kernel(K, D, prev_form):
    idx, valid, m, prev, pidx = _inputs(K, D, prev_form, seed=K + D)
    got = tops.robust_stats_indexed(_t(m), _t(idx), _t(valid), _t(prev), need_gram=True,
                                    prev_idx=_t(pidx))
    want = jops.robust_stats_indexed(_j(m), _j(idx), _j(valid), _j(prev), need_gram=True,
                                     prev_idx=_j(pidx))
    _assert_stats(got, want, prev, True)
    _tied(got, idx)


def _bands(st, N, K, seed):
    """WFAgg-T bands (N, 4, K) around this round's own temporal metrics:
    about 60% of the edges inside by 10% of their metric, the others
    outside by as much, so that no decision sits within float32 rounding
    of a band edge (with thousands of edges, bands jittered at random put
    some within the rounding of the sums' order, where a bit-equal mask
    cannot be asked for; the chip checks report those as near-ties)."""
    rng = np.random.default_rng(seed)
    s, b = np.asarray(st.prev_dist2), np.asarray(st.cosine_to_prev())
    inside = rng.random((N, K)) < 0.6
    lo, hi = np.where(inside, 0.9, 1.1), np.where(inside, 1.1, 1.3)
    return np.stack([s * lo, s * hi, b * lo, b * hi], 1).astype(np.float32)


def _configs(filters, K):
    kw = dict(transient=1, f=1)
    if filters == "alt_wfagg":
        kw.update(distance_filter="multi_krum", similarity_filter="clustering",
                  multi_krum_m=max(1, K // 4))
    return jwf.WFAggConfig(**kw), twf.WFAggConfig(**kw)


def _assert_round(got, want, valid):
    for i, name in enumerate(MASKS):
        assert np.array_equal(got[2 + i].numpy(), np.asarray(want[2 + i])), name
    assert got[4].any() and not got[4][_t(valid)].all()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("K,D,prev_form,filters", [
    (33, 300, "matrix", "wfagg"),
    (40, 302, "per_edge", "alt_wfagg"),
])
def test_round_plain_matches_pallas_kernel(K, D, prev_form, filters):
    idx, valid, m, prev, pidx = _inputs(K, D, prev_form, seed=3 * K + D)
    N = idx.shape[0]
    jcfg, tcfg = _configs(filters, K)
    st = jops.robust_stats_indexed(_j(m), _j(idx), _j(valid), _j(prev), use_kernel=False)
    tbands = _bands(st, N, K, seed=K)
    local = models(N, D, seed=7)
    want = jops.wfagg_round_indexed(_j(local), _j(m), _j(idx), _j(valid), jcfg,
                                    prev=_j(prev), tbands=_j(tbands))
    launches = tkernel.launches
    got = tops.wfagg_round_indexed(_t(local), _t(m), _t(idx), _t(valid), tcfg,
                                   prev=_t(prev), tbands=_t(tbands))
    assert tkernel.launches == launches                 # CPU tensors: the plain version
    _assert_round(got, want, valid)
    np.testing.assert_allclose(got[0].numpy()[1], local[1], rtol=1e-6, atol=1e-6)  # degree 0
    _tied(got[5], idx)


@pytest.mark.parametrize("K", [33, 40])
def test_combine_plain_matches_pallas_kernel(K):
    idx, valid, m, _, _ = _inputs(K, 302, None, seed=K)
    N = idx.shape[0]
    local = models(N, 302, seed=K + 9)
    w = (np.random.default_rng(K).random((N, K)) * valid).astype(np.float32)
    want = jwops.weighted_agg_indexed(_j(local), _j(m), _j(idx), _j(w), alpha=0.8)
    launches = wkernel.indexed_launches
    got = wops.weighted_agg_indexed(_t(local), _t(m), _t(idx), _t(w), alpha=0.8)
    assert wkernel.indexed_launches == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=COMBINE_TOL,
                               atol=COMBINE_TOL)
    assert np.array_equal(got.numpy()[1], local[1])     # all-zero weights keep local


def _reference_round(local, m, idx, valid, jcfg, prev, tbands):
    """The reference's plain round: its oracle statistics, the per-node
    scoring stage and the plain combine."""
    st = jops.robust_stats_indexed(_j(m), _j(idx), _j(valid), _j(prev),
                                   need_gram=jtrust.needs_gram(jcfg), use_kernel=False)
    N, K = idx.shape
    tb = jnp.asarray(tbands.reshape(N, 4, K))
    md, mc, mt, w = jax.vmap(
        lambda s, g, v, b: jtrust.derive_trust_weights(s, g, v, b, jcfg))(
            st._replace(gram=None), st.gram, jnp.asarray(valid, jnp.float32), tb)
    out = jwops.weighted_agg_indexed(_j(local), _j(m), _j(idx), w, alpha=jcfg.alpha,
                                     use_kernel=False)
    return out, w, md, mc, mt, st


@pytest.mark.parametrize("K,D,filters", [
    (100, 64, "wfagg"), (100, 64, "alt_wfagg"), (1024, 40, "wfagg"), (1024, 40, "multi_krum"),
])
def test_plain_versions_match_reference_oracles(K, D, filters):
    """K = 100 and 1,024: the three plain versions against the reference's
    plain functions, with matrix prev and bands."""
    N, M = 3, K + 40
    rng = np.random.default_rng(K)
    m = models(M, D, seed=K)
    m[7] = m[3]
    prev = m + np.float32(0.1) * models(M, D, seed=K + 1, shift=0.0)
    idx = np.stack([rng.choice(M, K, replace=False) for _ in range(N)]).astype(np.int32)
    idx[:, :2] = (3, 7)
    valid = rng.random((N, K)) < 0.9
    valid[:, :2] = True
    valid[1] = False
    if filters == "multi_krum":
        jcfg, tcfg = (c(transient=1, f=1, distance_filter="multi_krum", multi_krum_m=K // 4)
                      for c in (jwf.WFAggConfig, twf.WFAggConfig))
    else:
        jcfg, tcfg = _configs(filters, K)
    st = jops.robust_stats_indexed(_j(m), _j(idx), _j(valid), _j(prev), use_kernel=False)
    tbands = _bands(st, N, K, seed=K + 2).reshape(N, 4 * K)
    local = models(N, D, seed=K + 3)
    want = _reference_round(local, m, idx, valid, jcfg, prev, tbands)
    got = tops.wfagg_round_indexed(_t(local), _t(m), _t(idx), _t(valid), tcfg,
                                   prev=_t(prev), tbands=_t(tbands))
    _assert_round(got, want, valid)
    _assert_stats(got[5], want[5], prev, trust.needs_gram(tcfg))
    stats = tops.robust_stats_indexed(_t(m), _t(idx), _t(valid), _t(prev), need_gram=True)
    _assert_stats(stats, jops.robust_stats_indexed(_j(m), _j(idx), _j(valid), _j(prev),
                                                   need_gram=True, use_kernel=False),
                  prev, True)
    assert torch.equal(stats.gram[:, 0], stats.gram[:, 1])     # the tied rows
    assert (trust.sq_dists_from_gram(stats.gram)[:, 0, 1] == 0).all()


def test_stacked_allreduce_fused_over_40_candidates():
    """The stacked all-reduce's ``fused`` route (the round at N = 1: kernel
    1's plain version on the CPU) over K = 40 candidates against the
    ``reference`` backend, WFAgg and Alt-WFAgg, three rounds with state:
    weights within 3e-5, outputs within rtol 1e-4 / atol 3e-5, masks
    bit-equal, the four attackers rejected by the distance filter."""
    K = 40
    rng = np.random.default_rng(5)
    g = {"w": rng.standard_normal((K, 32, 8)).astype(np.float32),
         "b": rng.standard_normal((K, 100)).astype(np.float32)}
    for k in g:                                     # four attackers sending one model
        g[k][[3, 11, 19, 27]] = -3.0 * g[k][0]
    like = {k: torch.as_tensor(v[0]) for k, v in g.items()}
    for method in ("wfagg", "alt_wfagg"):
        cr = tra.RobustAggConfig(method=method, wfagg=twf.WFAggConfig(f=4, transient=1,
                                                                       window=2),
                                 layout="stacked", backend="reference")
        cf = dataclasses.replace(cr, backend="fused")
        sr, sf = tra.init_tree_agg_state(cr, K, like), tra.init_tree_agg_state(cf, K, like)
        fired = 0
        for r in range(3):
            gr = {k: torch.as_tensor(v + np.float32(0.1 * r)) for k, v in g.items()}
            o_r, sr, i_r = tra.robust_allreduce_stacked(gr, cr, sr)
            o_f, sf, i_f = tra.robust_allreduce_stacked(gr, cf, sf)
            np.testing.assert_allclose(i_f["weights"].numpy(), i_r["weights"].numpy(),
                                       atol=ATOL, err_msg=f"{method} round {r} weights")
            for k in g:
                np.testing.assert_allclose(o_f[k].numpy(), o_r[k].numpy(), rtol=1e-4,
                                           atol=ATOL, err_msg=f"{method} round {r} {k}")
            for m in MASKS:
                assert torch.equal(i_f[m], i_r[m]), (method, r, m)
            assert not i_f["mask_d"][[3, 11, 19, 27]].any()
            fired += int(i_f["mask_t"].sum())
        assert fired, f"{method}: the temporal filter never accepted a candidate"


def test_kernels_refuse_1025_neighbours():
    """The CPU takes any K; the kernels' wrappers refuse K = 1,025 (on the
    card that is the only route) naming where the limit is lifted next."""
    m = torch.as_tensor(models(4, 16, seed=1))
    idx = torch.zeros((1, 1025), dtype=torch.int32)
    v = torch.ones((1, 1025), dtype=torch.bool)
    st = tops.robust_stats_indexed(m, idx)
    assert st.dist2.shape == (1, 1025) and torch.isfinite(st.dist2).all()
    assert tkernel.INDEXED_MAX_K == 1024 and wkernel.MAX_K == 1024
    match = r"K=1025.*\(ROADMAP queue 2, item E\)"
    with pytest.raises(ValueError, match=match):
        tkernel.robust_stats_indexed_cuda(m, idx, v, None, False)
    with pytest.raises(ValueError, match=match):
        tkernel.wfagg_round_indexed_cuda(m[:1], m, idx, v, None, None, twf.WFAggConfig(),
                                         0.8, False)
    with pytest.raises(ValueError, match=match):
        wkernel.weighted_agg_indexed_cuda(torch.ones((1, 1025)), torch.ones(1), m[:1], m, idx)
    with pytest.raises(ValueError, match="combine_plan takes"):
        wkernel.combine_plan(4, 1, 1025, 16)


@pytest.mark.parametrize("M,N,K,D,route", [
    (40, 37, 33, 1 << 20, "staged"), (140, 100, 100, 50890, "staged"),
    (1100, 8, 1024, 50890, "direct"), (8, 8, 1024, 50890, "staged"),
])
def test_combine_plan_above_32(M, N, K, D, route):
    """Kernel 3's plan above 32 slots: staged wherever one node's distinct
    rows fit three stages of the narrowest tile (smaller groups as K grows),
    the direct route where they do not."""
    p = wkernel.combine_plan(M, N, K, D)
    assert p["route"] == route
    if route == "staged":
        assert p["rows"] == min(M, p["group"] * K) + p["group"]
        assert p["smem"] <= wkernel.SMEM_BYTES and p["stages"] >= wkernel.MIN_STAGES
    else:
        assert p["group"] == 1 and p["n_groups"] == N and p["smem"] == 0
        assert wkernel._smem_bytes(min(M, K) + 1, 1, K, 32,
                                   wkernel.MIN_STAGES) > wkernel.SMEM_BYTES
