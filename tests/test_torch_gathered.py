"""The port's gathered gossip form against the JAX package: the batched
statistics (the plain version of kernel 5, ``robust_stats_batch``), the
gathered ``wfagg_batch`` with per-edge WFAgg-T state, and the indexed
kernels fed that per-edge state.

* ``robust_stats_batch`` against JAX ``robust_stats_batch`` with its Pallas
  kernel in interpret mode and with its plain oracle, for K in {5, 8},
  with and without a per-edge ``prev`` and the centers, every node holding
  two bit-identical rows: the median is a selection and must be
  bit-equal; the trimmed mean and the sums are taken in another order,
  within rtol 1e-5 / atol 1e-4 (``test_torch_robust_stats_single.py``'s
  tolerance, values of order 1, d = 300); identical rows get identical
  sums.  A NaN row makes its node's median NaN in every column, as the
  Pallas network does, and leaves the other nodes bit-equal.
* The gathered ``wfagg_batch`` (WFAgg and Alt-WFAgg, ``reference`` and
  ``fused``) over 3 rounds with the per-edge state carried: masks
  bit-equal to JAX's, outputs within 3e-5 (``tests/test_one_launch.py:20``),
  the ring buffers within 1e-4.
* The indexed kernels with a per-edge ``prev``: statistics equal to the
  gathered batch's (as ``test_indexed_gossip.py::test_indexed_stats_match_
  gathered_batch[edge]``), the round bit-identical to the matrix-``prev``
  launch that reads the same rows, the indexed ``wfagg_batch`` with
  per-edge state equal to the matrix state on every backend (as
  ``::test_wfagg_batch_indexed_edge_state_matches_matrix_state``), to the
  gathered path, and to the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wfagg as jwf
from repro.kernels.robust_stats.ops import robust_stats_batch as jrobust_stats_batch
from repro.kernels.robust_stats.ops import robust_stats_indexed as jrobust_stats_indexed
from repro_torch.core import trust as ttrust
from repro_torch.core import wfagg as twf
from repro_torch.kernels.robust_stats import kernel as tkernel
from repro_torch.kernels.robust_stats import ops as tops

from _torch_fixtures import models, ring_slate

RTOL, ATOL = 1e-5, 1e-4       # sums in another order (values of order 1)
OUT_ATOL = 3e-5               # tests/test_one_launch.py:20
HIST_TOL = 1e-4               # the ring buffers hold those sums
FIELDS = ("dist2", "dotmed", "norm2", "mednorm2", "prev_dist2", "prev_dot",
          "prev_norm2")
MASKS = ("mask_d", "mask_c", "mask_t")


def _gathered(N, K, d, seed):
    """(u, prev), each (N, K, d): in every node rows 1 and K-1 bit-identical
    (two attackers sending one model, with one previous model), and a few
    repeated values in every column so the sort meets ties too."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((N, K, d)).astype(np.float32) + np.float32(0.3)
    u[:, K - 1] = u[:, 1]
    u[:, 0, ::7] = u[:, K // 2, ::7]
    prev = u + np.float32(0.2) * rng.standard_normal((N, K, d)).astype(np.float32)
    prev[:, K - 1] = prev[:, 1]
    return u, prev


def _t(x):
    return None if x is None else torch.as_tensor(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _assert_stats(got, want, fields=FIELDS, centers=True):
    if centers:
        np.testing.assert_array_equal(got.med.numpy(), np.asarray(want.med))
        np.testing.assert_allclose(got.trim.numpy(), np.asarray(want.trim),
                                   rtol=RTOL, atol=ATOL)
    for name in fields:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the batched statistics: the plain version of kernel 5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("need_center", [True, False])
@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("K", [5, 8])
def test_robust_stats_batch_matches_pallas_kernel_and_oracle(K, with_prev, need_center):
    N, d = 4, 300
    u, prev = _gathered(N, K, d, seed=K)
    p = prev if with_prev else None
    before = tkernel.batch_launches
    got = tops.robust_stats_batch(_t(u), _t(p), need_center=need_center)
    assert tkernel.batch_launches == before          # CPU tensors: plain version
    kern = jrobust_stats_batch(_j(u), _j(p), need_center=need_center)
    _assert_stats(got, kern, centers=need_center)
    if not need_center:
        assert got.med is None and got.trim is None
    # the reference's oracle (it always returns the centers)
    oracle = jrobust_stats_batch(_j(u), _j(p), need_center=need_center,
                                 use_kernel=False)
    _assert_stats(got, oracle, centers=need_center)
    assert got.mednorm2.shape == (N,) and got.dist2.shape == (N, K)
    for name in ("dist2", "dotmed", "norm2") + (FIELDS[4:] if with_prev else ()):
        v = getattr(got, name)
        assert torch.equal(v[:, 1], v[:, K - 1]), name     # tied rows, tied sums
    # the filter masks of the gathered fused path, with their tie-break
    cfg = twf.WFAggConfig(f=1)
    for fn in (ttrust.fused_distance_mask, ttrust.fused_similarity_mask):
        rows = torch.stack([fn(tops.robust_stats(_t(u[n]), _t(None if p is None
                                                                else p[n]),
                                                 need_center=False), None, cfg)
                            for n in range(N)])
        assert torch.equal(fn(got, None, cfg), rows)


def test_robust_stats_batch_nan_row_propagates_like_the_pallas_network():
    """A NaN row makes its node's median and trimmed mean NaN in every
    column, as the Pallas kernel's jnp.minimum/maximum network does (the
    reference's jnp.sort oracle sorts it last and stays finite); the other
    nodes are untouched and bit-equal."""
    N, K, d = 3, 5, 300
    u, _ = _gathered(N, K, d, seed=9)
    u[1, 2] = np.nan
    want = jax.device_get(jrobust_stats_batch(_j(u)))
    got = tops.robust_stats_batch(_t(u))
    assert torch.isnan(got.med[1]).all() and torch.isnan(got.trim[1]).all()
    assert np.isnan(want.med[1]).all() and np.isnan(want.trim[1]).all()
    assert torch.isnan(got.dist2[1]).all() and torch.isnan(got.mednorm2[1])
    assert np.isnan(want.dist2[1]).all() and np.isnan(want.mednorm2[1])
    keep = np.array([0, 2])
    np.testing.assert_array_equal(got.med.numpy()[keep], want.med[keep])
    for name in ("trim", "dist2", "dotmed", "norm2", "mednorm2"):
        np.testing.assert_allclose(getattr(got, name).numpy()[keep],
                                   np.asarray(getattr(want, name))[keep],
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert np.isfinite(np.asarray(jrobust_stats_batch(_j(u), use_kernel=False).med[1])).all()


def test_robust_stats_batch_limits_and_device_dispatch():
    """A gathered slate of 33 computes, and so does the round of the
    indexed form at degree 33 (on the CPU its plain version, the round
    kernel's wide route on the card); the round kernel refuses 1,025
    neighbours, naming where its limit is lifted next."""
    u = torch.as_tensor(_gathered(2, 33, 64, seed=1)[0])
    st = tops.robust_stats_batch(u)
    assert st.dist2.shape == (2, 33) and torch.isfinite(st.dist2).all()
    idx = torch.arange(33, dtype=torch.int32).repeat(2, 1)
    cfg = twf.WFAggConfig()
    got = tops.wfagg_round_indexed(u[:, 0], u[0], idx, None, cfg)
    want = tops.wfagg_round_indexed_plain(u[:, 0], u[0], idx,
                                          torch.ones((2, 33), dtype=torch.bool), cfg)
    for g, w in zip(got[:5], want[:5]):
        assert torch.equal(g, w)
    assert torch.isfinite(got[0]).all() and got[2].any()
    big = torch.zeros((1, 1025), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"K=1025 \(ROADMAP queue 2, item E\)"):
        tkernel.wfagg_round_indexed_cuda(u[:1, 0], u[0], big,
                                         torch.ones((1, 1025), dtype=torch.bool), None,
                                         None, cfg, cfg.alpha, False)
    with pytest.raises(ValueError, match="prev has shape"):
        tops.robust_stats_batch(u[:, :4], prev=u[:, :3])
    with pytest.raises(ValueError, match=r"\(N, K, d\)"):
        tops.robust_stats_batch(u[0])
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.robust_stats_batch(u[:, :4].to("meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.robust_stats_batch_cuda(u[:, :4], None, 0.1, True)


# ---------------------------------------------------------------------------
# the gathered wfagg_batch, per-edge state carried
# ---------------------------------------------------------------------------

def _round_models(N, K, d, r):
    """Round r's gathered candidates and anchors: benign rows near a slowly
    drifting model, and in every node two bit-identical attacker rows (0
    and 2) sending its negative, as under IPM."""
    rng = np.random.default_rng(100 + r)
    base = (np.random.default_rng(99).standard_normal(d)
            + 0.05 * r * rng.standard_normal(d)).astype(np.float32)
    u = (base + np.float32(0.1) * rng.standard_normal((N, K, d))).astype(np.float32)
    u[:, 0] = u[:, 2] = -base
    local = (base + np.float32(0.1) * rng.standard_normal((N, d))).astype(np.float32)
    return local, u


def _configs(filters, backend):
    kw = dict(backend=backend, transient=1)
    if filters == "alt":
        return (jwf.alt_wfagg_config(multi_krum_m=2, **kw),
                twf.alt_wfagg_config(multi_krum_m=2, **kw))
    return jwf.WFAggConfig(**kw), twf.WFAggConfig(**kw)


def _edge_state(N, K, d, W):
    return twf.TemporalState(
        prev=torch.zeros((N, K, d)), hist_s=torch.zeros((N, W, K)),
        hist_b=torch.zeros((N, W, K)), count=torch.zeros((N,), dtype=torch.int32),
        t=torch.zeros((N,), dtype=torch.int32))


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("filters", ["wfagg", "alt"])
def test_gathered_wfagg_batch_matches_reference_over_rounds(filters, backend):
    N, K, d = 6, 5, 300
    jcfg, tcfg = _configs(filters, backend)
    jst = jax.vmap(lambda _: jwf.init_temporal_state(K, d, jcfg.window))(jnp.arange(N))
    st = _edge_state(N, K, d, tcfg.window)
    before = tkernel.batch_launches
    fired = 0
    for r in range(3):
        local, u = _round_models(N, K, d, r)
        jout, jst, jinfo = jwf.wfagg_batch(_j(local), _j(u), jst, jcfg)
        out, st, info = twf.wfagg_batch(_t(local), _t(u), st, tcfg, device="cpu")
        for m in MASKS:
            assert np.array_equal(info[m].numpy(), np.asarray(jinfo[m])), (r, m)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=OUT_ATOL,
                                   atol=OUT_ATOL, err_msg=f"round {r}")
        assert torch.equal(st.prev, _t(u))               # the new per-edge state
        for name in ("hist_s", "hist_b"):
            np.testing.assert_allclose(getattr(st, name).numpy(),
                                       np.asarray(getattr(jst, name)),
                                       rtol=HIST_TOL, atol=HIST_TOL, err_msg=name)
        for name in ("count", "t"):
            assert np.array_equal(getattr(st, name).numpy(), np.asarray(getattr(jst, name)))
        fired += int(info["mask_t"].sum())
    assert tkernel.batch_launches == before              # CPU tensors: plain version
    assert fired, "the temporal filter never accepted an edge"


def test_gathered_wfagg_batch_rejects_indexed_arguments():
    """The gathered form has no valid mask and no prev_idx, as in the
    reference (``src/repro/core/wfagg.py:384-388``)."""
    local, u = _round_models(4, 3, 16, 0)
    cfg = twf.WFAggConfig()
    idx = torch.as_tensor(ring_slate(4, 3))
    with pytest.raises(ValueError, match="prev_idx requires neighbor_idx"):
        twf.wfagg_batch(_t(local), _t(u), None, cfg, prev_idx=idx, device="cpu")
    with pytest.raises(ValueError, match="valid requires neighbor_idx"):
        twf.wfagg_batch(_t(local), _t(u), None, cfg,
                        valid=torch.ones((4, 3), dtype=torch.bool), device="cpu")
    with pytest.raises(ValueError, match="gathered form"):
        twf.wfagg_batch(_t(local), _t(local), None, cfg, device="cpu")


# ---------------------------------------------------------------------------
# the indexed kernels with a per-edge prev
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [5, 8])
def test_indexed_stats_per_edge_prev_match_gathered_batch(K):
    """The gather-free statistics with a per-edge prev equal the gathered
    batch's over the same rows, and the JAX kernel's."""
    N, d = 9, 300
    m = models(N, d, seed=20 + K)
    prev_m = models(N, d, seed=30 + K, shift=0.1)
    idx = ring_slate(N, K)
    before = (tkernel.indexed_launches, tkernel.indexed_per_edge_launches)
    got = tops.robust_stats_indexed(_t(m), _t(idx), None, _t(prev_m[idx]))
    assert (tkernel.indexed_launches, tkernel.indexed_per_edge_launches) == before
    exp = tops.robust_stats_batch(_t(m[idx]), _t(prev_m[idx]), need_center=False)
    for name in FIELDS:
        torch.testing.assert_close(getattr(got, name), getattr(exp, name),
                                   rtol=1e-6, atol=1e-6)
    kern = jrobust_stats_indexed(_j(m), _j(idx), None, _j(prev_m[idx]))
    _assert_stats(got, kern, centers=False)
    with pytest.raises(ValueError, match="matrix-form prev"):
        tops.robust_stats_indexed(_t(m), _t(idx), prev=_t(prev_m[idx]), prev_idx=_t(idx))
    with pytest.raises(ValueError, match="per-edge prev has shape"):
        tops.robust_stats_indexed(_t(m), _t(idx), prev=_t(prev_m[idx][:, :-1]))


@pytest.mark.parametrize("filters", ["wfagg", "alt"])
def test_round_per_edge_prev_is_the_matrix_launch(filters):
    """The single-launch round with a per-edge prev equal to ``prev[idx]``
    reads exactly the rows the matrix-prev launch reads: bit-identical
    outputs."""
    N, K, d = 8, 4, 203
    u = _t(models(N, d, seed=3))
    prev = _t(models(N, d, seed=4, shift=0.1))
    idx = _t(ring_slate(N, K))
    cfg = _configs(filters, "fused")[1]
    tb = ttrust.temporal_bands(torch.rand((N, cfg.window, K)), torch.rand((N, cfg.window, K)),
                               torch.full((N,), 2, dtype=torch.int32),
                               torch.full((N,), 5, dtype=torch.int32), cfg)
    edge = tops.wfagg_round_indexed(u, u, idx, None, cfg, prev=prev[idx.long()], tbands=tb)
    mat = tops.wfagg_round_indexed(u, u, idx, None, cfg, prev=prev, tbands=tb)
    for a, b in zip(edge[:5], mat[:5]):
        assert torch.equal(a, b)
    for name in FIELDS:
        assert torch.equal(getattr(edge[5], name), getattr(mat[5], name)), name
    with pytest.raises(ValueError, match="matrix-form prev"):
        tops.wfagg_round_indexed(u, u, idx, None, cfg, prev=prev[idx.long()], prev_idx=idx)


@pytest.mark.parametrize("backend", ["fused", "fused_two_launch", "reference"])
def test_wfagg_batch_indexed_edge_state_matches_matrix_and_gathered(backend):
    """Per-edge (N, K, d) and matrix (N, d) ``prev`` are the same state on a
    static slate (``prev[idx]`` IS the per-edge history): the indexed round
    gives the same masks and outputs from either, and the per-edge state it
    carries is ``models[idx]``; the gathered form over ``models[idx]`` with
    the same per-edge state agrees too."""
    N, K, d = 6, 4, 300
    cfg = twf.WFAggConfig(backend=backend, transient=1)
    idx = torch.as_tensor(ring_slate(N, K)).long()
    st_m = _edge_state(N, K, d, cfg.window)._replace(prev=torch.zeros((N, d)))
    st_e = _edge_state(N, K, d, cfg.window)
    st_g = _edge_state(N, K, d, cfg.window)
    fired = 0
    for r in range(4):
        u = torch.as_tensor(models(N, d, seed=60 + r, shift=0.2))
        out_m, st_m, info_m = twf.wfagg_batch(u, u, st_m, cfg, neighbor_idx=idx, device="cpu")
        out_e, st_e, info_e = twf.wfagg_batch(u, u, st_e, cfg, neighbor_idx=idx, device="cpu")
        out_g, st_g, info_g = twf.wfagg_batch(u, u[idx], st_g, cfg, device="cpu")
        assert st_m.prev.ndim == 2 and st_e.prev.ndim == 3
        assert torch.equal(st_e.prev, u[idx]) and torch.equal(st_g.prev, u[idx])
        for m in MASKS:
            assert torch.equal(info_m[m], info_e[m]), (r, m)
            assert torch.equal(info_e[m], info_g[m]), (r, m)
        torch.testing.assert_close(out_e, out_m, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(out_g, out_e, rtol=OUT_ATOL, atol=OUT_ATOL)
        fired += int(info_e["mask_t"].sum())
    assert fired, "the temporal filter never accepted an edge"


@pytest.mark.parametrize("backend", ["fused", "fused_two_launch"])
def test_wfagg_batch_indexed_edge_state_matches_reference_package(backend):
    """The indexed round with per-edge state against the JAX package's (its
    Pallas kernels in interpret mode, per-edge BlockSpecs): masks
    bit-equal, outputs within 3e-5, the new per-edge state ``models[idx]``."""
    N, K, d = 6, 4, 300
    jcfg, tcfg = _configs("wfagg", backend)
    idx = ring_slate(N, K)
    jst = jax.vmap(lambda _: jwf.init_temporal_state(K, d, jcfg.window))(jnp.arange(N))
    st = _edge_state(N, K, d, tcfg.window)
    before = (tkernel.per_edge_launches, tkernel.indexed_per_edge_launches)
    for r in range(3):
        u = models(N, d, seed=70 + r, shift=0.2)
        jout, jst, jinfo = jwf.wfagg_batch(_j(u), _j(u), jst, jcfg, neighbor_idx=_j(idx))
        out, st, info = twf.wfagg_batch(_t(u), _t(u), st, tcfg, neighbor_idx=_t(idx),
                                        device="cpu")
        for m in MASKS:
            assert np.array_equal(info[m].numpy(), np.asarray(jinfo[m])), (r, m)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=OUT_ATOL,
                                   atol=OUT_ATOL)
        np.testing.assert_array_equal(st.prev.numpy(), np.asarray(jst.prev))
        np.testing.assert_allclose(st.hist_s.numpy(), np.asarray(jst.hist_s),
                                   rtol=HIST_TOL, atol=HIST_TOL)
    assert (tkernel.per_edge_launches, tkernel.indexed_per_edge_launches) == before
