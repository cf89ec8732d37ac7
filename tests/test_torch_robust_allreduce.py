"""Port parity of the stacked robust all-reduce: ``repro_torch.distributed.
robust_allreduce`` on the CPU (the plain versions of kernels 1, 4 and 6)
against ``repro.distributed.robust_allreduce`` on the same numpy trees,
backend for backend (the JAX ``fused`` backends run their Pallas kernels
in interpret mode).  Mirrors ``tests/test_fused_backend.py:184-240``,
``tests/test_one_launch.py:276-310``, ``tests/test_telemetry.py:241-260``,
``tests/test_indexed_gossip.py:345-380`` and the ``stacked`` mode of
``tests/_spmd_parity_main.py``, each with its own tolerances; filter
masks bit-equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wfagg as jwf
from repro.distributed import robust_allreduce as jra
from repro_torch.core import attacks as tatk
from repro_torch.core import wfagg as twf
from repro_torch.distributed import robust_allreduce as tra
from repro_torch.kernels.pairwise_dist import kernel as tpkernel
from repro_torch.kernels.robust_stats import kernel as trkernel
from repro_torch.obs import decision as tobs

ATOL_FUSED = 1e-5      # tests/test_fused_backend.py:17
ATOL_ONE = 3e-5        # tests/test_one_launch.py:20
BACKENDS = ("fused", "fused_two_launch", "reference")
MASKS = ("mask_d", "mask_c", "mask_t")


def _tree(seed, K=6, shapes=(("w", (32, 8)), ("b", (100,)))):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((K,) + s).astype(np.float32) for k, s in shapes}


def _shift(g, r, step=0.1):
    return {k: v + np.float32(step * r) for k, v in g.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def _configs(method, backend, **kw):
    wcfg_j = jwf.WFAggConfig(f=1, transient=1, window=2)
    wcfg_t = twf.WFAggConfig(f=1, transient=1, window=2)
    return (jra.RobustAggConfig(method=method, wfagg=wcfg_j, layout="stacked",
                                backend=backend, **kw),
            tra.RobustAggConfig(method=method, wfagg=wcfg_t, layout="stacked",
                                backend=backend, **kw))


def _states(cj, ct, g, K):
    like = {k: v[0] for k, v in g.items()}
    return (jra.init_tree_agg_state(cj, K, _j(like)),
            tra.init_tree_agg_state(ct, K, _t(like)))


def _hold(label, oj, ij, ot, it, atol, rtol=1e-4, masks=True):
    np.testing.assert_allclose(it["weights"].numpy(), np.asarray(ij["weights"]),
                               atol=atol, err_msg=f"{label} weights")
    for k in oj:
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), rtol=rtol,
                                   atol=atol, err_msg=f"{label} {k}")
    if masks:
        for m in MASKS:
            assert np.array_equal(it[m].numpy(), np.asarray(ij[m])), (label, m)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method", ["wfagg", "alt_wfagg", "multi_krum", "clustering"])
def test_stacked_matches_reference_package(method, backend):
    """tests/test_fused_backend.py:184-215 on each backend: 4 rounds with
    temporal state, the port against the JAX function on the same tree."""
    K = 6
    g = _tree(0, K)
    cj, ct = _configs(method, backend)
    stateful = method in ("wfagg", "alt_wfagg")
    sj, st = _states(cj, ct, g, K) if stateful else (None, None)
    for r in range(4):
        gr = _shift(g, r)
        oj, sj, ij = jra.robust_allreduce_stacked(_j(gr), cj, sj)
        ot, st, it = tra.robust_allreduce_stacked(_t(gr), ct, st)
        _hold(f"{method} {backend} round {r}", oj, ij, ot, it, ATOL_FUSED,
              masks=stateful)
        if stateful:
            np.testing.assert_allclose(st.hist_s.numpy(), np.asarray(sj.hist_s),
                                       rtol=1e-5, atol=1e-5)
            assert int(st.count) == int(sj.count) and int(st.t) == int(sj.t)


@pytest.mark.parametrize("method", ["wfagg", "alt_wfagg", "multi_krum", "clustering"])
def test_stacked_fused_matches_reference_backend(method):
    """tests/test_fused_backend.py:184-215 itself, on the port: the fused
    backend against the reference backend, weights within 1e-5."""
    K = 6
    g = _tree(1, K)
    _, cr = _configs(method, "reference")
    cf = dataclasses.replace(cr, backend="fused")
    like = _t({k: v[0] for k, v in g.items()})
    stateful = method in ("wfagg", "alt_wfagg")
    sr = tra.init_tree_agg_state(cr, K, like) if stateful else None
    sf = tra.init_tree_agg_state(cf, K, like) if stateful else None
    for r in range(4):
        gr = _t(_shift(g, r))
        o_r, sr, i_r = tra.robust_allreduce_stacked(gr, cr, sr)
        o_f, sf, i_f = tra.robust_allreduce_stacked(gr, cf, sf)
        np.testing.assert_allclose(i_r["weights"].numpy(), i_f["weights"].numpy(),
                                   atol=ATOL_FUSED)
        for k in g:
            np.testing.assert_allclose(o_r[k].numpy(), o_f[k].numpy(), rtol=1e-4,
                                       atol=ATOL_FUSED)


def test_stacked_fused_gather_dtype_keeps_temporal_masks():
    """tests/test_fused_backend.py:218-240: bfloat16 gathers quantize the
    D/C/Gram statistics only, so the WFAgg-T masks agree across backends
    and with the JAX package."""
    K = 6
    g = _tree(3, K, shapes=(("w", (64,)),))
    cj, cr = _configs("wfagg", "reference", gather_dtype="bfloat16")
    cf = dataclasses.replace(cr, backend="fused")
    sj, sr = _states(cj, cr, g, K)
    sf = tra.init_tree_agg_state(cf, K, _t({k: v[0] for k, v in g.items()}))
    for r in range(4):
        gr = _shift(g, r, 0.05)
        _, sj, i_j = jra.robust_allreduce_stacked(_j(gr), cj, sj)
        _, sr, i_r = tra.robust_allreduce_stacked(_t(gr), cr, sr)
        _, sf, i_f = tra.robust_allreduce_stacked(_t(gr), cf, sf)
        assert np.array_equal(i_r["mask_t"].numpy(), i_f["mask_t"].numpy()), r
        assert np.array_equal(i_r["mask_t"].numpy(), np.asarray(i_j["mask_t"])), r
        np.testing.assert_allclose(sr.hist_s.numpy(), sf.hist_s.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(sr.hist_s.numpy(), np.asarray(sj.hist_s),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["wfagg", "alt_wfagg"])
def test_stacked_one_launch_matches_fallbacks(method):
    """tests/test_one_launch.py:276-310: the single-launch route (kernel 1
    at N = 1, ``alpha=1``, ``mean_fallback``) against the two-launch and
    reference routes, and each against the JAX package's."""
    K = 6
    g = _tree(0, K, shapes=(("w", (24, 6)), ("b", (80,))))
    pair = {b: _configs(method, b) for b in BACKENDS}
    states = {b: _states(cj, ct, g, K) for b, (cj, ct) in pair.items()}
    launches = trkernel.launches
    for r in range(4):
        gr = _shift(g, r)
        res = {}
        for b, (cj, ct) in pair.items():
            sj, st = states[b]
            oj, sj, ij = jra.robust_allreduce_stacked(_j(gr), cj, sj)
            ot, st, it = tra.robust_allreduce_stacked(_t(gr), ct, st)
            states[b] = (sj, st)
            _hold(f"{method} {b} round {r} vs JAX", oj, ij, ot, it, ATOL_ONE)
            res[b] = (ot, it)
        for b in ("fused_two_launch", "reference"):
            np.testing.assert_allclose(res["fused"][1]["weights"].numpy(),
                                       res[b][1]["weights"].numpy(), atol=ATOL_ONE)
            for k in g:
                np.testing.assert_allclose(res["fused"][0][k].numpy(),
                                           res[b][0][k].numpy(), rtol=1e-4,
                                           atol=ATOL_ONE, err_msg=(r, b, k))
    assert trkernel.launches == launches      # CPU tensors: plain versions


def _all_rejected(K=6, d=96, seed=11):
    """Candidates every filter splits: WFAgg-D keeps one (f = K - 2), the
    closest to the median in L2; WFAgg-C keeps another, the one parallel
    to the median direction; WFAgg-T is in its transient.  No candidate
    reaches two votes."""
    rng = np.random.default_rng(seed)
    m0 = rng.standard_normal(d).astype(np.float32)
    c = [m0 + 0.3 * rng.standard_normal(d).astype(np.float32), 3.0 * m0]
    c += [m0 + 2.0 * rng.standard_normal(d).astype(np.float32) for _ in range(K - 2)]
    return {"w": np.stack(c).astype(np.float32)}


@pytest.mark.parametrize("backend", BACKENDS)
def test_every_candidate_rejected_gives_the_uniform_mean(backend):
    """The all-rejected branch (kernel 1's ``mean_fallback``): the output
    is the uniform mean of the candidates, as in the JAX package."""
    g = _all_rejected()
    K = g["w"].shape[0]
    wj = jwf.WFAggConfig(f=K - 2, transient=3, window=2)
    wt = twf.WFAggConfig(f=K - 2, transient=3, window=2)
    cj = jra.RobustAggConfig(method="wfagg", wfagg=wj, layout="stacked", backend=backend)
    ct = tra.RobustAggConfig(method="wfagg", wfagg=wt, layout="stacked", backend=backend)
    sj, st = _states(cj, ct, g, K)
    oj, _, ij = jra.robust_allreduce_stacked(_j(g), cj, sj)
    ot, _, it = tra.robust_allreduce_stacked(_t(g), ct, st)
    assert float(np.asarray(ij["weights"]).sum()) == 0.0      # the case holds
    assert it["mask_d"].any() and it["mask_c"].any()
    assert not (it["mask_d"] & it["mask_c"]).any()
    assert float(it["weights"].sum()) == 0.0
    _hold(f"all rejected {backend}", oj, ij, ot, it, ATOL_ONE)
    np.testing.assert_allclose(ot["w"].numpy(), g["w"].mean(0), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_stacked_allreduce_record(backend):
    """tests/test_telemetry.py:241-260: the all-reduce threads the same
    decision record as a gossip round, equal to the JAX package's."""
    K = 6
    g = _tree(0, K, shapes=(("w", (24, 6)), ("b", (80,))))
    cj, ct = _configs("wfagg", backend)
    sj, st = _states(cj, ct, g, K)
    for r in range(3):
        gr = _shift(g, r)
        _, sj, ij = jra.robust_allreduce_stacked(_j(gr), cj, sj)
        _, st, info = tra.robust_allreduce_stacked(_t(gr), ct, st)
        assert "record" in info, backend
        rec = info["record"]
        bits = tobs.unpack_verdict(rec.verdict.numpy())
        assert bits["valid"].all()  # the stacked layout has no padded slate
        for name in MASKS:
            assert np.array_equal(bits[name].ravel(), info[name].numpy().ravel()), (r, name)
        assert np.array_equal(bits["accepted"].ravel(),
                              (info["weights"] > 0).numpy().ravel())
        assert np.array_equal(rec.verdict.numpy(), np.asarray(ij["record"].verdict))


@pytest.mark.parametrize("attack", ["alie", "ipm_100", "ipm_0.5", "sign_flip", "noise"])
def test_stacked_attack_matches_engine_attack(attack):
    """tests/test_indexed_gossip.py:345-365: ``apply_stacked_attack`` is the
    engine's ``apply_matrix_attack`` per leaf, and equals the JAX
    package's on the same candidates (the noise attack fed the JAX draws
    of each leaf's key)."""
    K, d = 8, 96
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (K, d), jnp.float32))
    mal = np.zeros(K, bool)
    mal[[2, 6]] = True
    key = jax.random.PRNGKey(3)
    want = np.asarray(jra.apply_stacked_attack({"w": jnp.asarray(g)}, jnp.asarray(mal),
                                               attack, key)["w"])
    noise = None
    if attack == "noise":   # the JAX attack folds the leaf index into the key
        noise = {"w": torch.as_tensor(np.asarray(
            jax.random.normal(jax.random.fold_in(key, 0), (K, d), jnp.float32)))}
    got = tra.apply_stacked_attack({"w": torch.as_tensor(g)}, torch.as_tensor(mal),
                                   attack, noise=noise)["w"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6, err_msg=attack)
    if attack != "noise":
        direct = tatk.apply_matrix_attack(attack, torch.as_tensor(g), torch.as_tensor(mal))
        assert torch.equal(got, direct)
    assert np.array_equal(got.numpy()[~mal], g[~mal])


def test_stacked_noise_attack_draws_from_the_generator():
    """Without explicit draws, the noise attack reads each leaf's normals
    from the generator in leaf order: one seed, one result."""
    g = _t(_tree(5, 4, shapes=(("a", (3, 5)), ("b", (7,)))))
    mal = torch.tensor([True, False, False, True])
    outs = [tra.apply_stacked_attack(g, mal, "noise",
                                     torch.Generator().manual_seed(9)) for _ in range(2)]
    for k in g:
        assert torch.equal(outs[0][k], outs[1][k])
        assert torch.equal(outs[0][k][~mal], g[k][~mal])
        assert not torch.equal(outs[0][k][mal], g[k][mal])


def test_mode_b_multi_krum_m_prefers_wfagg_config():
    """tests/test_indexed_gossip.py:368-380: ``_weights_from_stats`` honours
    WFAggConfig.multi_krum_m, then RobustAggConfig's, then K // 4; the
    masks equal the JAX package's for every preference."""
    K, d = 9, 120
    u = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (K, d), jnp.float32))
    for wf_m, ra_m, eff_m in ((3, None, 3), (3, 5, 3), (None, 5, 5),
                              (None, None, max(1, K // 4))):
        cj = jra.RobustAggConfig(method="alt_wfagg", multi_krum_m=ra_m, layout="stacked",
                                 wfagg=jwf.alt_wfagg_config(f=1, use_temporal=False,
                                                            multi_krum_m=wf_m))
        ct = tra.RobustAggConfig(method="alt_wfagg", multi_krum_m=ra_m, layout="stacked",
                                 wfagg=twf.alt_wfagg_config(f=1, use_temporal=False,
                                                            multi_krum_m=wf_m))
        _, _, ij = jra._weights_from_stats(jra._stacked_stats({"w": jnp.asarray(u)}, cj),
                                           None, None, cj)
        _, _, it = tra._weights_from_stats(tra._stacked_stats({"w": torch.as_tensor(u)},
                                                              ct), None, None, ct)
        assert int(it["mask_d"].sum()) == eff_m, (wf_m, ra_m)
        for m in ("mask_d", "mask_c"):
            assert np.array_equal(it[m].numpy(), np.asarray(ij[m])), (wf_m, ra_m, m)
        assert tra._effective_wfagg_config(ct, K).multi_krum_m == eff_m


def test_stacked_parity_mode_against_the_reference_package():
    """The ``stacked`` mode of ``tests/_spmd_parity_main.py`` in one process:
    the reference backend on its fixture (K = 6, w (24, 8), b (80,), f = 1,
    window 2), against the JAX call, within its tolerances (2e-4; hist_s
    1e-4)."""
    K = 6
    rng = np.random.default_rng(9)
    g = {"w": rng.normal(size=(K, 24, 8)).astype(np.float32),
         "b": rng.normal(size=(K, 80)).astype(np.float32)}
    cj = jra.RobustAggConfig(method="wfagg", layout="stacked", backend="reference",
                             wfagg=jwf.WFAggConfig(f=1, transient=1, window=2))
    ct = tra.RobustAggConfig(method="wfagg", layout="stacked", backend="reference",
                             wfagg=twf.WFAggConfig(f=1, transient=1, window=2))
    sj, st = _states(cj, ct, g, K)
    oj, sj, _ = jax.jit(lambda s, stt: jra.robust_allreduce_stacked(s, cj, stt))(_j(g), sj)
    ot, st, _ = tra.robust_allreduce_stacked(_t(g), ct, st)
    for k in g:
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st.hist_s.numpy(), np.asarray(sj.hist_s), rtol=2e-4,
                               atol=1e-4)


@pytest.mark.parametrize("method", ["mean", "median", "trimmed_mean", "krum"])
def test_stateless_rules_match_reference_package(method):
    """The rules without statistics (mean, median, trimmed mean) and Krum,
    on every backend, against the JAX package."""
    g = _tree(7, 7)
    for backend in BACKENDS:
        cj, ct = _configs(method, backend)
        oj, _, ij = jra.robust_allreduce_stacked(_j(g), cj, None)
        ot, _, it = tra.robust_allreduce_stacked(_t(g), ct, None)
        _hold(f"{method} {backend}", oj, ij, ot, it, ATOL_FUSED, masks=False)


def test_state_from_jax_carries_the_reference_state():
    """A TreeAggState built by the JAX package (3 rounds) turned into the
    port's: the next round decides as the JAX package's does; AggState
    (the flat layout's) converts field for field."""
    K = 6
    g = _tree(2, K)
    cj, ct = _configs("wfagg", "fused_two_launch")
    sj, _ = _states(cj, ct, g, K)
    for r in range(3):
        _, sj, _ = jra.robust_allreduce_stacked(_j(_shift(g, r)), cj, sj)
    st = tra.state_from_jax(jax.tree.map(np.asarray, sj))
    assert isinstance(st, tra.TreeAggState) and st.prev["w"].shape == (K, 32, 8)
    oj, _, ij = jra.robust_allreduce_stacked(_j(_shift(g, 3)), cj, sj)
    ot, _, it = tra.robust_allreduce_stacked(_t(_shift(g, 3)), ct, st)
    _hold("state_from_jax", oj, ij, ot, it, ATOL_FUSED)
    flat = jra.init_agg_state(cj, K)
    ft = tra.state_from_jax(jax.tree.map(np.asarray, flat))
    assert isinstance(ft, tra.AggState)
    assert ft.temporal.prev.shape == (K, cj.sketch_dim)
    assert ft.temporal.count.dtype == torch.int32


def test_unknown_stacked_backend_raises():
    cfg = tra.RobustAggConfig(method="wfagg", layout="stacked", backend="pallas")
    with pytest.raises(ValueError, match="unknown backend"):
        tra.robust_allreduce_stacked(_t(_tree(0, 4)), cfg)


@pytest.mark.parametrize("backend", BACKENDS)
def test_candidates_on_one_matrix_are_read_without_a_copy(backend):
    """Candidates whose leaves are views of one (K, P) matrix in ravel order
    (the trainer's gradient buffer) are that matrix to the fused routes: no
    concatenated copy, the same bits as the copy, the same aggregate as on
    separate leaves; the new state's prev is the matrix again, and
    ``init_tree_agg_state``'s zero prev is one such matrix."""
    from repro_torch.core.flatten import unravel_rows, vmap_ravel

    K = 6
    g = _t(_tree(4, K))
    like = {k: v[0] for k, v in g.items()}
    mat, _ = vmap_ravel(g)
    views = unravel_rows(mat, like)
    one = tra._concat_candidates(views)
    assert one.data_ptr() == mat.data_ptr() and one.shape == mat.shape
    assert torch.equal(one, torch.cat([v.reshape(K, -1) for v in
                                       (g["b"], g["w"])], dim=1))
    assert tra._concat_candidates(g).data_ptr() != g["b"].data_ptr()    # separate: a copy
    assert tra._concat_candidates(views, torch.bfloat16).data_ptr() != mat.data_ptr()
    _, ct = _configs("wfagg", backend)
    st = tra.init_tree_agg_state(ct, K, like)
    assert tra._concat_candidates(st.prev).shape == (K, mat.shape[1])
    assert tra._one_matrix(tra._leaves(st.prev)) is not None
    o1, s1, i1 = tra.robust_allreduce_stacked(views, ct, st)
    o2, _, i2 = tra.robust_allreduce_stacked(g, ct, tra.init_tree_agg_state(ct, K, like))
    assert torch.equal(i1["weights"], i2["weights"])
    for k in o1:
        assert torch.equal(o1[k], o2[k])
    assert tra._concat_candidates(s1.prev).data_ptr() == mat.data_ptr()
    # an attack in place keeps the candidates on the matrix
    mal = torch.zeros(K, dtype=torch.bool)
    mal[1] = True
    out = tra.apply_stacked_attack(views, mal, "ipm_100", in_place=True)
    assert tra._concat_candidates(out).data_ptr() == mat.data_ptr()
    want = tra.apply_stacked_attack(g, mal, "ipm_100")
    assert torch.equal(tra._concat_candidates(want), mat)


def test_cpu_tensors_launch_no_kernel():
    """On CPU tensors every route runs the plain versions: no kernel
    counter moves."""
    g = _t(_tree(4, 6))
    before = (trkernel.launches, trkernel.robust_stats_launches, tpkernel.launches)
    for method in ("wfagg", "alt_wfagg"):
        for backend in BACKENDS:
            _, ct = _configs(method, backend)
            st = tra.init_tree_agg_state(ct, 6, {k: v[0] for k, v in g.items()})
            tra.robust_allreduce_stacked(g, ct, st)
    assert (trkernel.launches, trkernel.robust_stats_launches,
            tpkernel.launches) == before
