"""Port parity of chaos transport: ``repro_torch``'s fault schedules,
transport, the ``prev_idx`` variants of the round and statistics kernels,
the chaos round and kill-and-resume, against the JAX package.

* Every fault schedule is bit-equal to ``repro.dfl.faults``'s.
* ``apply_transport`` with the reference's corrupt bank injected gives
  every ``TransportOut`` field equal; ``realign_served_lag`` and
  ``advance_ring`` equal.
* ``robust_stats_indexed`` and ``wfagg_round_indexed`` with ``prev_idx``
  on the CPU (their plain versions) against the JAX Pallas kernels in
  interpret mode on a stacked matrix at d=203, plain and Gram: masks
  bit-equal, statistics within rtol = atol = 1e-5 (float32 sums in
  another order), ``out`` within 3e-5 (``tests/test_one_launch.py:20``).
* Three chaos MLP rounds (N=10, K=4) from the reference's initial
  weights, with the reference's batches and corrupt bank injected, against
  the JAX chaos round on its ``fused`` backend (interpret mode, one D
  block): verdicts with their fault bits bit-equal, models within 1e-4,
  the served-lag table equal.
* Kill-and-resume on the CPU: the resumed run's final carry equals the
  uninterrupted run's bit for bit.
* An out-of-range table still raises on the CPU; unsupported
  configurations raise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import trust as jtrust
from repro.core import wfagg as jwf
from repro.core.topology import make_topology as jmake_topology
from repro.data.synthetic import SyntheticImages as JImages
from repro.dfl import dynamics as jdyn
from repro.dfl import engine as jengine
from repro.dfl import faults as jflt
from repro.kernels.robust_stats import ops as jrops
from repro.obs import decision as jdecision
from repro_torch.core import trust
from repro_torch.core import wfagg as twf
from repro_torch.core.topology import make_topology
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.dfl import dynamics as tdyn
from repro_torch.dfl import engine as tengine
from repro_torch.dfl import faults as tflt
from repro_torch.kernels.robust_stats import kernel as tkernel
from repro_torch.kernels.robust_stats import ops as trops
from repro_torch.models.lenet import params_from_jax, ravel
from repro_torch.obs import decision as tdecision
from repro_torch.train import checkpoint as ckpt

from _torch_fixtures import irregular_slate, jax_batches, models, ring_slate, with_degree_zero

ATOL = 3e-5
TOL = 1e-5
FIELDS = ("dist2", "dotmed", "norm2", "mednorm2", "prev_dist2", "prev_dot",
          "prev_norm2")
OUT_FIELDS = ("full", "eff_idx", "eff_valid", "prev_idx", "served_lag", "dropped",
              "stale", "corrupt")


def _topos(n=10, k=4):
    return (make_topology(n, k, 2, "ring", placement="close"),
            jmake_topology(n, k, 2, "ring", placement="close"))


@pytest.mark.parametrize("name", tflt.FAULT_NAMES)
def test_fault_schedules_bit_equal_to_reference(name):
    topo, jtopo = _topos()
    sched = tdyn.make_schedule("churn", topo, 5, seed=1)
    jsched = jdyn.make_schedule("churn", jtopo, 5, seed=1)
    for intensity, seed in ((0.4, 7), (0.9, 2)):
        got = tflt.make_fault_schedule(name, sched, intensity, seed=seed)
        want = jflt.make_fault_schedule(name, jsched, intensity, seed=seed)
        for f in ("drop", "lag", "dup", "corrupt", "down"):
            g, w = getattr(got, f), getattr(want, f)
            assert g.dtype == w.dtype and np.array_equal(g, w), (name, f)
        assert got.summary() == want.summary()
        assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    s, f = tdyn.make_faulty_schedule("link_failure", topo, 4, fault=name, seed=3,
                                     fault_seed=4)
    js, jf = jdyn.make_faulty_schedule("link_failure", jtopo, 4, fault=name, seed=3,
                                       fault_seed=4)
    assert np.array_equal(s.neighbor_idx, js.neighbor_idx)
    assert all(np.array_equal(a, b) for a, b in zip(f.xs(), jf.xs()))


def _transport_inputs(rnd, N=10, K=4, d=37, seed=0):
    """A round's transport inputs in numpy: the model matrix with a NaN
    row, a random ring and served-lag table, a chaos fault round on a
    churned slate, and the reference's corrupt bank."""
    rng = np.random.default_rng(seed)
    topo, _ = _topos(N, K)
    sched, fs = tdyn.make_faulty_schedule("churn", topo, 4, fault="chaos",
                                          intensity=0.8, seed=seed, fault_seed=seed)
    cfg = fs.config
    flat = models(N, d, seed=seed + 1)
    flat[3] = np.nan
    ring = rng.standard_normal((cfg.ring_depth, N, d)).astype(np.float32)
    served = rng.integers(0, cfg.ring_depth + 1, (N, sched.width)).astype(np.int32)
    r = rnd % sched.rounds
    fr = [x[r] for x in (fs.drop, fs.lag, fs.dup, fs.corrupt, fs.down)]
    bank = np.array(jflt.corrupt_bank(jflt.FaultConfig(), d, rnd))
    return (flat, ring, served, sched.neighbor_idx[r], sched.valid[r], fr, cfg,
            bank)


@pytest.mark.parametrize("rnd", [1, 2, 3, 6])
def test_apply_transport_matches_reference(rnd):
    flat, ring, served, idx, valid, fr, cfg, bank = _transport_inputs(rnd, seed=rnd)
    want = jflt.apply_transport(
        jnp.asarray(flat), jflt.TransportState(jnp.asarray(ring), jnp.asarray(served)),
        jnp.asarray(idx), jnp.asarray(valid),
        jflt.FaultRound(*(jnp.asarray(x) for x in fr)), jflt.FaultConfig(), rnd)
    got = tflt.apply_transport(
        torch.as_tensor(flat), tflt.TransportState(torch.as_tensor(ring),
                                                   torch.as_tensor(served)),
        torch.as_tensor(idx), torch.as_tensor(valid),
        tflt.FaultRound(*(torch.as_tensor(x) for x in fr)), cfg, rnd, bank=bank)
    for f in OUT_FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert np.array_equal(g, w), f
    assert got.eff_valid.any() and (got.eff_idx >= got.full.shape[0] - 4).any()
    # the drawn bank keeps the reference's NaN / +Inf / -Inf / garbage cycle
    drawn = tflt.corrupt_bank(cfg, flat.shape[1], rnd)
    assert np.array_equal(np.isnan(drawn.numpy()), np.isnan(bank))
    assert np.array_equal(np.isposinf(drawn.numpy()), np.isposinf(bank))
    assert np.array_equal(np.isneginf(drawn.numpy()), np.isneginf(bank))
    assert np.array_equal(drawn.numpy(), tflt.corrupt_bank(cfg, flat.shape[1], rnd).numpy(),
                          equal_nan=True)


def test_realign_served_lag_and_advance_ring_match_reference():
    rng = np.random.default_rng(5)
    N, K, L, d = 6, 4, 3, 9
    prev = np.stack([rng.permutation(10)[:K] for _ in range(N)]).astype(np.int32)
    idx = np.stack([rng.permutation(p) for p in prev]).astype(np.int32)
    idx[1, 2] = 9 if 9 not in prev[1] else 8          # a stranger
    pv = rng.random((N, K)) < 0.8
    valid = rng.random((N, K)) < 0.8
    served = rng.integers(0, L + 1, (N, K)).astype(np.int32)
    want = jflt.realign_served_lag(*(jnp.asarray(x) for x in (served, prev, pv, idx, valid)))
    got = tflt.realign_served_lag(*(torch.as_tensor(x) for x in (served, prev, pv, idx, valid)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    ring = rng.standard_normal((L, N, d)).astype(np.float32)
    flat = rng.standard_normal((N, d)).astype(np.float32)
    jts = jflt.advance_ring(jflt.TransportState(jnp.asarray(ring), jnp.asarray(served)),
                            jnp.asarray(flat), jnp.asarray(served + 1))
    ts = tflt.advance_ring(tflt.TransportState(torch.as_tensor(ring),
                                               torch.as_tensor(served)),
                           torch.as_tensor(flat), torch.as_tensor(served + 1))
    assert np.array_equal(ts.ring.numpy(), np.asarray(jts.ring))
    assert np.array_equal(ts.served_lag.numpy(), np.asarray(jts.served_lag))


def _stacked(slate, d=203, seed=11):
    """A stacked chaos matrix, effective table and valid mask, and prev_idx
    (mostly != the table) from the port's own ``apply_transport``."""
    if slate == "ring":
        idx, valid = ring_slate(9, 4), np.ones((9, 4), bool)
    else:
        idx, valid = with_degree_zero(*irregular_slate(9, 5, seed=seed, min_degree=1))
    N, K = idx.shape
    rng = np.random.default_rng(seed)
    cfg = tflt.FaultConfig()
    flat = models(N, d, seed=seed)
    flat[4] = flat[0]                                   # two identical senders
    ring = models(cfg.ring_depth * N, d, seed=seed + 1, shift=0.1).reshape(
        cfg.ring_depth, N, d)
    served = rng.integers(0, 3, (N, K)).astype(np.int32)
    fr = tflt.FaultRound(*(torch.as_tensor(x) for x in (
        rng.random((N, K)) < 0.2, rng.integers(0, 3, (N, K)).astype(np.int32),
        rng.random((N, K)) < 0.1, rng.random((N, K)) < 0.3, np.zeros(N, bool))))
    tout = tflt.apply_transport(torch.as_tensor(flat), tflt.TransportState(
        torch.as_tensor(ring), torch.as_tensor(served)), torch.as_tensor(idx),
        torch.as_tensor(valid), fr, cfg, rnd=3)
    assert (tout.prev_idx != tout.eff_idx).float().mean() > 0.5
    return (tout.full.numpy(), tout.eff_idx.numpy().astype(np.int32),
            tout.eff_valid.numpy(), tout.prev_idx.numpy().astype(np.int32), flat)


@pytest.mark.parametrize("need_gram", [False, True])
@pytest.mark.parametrize("slate", ["ring", "irregular"])
def test_prev_idx_statistics_match_pallas_kernel(slate, need_gram):
    full, idx, valid, pidx, _ = _stacked(slate)
    launches = tkernel.indexed_launches
    got = trops.robust_stats_indexed(
        torch.as_tensor(full), torch.as_tensor(idx), torch.as_tensor(valid),
        torch.as_tensor(full), need_gram=need_gram, prev_idx=torch.as_tensor(pidx))
    want = jrops.robust_stats_indexed(
        jnp.asarray(full), jnp.asarray(idx), jnp.asarray(valid), jnp.asarray(full),
        need_gram=need_gram, prev_idx=jnp.asarray(pidx))
    assert tkernel.indexed_launches == launches          # CPU tensors: plain version
    for name in FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)
    if need_gram:
        np.testing.assert_allclose(got.gram.numpy(), np.asarray(want.gram),
                                   rtol=TOL, atol=TOL)
    # through the neighbour table again, the prev_idx variant is the matrix one
    same = trops.robust_stats_indexed(
        torch.as_tensor(full), torch.as_tensor(idx), torch.as_tensor(valid),
        torch.as_tensor(full), prev_idx=torch.as_tensor(idx))
    plain = trops.robust_stats_indexed(
        torch.as_tensor(full), torch.as_tensor(idx), torch.as_tensor(valid),
        torch.as_tensor(full))
    for name in FIELDS:
        assert torch.equal(getattr(same, name), getattr(plain, name)), name


@pytest.mark.parametrize("filters", ["wfagg", "alt_wfagg"])
@pytest.mark.parametrize("slate", ["ring", "irregular"])
def test_prev_idx_round_matches_pallas_kernel(slate, filters):
    full, idx, valid, pidx, flat = _stacked(slate, seed=13)
    N, K = idx.shape
    kw = _alt_kw(filters)
    jcfg, tcfg = jwf.WFAggConfig(**kw), twf.WFAggConfig(**kw)
    # bands around this round's own temporal metrics, so mask_t both
    # accepts and rejects; the additive term keeps a band of width > 0
    # where an edge was served last round's payload again (s_t = b_t = 0,
    # which a zero-width band would put exactly on its edge)
    st = jrops.robust_stats_indexed(jnp.asarray(full), jnp.asarray(idx),
                                    jnp.asarray(valid), jnp.asarray(full),
                                    prev_idx=jnp.asarray(pidx), use_kernel=False)
    rng = np.random.default_rng(1)
    jit = lambda x: (np.asarray(x)[:, None, :] * (  # noqa: E731
        1 + 0.05 * rng.standard_normal((N, 3, K)))
        + 1e-3 * rng.standard_normal((N, 3, K))).astype(np.float32)
    tbands = np.asarray(jax.vmap(lambda hs, hb: jtrust.temporal_bands(
        hs, hb, jnp.int32(3), jnp.int32(5), jcfg))(
            jnp.asarray(jit(st.prev_dist2)), jnp.asarray(jit(st.cosine_to_prev()))))
    want = jrops.wfagg_round_indexed(
        jnp.asarray(flat), jnp.asarray(full), jnp.asarray(idx), jnp.asarray(valid),
        jcfg, prev=jnp.asarray(full), tbands=jnp.asarray(tbands),
        prev_idx=jnp.asarray(pidx))
    launches = tkernel.launches
    got = trops.wfagg_round_indexed(
        torch.as_tensor(flat), torch.as_tensor(full), torch.as_tensor(idx),
        torch.as_tensor(valid), tcfg, prev=torch.as_tensor(full),
        tbands=torch.as_tensor(np.array(tbands)), prev_idx=torch.as_tensor(pidx))
    assert tkernel.launches == launches                  # CPU tensors: plain version
    for i, m in ((2, "mask_d"), (3, "mask_c"), (4, "mask_t")):
        assert np.array_equal(got[i].numpy(), np.asarray(want[i])), m
    assert got[4].any() and not got[4][torch.as_tensor(valid)].all()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=ATOL, atol=ATOL)
    for name in FIELDS:
        np.testing.assert_allclose(getattr(got[5], name).numpy(),
                                   np.asarray(getattr(want[5], name)),
                                   rtol=TOL, atol=TOL, err_msg=name)


def _alt_kw(filters):
    kw = dict(transient=1, f=1)
    if filters == "alt_wfagg":
        kw.update(distance_filter="multi_krum", similarity_filter="clustering",
                  multi_krum_m=2)
    return kw


@pytest.mark.parametrize("filters", ["wfagg", "alt_wfagg"])
@pytest.mark.parametrize("slate", ["ring", "irregular"])
def test_zero_width_band_accepts_a_reserved_payload_as_the_reference(slate, filters):
    """An edge served last round's payload again has s_t = b_t = 0 exactly.
    A metric history of zeros, what the no-delivery hygiene leaves on such
    an edge, gives a zero-width WFAgg-T band at 0, so the value sits on
    both band edges.  The JAX reference backend (plain statistics, no
    Pallas) accepts it (``lo <= x <= hi``), and so does every backend of
    the port (the fused ones through their plain versions on the CPU):
    mask_t bit-equal to the reference's, and exactly the valid re-served
    edges.  (The JAX Pallas kernel in interpret mode sums the cosine's
    terms in another order and can land off 0.)"""
    full, idx, valid, pidx, flat = _stacked(slate, seed=13)
    N, K = idx.shape
    kw = _alt_kw(filters)
    W = jwf.WFAggConfig().window

    def state(mod, arr):
        zeros = np.zeros((N, W, K), np.float32)
        return mod.TemporalState(prev=arr(full), hist_s=arr(zeros), hist_b=arr(zeros),
                                 count=arr(np.full(N, 3, np.int32)),
                                 t=arr(np.full(N, 5, np.int32)))

    _, _, want = jwf.wfagg_batch(
        jnp.asarray(flat), jnp.asarray(full), state(jwf, jnp.asarray),
        jwf.WFAggConfig(backend="reference", **kw), neighbor_idx=jnp.asarray(idx),
        valid=jnp.asarray(valid), prev_idx=jnp.asarray(pidx))
    reserved = valid & (full[idx] == full[pidx]).all(-1)
    assert reserved.any() and not reserved[valid].all()
    assert np.array_equal(np.asarray(want["mask_t"]), reserved)
    for backend in ("fused", "fused_two_launch", "reference"):
        st = state(twf, torch.as_tensor)
        # the chaos round hands one tensor as the models and as prev
        _, _, got = twf.wfagg_batch(
            torch.as_tensor(flat), st.prev, st, twf.WFAggConfig(backend=backend, **kw),
            neighbor_idx=torch.as_tensor(idx), valid=torch.as_tensor(valid),
            prev_idx=torch.as_tensor(pidx), device="cpu")
        assert np.array_equal(got["mask_t"].numpy(), reserved), backend


@pytest.mark.parametrize("slate", ["ring", "irregular"])
def test_bit_identical_candidates_are_at_distance_zero(slate):
    """Two slots that read bit-identical rows (one stacked row read twice,
    as two corrupt slots on one bank row, or the two identical senders)
    are at squared distance exactly 0 in the distances Multi-Krum reads
    from the Gram, on the statistics wrapper and the round's plain
    version, so Multi-Krum ties them exactly; the self-distance is 0."""
    full, idx, valid, pidx, _ = _stacked(slate, seed=13)
    # the last stacked row becomes finite garbage (norm ~1e3 sqrt(d)), read
    # by slots 2 and 3 of every node, and slot 1 reads slot 0's row again
    full[-1] = 1e3 * np.random.default_rng(5).standard_normal(full.shape[1])
    idx[:, 2:4], idx[:, 1] = full.shape[0] - 1, idx[:, 0]
    u = full[idx]
    twins = ((u[:, :, None] == u[:, None, :]).all(-1) & ~np.eye(idx.shape[1], dtype=bool)
             & (valid & (u != 0).any(-1))[:, :, None] & valid[:, None, :])
    assert twins[:, 2, 3].any() and twins[:, 0, 1].any()
    st = trops.robust_stats_indexed(torch.as_tensor(full), torch.as_tensor(idx),
                                    torch.as_tensor(valid), torch.as_tensor(full),
                                    need_gram=True, prev_idx=torch.as_tensor(pidx))
    rnd = trops.wfagg_round_indexed_plain(
        torch.as_tensor(full[:idx.shape[0]]), torch.as_tensor(full), torch.as_tensor(idx),
        torch.as_tensor(valid), twf.WFAggConfig(**_alt_kw("alt_wfagg")))
    for gram in (st.gram, rnd[5].gram):
        d2 = trust.sq_dists_from_gram(gram).numpy()
        assert (d2[twins] == 0).all()
        assert (np.diagonal(d2, axis1=1, axis2=2) == 0).all()
        assert (d2[~twins & valid[:, :, None] & valid[:, None, :]
                   & ~np.eye(idx.shape[1], dtype=bool)] > 0).all()


def _chaos_pair(aggregator, N=10, K=4):
    jtopo, topo = jmake_topology(N, K, 2, "ring", placement="close"), _topos(N, K)[0]
    sched, fs = tdyn.make_faulty_schedule("churn", topo, 3, fault="chaos",
                                          intensity=0.6, seed=1, fault_seed=3)
    jdata = JImages()
    kw = dict(aggregator=aggregator, attack="ipm_100", model="mlp", batches_per_round=1)
    jcfg = jengine.DFLConfig(**kw)
    jcfg = dataclasses.replace(jcfg, paper=dataclasses.replace(jcfg.paper, transient=1))
    cfg = tengine.DFLConfig(**kw)
    cfg = dataclasses.replace(cfg, paper=dataclasses.replace(cfg.paper, transient=1))
    return jtopo, topo, sched, fs, jdata, jcfg, cfg


@pytest.mark.parametrize("aggregator", ["wfagg", "alt_wfagg", "mean"])
def test_three_chaos_rounds_match_reference_engine(aggregator):
    jtopo, topo, sched, fs, jdata, jcfg, cfg = _chaos_pair(aggregator)
    N = topo.n_nodes
    jfcfg = jflt.FaultConfig()
    jfn = jengine.build_round_fn(jcfg, jtopo, jdata, dynamic=True, telemetry=True,
                                 faults=jfcfg)
    fn = tengine.build_round_fn(cfg, topo, SyntheticImages(), dynamic=True,
                                telemetry=True, faults=fs.config, device="cpu")
    jst = jax.jit(lambda: jengine.init_dfl_state(jcfg, jtopo, degree=sched.width))()
    st = tengine.init_dfl_state(cfg, topo, degree=sched.width, device="cpu")._replace(
        node_params=params_from_jax(jax.tree.map(np.array, jst.node_params)))
    d = ravel(st.node_params).shape[1]
    jts = jflt.init_transport_state(jfcfg, N, sched.width, d)
    ts = tflt.init_transport_state(fs.config, N, sched.width, d)
    jxs, xs = jnp, torch
    prev = (sched.neighbor_idx[0], sched.valid[0])
    fault_bits = 0
    for r in range(3):
        idx, val, mal = sched.neighbor_idx[r], sched.valid[r], sched.malicious[r]
        fr = [x[r] for x in (fs.drop, fs.lag, fs.dup, fs.corrupt, fs.down)]
        slate = (*prev, idx, val)
        if jst.temporal is not None:
            jst = jst._replace(temporal=jwf.realign_temporal_history(
                jst.temporal, *(jxs.asarray(x) for x in slate)))
            st = st._replace(temporal=twf.realign_temporal_history(
                st.temporal, *(xs.as_tensor(x) for x in slate)))
        jts = jts._replace(served_lag=jflt.realign_served_lag(
            jts.served_lag, *(jxs.asarray(x) for x in slate)))
        ts = ts._replace(served_lag=tflt.realign_served_lag(
            ts.served_lag, *(xs.as_tensor(x) for x in slate)))
        jst, jts, jrec = jfn(jst, jnp.asarray(idx), jnp.asarray(val), jnp.asarray(mal),
                             jts, jflt.FaultRound(*(jnp.asarray(x) for x in fr)))
        st, ts, rec = fn(st, torch.as_tensor(idx), torch.as_tensor(val),
                         torch.as_tensor(mal), ts,
                         tflt.FaultRound(*(torch.as_tensor(x) for x in fr)),
                         batches=jax_batches(jdata, N, r, 1, jcfg.paper.batch_size),
                         bank=np.array(jflt.corrupt_bank(jfcfg, d, r)))
        assert np.array_equal(rec.verdict.numpy(), np.asarray(jrec.verdict)), r
        fault_bits |= int(np.bitwise_or.reduce(rec.verdict.numpy(), axis=None)) >> 5
        want = np.asarray(jengine._ravel_nodes(jst.node_params)[0])
        np.testing.assert_allclose(ravel(st.node_params).numpy(), want, rtol=1e-4,
                                   atol=1e-4, err_msg=f"round {r}")
        assert np.array_equal(ts.served_lag.numpy(), np.asarray(jts.served_lag))
        np.testing.assert_allclose(ts.ring.numpy(), np.asarray(jts.ring),
                                   rtol=1e-4, atol=1e-4)
        if st.temporal is not None:
            np.testing.assert_allclose(st.temporal.hist_s.numpy(),
                                       np.asarray(jst.temporal.hist_s),
                                       rtol=1e-4, atol=1e-4)
            assert st.temporal.prev.shape == (N, d)
        prev = (idx, val)
    assert fault_bits == 0b111          # dropped, stale and corrupt all seen


def test_fault_bits_match_reference():
    rng = np.random.default_rng(2)
    masks = [rng.random((5, 4)) < 0.5 for _ in range(6)]
    w = rng.random((5, 4)).astype(np.float32)
    jrec = jdecision.with_fault_bits(jdecision.record_from_masks(
        *(jnp.asarray(m) for m in masks[:4]), jnp.asarray(w)),
        *(jnp.asarray(m) for m in (masks[4], masks[5], masks[0])))
    rec = tdecision.with_fault_bits(tdecision.record_from_masks(
        *(torch.as_tensor(m) for m in masks[:4]), torch.as_tensor(w)),
        *(torch.as_tensor(m) for m in (masks[4], masks[5], masks[0])))
    assert np.array_equal(rec.verdict.numpy(), np.asarray(jrec.verdict))
    assert tdecision.FAULT_BITS == jdecision.FAULT_BITS
    assert tdecision.BITS == jdecision.BITS


def _resume_runs(tmp_path, aggregator="wfagg"):
    topo = _topos()[0]
    sched, fs = tdyn.make_faulty_schedule("churn", topo, 6, fault="chaos",
                                          intensity=0.4, seed=1, fault_seed=3)
    cfg = tengine.DFLConfig(aggregator=aggregator, attack="alie", model="mlp",
                            batches_per_round=1)
    run = lambda **kw: tengine.run_dynamic_experiment(  # noqa: E731
        cfg, topo, SyntheticImages(), sched, n_test=64, faults=fs, device="cpu", **kw)
    full = run(checkpoint_dir=str(tmp_path / "full"))
    part = run(stop_after=3, checkpoint_dir=str(tmp_path / "snap"))
    resumed = run(resume_from=str(tmp_path / "snap"),
                  checkpoint_dir=str(tmp_path / "resumed"))
    return full, part, resumed


def test_kill_and_resume_bit_exact(tmp_path):
    full, part, resumed = _resume_runs(tmp_path)
    assert part["rounds_run"] == [0, 3] and resumed["rounds_run"] == [3, 6]
    assert (full["series"]["acc_benign_mean"]
            == part["series"]["acc_benign_mean"] + resumed["series"]["acc_benign_mean"])
    assert full["final"]["acc_benign_mean"] == resumed["final"]["acc_benign_mean"]
    assert full["final"]["r_squared"] == resumed["final"]["r_squared"]
    a = np.load(tmp_path / "full" / "chaos.npz")
    b = np.load(tmp_path / "resumed" / "chaos.npz")
    assert sorted(a.files) == sorted(b.files)
    # models, momentum, the WFAgg-T ring buffers and prev, the transport
    # ring and served-lag table, the slate, the round counter, the schedules
    assert any("ring" in k for k in a.files) and any("hist_s" in k for k in a.files)
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k
    assert ckpt.load_metadata(str(tmp_path / "snap"), "chaos")["round"] == 3


def test_checkpoint_restores_on_the_like_device_and_requires_round(tmp_path):
    tree = {"a": torch.arange(4, dtype=torch.int32),
            "b": (torch.ones(2, 3), None, 7), "c": [np.zeros(2, np.float32)]}
    ckpt.save_checkpoint(str(tmp_path), "t", tree, {"round": 1})
    back, meta = ckpt.restore_checkpoint(str(tmp_path), "t", tree)
    assert meta == {"round": 1}
    assert torch.equal(back["a"], tree["a"]) and back["a"].dtype == torch.int32
    assert torch.equal(back["b"][0], tree["b"][0]) and back["b"][1] is None
    assert back["b"][2] == 7 and isinstance(back["b"][2], int)
    with pytest.raises(ValueError, match="round"):
        ckpt.save_experiment_checkpoint(str(tmp_path), "x", {"a": torch.zeros(2)},
                                        [torch.zeros(2)])
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.restore_checkpoint(str(tmp_path), "t", {"a": torch.zeros(4)})


def test_engine_finite_under_corruption():
    topo = _topos()[0]
    sched, fs = tdyn.make_faulty_schedule("churn", topo, 3, fault="corrupt",
                                          intensity=0.5, seed=1, fault_seed=2)
    for aggregator in ("mean", "wfagg"):
        cfg = tengine.DFLConfig(aggregator=aggregator, attack="none", model="mlp",
                                batches_per_round=1)
        out = tengine.run_dynamic_experiment(cfg, topo, SyntheticImages(), sched,
                                             n_test=64, faults=fs, device="cpu")
        assert np.isfinite(out["series"]["acc_benign_mean"]).all()
        assert np.isfinite(out["series"]["r_squared"]).all()
        assert out["faults"]["corrupt_rate"] > 0


def test_out_of_range_tables_raise_on_the_cpu():
    idx = torch.as_tensor(ring_slate(6, 3))
    u = torch.as_tensor(models(6, 64, seed=5))
    for bad in (-1, 6):
        with pytest.raises(ValueError, match="outside"):
            trops.robust_stats_indexed(u, idx, prev=u, prev_idx=torch.where(idx == 2, bad, idx))
        with pytest.raises(ValueError, match="outside"):
            trops.wfagg_round_indexed(u, u, idx, None, twf.WFAggConfig(), prev=u,
                                      prev_idx=torch.where(idx == 2, bad, idx))
    with pytest.raises(ValueError, match="requires prev"):
        trops.robust_stats_indexed(u, idx, prev_idx=idx)
    with pytest.raises(ValueError, match="prev has shape"):
        trops.wfagg_round_indexed(u, u, idx, None, twf.WFAggConfig(), prev=u[:, :9],
                                  prev_idx=idx)


@pytest.mark.parametrize("what", ["krum", "adaptive", "centralized", "not_dynamic",
                                  "no_faults_checkpoint", "window"])
def test_unsupported_configurations_raise(what, tmp_path):
    topo = _topos()[0]
    sched, fs = tdyn.make_faulty_schedule("churn", topo, 3, seed=1)
    data = SyntheticImages()
    cfg = tengine.DFLConfig(batches_per_round=1)
    if what == "krum":
        # the baselines run on chaos slates; a standalone WFAgg filter has
        # no valid-masked form and raises, as in the reference
        tengine.build_round_fn(tengine.DFLConfig(aggregator="krum"), topo, data,
                               dynamic=True, faults=fs.config, device="cpu")
        with pytest.raises(NotImplementedError, match="no valid-mask-aware form"):
            tengine.build_round_fn(tengine.DFLConfig(aggregator="wfagg_c"), topo, data,
                                   dynamic=True, faults=fs.config, device="cpu")
    elif what == "adaptive":
        with pytest.raises(NotImplementedError, match="item 7"):
            tengine.build_round_fn(tengine.DFLConfig(attack="band_rider"), topo, data,
                                   dynamic=True, faults=fs.config, device="cpu")
    elif what == "centralized":
        with pytest.raises(NotImplementedError, match="gossip"):
            tengine.build_round_fn(tengine.DFLConfig(centralized=True), topo, data,
                                   dynamic=True, device="cpu")
    elif what == "not_dynamic":
        with pytest.raises(NotImplementedError, match="dynamic=True"):
            tengine.build_round_fn(cfg, topo, data, faults=fs.config, device="cpu")
    elif what == "no_faults_checkpoint":
        with pytest.raises(NotImplementedError, match="chaos scan"):
            tengine.run_dynamic_experiment(cfg, topo, data, sched, stop_after=1,
                                           device="cpu")
    else:
        with pytest.raises(ValueError, match="round window"):
            tengine.run_dynamic_experiment(cfg, topo, data, sched, faults=fs,
                                           stop_after=4, device="cpu")
