"""Port parity of round-varying topologies: ``repro_torch``'s schedules,
WFAgg-T history realignment and dynamic round against the JAX package.

* Every scenario's schedule is bit-equal to ``repro.dfl.dynamics``'s for
  two seeds, and ``static_schedule`` equals the topology.
* ``realign_temporal_history`` equals the reference's on permuted,
  shrinking and growing slates (exactly: a float32 einsum over 0/1
  weights).
* Three dynamic MLP rounds under ``churn`` (N=10, K=4) from the
  reference's initial weights, fed the reference's batches, against the
  JAX ``build_round_fn(dynamic=True)`` on its ``fused`` backend (the
  Pallas kernel in interpret mode, one D block): verdicts bit-equal and
  models within 1e-4 on the port's ``fused`` (the round kernel's plain
  version on the CPU) and ``reference`` backends, as in
  ``test_torch_engine.py``.
* A degree-0 node keeps its locally trained model exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wfagg as jwf
from repro.core.topology import make_topology as jmake_topology
from repro.data.synthetic import SyntheticImages as JImages
from repro.dfl import dynamics as jdyn
from repro.dfl import engine as jengine
from repro_torch.core import wfagg as twf
from repro_torch.core.topology import make_topology, static_schedule
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.dfl import dynamics as tdyn
from repro_torch.dfl import engine as tengine
from repro_torch.models.lenet import params_from_jax, ravel

from _torch_fixtures import jax_batches

SCHEDULE_FIELDS = ("neighbor_idx", "valid", "malicious", "adjacency")


def _topos(n=12, k=4, n_mal=2, placement="close"):
    return (make_topology(n, k, n_mal, "ring", placement=placement),
            jmake_topology(n, k, n_mal, "ring", placement=placement))


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name", tdyn.SCENARIO_NAMES)
def test_schedules_bit_equal_to_reference(name, seed):
    topo, jtopo = _topos()
    got = tdyn.make_schedule(name, topo, 6, seed=seed)
    want = jdyn.make_schedule(name, jtopo, 6, seed=seed)
    for f in SCHEDULE_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), (name, seed, f)
    assert np.array_equal(got.degree_stats(), want.degree_stats())
    assert np.array_equal(got.diff(), want.diff())
    assert got.width == want.width and got.rounds == 6


def test_static_schedule_matches_topology():
    topo, _ = _topos(n=10, k=4, placement="spaced")
    s = static_schedule(topo, 3)
    for r in range(3):
        assert np.array_equal(s.neighbor_idx[r], topo.neighbor_indices)
        assert np.array_equal(s.valid[r], topo.neighbor_valid)
        assert np.array_equal(s.malicious[r], topo.malicious)
    with pytest.raises(ValueError, match="unknown scenario"):
        tdyn.make_schedule("nope", topo, 3)


def _slates(kind):
    """(prev_idx, prev_valid, idx, valid) of a slate change."""
    rng = np.random.default_rng(3)
    N, K = 6, 5
    prev = np.stack([rng.permutation(12)[:K] for _ in range(N)]).astype(np.int32)
    pv = np.ones((N, K), bool)
    if kind == "permuted":
        idx = np.stack([rng.permutation(p) for p in prev]).astype(np.int32)
        return prev, pv, idx, pv.copy()
    if kind == "shrinking":          # valid prefixes shrink, a node to degree 0
        valid = pv.copy()
        valid[:, 3:] = False
        valid[2] = False
        idx = np.where(valid, np.roll(prev, 1, axis=1), np.arange(N)[:, None])
        return prev, pv, idx.astype(np.int32), valid
    # growing: last round's slate was short, new and returning neighbours
    pv[:, 2:] = False
    idx = np.concatenate([prev[:, 1::-1], rng.integers(0, 12, (N, K - 2))],
                         axis=1).astype(np.int32)
    idx[0, 2] = idx[0, 3] = prev[0, 0]    # one neighbour seen twice
    return prev, pv, idx, np.ones((N, K), bool)


@pytest.mark.parametrize("kind", ["permuted", "shrinking", "growing"])
def test_realign_temporal_history_matches_reference(kind):
    prev, pv, idx, valid = _slates(kind)
    N, K = idx.shape
    W, d = 3, 8
    rng = np.random.default_rng(4)
    hs, hb = (rng.standard_normal((N, W, K)).astype(np.float32) for _ in range(2))
    jst = jwf.TemporalState(prev=jnp.zeros((N, d)), hist_s=jnp.asarray(hs),
                            hist_b=jnp.asarray(hb), count=jnp.ones((N,), jnp.int32),
                            t=jnp.ones((N,), jnp.int32))
    tst = twf.TemporalState(prev=torch.zeros((N, d)), hist_s=torch.as_tensor(hs),
                            hist_b=torch.as_tensor(hb),
                            count=torch.ones((N,), dtype=torch.int32),
                            t=torch.ones((N,), dtype=torch.int32))
    want = jwf.realign_temporal_history(jst, *(jnp.asarray(x) for x in (prev, pv, idx, valid)))
    got = twf.realign_temporal_history(tst, *(torch.as_tensor(x) for x in (prev, pv, idx, valid)))
    assert np.array_equal(got.hist_s.numpy(), np.asarray(want.hist_s))
    assert np.array_equal(got.hist_b.numpy(), np.asarray(want.hist_b))
    # the same slate again keeps every valid column and zeroes the others
    same = twf.realign_temporal_history(tst, *(torch.as_tensor(x) for x in (prev, pv, prev, pv)))
    assert torch.equal(same.hist_s, torch.where(torch.as_tensor(pv)[:, None], tst.hist_s, 0.0))


def test_three_churn_rounds_match_reference_engine():
    N, K = 10, 4
    jtopo = jmake_topology(N, K, 2, "ring", placement="close")
    topo = make_topology(N, K, 2, "ring", placement="close")
    sched = tdyn.make_schedule("churn", topo, 3, seed=2)
    assert not sched.valid.all()                     # the slate changes
    jdata = JImages()
    jcfg = jengine.DFLConfig(aggregator="wfagg", attack="ipm_100", model="mlp",
                             batches_per_round=2)
    # WFAgg-T active from the second round on
    jcfg = dataclasses.replace(jcfg, paper=dataclasses.replace(jcfg.paper, transient=1))
    jfn = jengine.build_round_fn(jcfg, jtopo, jdata, dynamic=True, telemetry=True)
    jst = jax.jit(lambda: jengine.init_dfl_state(jcfg, jtopo, degree=sched.width))()
    params = params_from_jax(jax.tree.map(np.array, jst.node_params))
    sts, fns = {}, {}
    for b in ("fused", "reference"):
        cfg = tengine.DFLConfig(aggregator="wfagg", attack="ipm_100", model="mlp",
                                batches_per_round=2, wfagg_backend=b)
        cfg = dataclasses.replace(cfg, paper=dataclasses.replace(cfg.paper, transient=1))
        sts[b] = tengine.init_dfl_state(cfg, topo, degree=sched.width,
                                        device="cpu")._replace(node_params=params)
        fns[b] = tengine.build_round_fn(cfg, topo, SyntheticImages(), dynamic=True,
                                        telemetry=True, device="cpu")
    prev = (sched.neighbor_idx[0], sched.valid[0])
    t_fired = 0
    for r in range(3):
        idx, val, mal = sched.neighbor_idx[r], sched.valid[r], sched.malicious[r]
        batches = jax_batches(jdata, N, r, 2, jcfg.paper.batch_size)
        jst = jst._replace(temporal=jwf.realign_temporal_history(
            jst.temporal, *(jnp.asarray(x) for x in (*prev, idx, val))))
        jst, jrec = jfn(jst, jnp.asarray(idx), jnp.asarray(val), jnp.asarray(mal))
        want = np.asarray(jengine._ravel_nodes(jst.node_params)[0])
        for b in fns:
            st = sts[b]
            st = st._replace(temporal=twf.realign_temporal_history(
                st.temporal, *(torch.as_tensor(x) for x in (*prev, idx, val))))
            st, rec = fns[b](st, torch.as_tensor(idx), torch.as_tensor(val),
                             torch.as_tensor(mal), batches=batches)
            assert np.array_equal(rec.verdict.numpy(), np.asarray(jrec.verdict)), (r, b)
            t_fired += int(((rec.verdict >> 2) & 1).sum())
            np.testing.assert_allclose(ravel(st.node_params).numpy(), want,
                                       rtol=1e-4, atol=1e-4, err_msg=f"round {r} {b}")
            np.testing.assert_allclose(st.temporal.hist_s.numpy(),
                                       np.asarray(jst.temporal.hist_s), rtol=1e-4,
                                       atol=1e-4)
            sts[b] = st
        prev = (idx, val)
    assert t_fired, "the temporal filter never accepted an edge"


@pytest.mark.parametrize("aggregator,backend", [
    ("wfagg", "fused"), ("wfagg", "fused_two_launch"), ("wfagg", "reference"),
    ("alt_wfagg", "fused"), ("mean", "fused")])
def test_degree_zero_node_keeps_its_local_model(aggregator, backend):
    topo = make_topology(8, 4, 1, "ring", placement="close")
    sched = tdyn.make_schedule("dos", topo, 3, start=0, length=3)
    victim = int(np.flatnonzero(~sched.valid[0].any(1))[0])
    cfg = tengine.DFLConfig(aggregator=aggregator, attack="ipm_100", model="mlp",
                            batches_per_round=1, wfagg_backend=backend)
    data = SyntheticImages()
    state = tengine.init_dfl_state(cfg, topo, degree=sched.width, device="cpu")
    fn = tengine.build_round_fn(cfg, topo, data, dynamic=True, device="cpu")
    mal = torch.as_tensor(sched.malicious[0])
    for r in range(2):
        params, _ = tengine._local_train(cfg, data, mal, state.node_params,
                                         state.node_momentum, state.rnd)
        trained = tengine._apply_attacks(cfg, mal, ravel(params), state.rnd)
        state = fn(state, torch.as_tensor(sched.neighbor_idx[r]),
                   torch.as_tensor(sched.valid[r]), mal)
        assert torch.equal(ravel(state.node_params)[victim], trained[victim]), r
        assert torch.isfinite(ravel(state.node_params)).all()


def test_run_dynamic_experiment_shapes_and_cohort():
    topo = make_topology(10, 4, 2, "ring", placement="close")
    sched = tdyn.make_schedule("sleeper", topo, 3, wake_at=1)
    cfg = tengine.DFLConfig(aggregator="wfagg", attack="ipm_100", model="mlp",
                            batches_per_round=1)
    out = tengine.run_dynamic_experiment(cfg, topo, SyntheticImages(), sched,
                                         n_test=64, telemetry=True, device="cpu")
    s = out["series"]
    assert s["round"] == [1, 2, 3] and len(s["round_seconds"]) == 3
    assert len(s["degree_min_mean_max"]) == 3 and len(s["accepted_mean"]) == 3
    assert out["telemetry"]["verdict"].shape == (3, 10, sched.width)
    assert out["final"]["acc_benign_mean"] == s["acc_benign_mean"][-1]
    assert out["final"]["r_squared"] == pytest.approx(s["r_squared"][-1], rel=1e-5)
    assert "faults" not in out and "rounds_run" not in out
    # telemetry reads the masks only: the trajectory is the same without it
    off = tengine.run_dynamic_experiment(cfg, topo, SyntheticImages(), sched,
                                         n_test=64, device="cpu")
    assert off["series"]["acc_benign_mean"] == s["acc_benign_mean"]
    with pytest.raises(ValueError, match="nodes"):
        tengine.run_dynamic_experiment(
            cfg, make_topology(8, 4, 1, "ring"), SyntheticImages(), sched,
            device="cpu")
    bad = dataclasses.replace(sched, neighbor_idx=np.where(
        sched.neighbor_idx == 3, 10, sched.neighbor_idx).astype(np.int32))
    with pytest.raises(ValueError, match="outside"):
        tengine.run_dynamic_experiment(cfg, topo, SyntheticImages(), bad,
                                       device="cpu")
