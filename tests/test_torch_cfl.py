"""The port's CFL scenario (``DFLConfig(centralized=True)``: one server
aggregates all N received models) against the JAX package's engine.

* Two CFL rounds for WFAgg, Alt-WFAgg and Multi-Krum (MLP, 10 nodes, two
  Byzantine nodes placed close, IPM-100, so the server sees two
  bit-identical attacker rows), starting from the reference's own initial
  weights and WFAgg-T state and fed the reference's own per-node batches:
  models within 1e-4 (as ``tests/test_torch_engine.py``), the server's
  temporal history within 1e-4, its counters equal.
* The paper's IPM-100 claim in the centralized column on the port's own
  data: WFAgg and Alt-WFAgg each beat the mean by more than 0.2.
* Every CFL baseline runs a round; CFL tracks no per-edge series; the
  server state has a leading axis of 1 over K = N candidates."""
import jax
import numpy as np
import pytest
import torch

from repro.core.topology import make_topology as jmake_topology
from repro.data.synthetic import SyntheticImages as JImages
from repro.dfl import engine as jengine
from repro_torch.core import wfagg as twf
from repro_torch.core.topology import make_topology, paper_topology
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.dfl import engine as tengine
from repro_torch.dfl.faults import FaultConfig
from repro_torch.models.lenet import params_from_jax, ravel

from _torch_fixtures import jax_batches

TOL = 1e-4
N, K_RING = 10, 4


def _port_temporal(jt):
    """The reference's ``TemporalState``, from numpy arrays into the port's."""
    return None if jt is None else twf.TemporalState(
        *(torch.as_tensor(np.array(x)) for x in jt))


@pytest.mark.parametrize("aggregator", ["wfagg", "alt_wfagg", "multi_krum"])
def test_two_cfl_rounds_match_reference_engine(aggregator):
    jtopo = jmake_topology(N, K_RING, 2, "ring", placement="close")
    topo = make_topology(N, K_RING, 2, "ring", placement="close")
    jdata = JImages()
    kw = dict(aggregator=aggregator, attack="ipm_100", model="mlp", centralized=True)
    jcfg, cfg = jengine.DFLConfig(**kw), tengine.DFLConfig(**kw)
    jstate = jax.jit(lambda: jengine.init_dfl_state(jcfg, jtopo))()
    jround = jengine.build_round_fn(jcfg, jtopo, jdata)
    state = tengine.init_dfl_state(cfg, topo, device="cpu")._replace(
        node_params=params_from_jax(jax.tree.map(np.array, jstate.node_params)),
        temporal=_port_temporal(jstate.temporal))
    round_fn = tengine.build_round_fn(cfg, topo, SyntheticImages(), device="cpu")
    for r in range(2):
        batches = jax_batches(jdata, N, r, cfg.batches_per_round, cfg.paper.batch_size)
        jstate = jround(jstate)
        state = round_fn(state, batches=batches)
        flat = ravel(state.node_params)
        want = np.asarray(jengine._ravel_nodes(jstate.node_params)[0])
        np.testing.assert_allclose(flat.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=f"round {r + 1}")
        assert torch.equal(flat, flat[:1].expand_as(flat))   # one global model
        if aggregator == "multi_krum":
            assert state.temporal is None and jstate.temporal is None
            continue
        got_t = state.temporal
        assert got_t.prev.shape == (1, N, flat.shape[1])
        for name in ("hist_s", "hist_b"):
            np.testing.assert_allclose(getattr(got_t, name).numpy(),
                                       np.asarray(getattr(jstate.temporal, name)),
                                       rtol=TOL, atol=TOL, err_msg=name)
        for name in ("count", "t"):
            np.testing.assert_array_equal(getattr(got_t, name).numpy(),
                                          np.asarray(getattr(jstate.temporal, name)))


def test_cfl_wfagg_resists_ipm100_where_mean_collapses():
    """Table I's centralized column, IPM-100 row, on the port's own data."""
    accs = {}
    for agg in ("mean", "wfagg", "alt_wfagg"):
        cfg = tengine.DFLConfig(aggregator=agg, attack="ipm_100", model="mlp",
                                centralized=True)
        out = tengine.run_experiment(cfg, paper_topology(), SyntheticImages(),
                                     rounds=4, eval_every=4, device="cpu")
        accs[agg] = out["final"]["acc_benign_mean"]
        assert sorted(out["series"]) == ["acc_benign_mean", "r_squared",
                                         "round", "round_seconds"]
        assert len(out["series"]["round_seconds"]) == 4
        assert "mean_fallback_nodes" not in out["final"]
    assert accs["wfagg"] > accs["mean"] + 0.2, accs
    assert accs["alt_wfagg"] > accs["mean"] + 0.2, accs


@pytest.mark.parametrize("aggregator", tengine.AGGREGATORS)
def test_every_cfl_aggregator_runs_a_round(aggregator):
    topo = make_topology(8, 4, 1, "ring", placement="close")
    cfg = tengine.DFLConfig(aggregator=aggregator, attack="ipm_100", model="mlp",
                            centralized=True, batches_per_round=1)
    state = tengine.init_dfl_state(cfg, topo, device="cpu")
    if aggregator in ("wfagg", "alt_wfagg", "wfagg_t"):
        assert state.temporal.hist_s.shape == (1, cfg.paper.window, 8)
        assert state.temporal.count.shape == (1,)
    else:
        assert state.temporal is None
    nxt = tengine.build_round_fn(cfg, topo, SyntheticImages(), device="cpu")(state)
    flat = ravel(nxt.node_params)
    assert torch.isfinite(flat).all()
    assert torch.equal(flat, flat[:1].expand_as(flat))
    assert nxt.rnd == 1


@pytest.mark.parametrize("what", ["telemetry", "dynamic", "faults"])
def test_cfl_paths_the_reference_refuses_raise(what):
    """CFL has one server and no edges: per-edge telemetry, dynamic slates
    and chaos transport are refused, as the reference refuses them."""
    topo, data = paper_topology(), SyntheticImages()
    cfg = tengine.DFLConfig(centralized=True)
    kw = {"telemetry": True} if what == "telemetry" else (
        {"dynamic": True} if what == "dynamic" else
        {"dynamic": True, "faults": FaultConfig()})
    with pytest.raises(NotImplementedError,
                       match="ROADMAP" if what == "telemetry" else "gossip"):
        tengine.build_round_fn(cfg, topo, data, device="cpu", **kw)
