"""The port's slice as a whole: the static DFL round of ``repro_torch``
against the JAX package's engine.

* Two MLP rounds under IPM-100 with close placement (the two attackers
  send bit-identical models, so the filters meet exact ties), starting
  from the reference's own initial weights and fed the reference's own
  per-node batches: verdict bitmasks bit-equal, models within 1e-4.
* The paper's IPM-100 claim on the port's own data
  (``tests/test_system.py:43-53``): WFAgg > 0.9 and > mean + 0.2.
* The entry points run on the card by default and raise without one;
  paths of later slices raise NotImplementedError.  Decentralized
  Alt-WFAgg, the two-launch backend and the DFL baselines are held in
  ``test_torch_dfl_alt.py``."""
import dataclasses

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


def test_two_rounds_match_reference_engine():
    N, K = 10, 4
    jtopo = jmake_topology(N, K, 2, "ring", placement="close")
    topo = make_topology(N, K, 2, "ring", placement="close")
    assert np.array_equal(topo.neighbor_indices, jtopo.neighbor_indices)
    assert np.array_equal(topo.malicious, jtopo.malicious)
    jdata = JImages()
    jcfg = jengine.DFLConfig(aggregator="wfagg", attack="ipm_100", model="mlp")
    cfg = tengine.DFLConfig(aggregator="wfagg", attack="ipm_100", model="mlp")
    jstate = jax.jit(lambda: jengine.init_dfl_state(jcfg, jtopo))()
    jround = jengine.build_round_fn(jcfg, jtopo, jdata, telemetry=True)
    state = tengine.init_dfl_state(cfg, topo, device="cpu")._replace(
        node_params=params_from_jax(jax.tree.map(np.array, jstate.node_params)))
    round_fn = tengine.build_round_fn(cfg, topo, SyntheticImages(), telemetry=True,
                                      device="cpu")
    for r in range(2):
        batches = jax_batches(jdata, N, r, cfg.batches_per_round,
                               cfg.paper.batch_size)
        jstate, jrec = jround(jstate)
        state, rec = round_fn(state, batches=batches)
        assert np.array_equal(rec.verdict.numpy(), np.asarray(jrec.verdict)), r
        want = np.asarray(jengine._ravel_nodes(jstate.node_params)[0])
        np.testing.assert_allclose(ravel(state.node_params).numpy(), want,
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(state.temporal.count.numpy(),
                                      np.asarray(jstate.temporal.count))


def test_fused_and_reference_backends_agree_on_lenet():
    """The slice's main configuration (LeNet) at a small node count: the
    single-launch backend and the reference pipeline make the same
    decisions and the same models, round after round."""
    topo = make_topology(8, 4, 1, "ring", placement="close")
    data = SyntheticImages()
    cfg = tengine.DFLConfig(aggregator="wfagg", attack="ipm_100", model="lenet",
                            batches_per_round=1)
    cfg = dataclasses.replace(cfg, paper=dataclasses.replace(
        cfg.paper, batch_size=16, transient=0))
    fns = {b: tengine.build_round_fn(dataclasses.replace(cfg, wfagg_backend=b),
                                     topo, data, telemetry=True, device="cpu")
           for b in ("fused", "reference")}
    state = tengine.init_dfl_state(cfg, topo, device="cpu")
    for _ in range(3):
        (nxt, rec), (alt, rec_ref) = (fns[b](state) for b in ("fused", "reference"))
        assert torch.equal(rec.verdict, rec_ref.verdict)
        torch.testing.assert_close(ravel(nxt.node_params), ravel(alt.node_params),
                                   rtol=3e-5, atol=3e-5)
        state = nxt


def test_wfagg_resists_ipm100_where_mean_collapses():
    """The paper's central qualitative claim (Table I, IPM-100 row) on the
    port's own synthetic data."""
    accs = {}
    for agg in ("mean", "wfagg"):
        cfg = tengine.DFLConfig(aggregator=agg, attack="ipm_100", model="mlp")
        out = tengine.run_experiment(cfg, paper_topology(), SyntheticImages(),
                                     rounds=4, eval_every=4, device="cpu")
        accs[agg] = out["final"]["acc_benign_mean"]
        assert len(out["series"]["round_seconds"]) == 4
    assert accs["wfagg"] > 0.9
    assert accs["wfagg"] > accs["mean"] + 0.2


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo, data = paper_topology(), SyntheticImages()
    cfg = tengine.DFLConfig()
    for call in (lambda: tengine.run_experiment(cfg, topo, data, rounds=1),
                 lambda: tengine.init_dfl_state(cfg, topo),
                 lambda: tengine.build_round_fn(cfg, topo, data)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    u = torch.zeros((4, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twf.wfagg_batch(u, u, None, twf.WFAggConfig(),
                        neighbor_idx=torch.zeros((4, 2), dtype=torch.int64))


@pytest.mark.parametrize("what", ["wfagg_d", "krum_irregular", "centralized",
                                  "dynamic", "faults", "telemetry", "mesh",
                                  "gathered"])
def test_later_slices_raise(what):
    """Paths of later slices raise and name their ROADMAP item: a
    standalone WFAgg filter in DFL, a baseline other than the mean on an
    irregular graph (the valid-masked DYN_AGGREGATORS), a CFL aggregator
    that is still unported (the standalone WFAgg-T filter), a baseline
    other than the mean on a dynamic schedule (DYN_AGGREGATORS again), an
    adaptive attack on the chaos round, telemetry export of the static
    run, sharding, the gathered (N, K, d) ``wfagg_batch``."""
    topo, data = paper_topology(), SyntheticImages()
    cfg = tengine.DFLConfig()
    kw = {}
    if what == "wfagg_d":
        cfg = tengine.DFLConfig(aggregator="wfagg_d")
    elif what == "krum_irregular":
        cfg = tengine.DFLConfig(aggregator="krum")
        topo = make_topology(10, 4, 2, "erdos_renyi", seed=3)
        assert not topo.is_regular
    elif what == "centralized":
        cfg = tengine.DFLConfig(centralized=True, aggregator="wfagg_t")
    elif what == "mesh":
        cfg = tengine.DFLConfig(mesh_model_shards=2)
    elif what == "dynamic":
        cfg, kw = tengine.DFLConfig(aggregator="krum"), {"dynamic": True}
    elif what == "faults":
        cfg = tengine.DFLConfig(attack="min_max")
        kw = {"dynamic": True, "faults": FaultConfig()}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if what == "telemetry":
            tengine.run_experiment(cfg, topo, data, rounds=1, telemetry=True,
                                   device="cpu")
        elif what == "gathered":
            u = torch.zeros((4, 3, 8))
            twf.wfagg_batch(u[:, 0], u, None, twf.WFAggConfig(), device="cpu")
        else:
            fn = tengine.build_round_fn(cfg, topo, data, device="cpu", **kw)
            fn(tengine.init_dfl_state(cfg, topo, device="cpu"))
