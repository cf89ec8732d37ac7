"""The port's decentralized Alt-WFAgg and baselines against the JAX
package's engine.

* Two MLP rounds of DFL Alt-WFAgg under IPM-100 with close placement (the
  two attackers send bit-identical models, so Multi-Krum and Clustering
  meet exact ties), starting from the reference's own initial weights and
  fed its own per-node batches, on the port's "fused" and
  "fused_two_launch" backends: verdict bitmasks bit-equal, models within
  1e-4 (``test_torch_engine.py``'s tolerance).
* The five static baselines other than the mean on the same setup: models
  within 1e-4 of the JAX engine's.
* The paper's IPM-100 claim for Alt-WFAgg on the port's own data
  (``tests/test_system.py:43-53``): > 0.9 and > mean + 0.2."""
import jax
import numpy as np
import pytest

from repro.core.topology import make_topology as jmake_topology
from repro.data.synthetic import SyntheticImages as JImages
from repro.dfl import engine as jengine
from repro_torch.core.topology import make_topology, paper_topology
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.dfl import engine as tengine
from repro_torch.models.lenet import params_from_jax, ravel

from _torch_fixtures import jax_batches


def _two_rounds(aggregator, backend="fused"):
    """Two rounds of both engines from the reference's initial weights;
    yields (round, port record, reference record, port models, reference
    models, port state, reference state)."""
    N, K = 10, 4
    jtopo = jmake_topology(N, K, 2, "ring", placement="close")
    topo = make_topology(N, K, 2, "ring", placement="close")
    jdata = JImages()
    jcfg = jengine.DFLConfig(aggregator=aggregator, attack="ipm_100", model="mlp")
    cfg = tengine.DFLConfig(aggregator=aggregator, attack="ipm_100", model="mlp",
                            wfagg_backend=backend)
    jstate = jax.jit(lambda: jengine.init_dfl_state(jcfg, jtopo))()
    jround = jengine.build_round_fn(jcfg, jtopo, jdata, telemetry=True)
    state = tengine.init_dfl_state(cfg, topo, device="cpu")._replace(
        node_params=params_from_jax(jax.tree.map(np.array, jstate.node_params)))
    round_fn = tengine.build_round_fn(cfg, topo, SyntheticImages(), telemetry=True,
                                      device="cpu")
    for r in range(2):
        batches = jax_batches(jdata, N, r, cfg.batches_per_round, cfg.paper.batch_size)
        jstate, jrec = jround(jstate)
        state, rec = round_fn(state, batches=batches)
        want = np.asarray(jengine._ravel_nodes(jstate.node_params)[0])
        yield r, rec, jrec, ravel(state.node_params).numpy(), want, state, jstate


@pytest.mark.parametrize("backend", ["fused", "fused_two_launch"])
def test_alt_wfagg_two_rounds_match_reference_engine(backend):
    for r, rec, jrec, got, want, state, jstate in _two_rounds("alt_wfagg", backend):
        assert np.array_equal(rec.verdict.numpy(), np.asarray(jrec.verdict)), r
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(state.temporal.count.numpy(),
                                      np.asarray(jstate.temporal.count))
        assert state.temporal.prev.shape == got.shape      # (N, d) matrix state


@pytest.mark.parametrize("aggregator", ["median", "trimmed_mean", "krum",
                                        "multi_krum", "clustering"])
def test_baselines_two_rounds_match_reference_engine(aggregator):
    for r, rec, jrec, got, want, state, _ in _two_rounds(aggregator):
        assert np.array_equal(rec.verdict.numpy(), np.asarray(jrec.verdict)), r
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=str(r))
        assert state.temporal is None


def test_alt_wfagg_resists_ipm100_where_mean_collapses():
    """Table I's decentralized Alt-WFAgg column, IPM-100 row, on the port's
    own synthetic data."""
    accs = {}
    for agg in ("mean", "alt_wfagg"):
        cfg = tengine.DFLConfig(aggregator=agg, attack="ipm_100", model="mlp")
        out = tengine.run_experiment(cfg, paper_topology(), SyntheticImages(),
                                     rounds=4, eval_every=4, device="cpu")
        accs[agg] = out["final"]["acc_benign_mean"]
    assert accs["alt_wfagg"] > 0.9
    assert accs["alt_wfagg"] > accs["mean"] + 0.2
