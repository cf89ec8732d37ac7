"""The DFL gossip round at a degree above 32 on the CPU (the round
kernel's and the two-launch kernels' plain versions), against the JAX
package's engine.

* Two rounds on ``make_topology(34, 33, 2, "complete", placement="close")``
  (every node reads the other 33) for WFAgg and Alt-WFAgg, MLP, IPM-100.
* Two rounds on an irregular Erdős–Rényi graph of 40 nodes whose padded
  degree is above 32 (the slates padded and valid-masked), WFAgg.

Both sides start from the reference's own initial weights and train on
its own per-node batches, as ``test_torch_engine.py``'s
``test_two_rounds_match_reference_engine`` does: verdicts bit-equal,
models within 1e-4, the WFAgg-T counters equal.  The reference runs its
``reference`` backend (its Pallas round at K = 33 takes ~10 s to compile
and the interpreter ~10 s a round); the port its ``fused`` backend.  One
process: ~65 s."""
import jax
import numpy as np
import pytest

from repro.core.topology import make_topology as jmake_topology
from repro.data.synthetic import SyntheticImages as JImages
from repro.dfl import engine as jengine
from repro_torch.core.topology import make_topology
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.dfl import engine as tengine
from repro_torch.kernels.robust_stats import kernel as tkernel
from repro_torch.models.lenet import params_from_jax, ravel

from _torch_fixtures import jax_batches

TOL = 1e-4


def _topologies(graph):
    if graph == "complete":
        args, kw = (34, 33, 2, "complete"), dict(placement="close")
    else:
        args, kw = (40, 24, 4, "erdos_renyi"), dict(seed=5)
    return jmake_topology(*args, **kw), make_topology(*args, **kw)


@pytest.mark.parametrize("aggregator,graph", [
    ("wfagg", "complete"), ("alt_wfagg", "complete"), ("wfagg", "erdos_renyi")])
def test_two_rounds_above_32_match_reference_engine(aggregator, graph):
    jtopo, topo = _topologies(graph)
    assert np.array_equal(topo.neighbor_indices, jtopo.neighbor_indices)
    assert np.array_equal(topo.malicious, jtopo.malicious)
    N, K = topo.neighbor_indices.shape
    assert K > 32
    if graph == "erdos_renyi":
        assert not topo.is_regular
    kw = dict(aggregator=aggregator, attack="ipm_100", model="mlp", batches_per_round=1)
    jcfg = jengine.DFLConfig(wfagg_backend="reference", **kw)
    cfg = tengine.DFLConfig(wfagg_backend="fused", **kw)
    jdata = JImages()
    jstate = jax.jit(lambda: jengine.init_dfl_state(jcfg, jtopo))()
    jround = jengine.build_round_fn(jcfg, jtopo, jdata, telemetry=True)
    state = tengine.init_dfl_state(cfg, topo, device="cpu")._replace(
        node_params=params_from_jax(jax.tree.map(np.array, jstate.node_params)))
    round_fn = tengine.build_round_fn(cfg, topo, SyntheticImages(), telemetry=True,
                                      device="cpu")
    launches = tkernel.launches
    for r in range(2):
        batches = jax_batches(jdata, N, r, cfg.batches_per_round, cfg.paper.batch_size)
        jstate, jrec = jround(jstate)
        state, rec = round_fn(state, batches=batches)
        assert np.array_equal(rec.verdict.numpy(), np.asarray(jrec.verdict)), r
        want = np.asarray(jengine._ravel_nodes(jstate.node_params)[0])
        np.testing.assert_allclose(ravel(state.node_params).numpy(), want,
                                   rtol=TOL, atol=TOL, err_msg=f"round {r + 1}")
        np.testing.assert_array_equal(state.temporal.count.numpy(),
                                      np.asarray(jstate.temporal.count))
    assert tkernel.launches == launches             # CPU tensors: the plain versions
    # the last round weighed some attacker's model at 0 (verdict bit 4: a
    # positive trust weight)
    reads_attacker = np.isin(topo.neighbor_indices, np.flatnonzero(topo.malicious))
    assert (((rec.verdict.numpy() >> 4) & 1)[reads_attacker] == 0).any()
