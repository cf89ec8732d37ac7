"""The routes that take more than 32 candidates, end to end on the CPU,
against the JAX package or the port's reference backend.

* Two CFL rounds at N = 36 (the server aggregates K = 36 > 32 models:
  kernels 4, 6 and 7's plain versions) for WFAgg, Alt-WFAgg and Multi-Krum
  (MLP, two Byzantine nodes placed close, IPM-100), from the reference's
  own initial weights and WFAgg-T state, fed the reference's own per-node
  batches, as ``tests/test_torch_cfl.py`` does at N = 10: models within
  1e-4, the server's ring buffers within 1e-4, its counters equal.
* The gathered ``wfagg_batch`` at K = 36 (kernel 5's plain version, the
  ``bmm`` Gram, host scoring) with per-edge state over three rounds, WFAgg
  and Alt-WFAgg on ``fused``, against the reference's gathered form with
  its Pallas kernel in interpret mode: masks bit-equal, outputs within
  3e-5 (``tests/test_one_launch.py:20``), ring buffers within 1e-4.
* ``robust_allreduce_stacked`` over K = 40 candidates on
  ``fused_two_launch`` (kernels 4, 6 and 7) against the port's
  ``reference`` backend over three rounds with state: weights within
  3e-5, outputs within rtol 1e-4 / atol 3e-5, masks bit-equal; its
  ``fused`` route (kernel 1 at N = 1, its plain version on the CPU)
  computes at K = 40 and equals the ``reference`` backend, and kernel 1
  refuses K = 1,025, naming ROADMAP queue 2, item E.

The reference's round compiles its Pallas statistics at K = 36 (~15 s a
jit), so each CFL aggregator and the gathered form compile it once."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wfagg as jwf
from repro.core.topology import make_topology as jmake_topology
from repro.data.synthetic import SyntheticImages as JImages
from repro.dfl import engine as jengine
from repro_torch.core import wfagg as twf
from repro_torch.core.topology import make_topology
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.dfl import engine as tengine
from repro_torch.distributed import robust_allreduce as tra
from repro_torch.kernels.robust_stats import kernel as tkernel
from repro_torch.models.lenet import params_from_jax, ravel

from _torch_fixtures import jax_batches

TOL = 1e-4
OUT_ATOL = 3e-5               # tests/test_one_launch.py:20
MASKS = ("mask_d", "mask_c", "mask_t")


def _port_temporal(jt):
    """The reference's ``TemporalState``, from numpy arrays into the port's."""
    return None if jt is None else twf.TemporalState(
        *(torch.as_tensor(np.array(x)) for x in jt))


@pytest.mark.parametrize("aggregator", ["wfagg", "alt_wfagg", "multi_krum"])
def test_two_cfl_rounds_over_36_clients_match_reference_engine(aggregator):
    N = 36
    jtopo = jmake_topology(N, 4, 2, "ring", placement="close")
    topo = make_topology(N, 4, 2, "ring", placement="close")
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


def _round_models(N, K, d, r):
    """Round r's gathered candidates and anchors: benign rows near a slowly
    drifting model, and in every node two bit-identical attacker rows (0
    and 2) sending its negative, as under IPM."""
    rng = np.random.default_rng(200 + r)
    base = (np.random.default_rng(199).standard_normal(d)
            + 0.05 * r * rng.standard_normal(d)).astype(np.float32)
    u = (base + np.float32(0.1) * rng.standard_normal((N, K, d))).astype(np.float32)
    u[:, 0] = u[:, 2] = -base
    local = (base + np.float32(0.1) * rng.standard_normal((N, d))).astype(np.float32)
    return local, u


@pytest.mark.parametrize("filters", ["wfagg", "alt"])
def test_gathered_wfagg_batch_at_36_matches_reference(filters):
    N, K, d = 3, 36, 300
    kw = dict(backend="fused", transient=1)
    jcfg, tcfg = ((jwf.alt_wfagg_config(multi_krum_m=9, **kw),
                   twf.alt_wfagg_config(multi_krum_m=9, **kw)) if filters == "alt"
                  else (jwf.WFAggConfig(**kw), twf.WFAggConfig(**kw)))
    jst = jax.vmap(lambda _: jwf.init_temporal_state(K, d, jcfg.window))(jnp.arange(N))
    W = tcfg.window
    st = twf.TemporalState(
        prev=torch.zeros((N, K, d)), hist_s=torch.zeros((N, W, K)),
        hist_b=torch.zeros((N, W, K)), count=torch.zeros((N,), dtype=torch.int32),
        t=torch.zeros((N,), dtype=torch.int32))
    fired = 0
    for r in range(3):
        local, u = _round_models(N, K, d, r)
        jout, jst, jinfo = jwf.wfagg_batch(jnp.asarray(local), jnp.asarray(u), jst, jcfg)
        out, st, info = twf.wfagg_batch(torch.as_tensor(local), torch.as_tensor(u), st,
                                        tcfg, device="cpu")
        for m in MASKS:
            assert np.array_equal(info[m].numpy(), np.asarray(jinfo[m])), (r, m)
        assert not info["mask_d"][:, 0].any() and not info["mask_d"][:, 2].any()
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=OUT_ATOL,
                                   atol=OUT_ATOL, err_msg=f"round {r}")
        assert torch.equal(st.prev, torch.as_tensor(u))
        for name in ("hist_s", "hist_b"):
            np.testing.assert_allclose(getattr(st, name).numpy(),
                                       np.asarray(getattr(jst, name)), rtol=TOL, atol=TOL,
                                       err_msg=name)
        for name in ("count", "t"):
            assert np.array_equal(getattr(st, name).numpy(), np.asarray(getattr(jst, name)))
        fired += int(info["mask_t"].sum())
    assert fired, "the temporal filter never accepted an edge"


def _stacked_configs(method, backend):
    wcfg = twf.WFAggConfig(f=4, transient=1, window=2)
    return tra.RobustAggConfig(method=method, wfagg=wcfg, layout="stacked", backend=backend)


@pytest.mark.parametrize("method", ["wfagg", "alt_wfagg", "multi_krum"])
def test_stacked_allreduce_over_40_candidates(method):
    K = 40
    rng = np.random.default_rng(5)
    g = {"w": rng.standard_normal((K, 32, 8)).astype(np.float32),
         "b": rng.standard_normal((K, 100)).astype(np.float32)}
    for k in g:                                     # four attackers sending one model
        g[k][[3, 11, 19, 27]] = -3.0 * g[k][0]
    cr = _stacked_configs(method, "reference")
    cf = dataclasses.replace(cr, backend="fused_two_launch")
    like = {k: torch.as_tensor(v[0]) for k, v in g.items()}
    stateful = method in ("wfagg", "alt_wfagg")
    sr = tra.init_tree_agg_state(cr, K, like) if stateful else None
    sf = tra.init_tree_agg_state(cf, K, like) if stateful else None
    for r in range(3):
        gr = {k: torch.as_tensor(v + np.float32(0.1 * r)) for k, v in g.items()}
        o_r, sr, i_r = tra.robust_allreduce_stacked(gr, cr, sr)
        o_f, sf, i_f = tra.robust_allreduce_stacked(gr, cf, sf)
        np.testing.assert_allclose(i_f["weights"].numpy(), i_r["weights"].numpy(),
                                   atol=OUT_ATOL, err_msg=f"round {r} weights")
        for k in g:
            np.testing.assert_allclose(o_f[k].numpy(), o_r[k].numpy(), rtol=1e-4,
                                       atol=OUT_ATOL, err_msg=f"round {r} {k}")
        if stateful:
            for m in MASKS:
                assert torch.equal(i_f[m], i_r[m]), (r, m)
            assert not i_f["mask_d"][[3, 11, 19, 27]].any()   # the distance filter's
    if stateful:
        cu = dataclasses.replace(cr, backend="fused")
        o_u, _, i_u = tra.robust_allreduce_stacked(gr, cu, tra.init_tree_agg_state(cr, K, like))
        o_r, _, i_r = tra.robust_allreduce_stacked(gr, cr, tra.init_tree_agg_state(cr, K, like))
        for m in MASKS:
            assert torch.equal(i_u[m], i_r[m]), m
        for k in g:
            np.testing.assert_allclose(o_u[k].numpy(), o_r[k].numpy(), rtol=1e-4,
                                       atol=OUT_ATOL, err_msg=f"fused {k}")
        with pytest.raises(ValueError, match=r"K=1025 \(ROADMAP queue 2, item E\)"):
            big = torch.zeros((1, 1025), dtype=torch.int32)
            tkernel.wfagg_round_indexed_cuda(torch.zeros((1, 4)), torch.zeros((4, 4)), big,
                                             torch.ones((1, 1025), dtype=torch.bool), None,
                                             None, cr.wfagg, 1.0, True)
