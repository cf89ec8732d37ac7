"""Table I in the port: every aggregator in CFL and DFL, and every baseline
on padded slates, against the JAX package.

* ``DYN_AGGREGATORS`` (the valid-masked baselines) against the reference's
  on padded slates with a degree-0 row, odd and even valid counts and two
  bit-identical rows: masks bit-equal, the median bit-equal (a selection),
  the other aggregates within 1e-5 (sums in another order, values of
  order 1); a NaN row gives the reference's medians (``jnp.sort`` puts it
  last: a median is NaN only where a middle lands on it).
* The standalone filters ``wfagg_d_agg`` / ``wfagg_c_agg`` on both
  backends (masks bit-equal to each other and to the reference's,
  aggregates within 2e-5, as ``tests/test_fused_backend.py``) and
  ``wfagg_e_agg``; ``memory_passes`` as the reference counts.
* Engine replays against the JAX engine, from its initial weights and fed
  its per-node batches (MLP, 10 nodes, IPM-100, two Byzantine nodes placed
  close): WFAgg-D, -C, -T, -E in CFL and DFL; the median and Multi-Krum on
  an Erdős–Rényi graph, on a churn schedule and on a chaos schedule (the
  reference's corrupt bank injected).  Verdict bitmasks bit-equal, models
  within 1e-4 (``test_torch_engine.py``'s tolerance)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro.core import wfagg as jwf
from repro.core.topology import make_topology as jmake_topology
from repro.data.synthetic import SyntheticImages as JImages
from repro.dfl import engine as jengine
from repro.dfl import faults as jflt
from repro_torch.core import aggregators as tagg
from repro_torch.core import wfagg as twf
from repro_torch.core.topology import make_topology
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.dfl import dynamics as tdyn
from repro_torch.dfl import engine as tengine
from repro_torch.dfl import faults as tflt
from repro_torch.models.lenet import params_from_jax, ravel

from _torch_fixtures import jax_batches, models

AGG_TOL = 1e-5       # aggregates: sums in another order, values of order 1
FILTER_TOL = 2e-5    # tests/test_fused_backend.py's ATOL
ENGINE_TOL = 1e-4    # tests/test_torch_engine.py


# ---------------------------------------------------------------------------
# the valid-masked baselines
# ---------------------------------------------------------------------------

def _padded_slates(N=7, K=6, d=40, seed=0):
    """(u (N, K, d), valid (N, K)): valid counts 6, 0, 4, 3, 5, 2, 1 (node 1
    degree 0, even and odd counts), every valid prefix of node 0 holding two
    bit-identical rows (1 and 4), and huge values in the padded slots (they
    must never reach an aggregate)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((N, K, d)).astype(np.float32) + np.float32(0.3)
    u[0, 4] = u[0, 1]
    counts = [6, 0, 4, 3, 5, 2, 1][:N]
    valid = np.arange(K)[None, :] < np.asarray(counts)[:, None]
    u[~valid] = np.float32(1e6)
    return u, valid


_RULE_KW = [("mean", {}), ("median", {}), ("trimmed_mean", {"beta": 0.25}),
            ("trimmed_mean", {"beta": 0.1}), ("krum", {"f": 1}),
            ("multi_krum", {"f": 1}), ("multi_krum", {"f": 1, "m": 2}),
            ("clustering", {})]


@pytest.mark.parametrize("rule,kw", _RULE_KW,
                         ids=[f"{r}-{'-'.join(f'{k}{v}' for k, v in kw.items())}"
                              for r, kw in _RULE_KW])
def test_dyn_aggregators_match_reference(rule, kw):
    u, valid = _padded_slates()
    want_out, want_mask = jax.vmap(
        lambda x, v: jagg.DYN_AGGREGATORS[rule](x, v, **kw))(jnp.asarray(u),
                                                               jnp.asarray(valid))
    out, mask = tagg.DYN_AGGREGATORS[rule](torch.as_tensor(u), torch.as_tensor(valid), **kw)
    assert np.array_equal(mask.numpy(), np.asarray(want_mask))
    assert not (mask.numpy() & ~valid).any()
    if rule == "median":
        np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))
    else:
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=AGG_TOL,
                                   atol=AGG_TOL)
    assert (out[1] == 0).all()            # degree 0: nothing to aggregate
    # one node at a time gives the same as the batch
    for n in range(u.shape[0]):
        o, m = tagg.DYN_AGGREGATORS[rule](torch.as_tensor(u[n]), torch.as_tensor(valid[n]),
                                          **kw)
        assert torch.equal(m, mask[n])
        torch.testing.assert_close(o, out[n], rtol=AGG_TOL, atol=AGG_TOL)


def test_dyn_aggregators_reduce_to_static_on_full_slates():
    u = models(8, 50, seed=3)
    ones = np.ones(8, bool)
    for rule in tagg.AGGREGATORS:
        kw = {"f": 1} if "krum" in rule else {}
        a, ma = tagg.AGGREGATORS[rule](torch.as_tensor(u), **kw)
        b, mb = tagg.DYN_AGGREGATORS[rule](torch.as_tensor(u), torch.as_tensor(ones), **kw)
        assert torch.equal(ma, mb), rule
        torch.testing.assert_close(a, b, rtol=AGG_TOL, atol=AGG_TOL)


def test_masked_median_nan_row_as_the_reference_sorts():
    """``jnp.sort`` puts a NaN last, after the +inf padding: the valid
    median is NaN only where a middle position lands on a NaN (unlike
    ``coordinate_median``, which spreads a NaN over its column), and a
    middle that would read a NaN of a short slate reads the padding."""
    u, valid = _padded_slates(seed=5)
    u[3, 0, ::2] = np.nan           # node 3: 3 valid rows, middle = rank 1
    u[0, 2:5, 0] = np.nan           # node 0: 6 valid rows, middles = ranks 2, 3
    u[5, 1, 1::2] = np.nan          # node 5: 2 valid rows, middles = ranks 0, 1
    got = tagg.masked_median(torch.as_tensor(u), torch.as_tensor(valid)).numpy()
    for n in range(u.shape[0]):
        want = np.asarray(jagg.masked_median(jnp.asarray(u[n]), jnp.asarray(valid[n])))
        np.testing.assert_array_equal(got[n], want)
    assert np.isfinite(got[3]).all()              # the NaN sorts past the middle
    assert np.isnan(got[0, 0]) and np.isfinite(got[0, 1:]).all()
    assert np.isposinf(got[5, 1::2]).all() and np.isfinite(got[5, ::2]).all()


# ---------------------------------------------------------------------------
# the standalone filters and memory_passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [5, 8])
def test_wfagg_d_c_agg_backend_parity(K):
    u = models(K, 700, seed=11)
    u[K - 1] = u[1]                       # two attackers, one model
    for jfn, tfn in ((jwf.wfagg_d_agg, twf.wfagg_d_agg), (jwf.wfagg_c_agg, twf.wfagg_c_agg)):
        out_r, m_r = tfn(torch.as_tensor(u), 2, backend="reference")
        out_f, m_f = tfn(torch.as_tensor(u), 2, backend="fused")
        assert torch.equal(m_r, m_f)
        torch.testing.assert_close(out_r, out_f, rtol=FILTER_TOL, atol=FILTER_TOL)
        for backend in ("reference", "fused"):
            jout, jm = jfn(jnp.asarray(u), 2, backend=backend)
            assert np.array_equal(m_r.numpy(), np.asarray(jm))
            np.testing.assert_allclose(out_r.numpy(), np.asarray(jout), rtol=FILTER_TOL,
                                       atol=FILTER_TOL)
    # a batch of nodes is each node on its own
    ub = np.stack([u, models(K, 700, seed=12)])
    for tfn in (twf.wfagg_d_agg, twf.wfagg_c_agg):
        out, m = tfn(torch.as_tensor(ub), 2)
        for n in range(2):
            o, mn = tfn(torch.as_tensor(ub[n]), 2)
            assert torch.equal(m[n], mn)
            torch.testing.assert_close(out[n], o, rtol=AGG_TOL, atol=AGG_TOL)


def test_wfagg_e_agg_matches_reference():
    u, local = models(6, 300, seed=13), models(1, 300, seed=14)[0]
    want = np.asarray(jwf.wfagg_e_agg(jnp.asarray(local), jnp.asarray(u), 0.7))
    got = twf.wfagg_e_agg(torch.as_tensor(local), torch.as_tensor(u), 0.7)
    np.testing.assert_allclose(got.numpy(), want, rtol=AGG_TOL, atol=AGG_TOL)
    batch = twf.wfagg_e_agg(torch.as_tensor(np.stack([local, local])),
                            torch.as_tensor(np.stack([u, u])), 0.7)
    assert torch.equal(batch[0], batch[1])
    torch.testing.assert_close(batch[0], got)


def test_memory_passes_accounting():
    """The fused path costs at least 2x fewer (K, d)-sized passes, and every
    configuration counts as in the reference."""
    cfg_r = twf.WFAggConfig(backend="reference")
    cfg_f = twf.WFAggConfig(backend="fused")
    assert twf.memory_passes(cfg_f) == 2
    assert twf.memory_passes(cfg_r) >= 2 * twf.memory_passes(cfg_f)
    assert twf.memory_passes(twf.alt_wfagg_config(backend="fused")) == 3
    for backend in ("reference", "fused", "fused_two_launch"):
        for alt in (False, True):
            for temporal in (False, True):
                mk = (twf.alt_wfagg_config, jwf.alt_wfagg_config) if alt else (
                    twf.WFAggConfig, jwf.WFAggConfig)
                tc, jc = (f(backend=backend, use_temporal=temporal) for f in mk)
                for gather in (False, True):
                    for indexed in (False, True):
                        assert twf.memory_passes(tc, gather, indexed) == \
                            jwf.memory_passes(jc, gather, indexed)


# ---------------------------------------------------------------------------
# engine replays against the JAX engine
# ---------------------------------------------------------------------------

N, K_RING = 10, 4


def _cfgs(aggregator, centralized=False, transient=None, batches=1):
    kw = dict(aggregator=aggregator, attack="ipm_100", model="mlp",
              centralized=centralized, batches_per_round=batches)
    jcfg, cfg = jengine.DFLConfig(**kw), tengine.DFLConfig(**kw)
    if transient is not None:
        jcfg = dataclasses.replace(jcfg, paper=dataclasses.replace(jcfg.paper,
                                                                   transient=transient))
        cfg = dataclasses.replace(cfg, paper=dataclasses.replace(cfg.paper,
                                                                 transient=transient))
    return jcfg, cfg


def _port_state(cfg, topo, jstate, degree=None):
    state = tengine.init_dfl_state(cfg, topo, degree=degree, device="cpu")
    if jstate.temporal is not None:
        assert state.temporal.prev.shape == jstate.temporal.prev.shape
    return state._replace(
        node_params=params_from_jax(jax.tree.map(np.array, jstate.node_params)))


def _check_round(r, state, jstate, rec=None, jrec=None):
    if rec is not None:
        assert np.array_equal(rec.verdict.numpy(), np.asarray(jrec.verdict)), r
    want = np.asarray(jengine._ravel_nodes(jstate.node_params)[0])
    np.testing.assert_allclose(ravel(state.node_params).numpy(), want, rtol=ENGINE_TOL,
                               atol=ENGINE_TOL, err_msg=f"round {r + 1}")
    if state.temporal is not None:
        for name in ("hist_s", "hist_b"):
            np.testing.assert_allclose(getattr(state.temporal, name).numpy(),
                                       np.asarray(getattr(jstate.temporal, name)),
                                       rtol=ENGINE_TOL, atol=ENGINE_TOL, err_msg=name)
        for name in ("count", "t"):
            assert np.array_equal(getattr(state.temporal, name).numpy(),
                                  np.asarray(getattr(jstate.temporal, name)))


@pytest.mark.parametrize("centralized", [False, True], ids=["dfl", "cfl"])
@pytest.mark.parametrize("aggregator", ["wfagg_d", "wfagg_c", "wfagg_t", "wfagg_e"])
def test_standalone_filters_match_reference_engine(aggregator, centralized):
    """Table I's four standalone columns.  WFAgg-T runs 4 rounds with no
    transient: it accepts nothing in round 1 (every node keeps its own
    model, the CFL server its anchor) and some edges once its band holds
    two or three metrics; its per-edge state is (N, K, d) in DFL and
    (1, N, d) in CFL."""
    rounds = 4 if aggregator == "wfagg_t" else 2
    jtopo = jmake_topology(N, K_RING, 2, "ring", placement="close")
    topo = make_topology(N, K_RING, 2, "ring", placement="close")
    jdata, data = JImages(), SyntheticImages()
    jcfg, cfg = _cfgs(aggregator, centralized, transient=0)
    jstate = jax.jit(lambda: jengine.init_dfl_state(jcfg, jtopo))()
    state = _port_state(cfg, topo, jstate)
    jround = jengine.build_round_fn(jcfg, jtopo, jdata, telemetry=not centralized)
    round_fn = tengine.build_round_fn(cfg, topo, data, telemetry=not centralized,
                                      device="cpu")
    mal = torch.as_tensor(topo.malicious)
    moved = []
    for r in range(rounds):
        batches = jax_batches(jdata, N, r, cfg.batches_per_round, cfg.paper.batch_size)
        # what a node keeps when it accepts nothing
        keep = (ravel(state.node_params)[:1] if centralized else
                tengine._trained(cfg, data, state, mal, batches)[2])
        if centralized:
            jstate, jrec = jround(jstate), None
            state, rec = round_fn(state, batches=batches), None
        else:
            jstate, jrec = jround(jstate)
            state, rec = round_fn(state, batches=batches)
        _check_round(r, state, jstate, rec, jrec)
        moved.append(int((ravel(state.node_params) != keep).any(1).sum()))
    if aggregator == "wfagg_t":
        d = ravel(state.node_params).shape[1]
        assert state.temporal.prev.shape == ((1, N, d) if centralized else (N, K_RING, d))
        assert moved[0] == 0 and max(moved) > 0, moved
    else:
        assert state.temporal is None


def _baseline_inputs(aggregator, scenario):
    """The two engines' round functions and initial states for a baseline
    on a padded slate: an Erdős–Rényi graph, a churn schedule, or churn
    with chaos transport.  Returns ``step(r) -> (port state,
    reference state, port record, reference record)``."""
    jdata, data = JImages(), SyntheticImages()
    jcfg, cfg = _cfgs(aggregator)
    if scenario == "erdos_renyi":
        jtopo = jmake_topology(N, K_RING, 2, "erdos_renyi", seed=3)
        topo = make_topology(N, K_RING, 2, "erdos_renyi", seed=3)
        assert not topo.is_regular
        assert np.array_equal(topo.neighbor_indices, jtopo.neighbor_indices)
        jfn = jengine.build_round_fn(jcfg, jtopo, jdata, telemetry=True)
        fn = tengine.build_round_fn(cfg, topo, data, telemetry=True, device="cpu")
        box = {"j": jax.jit(lambda: jengine.init_dfl_state(jcfg, jtopo))()}
        box["t"] = _port_state(cfg, topo, box["j"])

        def step(r):
            box["j"], jrec = jfn(box["j"])
            box["t"], rec = fn(box["t"], batches=jax_batches(
                jdata, N, r, cfg.batches_per_round, cfg.paper.batch_size))
            return box["t"], box["j"], rec, jrec
        return step

    jtopo = jmake_topology(N, K_RING, 2, "ring", placement="close")
    topo = make_topology(N, K_RING, 2, "ring", placement="close")
    if scenario == "churn":
        sched, fs = tdyn.make_schedule("churn", topo, 3, seed=2), None
    else:
        sched, fs = tdyn.make_faulty_schedule("churn", topo, 3, fault="chaos",
                                              intensity=0.6, seed=1, fault_seed=3)
    assert not sched.valid.all()
    jfcfg = jflt.FaultConfig() if fs is not None else None
    jfn = jengine.build_round_fn(jcfg, jtopo, jdata, dynamic=True, telemetry=True,
                                 faults=jfcfg)
    fn = tengine.build_round_fn(cfg, topo, data, dynamic=True, telemetry=True,
                                faults=fs.config if fs else None, device="cpu")
    box = {"j": jax.jit(lambda: jengine.init_dfl_state(jcfg, jtopo, degree=sched.width))()}
    box["t"] = _port_state(cfg, topo, box["j"], degree=sched.width)
    assert box["t"].temporal is None
    if fs is not None:
        d = ravel(box["t"].node_params).shape[1]
        box["jts"] = jflt.init_transport_state(jfcfg, N, sched.width, d)
        box["ts"] = tflt.init_transport_state(fs.config, N, sched.width, d)
    prev = [(sched.neighbor_idx[0], sched.valid[0])]

    def step(r):
        idx, val, mal = sched.neighbor_idx[r], sched.valid[r], sched.malicious[r]
        batches = jax_batches(jdata, N, r, cfg.batches_per_round, cfg.paper.batch_size)
        jargs = (jnp.asarray(idx), jnp.asarray(val), jnp.asarray(mal))
        targs = (torch.as_tensor(idx), torch.as_tensor(val), torch.as_tensor(mal))
        if fs is None:
            box["j"], jrec = jfn(box["j"], *jargs)
            box["t"], rec = fn(box["t"], *targs, batches=batches)
        else:
            slate = (*prev[0], idx, val)
            box["jts"] = box["jts"]._replace(served_lag=jflt.realign_served_lag(
                box["jts"].served_lag, *(jnp.asarray(x) for x in slate)))
            box["ts"] = box["ts"]._replace(served_lag=tflt.realign_served_lag(
                box["ts"].served_lag, *(torch.as_tensor(x) for x in slate)))
            fr = [x[r] for x in (fs.drop, fs.lag, fs.dup, fs.corrupt, fs.down)]
            d = ravel(box["t"].node_params).shape[1]
            box["j"], box["jts"], jrec = jfn(
                box["j"], *jargs, box["jts"], jflt.FaultRound(*(jnp.asarray(x) for x in fr)))
            box["t"], box["ts"], rec = fn(
                box["t"], *targs, box["ts"], tflt.FaultRound(*(torch.as_tensor(x) for x in fr)),
                batches=batches, bank=np.array(jflt.corrupt_bank(jfcfg, d, r)))
        prev[0] = (idx, val)
        return box["t"], box["j"], rec, jrec
    return step


@pytest.mark.parametrize("scenario", ["erdos_renyi", "churn", "chaos"])
@pytest.mark.parametrize("aggregator", ["median", "multi_krum"])
def test_padded_baselines_match_reference_engine(aggregator, scenario):
    step = _baseline_inputs(aggregator, scenario)
    for r in range(2 if scenario == "erdos_renyi" else 3):
        state, jstate, rec, jrec = step(r)
        _check_round(r, state, jstate, rec, jrec)
        assert torch.isfinite(ravel(state.node_params)).all()
