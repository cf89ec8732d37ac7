"""The port's slice as a whole: the static DFL round of ``repro_torch``
against the JAX package's engine.

* Two MLP rounds under IPM-100 with close placement (the two attackers
  send bit-identical models, so the filters meet exact ties), starting
  from the reference's own initial weights and fed the reference's own
  per-node batches: verdict bitmasks bit-equal, models within 1e-4.
* The adaptive attacks (``band_rider``, ``min_max``) on the static round
  and on the dynamic round under ``eclipse``: three MLP rounds with
  WFAgg-T active from the third (``transient=1``), so band_rider rides
  the bands its ``DefenseView`` carries; verdicts bit-equal, models
  within 1e-4.  (The chaos round's cases are in ``test_torch_chaos.py``.)
* The static ``run_experiment(telemetry=True)`` export: the reference's
  keys, shapes and dtypes, verdicts bit-equal to the reference's on the
  same weights and batches.
* The paper's IPM-100 claim on the port's own data
  (``tests/test_system.py:43-53``): WFAgg > 0.9 and > mean + 0.2.
* The entry points run on the card by default and raise without one;
  paths of later slices raise naming their ROADMAP item, and the
  configurations the reference refuses raise as it does.  Decentralized
  Alt-WFAgg, the two-launch backend and the DFL baselines are held in
  ``test_torch_dfl_alt.py``."""
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
from repro_torch.core import attacks as tatk
from repro_torch.core import wfagg as twf
from repro_torch.core.topology import make_topology, paper_topology
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.dfl import dynamics as tdyn
from repro_torch.dfl import engine as tengine
from repro_torch.kernels.robust_stats import kernel as tkernel
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


def _transient(cfg, transient):
    return dataclasses.replace(cfg, paper=dataclasses.replace(cfg.paper,
                                                              transient=transient))


@pytest.mark.parametrize("attack", ["band_rider", "min_max"])
@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_adaptive_rounds_match_reference_engine(mode, attack):
    """Three MLP rounds under an adaptive attack, from the reference's
    initial weights and batches: the static round on the close-placement
    ring, the dynamic round on the ``eclipse`` schedule (the victim's slate
    padded and all attackers).  WFAgg-T is active from round 3
    (``transient=1``), where band_rider's senders face finite bands."""
    N, K, R = 10, 4, 3
    jtopo = jmake_topology(N, K, 2, "ring", placement="close")
    topo = make_topology(N, K, 2, "ring", placement="close")
    jdata = JImages()
    kw = dict(aggregator="wfagg", attack=attack, model="mlp", batches_per_round=1)
    jcfg = _transient(jengine.DFLConfig(**kw), 1)
    cfg = _transient(tengine.DFLConfig(**kw), 1)
    sched = tdyn.make_schedule("eclipse" if mode == "dynamic" else "static", topo, R)
    jsched = jdyn.make_schedule("eclipse" if mode == "dynamic" else "static", jtopo, R)
    assert np.array_equal(sched.neighbor_idx, jsched.neighbor_idx)
    dynamic = mode == "dynamic"
    jround = jengine.build_round_fn(jcfg, jtopo, jdata, dynamic=dynamic, telemetry=True)
    round_fn = tengine.build_round_fn(cfg, topo, SyntheticImages(), dynamic=dynamic,
                                      telemetry=True, device="cpu")
    width = sched.width if dynamic else None
    jstate = jax.jit(lambda: jengine.init_dfl_state(jcfg, jtopo, degree=width))()
    state = tengine.init_dfl_state(cfg, topo, degree=width, device="cpu")._replace(
        node_params=params_from_jax(jax.tree.map(np.array, jstate.node_params)))
    prev, rode = (sched.neighbor_idx[0], sched.valid[0]), 0
    for r in range(R):
        batches = jax_batches(jdata, N, r, 1, cfg.paper.batch_size)
        idx, val, mal = sched.neighbor_idx[r], sched.valid[r], sched.malicious[r]
        if dynamic:
            slate = (*prev, idx, val)
            jstate = jstate._replace(temporal=jwf.realign_temporal_history(
                jstate.temporal, *(jnp.asarray(x) for x in slate)))
            state = state._replace(temporal=twf.realign_temporal_history(
                state.temporal, *(torch.as_tensor(x) for x in slate)))
        view = tengine._defense_view(cfg, state, torch.as_tensor(idx),
                                     torch.as_tensor(val) if dynamic else None)
        hi_d = tatk._sender_band_limits(view, torch.as_tensor(mal), N)[1]
        rode += int(torch.isfinite(hi_d[torch.as_tensor(mal)]).sum())
        if dynamic:
            jstate, jrec = jround(jstate, *(jnp.asarray(x) for x in (idx, val, mal)))
            state, rec = round_fn(state, *(torch.as_tensor(x) for x in (idx, val, mal)),
                                  batches=batches)
        else:
            jstate, jrec = jround(jstate)
            state, rec = round_fn(state, batches=batches)
        assert np.array_equal(rec.verdict.numpy(), np.asarray(jrec.verdict)), r
        want = np.asarray(jengine._ravel_nodes(jstate.node_params)[0])
        np.testing.assert_allclose(ravel(state.node_params).numpy(), want,
                                   rtol=1e-4, atol=1e-4, err_msg=f"round {r}")
        prev = (idx, val)
    assert rode > 0, "no attacker faced a finite WFAgg-T band"


def test_static_telemetry_export_matches_reference(monkeypatch):
    """``run_experiment(telemetry=True)``: ``out["telemetry"]`` has the
    reference's keys, shapes and dtypes, with the static slate broadcast to
    (R, ...); from the reference's weights (the port's ``init_dfl_state``
    patched to them) and batches (``SyntheticImages.node_batches`` patched
    to ``jax_batches``), every round's verdicts equal the reference's."""
    N, K, R = 10, 4, 2
    jtopo = jmake_topology(N, K, 2, "ring", placement="close")
    topo = make_topology(N, K, 2, "ring", placement="close")
    jdata = JImages()
    jcfg = jengine.DFLConfig(aggregator="wfagg", attack="ipm_100", model="mlp",
                             batches_per_round=1)
    cfg = tengine.DFLConfig(aggregator="wfagg", attack="ipm_100", model="mlp",
                            batches_per_round=1)
    want = jengine.run_experiment(jcfg, jtopo, jdata, rounds=R, telemetry=True)
    jstate = jax.jit(lambda: jengine.init_dfl_state(jcfg, jtopo))()
    params = params_from_jax(jax.tree.map(np.array, jstate.node_params))

    class RefBatches(SyntheticImages):
        def node_batches(self, n_nodes, rnd, b, batch_size, device):
            return tuple(torch.as_tensor(x) for x in
                         jax_batches(jdata, n_nodes, rnd, b + 1, batch_size)[b])

    init = tengine.init_dfl_state
    monkeypatch.setattr(tengine, "init_dfl_state",
                        lambda *a, **k: init(*a, **k)._replace(node_params=params))
    got = tengine.run_experiment(cfg, topo, RefBatches(), rounds=R, telemetry=True,
                                 device="cpu")
    tel, jtel = got["telemetry"], want["telemetry"]
    assert sorted(tel) == sorted(jtel)
    for key in jtel:
        assert tel[key].shape == jtel[key].shape, key
        assert tel[key].dtype == jtel[key].dtype, key
    for key in ("verdict", "accepted", "mean_fallback", "degree_zero", "neighbor_idx",
                "valid", "malicious"):
        assert np.array_equal(tel[key], jtel[key]), key
    np.testing.assert_allclose(tel["entropy"], jtel["entropy"], rtol=1e-5, atol=1e-6)
    assert got["series"]["mean_fallback_count"] == want["series"]["mean_fallback_count"]


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


@pytest.mark.parametrize("what", ["wfagg_d", "krum_irregular", "degree_33",
                                  "dynamic", "mesh"])
def test_later_slices_raise(what):
    """Paths that still raise.  Those of later slices name their ROADMAP
    item: the gather-free kernels past 1,025 neighbours (at degree 33 the
    round computes, on the single-launch backend as on the two-launch one,
    and the kernel refuses K = 1,025, naming item E; the DFL round above 32
    is held against the reference in ``test_torch_many_neighbours_dfl.py``).
    Sharding without an initialised process group of
    ``mesh_model_shards`` ranks raises ValueError (``distributed/spmd.py``;
    with a group it runs, ``test_torch_spmd.py``).  Those the reference
    itself refuses raise as it does: a standalone WFAgg filter has no
    valid-masked form, so WFAgg-D on an irregular graph and WFAgg-T on a
    dynamic schedule raise, while a baseline such as Krum runs on the same
    irregular graph and WFAgg-C beside it raises.  (The adaptive attacks and the static
    telemetry export, which raised until they were ported, are held
    against the reference above and in ``test_torch_chaos.py``.)"""
    topo, data = paper_topology(), SyntheticImages()
    cfg = tengine.DFLConfig()
    kw = {}
    exc, match = NotImplementedError, "ROADMAP"

    def call():
        fn = tengine.build_round_fn(cfg, topo, data, device="cpu", **kw)
        fn(tengine.init_dfl_state(cfg, topo, device="cpu"))

    irregular = make_topology(10, 4, 2, "erdos_renyi", seed=3)
    assert not irregular.is_regular
    if what == "wfagg_d":
        cfg, topo = tengine.DFLConfig(aggregator="wfagg_d"), irregular
        match = "no valid-mask-aware form"
    elif what == "krum_irregular":
        krum = tengine.DFLConfig(aggregator="krum", model="mlp", batches_per_round=1)
        fn = tengine.build_round_fn(krum, irregular, data, device="cpu")
        assert fn(tengine.init_dfl_state(krum, irregular, device="cpu")).rnd == 1
        cfg, topo = tengine.DFLConfig(aggregator="wfagg_c"), irregular
        match = "no valid-mask-aware form"
    elif what == "degree_33":
        topo = make_topology(34, 33, 2, "complete")
        outs = {}
        for backend in ("fused", "fused_two_launch"):
            c = tengine.DFLConfig(aggregator="wfagg", model="mlp", batches_per_round=1,
                                  wfagg_backend=backend)
            fn = tengine.build_round_fn(c, topo, data, device="cpu", telemetry=True)
            outs[backend] = fn(tengine.init_dfl_state(c, topo, device="cpu"))
        (s1, r1), (s2, r2) = outs["fused"], outs["fused_two_launch"]
        assert torch.equal(r1.verdict, r2.verdict) and (r1.verdict & 1).any()
        torch.testing.assert_close(ravel(s1.node_params), ravel(s2.node_params), rtol=1e-6,
                                   atol=1e-6)
        exc, match = ValueError, r"K=1025 \(ROADMAP queue 2, item E\)"

        def call():
            m = torch.zeros((4, 8))
            tkernel.wfagg_round_indexed_cuda(
                m[:1], m, torch.zeros((1, 1025), dtype=torch.int32),
                torch.ones((1, 1025), dtype=torch.bool), None, None, twf.WFAggConfig(), 0.8,
                False)
    elif what == "mesh":
        cfg = tengine.DFLConfig(mesh_model_shards=2)
        exc, match = ValueError, "initialised torch.distributed"
    elif what == "dynamic":
        cfg, kw = tengine.DFLConfig(aggregator="wfagg_t"), {"dynamic": True}
        match = "no valid-mask-aware form"
    with pytest.raises(exc, match=match):
        call()
