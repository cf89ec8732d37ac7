"""The port's flight recorder (``repro_torch.obs``) against the JAX
package's, and its mirror of ``tests/test_telemetry.py``.

* Decision plane: pack/unpack, the record's semantics, and on every
  dynamics scenario the verdicts of all three WFAgg backends bit-equal on
  the valid lanes to the port's reference backend, which is bit-equal to
  the JAX reference backend's on the same numpy inputs.
* Telemetry is an observer: trajectories equal with telemetry on or off,
  static and dynamic; the static export has the reference's layout; a CFL
  run refuses it.
* Export plane: filter rates and attribution on hand-built verdicts, the
  JSONL schema, the recorder, the Perfetto trace, the audit.
* The audit against the reference: from one JAX telemetry bundle (an
  eclipse run under band_rider, and a chaos run with fault bits), the
  port's ``events_from_telemetry`` gives the reference's event list,
  ``render_audit`` the same text and ``to_trace_events`` the same trace.
* Timing plane: ``time_compile_steady`` and the ``memory_passes`` join.
* ``python -m repro_torch.obs.report --device cpu`` end to end: a strictly
  valid log, a trace, a ``torch.profiler`` capture, a replay that renders
  the same audit, and decisions equal to ``run_dynamic_experiment``'s.

``test_stacked_allreduce_record`` is mirrored with the stacked all-reduce
in ``tests/test_torch_robust_allreduce.py``.  Not mirrored:
``test_microbench_timeit_median`` (a ``benchmarks/`` script)."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wfagg as jwf
from repro.core.topology import make_topology as jmake_topology
from repro.data.synthetic import SyntheticImages as JImages
from repro.dfl import dynamics as jdyn
from repro.dfl import engine as jengine
from repro.obs import decision as jdecision
from repro.obs import report as jreport
from repro.obs import trace as jtrace
from repro_torch.core import wfagg as wf
from repro_torch.core.topology import make_topology
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.dfl.dynamics import SCENARIO_NAMES, make_faulty_schedule, make_schedule
from repro_torch.dfl.engine import DFLConfig, run_dynamic_experiment, run_experiment
from repro_torch.obs import decision as obs
from repro_torch.obs import profile as obs_profile
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs import report as obs_report
from repro_torch.obs import trace as obs_trace

BACKENDS = ("fused", "fused_two_launch", "reference")
META = dict(aggregator="wfagg", attack="unit", scenario="static", backend="fused")


# ---------------------------------------------------------------------------
# decision plane
# ---------------------------------------------------------------------------

def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    masks = {name: rng.random((6, 4)) < 0.5 for name in obs.BITS}
    args = [masks[k] for k in ("mask_d", "mask_c", "mask_t", "valid", "accepted")]
    v = obs.pack_verdict(*(torch.as_tensor(m) for m in args))
    assert v.dtype == torch.uint8
    assert np.array_equal(v.numpy(), np.asarray(jdecision.pack_verdict(
        *(jnp.asarray(m) for m in args))))
    for back in (obs.unpack_verdict(v), obs.unpack_verdict(v.numpy())):
        for name in obs.BITS:
            assert np.array_equal(np.asarray(back[name]), masks[name]), name
        assert not any(np.asarray(back[k]).any() for k in obs.FAULT_BITS)


def test_record_from_masks_semantics():
    """Normal node, all-rejected node (mean-fallback), padded-away node."""
    t, f = True, False
    mask = torch.tensor([[t, t, f], [f, f, f], [f, f, f]])
    valid = torch.tensor([[t, t, t], [t, t, f], [f, f, f]])
    weights = torch.tensor([[0.5, 0.5, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    rec = obs.record_from_masks(mask, mask, mask, valid, weights)
    assert rec.accepted.tolist() == [2, 0, 0]
    assert rec.mean_fallback.tolist() == [False, True, False]
    assert rec.degree_zero.tolist() == [False, False, True]
    ent = rec.entropy.numpy()
    np.testing.assert_allclose(ent[0], np.log(2.0), rtol=1e-6)
    assert ent[1] == 0.0 and ent[2] == 0.0
    bits = obs.unpack_verdict(rec.verdict)
    assert torch.equal(bits["valid"], valid)
    assert torch.equal(bits["accepted"], weights > 0)


def test_record_uniform_baselines():
    valid = torch.tensor([[True, True, False], [False, False, False]])
    rec = obs.record_uniform(valid)
    bits = obs.unpack_verdict(rec.verdict)
    for name in ("mask_d", "mask_c", "mask_t"):
        assert not bits[name].any(), name
    assert torch.equal(bits["accepted"], valid)
    assert rec.accepted.tolist() == [2, 0]
    assert rec.degree_zero.tolist() == [False, True]
    np.testing.assert_allclose(rec.entropy.numpy(), [np.log(2.0), 0.0], rtol=1e-6)


def _scenario_records(scenario, rounds=4, N=8, d=96):
    """Drive ``wfagg_batch`` round by round over a scenario's slates (the
    matrix-prev temporal layout and the per-round history realign) on
    every port backend and on the JAX reference backend, with the same
    numpy models; every round's ``DecisionRecord`` per backend ("jax" the
    reference's)."""
    topo = make_topology(N, 4, 2, "ring", seed=0)
    sched = make_schedule(scenario, topo, rounds, seed=0)
    K = sched.width
    kw = dict(f=1, transient=1, window=2)
    rng = np.random.default_rng(5)
    us = [rng.standard_normal((N, d)).astype(np.float32) + np.float32(0.3)
          for _ in range(rounds)]
    recs = {}
    for b in BACKENDS + ("jax",):
        xp, mod = (jnp, jwf) if b == "jax" else (torch, wf)
        cfg = mod.WFAggConfig(backend="reference" if b == "jax" else b, **kw)
        z = lambda *shape, dt=np.float32: xp.asarray(np.zeros(shape, dt))  # noqa: E731
        st = mod.TemporalState(prev=z(N, d), hist_s=z(N, 2, K), hist_b=z(N, 2, K),
                               count=z(N, dt=np.int32), t=z(N, dt=np.int32))
        out = []
        for r in range(rounds):
            idx, val = xp.asarray(sched.neighbor_idx[r]), xp.asarray(sched.valid[r])
            if r > 0:
                st = mod.realign_temporal_history(
                    st, xp.asarray(sched.neighbor_idx[r - 1]),
                    xp.asarray(sched.valid[r - 1]), idx, val)
            u = xp.asarray(us[r])
            if b == "jax":
                _, st, info = jwf.wfagg_batch(u, u, st, cfg, neighbor_idx=idx, valid=val)
                rec = jdecision.record_from_info(info)
            else:
                _, st, info = wf.wfagg_batch(u, u, st, cfg, neighbor_idx=idx, valid=val,
                                             device="cpu")
                rec = obs.record_from_info(info)
            out.append([np.asarray(x) for x in rec])
        recs[b] = out
    return recs


@pytest.mark.parametrize("scenario", SCENARIO_NAMES)
def test_verdict_matches_reference_masks_every_scenario(scenario):
    recs = _scenario_records(scenario)
    ref = recs["reference"]
    for r, (rec, want) in enumerate(zip(ref, recs["jax"])):
        assert np.array_equal(rec[0], want[0]), (scenario, r)
        for a, b in zip(rec[1:4], want[1:4]):
            assert np.array_equal(a, b), (scenario, r)
    for b in BACKENDS:
        for r, (rec, rec_ref) in enumerate(zip(recs[b], ref)):
            bits, ref_bits = obs.unpack_verdict(rec[0]), obs.unpack_verdict(rec_ref[0])
            assert np.array_equal(bits["valid"], ref_bits["valid"]), (b, r)
            valid = bits["valid"]
            for name in ("mask_d", "mask_c", "mask_t", "accepted"):
                assert np.array_equal(bits[name][valid], ref_bits[name][valid]), \
                    (scenario, b, r, name)
            for i in (1, 2, 3):       # accepted, mean_fallback, degree_zero
                assert np.array_equal(rec[i], rec_ref[i]), (scenario, b, r, i)


def test_record_from_info_reflects_info_masks():
    rng = np.random.default_rng(7)
    for scenario in ("static", "eclipse"):
        topo = make_topology(8, 4, 2, "ring", seed=0)
        sched = make_schedule(scenario, topo, 3, seed=0)
        idx = torch.as_tensor(sched.neighbor_idx[-1])
        val = torch.as_tensor(sched.valid[-1])
        u = torch.as_tensor(rng.standard_normal((8, 96)).astype(np.float32) + 0.3)
        _, _, info = wf.wfagg_batch(u, u, None, wf.WFAggConfig(backend="fused", f=1),
                                    neighbor_idx=idx, valid=val, device="cpu")
        bits = obs.unpack_verdict(obs.record_from_info(info).verdict)
        for name in ("mask_d", "mask_c", "mask_t"):
            assert torch.equal(bits[name], info[name]), (scenario, name)
        assert torch.equal(bits["valid"], info["valid"])
        assert torch.equal(bits["accepted"], (info["weights"] > 0) & info["valid"])


# ---------------------------------------------------------------------------
# telemetry is an observer
# ---------------------------------------------------------------------------

def _small():
    topo = make_topology(8, 4, 2, "ring", seed=0)
    cfg = DFLConfig(aggregator="wfagg", attack="ipm_100", model="mlp", seed=0)
    return cfg, topo, SyntheticImages(seed=0)


def test_trajectory_bit_identical_dynamic():
    cfg, topo, data = _small()
    sched = make_schedule("churn", topo, 3, seed=0)
    off = run_dynamic_experiment(cfg, topo, data, sched, n_test=64, device="cpu")
    on = run_dynamic_experiment(cfg, topo, data, sched, n_test=64, telemetry=True,
                                device="cpu")
    assert off["series"]["acc_benign_mean"] == on["series"]["acc_benign_mean"]
    assert off["final"]["acc_all"] == on["final"]["acc_all"]
    tel = on["telemetry"]
    R, N, K = 3, topo.n_nodes, sched.width
    assert tel["verdict"].shape == (R, N, K) and tel["verdict"].dtype == np.uint8
    for key in ("accepted", "mean_fallback", "degree_zero", "entropy"):
        assert tel[key].shape == (R, N), key
    for key in ("mean_fallback_count", "degree_zero_count", "accepted_mean"):
        assert len(on["series"][key]) == R, key


def test_trajectory_bit_identical_static():
    cfg, topo, data = _small()
    off = run_experiment(cfg, topo, data, rounds=3, eval_every=3, device="cpu")
    on = run_experiment(cfg, topo, data, rounds=3, eval_every=3, telemetry=True,
                        device="cpu")
    assert off["final"]["acc_all"] == on["final"]["acc_all"]
    tel = on["telemetry"]
    assert tel["verdict"].shape[0] == 3
    assert tel["neighbor_idx"].shape == tel["verdict"].shape
    assert tel["valid"].shape == tel["verdict"].shape and tel["valid"].all()
    assert tel["malicious"].shape == (3, topo.n_nodes)
    for out in (off, on):
        assert len(out["series"]["mean_fallback_count"]) == 3
    assert "telemetry" not in off


def test_dos_scenario_surfaces_degree_zero():
    cfg, topo, data = _small()
    sched = make_schedule("dos", topo, 4, seed=0)
    assert (sched.valid.sum(axis=-1) == 0).any(), "fixture: dos should DoS someone"
    out = run_dynamic_experiment(cfg, topo, data, sched, n_test=64, telemetry=True,
                                 device="cpu")
    assert sum(out["series"]["degree_zero_count"]) > 0


def test_centralized_telemetry_rejected():
    topo = make_topology(8, 4, 2, "complete", seed=0)
    cfg = DFLConfig(aggregator="mean", attack="none", model="mlp", centralized=True)
    with pytest.raises(NotImplementedError, match="no edges"):
        run_experiment(cfg, topo, SyntheticImages(seed=0), rounds=1, telemetry=True,
                       device="cpu")


# ---------------------------------------------------------------------------
# export plane
# ---------------------------------------------------------------------------

def _synthetic_telemetry():
    """1 round, 2 receiving nodes, K=2, 4-node system, node 3 malicious.
    D catches both attacker edges and 1 of 2 benign; C accepts all; T
    rejects everything (transient-style blanket abstention)."""
    t, f = True, False
    mask_d = torch.tensor([[[f, f], [t, f]]])
    mask_c = torch.ones((1, 2, 2), dtype=torch.bool)
    mask_t = torch.zeros((1, 2, 2), dtype=torch.bool)
    valid = torch.ones((1, 2, 2), dtype=torch.bool)
    accepted = mask_d & mask_c
    return {
        "verdict": obs.pack_verdict(mask_d, mask_c, mask_t, valid, accepted).numpy(),
        "neighbor_idx": np.asarray([[[1, 3], [0, 3]]]),
        "valid": np.ones((1, 2, 2), bool),
        "malicious": np.asarray([[False, False, False, True]]),
        "accepted": accepted.sum(-1).to(torch.int32).numpy(),
        "mean_fallback": np.zeros((1, 2), bool),
        "degree_zero": np.zeros((1, 2), bool),
        "entropy": np.zeros((1, 2), np.float32),
    }


def test_filter_rates_exact():
    rates = obs_report.telemetry_rates(_synthetic_telemetry())
    np.testing.assert_array_equal(rates["n_attacker_edges"], [2.0])
    np.testing.assert_array_equal(rates["n_benign_edges"], [2.0])
    assert rates["d"]["true_catch"][0] == 1.0 and rates["d"]["false_pos"][0] == 0.5
    assert rates["c"]["true_catch"][0] == 0.0 and rates["c"]["false_pos"][0] == 0.0
    assert rates["t"]["true_catch"][0] == 1.0 and rates["t"]["false_pos"][0] == 1.0
    assert rates["final"]["true_catch"][0] == 1.0
    assert rates["final"]["false_pos"][0] == 0.5


def test_attribution_margin_rule():
    tel = _synthetic_telemetry()
    attr = obs_report.attribution(obs_report.telemetry_rates(tel))
    assert attr["carried_by"] == "d"
    assert attr["d"]["margin"] == 0.5 and attr["t"]["margin"] == 0.0
    # blanket abstention alone must not claim credit
    v = obs.unpack_verdict(tel["verdict"])
    v["mask_d"][:] = True
    tel2 = dict(tel, verdict=obs.pack_verdict(*(torch.as_tensor(v[k]) for k in (
        "mask_d", "mask_c", "mask_t", "valid", "accepted"))).numpy())
    assert obs_report.attribution(obs_report.telemetry_rates(tel2))["carried_by"] is None


def test_rates_nan_without_attackers():
    tel = _synthetic_telemetry()
    tel["malicious"] = np.zeros((1, 4), bool)
    rates = obs_report.telemetry_rates(tel)
    assert np.isnan(rates["d"]["true_catch"][0])
    assert obs_report.attribution(rates)["carried_by"] is None


def test_event_stream_schema_roundtrip(tmp_path):
    events = obs_report.events_from_telemetry(_synthetic_telemetry(), META)
    assert obs_recorder.validate_events(events, strict=True) == []
    path = str(tmp_path / "flight.jsonl")
    obs_recorder.write_events(events, path)
    assert obs_recorder.read_events(path) == json.loads(json.dumps(events))
    assert obs_recorder.validate_events(events[1:])          # no run_meta first
    doctored = [dict(ev) for ev in events]
    doctored[1]["verdict"] = [[1]]                           # wrong (N, K) shape
    assert any("verdict" in e for e in obs_recorder.validate_events(doctored))
    with pytest.raises(ValueError):
        obs_recorder.validate_events(doctored, strict=True)


def test_flight_recorder_streams_jsonl(tmp_path):
    path = str(tmp_path / "rec.jsonl")
    with obs_recorder.FlightRecorder(path) as rec:
        rec.emit("run_meta", n_nodes=2, width=2, rounds=1, aggregator="wfagg",
                 attack="none", scenario="static", backend="fused")
        rec.emit("round_timing", round=1, wall_s=0.5, kind="compile")
        with pytest.raises(ValueError):
            rec.emit("round_timing", round=2, wall_s=0.5, kind="bogus")
    assert len(obs_recorder.read_events(path)) == 2


def test_perfetto_trace_structure(tmp_path):
    events = obs_report.events_from_telemetry(_synthetic_telemetry(), META)
    path = str(tmp_path / "trace.json")
    obs_trace.write_trace(events, path)
    with open(path) as f:
        tes = json.load(f)["traceEvents"]
    assert tes and all(ev["ph"] in ("X", "C", "M") and "pid" in ev for ev in tes)
    slices = [ev for ev in tes if ev["ph"] == "X"]
    assert len(slices) == 1 and all(ev["dur"] > 0 for ev in slices)
    ts = [ev["ts"] for ev in tes if ev["ph"] in ("X", "C")]
    assert ts == sorted(ts)


def test_render_audit_smoke():
    text = obs_report.render_audit(obs_report.events_from_telemetry(
        _synthetic_telemetry(), META))
    assert "true-catch" in text and "carried by" in text.lower()


# ---------------------------------------------------------------------------
# the audit against the reference, on one JAX telemetry bundle
# ---------------------------------------------------------------------------

def _jax_bundle(kind):
    """A JAX ``out["telemetry"]`` bundle: an eclipse run under band_rider
    (the acceptance scenario at N=10, K=4), or a chaos run (fault bits)."""
    topo = jmake_topology(10, 4, 2, "ring", placement="close")
    cfg = jengine.DFLConfig(aggregator="wfagg", model="mlp", batches_per_round=1,
                            attack="band_rider" if kind == "eclipse" else "ipm_100")
    cfg = dataclasses.replace(cfg, paper=dataclasses.replace(cfg.paper, transient=1))
    if kind == "eclipse":
        sched, faults = jdyn.make_schedule("eclipse", topo, 4, seed=0), None
    else:
        sched, faults = jdyn.make_faulty_schedule("churn", topo, 3, fault="chaos",
                                                  intensity=0.6, seed=1, fault_seed=3)
    out = jengine.run_dynamic_experiment(cfg, topo, JImages(), sched, n_test=64,
                                         telemetry=True, faults=faults)
    return out["telemetry"], dict(aggregator="wfagg", attack=cfg.attack, scenario=kind,
                                  backend="fused")


def _timed(events):
    """The events with the timing plane's events a flight run adds."""
    rounds = [e["round"] for e in events if e["type"] == "round_decision"]
    extra = []
    for r in rounds:
        extra += [dict(type="round_timing", round=r, wall_s=0.01 * r,
                       kind="compile" if r == 1 else "steady"),
                  dict(type="round_eval", round=r, acc_benign_mean=0.5 + 0.1 * r)]
    extra.append(dict(type="profile", compile_s=0.01, steady_s_median=0.02,
                      bytes_per_round=1.5e6, achieved_bytes_per_s=7.5e7))
    return events + extra


@pytest.mark.parametrize("kind", ["eclipse", "chaos"])
def test_audit_matches_reference(kind):
    tel, meta = _jax_bundle(kind)
    events = obs_report.events_from_telemetry(tel, meta)
    want = jreport.events_from_telemetry(tel, meta)
    assert events == want
    assert obs_recorder.validate_events(events, strict=True) == []
    for ev in (events, _timed(events)):
        assert obs_report.render_audit(ev) == jreport.render_audit(ev)
        assert obs_trace.to_trace_events(ev) == jtrace.to_trace_events(ev)
    fr = obs_report.fault_rates(tel["verdict"])
    assert (fr["any"] > 0).any() == (kind == "chaos")
    assert obs_report.fault_attribution(fr) == jreport.fault_attribution(
        jreport.fault_rates(tel["verdict"]))


# ---------------------------------------------------------------------------
# timing plane and the report's entry point
# ---------------------------------------------------------------------------

def test_time_compile_steady():
    x = torch.ones((256,))
    res = obs_profile.time_compile_steady(lambda x: (x * 2.0).sum(), x, reps=3)
    assert res.compile_s > 0 and res.steady_s > 0
    assert len(res.steady_all_s) == 3
    assert res.steady_s == sorted(res.steady_all_s)[1]      # the median


def test_round_traffic_bytes_joins_memory_passes():
    wcfg = wf.WFAggConfig(backend="fused")
    N, K, d = 20, 8, 4096
    got = obs_profile.round_traffic_bytes(wcfg, N, K, d)
    assert got == wf.memory_passes(wcfg, include_gather=True, indexed=True) * N * K * d * 4
    assert obs_profile.achieved_bytes_per_s(got, 2.0) == got / 2.0


def test_report_main_runs_the_flight_on_the_cpu(tmp_path, capsys):
    """The entry point with the acceptance scenario cut to 10 nodes: a
    strictly valid log, a Perfetto trace and a ``torch.profiler`` capture
    (its "round r" spans), a replay of the log rendering the same audit,
    and the flight's decisions equal to ``run_dynamic_experiment``'s."""
    ev_path, tr_path = str(tmp_path / "run.jsonl"), str(tmp_path / "trace.json")
    cap = str(tmp_path / "capture")
    argv = ["--device", "cpu", "--nodes", "10", "--degree", "4", "--rounds", "4",
            "--n-test", "64"]
    assert obs_report.main(argv + ["--out-events", ev_path, "--out-trace", tr_path,
                                   "--capture-dir", cap]) == 0
    text = capsys.readouterr().out
    events = obs_recorder.read_events(ev_path)
    assert obs_recorder.validate_events(events, strict=True) == []
    assert [e["type"] for e in events][:1] == ["run_meta"]
    assert events[0]["attack"] == "band_rider" and events[0]["scenario"] == "eclipse"
    prof = [e for e in events if e["type"] == "profile"]
    assert len(prof) == 1 and prof[0]["bytes_per_round"] > 0
    with open(os.path.join(cap, obs_profile.TRACE_FILE)) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert {f"round {r}" for r in (1, 2, 3, 4)} <= names
    with open(tr_path) as f:
        assert len([e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]) == 4
    assert obs_report.main(["--events", ev_path]) == 0
    assert capsys.readouterr().out.strip() in text

    topo = make_topology(n_nodes=10, degree=4, n_malicious=2, kind="ring",
                         placement="close", seed=0)
    cfg = DFLConfig(aggregator="wfagg", attack="band_rider", model="mlp", seed=0)
    sched = make_schedule("eclipse", topo, 4, seed=0)
    out = run_dynamic_experiment(cfg, topo, SyntheticImages(seed=0), sched, n_test=64,
                                 telemetry=True, device="cpu")
    verdicts = [e["verdict"] for e in events if e["type"] == "round_decision"]
    assert np.array_equal(np.asarray(verdicts, np.uint8), out["telemetry"]["verdict"])
    accs = [e["acc_benign_mean"] for e in events if e["type"] == "round_eval"]
    np.testing.assert_allclose(accs, out["series"]["acc_benign_mean"], rtol=1e-6)


def test_flight_on_a_chaos_free_log_has_no_fault_column():
    """A clean log renders without the fault column, a faulty one with it
    (the port's chaos round sets bits 5-7)."""
    topo = make_topology(10, 4, 2, "ring", placement="close")
    sched, fs = make_faulty_schedule("churn", topo, 3, fault="chaos", intensity=0.6,
                                     seed=1, fault_seed=3)
    cfg = DFLConfig(aggregator="wfagg", attack="min_max", model="mlp",
                    batches_per_round=1)
    texts = []
    for faults in (None, fs):
        out = run_dynamic_experiment(cfg, topo, SyntheticImages(), sched, n_test=64,
                                     telemetry=True, faults=faults, device="cpu")
        texts.append(obs_report.render_audit(obs_report.events_from_telemetry(
            out["telemetry"], META)))
    assert "drp/stl/cor" not in texts[0] and "drp/stl/cor" in texts[1]
