"""Export plane, part 3: the audit report (port of ``repro.obs.report``).

``python -m repro_torch.obs.report`` either replays a recorded JSONL
event log (``--events run.jsonl``) or runs a fresh experiment round by
round with the flight recorder on (defaults: the reference's acceptance
scenario: 20-node ring, eclipse topology attack, band_rider adaptive
adversary, WFAgg on ``fused``; ``--device cpu`` runs it on the CPU),
then renders:

- the per-filter decision audit: for every round, each filter's
  TRUE-CATCH rate (fraction of valid attacker edges it rejected) and
  FALSE-POSITIVE rate (fraction of valid benign edges it rejected): the
  table that says which filter actually carried the defense;
- mean-fallback and degree-0 counts per round;
- the round timeline: first-round vs steady wall clock and the achieved
  bytes/s against the ``memory_passes`` traffic table;
- on fault-injected logs (verdict bits 5-7 set, ``dfl.faults``): a
  per-round dropped/stale/corrupted edge column and a per-fault
  attribution summary; clean logs render without them.

With ``--out-events`` / ``--out-trace`` it writes the JSONL log and the
Perfetto ``trace_event`` JSON; with ``--capture-dir`` a
``torch.profiler`` trace of the run (``obs.profile.capture``).  The
analysis helpers (:func:`attacker_edge_mask`, :func:`filter_rates`,
:func:`attribution`, ...) are plain numpy over the packed verdicts, the
same functions as the reference's, so both packages render one audit
from one event log.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.obs import profile as obs_profile
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.decision import BITS, FAULT_BITS

FILTERS = (("d", "mask_d"), ("c", "mask_c"), ("t", "mask_t"))

#: chaos-transport attribution bits (decision verdict bits 5-7); short
#: label -> FAULT_BITS key.  Zero on clean runs, so the audit only grows its
#: fault column when a fault-injected log is being rendered.
FAULT_KINDS = (("drp", "dropped"), ("stl", "stale"), ("cor", "corrupt"))


# ---------------------------------------------------------------------------
# analysis over packed verdicts (plain numpy, reusable)
# ---------------------------------------------------------------------------

def attacker_edge_mask(neighbor_idx: np.ndarray, valid: np.ndarray,
                       malicious: np.ndarray) -> np.ndarray:
    """(R, N, K) bool: edge (r, n, k) is valid AND its sender (the
    neighbor ``neighbor_idx[r, n, k]``) is malicious in round r."""
    idx = np.asarray(neighbor_idx)
    R = idx.shape[0]
    mal = np.asarray(malicious, bool)
    sender_mal = mal[np.arange(R)[:, None, None], idx]
    return sender_mal & np.asarray(valid, bool)


def filter_rates(verdict: np.ndarray, neighbor_idx: np.ndarray,
                 valid: np.ndarray, malicious: np.ndarray) -> Dict[str, Any]:
    """Per-round true-catch / false-positive rates per filter.

    Returns ``{"d"|"c"|"t"|"final": {"true_catch": (R,), "false_pos":
    (R,)}, "n_attacker_edges": (R,), "n_benign_edges": (R,)}`` where
    true-catch[r] is the fraction of valid attacker edges the filter
    rejected in round r (NaN when the round has no attacker edges) and
    false-pos[r] the fraction of valid benign edges it rejected.
    "final" is the 2-of-3 vote's verdict (the accepted bit).

    Caveat read with the tables: WFAgg-T abstains during its transient
    (mask_t is all-false before the EWMA bands exist), which reads as
    rejecting EVERYTHING in early rounds — per-round tables make that
    visible instead of averaging it away.
    """
    v = np.asarray(verdict, np.uint8)
    valid_b = ((v >> BITS["valid"]) & 1).astype(bool)
    attacker = attacker_edge_mask(neighbor_idx, valid, malicious) & valid_b
    benign = valid_b & ~attacker
    n_att = attacker.sum(axis=(1, 2)).astype(float)
    n_ben = benign.sum(axis=(1, 2)).astype(float)
    out: Dict[str, Any] = {"n_attacker_edges": n_att, "n_benign_edges": n_ben}
    for name, key in FILTERS + (("final", "accepted"),):
        ok = ((v >> BITS[key]) & 1).astype(bool)
        rejected = valid_b & ~ok
        with np.errstate(invalid="ignore", divide="ignore"):
            tc = np.where(n_att > 0,
                          (rejected & attacker).sum(axis=(1, 2)) / np.maximum(n_att, 1),
                          np.nan)
            fp = np.where(n_ben > 0,
                          (rejected & benign).sum(axis=(1, 2)) / np.maximum(n_ben, 1),
                          np.nan)
        out[name] = {"true_catch": tc, "false_pos": fp}
    return out


def attribution(rates: Dict[str, Any]) -> Dict[str, Any]:
    """Which filter carried the defense: mean (true-catch − false-pos)
    margin per filter over the rounds that HAD attacker edges;
    ``carried_by`` is the best filter with a STRICTLY POSITIVE margin
    (None otherwise).  The margin (not raw catch rate) keeps the
    temporal filter's transient — where it "catches" everything by
    abstaining — from claiming credit it shares with every benign edge
    it also dropped."""
    out: Dict[str, Any] = {}
    best, best_margin = None, 0.0
    for name, _ in FILTERS:
        tc, fp = rates[name]["true_catch"], rates[name]["false_pos"]
        seen = ~np.isnan(tc)
        if not seen.any():
            out[name] = {"true_catch": None, "false_pos": None, "margin": None}
            continue
        mtc = float(np.nanmean(tc))
        mfp = float(np.nanmean(np.where(seen, fp, np.nan)))
        margin = mtc - (0.0 if np.isnan(mfp) else mfp)
        out[name] = {"true_catch": round(mtc, 4),
                     "false_pos": round(mfp, 4) if not np.isnan(mfp) else None,
                     "margin": round(margin, 4)}
        # a filter only gets credit for a strictly positive margin: a
        # filter that rejects everything (e.g. WFAgg-T in transient) or
        # nothing scores <= 0 and cannot "carry" the defense
        if margin > best_margin:
            best, best_margin = name, margin
    out["carried_by"] = best
    return out


def fault_rates(verdict: np.ndarray) -> Dict[str, Any]:
    """Per-round transport-fault rates off the packed verdicts.

    Returns ``{"dropped"|"stale"|"corrupt"|"any": (R,) fraction of slate
    edges, "counts": {kind: (R,) int}}``.  The denominator is the full
    N*K slate (not the valid mask): a dropped edge is by definition no
    longer valid, so rating faults against surviving edges would hide
    exactly the events being attributed.  All zeros on clean runs —
    bits 5-7 are only OR'd in by fault-injected rounds
    (:func:`obs.decision.with_fault_bits`)."""
    v = np.asarray(verdict, np.uint8)
    edges = float(v.shape[-1] * v.shape[-2])
    axes = (-2, -1)
    out: Dict[str, Any] = {"counts": {}}
    any_m = np.zeros(v.shape, bool)
    for _, kind in FAULT_KINDS:
        m = ((v >> FAULT_BITS[kind]) & 1).astype(bool)
        any_m |= m
        out["counts"][kind] = m.sum(axis=axes)
        out[kind] = m.sum(axis=axes) / edges
    out["any"] = any_m.sum(axis=axes) / edges
    return out


def fault_attribution(rates: Dict[str, Any]) -> Dict[str, Any]:
    """Mean per-kind fault rate over the run + the dominant kind (None
    when the log carries no fault bits at all — i.e. a clean run)."""
    out: Dict[str, Any] = {}
    best, best_rate = None, 0.0
    for _, kind in FAULT_KINDS:
        mean = float(np.mean(rates[kind]))
        out[kind] = round(mean, 4)
        if mean > best_rate:
            best, best_rate = kind, mean
    out["dominant"] = best
    return out


def telemetry_rates(telemetry: Dict[str, Any]) -> Dict[str, Any]:
    """:func:`filter_rates` straight off an engine ``out["telemetry"]``
    bundle (run_experiment / run_dynamic_experiment with
    ``telemetry=True``)."""
    return filter_rates(telemetry["verdict"], telemetry["neighbor_idx"],
                        telemetry["valid"], telemetry["malicious"])


def events_from_telemetry(telemetry: Dict[str, Any],
                          meta: Optional[Dict[str, Any]] = None) -> list:
    """Recorder-schema event stream from an engine ``out["telemetry"]``
    bundle — decision events only: the bundle carries no per-round wall
    clock (:func:`run_flight` times each round), so no ``round_timing``
    events are synthesized."""
    verdict = np.asarray(telemetry["verdict"], np.uint8)
    R, N, K = verdict.shape
    base: Dict[str, Any] = dict(n_nodes=N, width=K, rounds=R,
                                aggregator="?", attack="?", scenario="?",
                                backend="?")
    base.update(meta or {})
    events = [obs_recorder._jsonable(dict(type="run_meta", **base))]
    for r in range(R):
        events.append(obs_recorder._jsonable(dict(
            type="round_decision", round=r + 1,
            verdict=verdict[r],
            neighbor_idx=np.asarray(telemetry["neighbor_idx"][r]),
            malicious=np.asarray(telemetry["malicious"][r], bool),
            accepted=np.asarray(telemetry["accepted"][r]),
            mean_fallback=np.asarray(telemetry["mean_fallback"][r], bool),
            degree_zero=np.asarray(telemetry["degree_zero"][r], bool),
            entropy=np.asarray(telemetry["entropy"][r]))))
    return events


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def _pct(x: float) -> str:
    return "    --" if x is None or np.isnan(x) else f"{100 * x:6.1f}"


def render_audit(events) -> str:
    """The audit tables from a flight-recorder event stream."""
    meta = next((e for e in events if e.get("type") == "run_meta"), {})
    decisions = [e for e in events if e.get("type") == "round_decision"]
    if not decisions:
        return "no round_decision events — was telemetry on?"
    verdict = np.asarray([e["verdict"] for e in decisions], np.uint8)
    nidx = np.asarray([e["neighbor_idx"] for e in decisions])
    mal = np.asarray([e["malicious"] for e in decisions], bool)
    valid = ((verdict >> BITS["valid"]) & 1).astype(bool)
    rates = filter_rates(verdict, nidx, valid, mal)
    attr = attribution(rates)
    frates = fault_rates(verdict)
    has_faults = bool(np.any(frates["any"] > 0))
    wall = {e["round"]: e for e in events if e.get("type") == "round_timing"}
    acc = {e["round"]: e["acc_benign_mean"] for e in events
           if e.get("type") == "round_eval"}

    lines = []
    lines.append(
        f"flight audit: {meta.get('aggregator', '?')} vs "
        f"{meta.get('attack', '?')} attack, {meta.get('scenario', '?')} "
        f"scenario, {meta.get('n_nodes', '?')} nodes "
        f"[{meta.get('backend', '?')} backend]")
    lines.append("")
    lines.append("per-filter decision audit — true-catch % of attacker "
                 "edges / false-positive % of benign edges")
    lines.append(f"{'round':>5s} {'edges(att/ben)':>14s}"
                 + "".join(f"{f.upper() + ' tc/fp':>16s}" for f, _ in FILTERS)
                 + f"{'FINAL tc/fp':>16s}"
                 + f"{'fallbk':>7s}{'deg0':>5s}"
                 + (f"{'drp/stl/cor':>13s}" if has_faults else "")
                 + f"{'acc%':>7s}{'ms':>9s}")
    for r, dec in enumerate(decisions, start=1):
        row = f"{r:5d} {int(rates['n_attacker_edges'][r-1]):6d}/"
        row += f"{int(rates['n_benign_edges'][r-1]):<7d}"
        for name, _ in FILTERS + (("final", None),):
            tc = rates[name]["true_catch"][r - 1]
            fp = rates[name]["false_pos"][r - 1]
            row += f" {_pct(tc)}/{_pct(fp).strip():>5s}"
        row += f"{int(np.sum(dec['mean_fallback'])):7d}"
        row += f"{int(np.sum(dec['degree_zero'])):5d}"
        if has_faults:
            cts = frates["counts"]
            cell = "/".join(str(int(cts[k][r - 1])) for _, k in FAULT_KINDS)
            row += f"{cell:>13s}"
        row += (f"{100 * acc[r]:7.2f}" if r in acc else f"{'--':>7s}")
        w = wall.get(r)
        row += (f"{1e3 * w['wall_s']:9.1f}" if w else f"{'--':>9s}")
        lines.append(row)

    lines.append("")
    lines.append("filter attribution (mean over attacked rounds, margin = "
                 "true-catch − false-positive):")
    for name, _ in FILTERS:
        a = attr[name]
        if a["true_catch"] is None:
            lines.append(f"  {name.upper()}: no attacked rounds")
        else:
            lines.append(f"  {name.upper()}: true-catch {100*a['true_catch']:5.1f}%  "
                         f"false-pos {100*(a['false_pos'] or 0):5.1f}%  "
                         f"margin {100*a['margin']:+6.1f}%")
    lines.append("  defense carried by: "
                 + (attr["carried_by"].upper() if attr["carried_by"]
                    else "none (no filter beat its false-positive rate — "
                         "transient, or no attacker present)"))

    if has_faults:
        fattr = fault_attribution(frates)
        lines.append("")
        lines.append("transport-fault attribution (mean % of slate edges "
                     "per round, docs/FAULTS.md):")
        lines.append("  " + "  ".join(
            f"{kind} {100 * fattr[kind]:5.2f}%" for _, kind in FAULT_KINDS)
            + f"  dominant: {fattr['dominant'] or 'none'}")

    prof = next((e for e in events if e.get("type") == "profile"), None)
    if prof is not None:
        lines.append("")
        lines.append(
            f"timing: compile {prof['compile_s']:.2f}s, steady median "
            f"{1e3 * prof['steady_s_median']:.1f}ms/round, analytic "
            f"traffic {prof['bytes_per_round'] / 1e6:.2f} MB/round -> "
            f"achieved {prof['achieved_bytes_per_s'] / 1e9:.3f} GB/s")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the flight run: drive an experiment round by round, recorder on
# ---------------------------------------------------------------------------

def run_flight(cfg, topo, data, schedule, recorder: obs_recorder.FlightRecorder,
               n_test: int = 256, scenario: str = "?",
               capture_dir: Optional[str] = None, device=None) -> None:
    """Run the schedule round by round on ``device`` (None: the card) with
    telemetry on, emitting decision, timing and eval events into
    ``recorder``.

    The same rounds as ``run_dynamic_experiment`` (the same
    ``build_round_fn(dynamic=True, telemetry=True)`` round, the same
    ``realign_temporal_history`` re-keying between slates), driven here so
    every round gets its own wall clock, ended by
    ``torch.cuda.synchronize()``, and an ``obs.profile.annotate`` span
    ("round r") in the ``capture_dir`` trace.  Round 1 is timed as
    "compile" (on the card: kernel-library load and set-up)."""
    from repro_torch.core import metrics as met
    from repro_torch.core import wfagg as wf
    from repro_torch.dfl import engine as eng
    from repro_torch.kernels.common import resolve_device
    from repro_torch.models.lenet import MODELS, ravel

    dev = resolve_device(device)
    state = eng.init_dfl_state(cfg, topo, degree=schedule.width, device=dev)
    round_fn = eng.build_round_fn(cfg, topo, data, dynamic=True, telemetry=True,
                                  device=dev)
    _, fwd = MODELS[cfg.model]
    imgs, labels = data.test_set(n_test, dev)
    benign = ~schedule.malicious.any(axis=0)

    recorder.emit(
        "run_meta", n_nodes=int(topo.n_nodes), width=int(schedule.width),
        rounds=int(schedule.rounds), aggregator=cfg.aggregator,
        attack=cfg.attack, scenario=scenario, backend=cfg.wfagg_backend)

    idx, val, mal = (torch.as_tensor(np.asarray(a), device=dev) for a in (
        schedule.neighbor_idx, schedule.valid, schedule.malicious))
    prev_r = 0
    walls = []
    with obs_profile.capture(capture_dir):
        for r in range(schedule.rounds):
            if state.temporal is not None:
                state = state._replace(temporal=wf.realign_temporal_history(
                    state.temporal, idx[prev_r], val[prev_r], idx[r], val[r]))
            prev_r = r
            with obs_profile.annotate(f"round {r + 1}"):
                t0 = time.perf_counter()
                state, record = round_fn(state, idx[r], val[r], mal[r])
                obs_profile.block_until_ready((state.node_params, record))
                wall = time.perf_counter() - t0
            walls.append(wall)
            recorder.emit(
                "round_decision", round=r + 1,
                verdict=record.verdict.cpu().numpy(),
                neighbor_idx=np.asarray(schedule.neighbor_idx[r]),
                malicious=np.asarray(schedule.malicious[r]),
                accepted=record.accepted.cpu().numpy(),
                mean_fallback=record.mean_fallback.cpu().numpy(),
                degree_zero=record.degree_zero.cpu().numpy(),
                entropy=record.entropy.cpu().numpy())
            recorder.emit("round_timing", round=r + 1, wall_s=wall,
                          kind="compile" if r == 0 else "steady")
            with torch.no_grad():
                logits = torch.func.vmap(fwd, in_dims=(0, None))(state.node_params, imgs)
                accs = met.micro_accuracy(logits, labels[None]).cpu().numpy()
            recorder.emit("round_eval", round=r + 1,
                          acc_benign_mean=float(accs[benign].mean()))

    steady = sorted(walls[1:]) or walls
    steady_median = steady[len(steady) // 2]
    d = int(ravel(state.node_params).shape[1])
    traffic = obs_profile.round_traffic_bytes(
        cfg.wfagg_config(), topo.n_nodes, int(schedule.width), d)
    recorder.emit(
        "profile", compile_s=walls[0], steady_s_median=steady_median,
        bytes_per_round=traffic,
        achieved_bytes_per_s=obs_profile.achieved_bytes_per_s(traffic, steady_median))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="flight-recorder audit report")
    ap.add_argument("--events", default="",
                    help="replay a recorded JSONL event log instead of "
                         "running an experiment")
    ap.add_argument("--aggregator", default="wfagg")
    ap.add_argument("--attack", default="band_rider")
    ap.add_argument("--scenario", default="eclipse")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--nodes", type=int, default=20)
    ap.add_argument("--degree", type=int, default=8)
    ap.add_argument("--malicious", type=int, default=2)
    ap.add_argument("--backend", default="fused")
    ap.add_argument("--model", default="mlp", choices=("mlp", "lenet"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-test", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device of the run (default: the CUDA card; "
                         "'cpu' runs the plain versions of the kernels)")
    ap.add_argument("--out-events", default="",
                    help="write the JSONL event log here")
    ap.add_argument("--out-trace", default="",
                    help="write Perfetto trace_event JSON here "
                         "(load at ui.perfetto.dev)")
    ap.add_argument("--capture-dir", default="",
                    help="opt-in torch.profiler capture directory (a Chrome "
                         "trace of the run, CUDA kernels included on the card)")
    args = ap.parse_args(argv)

    if args.events:
        events = obs_recorder.read_events(args.events)
        obs_recorder.validate_events(events, strict=True)
    else:
        from repro_torch.core.topology import make_topology
        from repro_torch.data.synthetic import SyntheticImages
        from repro_torch.dfl.dynamics import make_schedule
        from repro_torch.dfl.engine import DFLConfig

        topo = make_topology(n_nodes=args.nodes, degree=args.degree,
                             n_malicious=args.malicious, kind="ring",
                             placement="close", seed=args.seed)
        data = SyntheticImages(seed=args.seed)
        cfg = DFLConfig(aggregator=args.aggregator, attack=args.attack,
                        model=args.model, seed=args.seed,
                        wfagg_backend=args.backend)
        schedule = make_schedule(args.scenario, topo, args.rounds, seed=args.seed)
        with obs_recorder.FlightRecorder(args.out_events or None) as rec:
            run_flight(cfg, topo, data, schedule, rec, n_test=args.n_test,
                       scenario=args.scenario,
                       capture_dir=args.capture_dir or None, device=args.device)
        events = rec.events
        obs_recorder.validate_events(events, strict=True)

    print(render_audit(events))
    if args.out_trace:
        obs_trace.write_trace(events, args.out_trace)
        print(f"\nwrote Perfetto trace: {args.out_trace}")
    if args.out_events and not args.events:
        print(f"wrote event log:     {args.out_events}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
