"""Export plane, part 2: Chrome/Perfetto ``trace_event`` JSON (port of
``repro.obs.trace``).

Converts a flight-recorder event stream (``obs.recorder``) into the
Trace Event Format that ``ui.perfetto.dev`` / ``chrome://tracing`` load
directly: each round is a complete ("X") slice on the rounds track, and
the per-filter rejection counts, fallback counts and mean trust entropy
are counter ("C") tracks aligned to the slice starts.

Rounds without a ``round_timing`` event (a record exported from a whole
``run_dynamic_experiment``, which times no single round into the log)
get a nominal 1 ms slice so the counter tracks still render on a usable
time axis.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List

import numpy as np

from repro_torch.obs.decision import BITS

_PID = 0
_TID_ROUNDS = 0
_DEFAULT_DUR_US = 1000.0   # nominal slice for rounds without wall clock


def _rejections(verdict: np.ndarray) -> Dict[str, int]:
    """Per-filter rejection counts over one round's (N, K) verdict:
    rejected-by-F = valid edge whose F bit is unset.  Only meaningful
    when the filter actually ran (wfagg family); for uniform/baseline
    records the accepted bit equals valid and these all read N*K-ish —
    the report layer guards on that, the trace just plots."""
    v = np.asarray(verdict, np.uint8)
    valid = (v >> BITS["valid"]) & 1
    out = {}
    for name, key in (("D", "mask_d"), ("C", "mask_c"), ("T", "mask_t")):
        ok = (v >> BITS[key]) & 1
        out[name] = int((valid & (1 - ok)).sum())
    out["final"] = int((valid & (1 - ((v >> BITS["accepted"]) & 1))).sum())
    return out


def to_trace_events(events: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Flight-recorder events -> list of Trace Event Format dicts."""
    events = list(events)
    meta = next((e for e in events if e.get("type") == "run_meta"), {})
    title = (f"dfl {meta.get('aggregator', '?')} vs "
             f"{meta.get('attack', '?')} [{meta.get('scenario', '?')}]"
             if meta else "dfl flight")
    out: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": _PID,
         "args": {"name": title}},
        {"name": "thread_name", "ph": "M", "pid": _PID, "tid": _TID_ROUNDS,
         "args": {"name": "rounds"}},
    ]

    wall_us = {e["round"]: 1e6 * e["wall_s"] for e in events
               if e.get("type") == "round_timing"}
    kind = {e["round"]: e["kind"] for e in events
            if e.get("type") == "round_timing"}
    acc = {e["round"]: e["acc_benign_mean"] for e in events
           if e.get("type") == "round_eval"}
    decisions = [e for e in events if e.get("type") == "round_decision"]
    rounds = sorted({e["round"] for e in decisions} | set(wall_us))

    ts = 0.0
    for r in rounds:
        dur = wall_us.get(r, _DEFAULT_DUR_US)
        dec = next((e for e in decisions if e["round"] == r), None)
        slice_args: Dict[str, Any] = {"kind": kind.get(r, "steady")}
        if r in acc:
            slice_args["acc_benign_mean"] = round(acc[r], 4)
        if dec is not None:
            slice_args["accepted_total"] = int(np.sum(dec["accepted"]))
            slice_args["mean_fallback"] = int(np.sum(dec["mean_fallback"]))
            slice_args["degree_zero"] = int(np.sum(dec["degree_zero"]))
        out.append({"name": f"round {r}", "cat": "round", "ph": "X",
                    "ts": ts, "dur": dur, "pid": _PID, "tid": _TID_ROUNDS,
                    "args": slice_args})
        if dec is not None:
            rej = _rejections(np.asarray(dec["verdict"]))
            out.append({"name": "filter rejections", "ph": "C", "ts": ts,
                        "pid": _PID, "args": rej})
            out.append({"name": "fallback", "ph": "C", "ts": ts, "pid": _PID,
                        "args": {"mean_fallback": int(np.sum(dec["mean_fallback"])),
                                 "degree_zero": int(np.sum(dec["degree_zero"]))}})
            out.append({"name": "trust entropy (mean)", "ph": "C", "ts": ts,
                        "pid": _PID,
                        "args": {"nats": round(float(np.mean(dec["entropy"])), 4)}})
        if r in acc:
            out.append({"name": "benign accuracy", "ph": "C", "ts": ts,
                        "pid": _PID, "args": {"acc": round(acc[r], 4)}})
        ts += dur
    return out


def write_trace(events: Iterable[Dict[str, Any]], path: str) -> None:
    """Write the Perfetto-loadable JSON object form
    (``{"traceEvents": [...]}``) — the safest of the accepted container
    formats for third-party viewers."""
    with open(path, "w") as f:
        json.dump({"traceEvents": to_trace_events(events),
                   "displayTimeUnit": "ms"}, f, indent=1)
        f.write("\n")
