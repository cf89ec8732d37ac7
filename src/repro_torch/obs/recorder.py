"""Export plane, part 1: the structured JSONL event log (port of
``repro.obs.recorder``, numpy only, with the schema unchanged).

One run = one event stream.  Every event is a flat JSON object with a
``type`` field; the schema below is the contract that
``validate_events`` checks and that ``obs.trace`` / ``obs.report``
consume.

Event types:

``run_meta``        once, first: the run's shape and knobs.
``round_decision``  per round: the decision plane (the packed verdict
                    bitmask of ``obs.decision``), slate context and
                    per-node summaries.
``round_timing``    per round: wall seconds; ``kind`` is "compile" for
                    the first round (kernel-library load and set-up),
                    "steady" after.
``round_eval``      per evaluated round: benign accuracy.
``profile``         once, last: the compile/steady split and the
                    ``memory_passes`` bandwidth join (``obs.profile``).
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

#: type name -> {field: allowed python types}; every event also gets
#: free-form extra fields (the schema pins the floor, not the ceiling).
SCHEMA: Dict[str, Dict[str, tuple]] = {
    "run_meta": {
        "n_nodes": (int,), "width": (int,), "rounds": (int,),
        "aggregator": (str,), "attack": (str,), "scenario": (str,),
        "backend": (str,),
    },
    "round_decision": {
        "round": (int,),            # 1-based
        "verdict": (list,),         # (N, K) uint8 bitmask, nested lists
        "neighbor_idx": (list,),    # (N, K) int
        "malicious": (list,),       # (N,) bool
        "accepted": (list,),        # (N,) int
        "mean_fallback": (list,),   # (N,) bool
        "degree_zero": (list,),     # (N,) bool
        "entropy": (list,),         # (N,) float
    },
    "round_timing": {
        "round": (int,), "wall_s": (float,), "kind": (str,),
    },
    "round_eval": {
        "round": (int,), "acc_benign_mean": (float,),
    },
    "profile": {
        "compile_s": (float,), "steady_s_median": (float,),
        "bytes_per_round": (float, int), "achieved_bytes_per_s": (float, int),
    },
}

_TIMING_KINDS = ("compile", "steady")


def _jsonable(value: Any) -> Any:
    """numpy arrays/scalars -> plain python, recursively."""
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (np.bool_, np.integer, np.floating)):
        return value.item()
    if isinstance(value, dict):
        return {k: _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    return value


def validate_event(event: Dict[str, Any]) -> List[str]:
    """Schema errors for one event ([] = valid)."""
    errs = []
    etype = event.get("type")
    if etype not in SCHEMA:
        return [f"unknown event type {etype!r}"]
    for field, types in SCHEMA[etype].items():
        if field not in event:
            errs.append(f"{etype}: missing field {field!r}")
        elif not isinstance(event[field], types):
            errs.append(f"{etype}.{field}: expected {types}, got "
                        f"{type(event[field]).__name__}")
    if etype == "round_timing" and event.get("kind") not in _TIMING_KINDS:
        errs.append(f"round_timing.kind: expected one of {_TIMING_KINDS}, "
                    f"got {event.get('kind')!r}")
    return errs


def validate_events(events: Iterable[Dict[str, Any]],
                    strict: bool = False) -> List[str]:
    """Schema errors for a whole stream, plus stream-level checks: the
    stream must open with ``run_meta``, and every ``round_decision``
    verdict must be (N, K)-shaped per the meta.  ``strict`` raises."""
    events = list(events)
    errs: List[str] = []
    if not events:
        errs.append("empty event stream")
    elif events[0].get("type") != "run_meta":
        errs.append("stream must open with a run_meta event")
    meta = events[0] if events and events[0].get("type") == "run_meta" else {}
    for i, ev in enumerate(events):
        for e in validate_event(ev):
            errs.append(f"event[{i}]: {e}")
    n, k = meta.get("n_nodes"), meta.get("width")
    if isinstance(n, int) and isinstance(k, int):
        for i, ev in enumerate(events):
            if ev.get("type") != "round_decision":
                continue
            v = ev.get("verdict")
            if (not isinstance(v, list) or len(v) != n
                    or any(not isinstance(row, list) or len(row) != k
                           for row in v)):
                errs.append(f"event[{i}]: round_decision.verdict is not "
                            f"({n}, {k})-shaped")
    if strict and errs:
        raise ValueError("invalid event stream:\n  " + "\n  ".join(errs))
    return errs


class FlightRecorder:
    """Collects events in memory and (optionally) streams them to a
    JSONL file as they are emitted — a crash still leaves the rounds
    recorded so far on disk.

        with FlightRecorder("run.jsonl") as rec:
            rec.emit("run_meta", n_nodes=20, ...)
            rec.emit("round_decision", round=1, verdict=..., ...)
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.events: List[Dict[str, Any]] = []
        self._fh = open(path, "w") if path else None

    def emit(self, etype: str, **fields: Any) -> Dict[str, Any]:
        event = {"type": etype, **{k: _jsonable(v) for k, v in fields.items()}}
        errs = validate_event(event)
        if errs:
            raise ValueError("invalid event:\n  " + "\n  ".join(errs))
        self.events.append(event)
        if self._fh is not None:
            self._fh.write(json.dumps(event) + "\n")
            self._fh.flush()
        return event

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "FlightRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_events(events: Iterable[Dict[str, Any]], path: str) -> None:
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(_jsonable(ev)) + "\n")


def read_events(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
