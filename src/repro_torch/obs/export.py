"""Trace export: Chrome-trace / Perfetto JSON and JSON-native values.

:func:`chrome_trace` turns a :class:`~repro_torch.obs.trace.SpanTracer`
record stream into the Chrome Trace Event Format (the ``{"traceEvents":
[...]}`` object) that Perfetto (https://ui.perfetto.dev) and
``chrome://tracing`` load: one thread track per client, one server
track, and a ``queue_depth`` counter track.  Timestamps are the
simulated clock in microseconds.  The events are the reference's
(``repro.obs.export``) for the same records.

:func:`to_native` turns numpy scalars and arrays, CPU tensors and
non-string dict keys into plain JSON types, so that
``json.loads(json.dumps(x)) == x`` holds exactly (``fl_sim --json-out``
is built on it).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

_PID = 1
_SERVER_TID = 0
#: record keys consumed structurally (everything else lands in args)
_STRUCT_KEYS = ("kind", "name", "cat", "cid", "slot", "t", "t0", "t1",
                "round", "wall")


def to_native(obj: Any) -> Any:
    """Recursively convert to JSON-native types that round-trip through
    ``json.dumps``/``json.loads`` by equality (numpy scalars and 0-d CPU
    tensors -> Python scalars, arrays and CPU tensors -> lists, dict
    keys -> str)."""
    if isinstance(obj, dict):
        return {str(k): to_native(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_native(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return [to_native(v) for v in obj.tolist()]
    if isinstance(obj, torch.Tensor):
        # host values only: a device tensor would be a hidden copy
        if obj.device.type != "cpu":
            raise TypeError(f"to_native takes CPU tensors, not one on "
                            f"{obj.device}")
        return to_native(obj.tolist())
    if isinstance(obj, (bool, np.bool_)):
        return bool(obj)
    if isinstance(obj, (int, np.integer)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        return float(obj)
    if obj is None or isinstance(obj, str):
        return obj
    return str(obj)


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load a SpanTracer trace.jsonl file back into a record list."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def _us(t: float) -> float:
    return float(t) * 1e6


def chrome_trace(records: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Build a Chrome-trace object from a SpanTracer record stream."""
    meta: Dict[str, Any] = {}
    events: List[Dict[str, Any]] = []
    named_tids = set()

    def _name_tid(tid: int, name: str) -> None:
        if tid in named_tids:
            return
        named_tids.add(tid)
        events.append({"ph": "M", "name": "thread_name", "pid": _PID,
                       "tid": tid, "args": {"name": name},
                       # sort server first, then clients by id
                       "ts": 0})
        events.append({"ph": "M", "name": "thread_sort_index", "pid": _PID,
                       "tid": tid, "ts": 0, "args": {"sort_index": tid}})

    events.append({"ph": "M", "name": "process_name", "pid": _PID,
                   "tid": _SERVER_TID, "ts": 0,
                   "args": {"name": "safl-sim"}})
    _name_tid(_SERVER_TID, "server")

    depth = 0
    for rec in records:
        kind = rec.get("kind")
        if kind == "meta":
            meta = {k: v for k, v in rec.items() if k != "kind"}
            continue
        name = rec.get("name", "")
        cid = rec.get("cid")
        # server-cat records (ingest/aggregate/round) live on the server
        # track; client-cat spans and sched instants on the client's own
        on_server = rec.get("cat") == "server" or cid is None
        tid = _SERVER_TID if on_server else int(cid) + 1
        if not on_server:
            _name_tid(tid, f"client {cid}")
        args = {k: v for k, v in rec.items() if k not in _STRUCT_KEYS}
        if cid is not None and on_server:
            args["cid"] = cid
        if kind == "span":
            events.append({"ph": "X", "name": name, "cat": rec.get("cat", ""),
                           "pid": _PID, "tid": tid, "ts": _us(rec["t0"]),
                           "dur": max(_us(rec["t1"]) - _us(rec["t0"]), 0.0),
                           "args": args})
            if name == "aggregate":
                depth = 0
                events.append({"ph": "C", "name": "queue_depth", "pid": _PID,
                               "ts": _us(rec["t0"]),
                               "args": {"uploads": depth}})
        elif kind == "instant":
            events.append({"ph": "i", "name": name, "cat": rec.get("cat", ""),
                           "pid": _PID, "tid": tid, "ts": _us(rec["t"]),
                           "s": "t", "args": args})
            if name == "ingest":
                depth += 1
                events.append({"ph": "C", "name": "queue_depth", "pid": _PID,
                               "ts": _us(rec["t"]),
                               "args": {"uploads": depth}})
    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": to_native(meta)}


def validate_chrome_trace(obj: Any) -> int:
    """Validate the Chrome Trace Event Format shape; raise ValueError on
    the first violation, return the event count on success."""
    if not isinstance(obj, dict):
        raise ValueError("trace must be a JSON object")
    evs = obj.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        raise ValueError("traceEvents must be a non-empty list")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        ph = ev.get("ph")
        if ph not in ("X", "i", "I", "M", "C", "B", "E"):
            raise ValueError(f"event {i}: bad ph {ph!r}")
        if not isinstance(ev.get("name"), str) or "pid" not in ev:
            raise ValueError(f"event {i}: missing name/pid")
        if ph in ("X", "i", "I", "C", "B", "E"):
            if not isinstance(ev.get("ts"), (int, float)):
                raise ValueError(f"event {i}: missing numeric ts")
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"event {i}: X event needs dur >= 0")
            if "tid" not in ev:
                raise ValueError(f"event {i}: X event needs tid")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                raise ValueError(f"event {i}: C event needs numeric args")
        if ph == "M" and not isinstance(ev.get("args"), dict):
            raise ValueError(f"event {i}: M event needs args")
    return len(evs)


def export_chrome_trace(records, out_path: Optional[str] = None
                        ) -> Dict[str, Any]:
    """Build + validate a Chrome trace; write it to ``out_path`` if
    given.  ``records`` may be a record list or a trace.jsonl path."""
    if isinstance(records, str):
        records = load_jsonl(records)
    obj = to_native(chrome_trace(records))
    validate_chrome_trace(obj)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(obj, f)
    return obj
