"""Span / event tracer of the FL engines, on the simulated clock.

The tracer records each upload's life on the *simulated* clock: its
local training, its wire transfer (with the payload's bytes), the
server's ingest (with staleness, the defense's factor and the final
aggregation weight), the scheduler's instants (wake, crash, offline,
reject, idle) and the horizon's aggregate, plus one ``round`` span per
horizon with the engine's cumulative counters and a wall-clock note.
Records are plain dicts, the reference's (``repro.obs.trace``) key for
key: written as JSONL when a trace directory is given and always kept in
``SpanTracer.records`` for the Chrome export, the report and the tests.

The sequential and horizon-batched engines meet a horizon's uploads in
different orders, so the tracer holds the open horizon's records and
flushes them sorted by ``(time, cid, name, slot)`` when it closes.  Both
engines pop the same scheduler events and compute the same host values
for each slot, so their flushed streams are equal record for record once
the wall-clock note is stripped (:func:`canonical`).

All of it is host Python over values the engine already holds on the
host: with ``trace_level="off"`` no tracer exists, and with tracing on no
device work, synchronization or copy is added.
"""
from __future__ import annotations

import json
import os
import time as _time
from typing import Any, Dict, List, Optional, Sequence

TRACE_SCHEMA = 1
LEVELS = ("off", "round", "upload")

#: keys that intentionally differ between otherwise-identical runs
#: (wall-clock annotations): stripped by :func:`canonical`.
VOLATILE_KEYS = ("wall",)


def canonical(records: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Strip volatile (wall-clock) keys for stream-equality comparison."""
    return [{k: v for k, v in r.items() if k not in VOLATILE_KEYS}
            for r in records]


def _order(rec: Dict[str, Any]):
    """Deterministic within-horizon sort key: (time, cid, name, slot)."""
    t = rec.get("t0", rec.get("t", 0.0))
    return (float(t), rec.get("cid", -1), rec.get("name", ""),
            rec.get("slot", -1))


class SpanTracer:
    """Horizon-buffered span/event recorder on the simulated clock.

    Parameters
    ----------
    trace_dir:
        Directory for the ``trace.jsonl`` span log.  An empty string
        keeps the records in memory only (``self.records``).
    level:
        ``"round"`` emits only per-horizon round/aggregate spans;
        ``"upload"`` adds the full per-upload lifecycle and scheduler
        verdict instants.  ``"off"`` is rejected: the engine simply
        does not construct a tracer when tracing is off.
    meta:
        Run facts recorded as the first JSONL line (``kind="meta"``).
    """

    def __init__(self, trace_dir: str = "", level: str = "upload",
                 meta: Optional[Dict[str, Any]] = None):
        if level not in LEVELS or level == "off":
            raise ValueError(f"bad trace level {level!r}")
        self.level = level
        self.dir = trace_dir or ""
        self.path = os.path.join(self.dir, "trace.jsonl") if self.dir else ""
        self.records: List[Dict[str, Any]] = []
        self._pending: List[Dict[str, Any]] = []
        self._fh = None
        if self.dir:
            os.makedirs(self.dir, exist_ok=True)
            self._fh = open(self.path, "w")
        self.meta = {"kind": "meta", "schema": TRACE_SCHEMA,
                     "clock": "simulated_s", "level": level}
        self.meta.update(meta or {})
        self.records.append(self.meta)
        self._write(self.meta)

    # ------------------------------------------------------------------
    def _write(self, rec: Dict[str, Any]) -> None:
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")

    # ---- per-upload lifecycle (level "upload") -----------------------
    def upload(self, *, slot: int, cid: int, t: float, compute_s: float,
               comm_s: float, staleness: int, nbytes: int, wire: str,
               fac=None) -> None:
        """Record one admitted upload: train span, wire-transfer span,
        and the server ingest instant.

        ``t`` is the arrival (ingest) time; the scheduler's timing
        models place it at ``wake + compute_s + comm_s``, so the train
        span is ``[t - comm_s - compute_s, t - comm_s]`` and the
        transfer span ``[t - comm_s, t]``: exact for the static and
        lognormal models (jitter folds into ``compute_s``).
        """
        if self.level != "upload":
            return
        t, compute_s, comm_s = float(t), float(compute_s), float(comm_s)
        t_up = t - comm_s
        self._pending.append({
            "kind": "span", "name": "train", "cat": "client",
            "cid": int(cid), "slot": int(slot),
            "t0": t_up - compute_s, "t1": t_up})
        self._pending.append({
            "kind": "span", "name": "wire", "cat": "client",
            "cid": int(cid), "slot": int(slot), "t0": t_up, "t1": t,
            "bytes": int(nbytes), "wire": str(wire)})
        rec = {"kind": "instant", "name": "ingest", "cat": "server",
               "cid": int(cid), "slot": int(slot), "t": t,
               "staleness": int(staleness), "bytes": int(nbytes),
               "wire": str(wire)}
        if fac is not None:
            rec["fac"] = float(fac)
        self._pending.append(rec)

    # ---- scheduler verdict / lifecycle instants ----------------------
    def sched(self, name: str, t: float, cid: int, **args) -> None:
        """Record a scheduler instant: ``reject`` / ``idle`` / ``crash``
        (with backoff) / ``wake`` / ``offline`` (no-show transition)."""
        if self.level != "upload":
            return
        rec = {"kind": "instant", "name": str(name), "cat": "sched",
               "cid": int(cid), "t": float(t)}
        for k, v in args.items():
            rec[k] = float(v) if isinstance(v, float) else v
        self._pending.append(rec)

    # ---- horizon close -----------------------------------------------
    def round(self, rnd: int, *, t0: float, t1: float, agg_s: float,
              k: int, staleness: Sequence[int], weights: Sequence[float],
              counts: Dict[str, int]) -> None:
        """Close a horizon: attach final aggregation weights to this
        horizon's ingest records, emit the aggregate span and the round
        span (cumulative counters + wall-clock annotation), then flush
        the pending records sorted by :func:`_order`."""
        for rec in self._pending:
            if rec.get("name") == "ingest":
                rec["w"] = float(weights[rec["slot"]])
        stal = [int(s) for s in staleness]
        t0, t1, agg_s = float(t0), float(t1), float(agg_s)
        self._pending.append({
            "kind": "span", "name": "aggregate", "cat": "server",
            "t0": t1, "t1": t1 + agg_s, "k": int(k)})
        self._pending.append({
            "kind": "span", "name": "round", "cat": "server",
            "t0": t0, "t1": t1 + agg_s, "k": int(k),
            "stal_mean": (sum(stal) / len(stal)) if stal else 0.0,
            "stal_max": max(stal) if stal else 0,
            "counts": {str(kk): int(vv) for kk, vv in counts.items()},
            "wall": _time.time()})
        self._flush(rnd)

    def _flush(self, rnd: Optional[int]) -> None:
        recs = sorted(self._pending, key=_order)
        self._pending = []
        for rec in recs:
            if rnd is not None:
                rec["round"] = int(rnd)
            self.records.append(rec)
            self._write(rec)
        if self._fh is not None:
            self._fh.flush()

    # ---- run end -----------------------------------------------------
    def tail(self) -> None:
        """Flush events of a partial horizon left open at run end (no
        round span: the aggregation never happened)."""
        if self._pending:
            self._flush(None)

    def close(self) -> None:
        self.tail()
        if self._fh is not None:
            self._fh.close()
            self._fh = None
