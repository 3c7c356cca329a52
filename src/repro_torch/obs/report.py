"""ASCII trace report: a timeline per round and the run's rollups.

Renders a :class:`~repro_torch.obs.trace.SpanTracer` JSONL trace as
text, as the reference's report does::

    PYTHONPATH=src python -m repro_torch.obs.report runs/t1/trace.jsonl

Each round's line shows the horizon's simulated window, K, the staleness
summary, the ingested bytes and a timeline bar (``|`` an upload's
ingest, ``A`` the aggregation).  The rollups sum staleness, bytes by
wire and the scheduler's and defense's verdicts over the run.

The module itself uses the standard library only.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Sequence


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024.0 or unit == "GB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} GB"


def _bar(t0: float, t1: float, marks: Sequence[float], width: int) -> str:
    cells = ["."] * width
    span = max(t1 - t0, 1e-12)
    for m in marks:
        i = min(int((m - t0) / span * (width - 1)), width - 1)
        cells[max(i, 0)] = "|"
    cells[-1] = "A"
    return "".join(cells)


def _hist_bar(n: int, peak: int, width: int = 32) -> str:
    return "#" * max(int(n / max(peak, 1) * width), 1 if n else 0)


def render(records: Sequence[Dict[str, Any]], width: int = 48) -> str:
    """Render a record stream (see :mod:`repro_torch.obs.trace`) as
    text."""
    meta: Dict[str, Any] = {}
    rounds: Dict[int, Dict[str, Any]] = {}
    ingests: List[Dict[str, Any]] = []
    sched: Dict[str, int] = {}
    for rec in records:
        if rec.get("kind") == "meta":
            meta = rec
        elif rec.get("name") == "round":
            rounds[int(rec["round"])] = rec
        elif rec.get("name") == "ingest":
            ingests.append(rec)
        elif rec.get("cat") == "sched":
            sched[rec["name"]] = sched.get(rec["name"], 0) + 1

    lines: List[str] = []
    head = " ".join(f"{k}={meta[k]}" for k in
                    ("mode", "aggregation", "wire", "channel", "n_clients",
                     "k") if k in meta)
    lines.append(f"trace: {head}" if head else "trace:")
    lines.append("")

    for rnd in sorted(rounds):
        rec = rounds[rnd]
        marks = [i["t"] for i in ingests if i.get("round") == rnd]
        rbytes = sum(i.get("bytes", 0) for i in ingests
                     if i.get("round") == rnd)
        lines.append(
            f"r{rnd:4d} [{rec['t0']:9.2f}s ..{rec['t1']:9.2f}s] "
            f"K={rec['k']:<4d} stale mean={rec['stal_mean']:<5.2f} "
            f"max={rec['stal_max']:<3d} {_fmt_bytes(rbytes):>9} "
            f"{_bar(rec['t0'], rec['t1'], marks, width)}")

    # ---- rollups -----------------------------------------------------
    if ingests:
        lines.append("")
        lines.append("staleness at ingest:")
        hist: Dict[int, int] = {}
        for i in ingests:
            hist[int(i["staleness"])] = hist.get(int(i["staleness"]), 0) + 1
        peak = max(hist.values())
        for s in sorted(hist):
            lines.append(f"  tau={s:<3d} {hist[s]:6d} "
                         f"{_hist_bar(hist[s], peak)}")
        lines.append("")
        lines.append("bytes by wire:")
        by_wire: Dict[str, int] = {}
        for i in ingests:
            by_wire[i.get("wire", "?")] = (by_wire.get(i.get("wire", "?"), 0)
                                           + i.get("bytes", 0))
        for w in sorted(by_wire):
            lines.append(f"  {w:<5s} {_fmt_bytes(by_wire[w]):>10}")
        screened = sum(1 for i in ingests if i.get("fac") == 0.0)
        clipped = sum(1 for i in ingests
                      if i.get("fac") is not None and 0.0 < i["fac"] < 1.0)
        if screened or clipped:
            lines.append("")
            lines.append(f"defense: screened={screened} clipped={clipped}")
    if sched:
        lines.append("")
        lines.append("scheduler: " + " ".join(
            f"{k}={sched[k]}" for k in sorted(sched)))
    if rounds:
        last = rounds[max(rounds)]
        counts = last.get("counts", {})
        if counts:
            lines.append("")
            lines.append("totals: " + " ".join(
                f"{k}={counts[k]}" for k in sorted(counts)))
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Render a SAFL trace.jsonl as an ASCII timeline")
    ap.add_argument("trace", help="path to trace.jsonl")
    ap.add_argument("--width", type=int, default=48,
                    help="timeline bar width in characters")
    args = ap.parse_args(argv)
    records = []
    with open(args.trace) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    sys.stdout.write(render(records, width=args.width))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
