"""The traced run's device trace: ``torch.profiler`` with its CUDA
activities alone (CUPTI's kernel, copy and memset records and the CUDA
API calls that launched them; no PyTorch operator is recorded), over a
steady sub-window of rounds, written to ``$TMPDIR`` as a Chrome trace,
read back and deleted.

The host's side comes from the benchmark's own calls: every timed call
(the wall split's buckets and the server's fold and round calls) runs
between two ``cudaDeviceSynchronize`` calls, which the trace records.
The engine never synchronizes itself, so the trace's synchronize records
match the benchmark's log of them one for one, and each timed call
becomes a host interval on the trace's clock.  From that:

  * the device's busy seconds, the union of its records, against the
    sub-window's host wall;
  * the device operations that took most time;
  * the idle gaps by what the host was doing: the timed call whose
    interval holds the gap (``engine`` between calls);
  * the device seconds of every kernel launched inside the server's
    calls: a kernel belongs to a call when the API call that launched it
    (matched by CUPTI's correlation id) lies in that call's interval.
    Never by kernel name.
"""
from __future__ import annotations

import json
import os
import tempfile
from bisect import bisect_right
from typing import Dict, List, Optional, Tuple

from bench import measure

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
API_CATS = ("cuda_runtime", "cuda_driver")
SYNC = "cudaDeviceSynchronize"
TOP = 10
#: characters kept of a kernel's name
NAME = 160


class DeviceTrace:
    """``start()``, the rounds, ``stop()``, then ``summary(events,
    wall)``.  ``marks`` is the holder the timed calls log into
    (:func:`bench.measure.new_marks`)."""

    def __init__(self, device, marks: Dict):
        import torch
        self.device, self.marks = device, marks
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])

    def start(self) -> None:
        self.prof.start()
        self.marks.update(on=True, calls=[], syncs=[])
        measure.sync(self.device, self.marks, ("start",))

    def stop(self) -> List[Dict]:
        measure.sync(self.device, self.marks, ("stop",))
        self.marks["on"] = False
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.unlink(path)

    def summary(self, events: List[Dict], wall_s: float) -> Dict:
        return summarize(events, self.marks["calls"], self.marks["syncs"],
                         wall_s)


def _holder(spans: List[Tuple[float, float, str]], t: float):
    """The innermost span of ``spans`` (sorted by start; nested or
    disjoint) holding ``t``."""
    i = bisect_right(spans, (t, float("inf"), ""))
    best = None
    for a, b, lab in reversed(spans[max(0, i - 8):i]):
        if b >= t and (best is None or b - a < best[1] - best[0]):
            best = (a, b, lab)
    return best


def call_spans(syncs: List[float], calls: List[str],
               tags: List[tuple]) -> Optional[List[Tuple[float, float,
                                                         str]]]:
    """Each logged call's host interval (label, from the end of its first
    synchronize to the start of its second), given the trace's
    synchronize records as (start, end) pairs in time order; None when
    they do not match the log one for one (the profiler's own
    synchronize as it stops may follow the log's last)."""
    if not 0 <= len(syncs) - len(tags) <= 1:
        return None
    pre: Dict[int, float] = {}
    spans = []
    for (a, b), tag in zip(syncs, tags):
        if tag[0] == "pre":
            pre[tag[1]] = b
        elif tag[0] == "post":
            spans.append((pre.pop(tag[1]), a, calls[tag[1]]))
    return sorted(spans)


def summarize(events: List[Dict], calls: List[str], tags: List[tuple],
              wall_s: float) -> Dict:
    """Seconds from a Chrome trace's events (``ts``/``dur`` in
    microseconds): ``window_s`` (the host wall), ``busy_s``,
    ``device_events``, ``device_ops``, ``idle_gaps``,
    ``server_kernel_s`` and ``server_calls`` (how many calls of each
    server kind; ``server_kernel_s`` None where the trace's synchronizes
    do not match the log)."""
    dev, launch_ts, syncs = [], {}, []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat")
        a, d = float(e["ts"]), float(e["dur"])
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            dev.append((a, a + d, str(e.get("name", "")), corr))
        elif cat in API_CATS:
            if e.get("name") == SYNC:
                syncs.append((a, a + d))
            if corr is not None:
                launch_ts[corr] = a
    dev.sort()
    syncs.sort()
    spans = call_spans(syncs, calls, tags)
    by_op: Dict[str, float] = {}
    for a, b, n, _ in dev:
        by_op[n] = by_op.get(n, 0.0) + (b - a)

    by_host: Dict[str, float] = {}
    buckets = sorted(s for s in spans or [] if not s[2].startswith("server."))
    if dev:
        w0 = dev[0][0]
        w1 = w0 + 1e6 * wall_s
        gaps, end = [], w0
        for a, b, _, _ in dev:
            if a > end:
                gaps.append((end, min(a, w1)))
            end = max(end, b)
        if w1 > end:
            gaps.append((end, w1))
        for a, b in gaps:
            h = _holder(buckets, 0.5 * (a + b))
            name = h[2] if h else "engine"
            by_host[name] = by_host.get(name, 0.0) + max(b - a, 0.0)

    server_k, n_calls = None, {}
    if spans is not None:
        server = [s for s in spans if s[2].startswith("server.")]
        for _, _, lab in server:
            key = lab[len("server."):]
            n_calls[key] = n_calls.get(key, 0) + 1
        server_k = 0.0
        for a, b, _, corr in dev:
            t = launch_ts.get(corr)
            if t is not None and _holder(server, t) is not None:
                server_k += b - a
        server_k /= 1e6

    def top(d):
        return [[k[:NAME], v / 1e6]
                for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"window_s": wall_s,
            "busy_s": measure.merged([(a, b) for a, b, _, _ in dev]) / 1e6,
            "device_events": len(dev),
            "device_ops": top(by_op), "idle_gaps": top(by_host),
            "server_kernel_s": server_k, "server_calls": n_calls,
            "sync_match": spans is not None}
