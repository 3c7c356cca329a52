"""Counters, gauges and histograms with Prometheus-text and JSON
exposition.

A small registry in the Prometheus data model: named families with
label sets, rendered as the text exposition format 0.0.4
(:meth:`MetricsRegistry.to_prometheus`) or a JSON object
(:meth:`MetricsRegistry.to_json`), family for family the reference's
(``repro.obs.metrics``).  :func:`from_engine` snapshots an
:class:`~repro_torch.core.safl.FLEngine`'s host accounting: rounds,
bytes by wire, admitted uploads, the scheduler's verdict counts, the
fault and defense counts, the staleness distribution, the open horizon's
queue depth, the simulated clock, the wall time of ``run`` and folds per
second.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

DEFAULT_STALENESS_BUCKETS = (0, 1, 2, 4, 8, 16, 32)


class Counter:
    """Monotonically increasing value."""

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        self.value += v


class Gauge:
    """Point-in-time value."""

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Histogram:
    """Cumulative-bucket histogram (Prometheus ``le`` semantics)."""

    def __init__(self, buckets: Sequence[float] = DEFAULT_STALENESS_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float, n: int = 1) -> None:
        v = float(v)
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += n
                break
        else:
            self.counts[-1] += n
        self.sum += v * n
        self.count += n


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class MetricsRegistry:
    """Get-or-create registry of metric families keyed by name+labels."""

    def __init__(self):
        self._families: Dict[str, Dict[str, Any]] = {}

    def _get(self, name, mtype, help_, labels, factory):
        fam = self._families.setdefault(
            name, {"type": mtype, "help": help_ or "", "samples": {}})
        if fam["type"] != mtype:
            raise ValueError(f"{name} already registered as {fam['type']}")
        if help_ and not fam["help"]:
            fam["help"] = help_
        key = _label_key(labels or {})
        if key not in fam["samples"]:
            fam["samples"][key] = factory()
        return fam["samples"][key]

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(name, "counter", help, labels, Counter)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(name, "gauge", help, labels, Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_STALENESS_BUCKETS,
                  **labels) -> Histogram:
        return self._get(name, "histogram", help, labels,
                         lambda: Histogram(buckets))

    # ---- exposition --------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for key in sorted(fam["samples"]):
                m = fam["samples"][key]
                ls = _label_str(key)
                if fam["type"] == "histogram":
                    cum = 0
                    for b, c in zip(m.buckets, m.counts):
                        cum += c
                        lab = dict(key)
                        lab["le"] = repr(b) if b != int(b) else str(int(b))
                        lines.append(
                            f"{name}_bucket{_label_str(_label_key(lab))}"
                            f" {cum}")
                    lab = dict(key)
                    lab["le"] = "+Inf"
                    lines.append(
                        f"{name}_bucket{_label_str(_label_key(lab))}"
                        f" {m.count}")
                    lines.append(f"{name}_sum{ls} {m.sum}")
                    lines.append(f"{name}_count{ls} {m.count}")
                else:
                    v = m.value
                    out = repr(v) if v != int(v) else str(int(v))
                    lines.append(f"{name}{ls} {out}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, fam in self._families.items():
            samples = []
            for key, m in sorted(fam["samples"].items()):
                s: Dict[str, Any] = {"labels": dict(key)}
                if fam["type"] == "histogram":
                    s.update(buckets=list(m.buckets), counts=list(m.counts),
                             sum=m.sum, count=m.count)
                else:
                    s["value"] = m.value
                samples.append(s)
            out[name] = {"type": fam["type"], "help": fam["help"],
                         "samples": samples}
        return out


def from_engine(eng, registry: Optional[MetricsRegistry] = None
                ) -> MetricsRegistry:
    """Snapshot an ``FLEngine``'s accounting into a registry.

    Host reads only (no device value is touched): safe mid-run or after
    ``run()``.
    """
    reg = registry if registry is not None else MetricsRegistry()
    wire = getattr(eng, "_wire", "f32")
    reg.counter("safl_rounds_total",
                "aggregation rounds completed").inc(int(eng.t_global))
    reg.counter("safl_tx_bytes_total",
                "client->server payload bytes (wire format)",
                wire=wire).inc(int(eng.tx_bytes))
    reg.counter("safl_rx_bytes_total",
                "server->client broadcast bytes").inc(int(eng.rx_bytes))
    sched = eng.sched.stats()
    part = sched.get("participation", ())
    uploads = int(sum(part)) if len(part) else 0
    reg.counter("safl_uploads_total", "admitted uploads folded",
                wire=wire).inc(uploads)
    for k in ("rejected_uploads", "idle_requests", "no_shows",
              "crashed_uploads"):
        reg.counter(f"safl_sched_{k}_total",
                    f"scheduler {k.replace('_', ' ')}").inc(int(sched[k]))
    for k in ("screened_uploads", "clipped_uploads", "corrupted_uploads",
              "byzantine_uploads"):
        reg.counter(f"safl_{k}_total",
                    f"defense/fault {k.replace('_', ' ')}").inc(
                        int(getattr(eng, k)))
    hist = reg.histogram("safl_staleness", "upload staleness at ingest")
    for s, n in sorted(eng.staleness_hist.items()):
        hist.observe(int(s), int(n))
    accum = getattr(eng, "_accum", None)
    reg.gauge("safl_queue_depth",
              "uploads buffered in the open horizon").set(
                  int(accum.count) if accum is not None else 0)
    reg.gauge("safl_clients", "client population").set(len(eng.clients))
    reg.gauge("safl_sim_time_seconds",
              "simulated clock at the last horizon close").set(
                  float(eng._last_agg_time))
    wall = float(getattr(eng, "wall_run_s", 0.0))
    reg.gauge("safl_wall_run_seconds",
              "wall-clock spent inside FLEngine.run").set(wall)
    if wall > 0:
        reg.gauge("safl_folds_per_second",
                  "admitted uploads per wall-clock second").set(
                      uploads / wall)
    return reg
