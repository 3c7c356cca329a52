"""One run of one cell: set-up, the measured window, the traced
sub-window (``--trace 1``), the check against the plain reference, and
the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is found by name: ``bench/configs/<config>.json``,
``bench/traffic/<traffic>.json`` (over a shared mix in
``bench/traffic/base/``), ``bench/workloads/<cell>.json`` (the
cell's correctness limits) and ``bench/metrics/<metric>.py`` (a reader
over the traced run's records).
"""
from __future__ import annotations

import gc
import importlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_traffic(name: str) -> Dict:
    """``bench/traffic/<name>.json``, over the shared mix it names as
    ``base`` (``bench/traffic/base/<base>.json``), whose keys it may
    override."""
    tr = load_json(BENCH / "traffic" / f"{name}.json")
    base = tr.pop("base", None)
    if base is None:
        return tr
    return {**load_json(BENCH / "traffic" / "base" / f"{base}.json"), **tr}


def resolve(manifest: Dict, cell: str) -> Dict:
    """The cell's entry, configuration, traffic mix, limits and the
    per-layer metrics it reports."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[cell]
    per_layer = [m["name"] for m in manifest["per_layer"]
                 if cell in m.get("workloads", [cell])]
    return {"cell": w,
            "config": load_json(BENCH / "configs" / f"{w['config']}.json"),
            "traffic": load_traffic(w["traffic"]),
            "limits": load_json(BENCH / "workloads" / f"{cell}.json")[
                "limits"],
            "per_layer": per_layer}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (the part before the first dot, compared whole)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def read_metric(name: str, rec: Dict) -> Optional[float]:
    mod = importlib.import_module(f"bench.metrics.{name.replace('.', '_')}")
    return mod.read(rec)


def _wrap_server(eng, tr, d: int, device, marks: Dict) -> Dict[str, int]:
    """The server's fold and round calls, each timed between synchronizes
    and marked as ``server.<call>``; -> each call's logical bytes."""
    from bench import measure
    mode = "fedsgd" if tr["aggregation"] == "fedsgd" else "avg"
    acc: Dict[str, float] = {}
    if eng._accum is not None:
        measure.wrap_timed(eng._accum, "fold", "server.fold", acc, device,
                           marks)
        measure.wrap_timed(eng._server, "finalize", "server.finalize", acc,
                           device, marks)
    else:
        measure.wrap_timed(eng._server, "step", "server.step", acc, device,
                           marks)
    kw = dict(k=tr["k"], mode=mode, qblock=tr["quant_block"])
    return {c: measure.agg_bytes(c, tr["wire"], d, **kw)
            for c in ("fold", "finalize", "step")}


def run_cell(spec: Dict, seed: int, seconds: float, trace: bool, device,
             t_process: float, program_hook=None) -> Dict:
    """Set-up, window, trace and check of one cell on ``device``.
    ``program_hook(eng)``, when given, is called on the built engine
    before its first round (the fault tests plant their faults there)."""
    import torch
    from bench import correct, inputs, measure, program, tracing
    cfg, tr = spec["config"], spec["traffic"]
    parts = {"start": time.perf_counter() - t_process}
    program.set_precision(cfg)
    data = inputs.make_data(tr, seed, device)
    params, state = inputs.make_weights(cfg, seed, device)
    parts["inputs"] = time.perf_counter() - t_process
    # the reference's copy of the start; the engine gets its own
    start = {"params": params, "state": state}
    params, state = program.clone(params), program.clone(state)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    eng = program.build_engine(cfg, tr, data, params, state, device)
    parts["engine"] = time.perf_counter() - t_process
    if program_hook is not None:
        program_hook(eng)
    # set-up's warm-up, which the reference judges after the window
    warm = tr["warm_rounds"]
    prog = program.warm_up(eng, warm, data["valid"])
    measure.sync(device)
    setup_s = time.perf_counter() - t_process

    # ---- the measured window: rounds back to back ----
    marks = measure.new_marks()
    split = measure.wrap_split(eng, device, marks) if trace else None
    part0 = eng.sched.participation.copy()
    n_rec0 = len(eng.metrics.records)
    precision = measure.precision_now()
    t0 = time.perf_counter()
    rounds, ends = 0, []
    while True:
        program.run_rounds(eng)
        rounds += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    measure.sync(device)
    window_s = time.perf_counter() - t0
    recs = eng.metrics.records[n_rec0:]
    failed = sum(1 for r in recs if not np.isfinite(r.loss))
    n = np.asarray(data["n"], np.float64)
    rec: Dict = {
        "rounds": rounds, "window_s": window_s,
        "round_s": list(np.diff([0.0] + ends)),
        "losses": [float(r.loss) for r in recs],
        "split": None if split is None else dict(split),
        "train_samples": float(np.sum((eng.sched.participation - part0)
                                      * n)),
        "eval_samples": float(len(recs) * len(data["test_y"])),
        "fwd_flops": measure.forward_flops(cfg), "precision": precision,
    }

    # ---- the traced sub-window: more rounds under the device trace ----
    rec["trace"] = None
    if trace and device.type == "cuda":
        rec["server_bytes"] = _wrap_server(eng, tr, sum(
            int(np.prod(s[1])) for s in _param_specs(cfg)), device, marks)
        dt = tracing.DeviceTrace(device, marks)
        dt.start()
        t1 = time.perf_counter()
        for _ in range(tr["profile_rounds"]):
            program.run_rounds(eng)
        wall = time.perf_counter() - t1
        rec["trace"] = dt.summary(dt.stop(), wall)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    # ---- the check: the reference judges the warm-up rounds ----
    del eng, split, params, state, marks
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = correct.judge(cfg, tr, inputs.data_to(data, device), start,
                            prog, warm)
    parts["reference"] = time.perf_counter() - t_ref
    ver = correct.verdict(numbers, spec["limits"])
    return {"setup_s": setup_s, "rounds": rounds, "window_s": window_s,
            "failed": failed, "memory_peak_bytes": int(peak), "rec": rec,
            "parts": parts,
            "numbers": numbers, **ver}


def _param_specs(cfg):
    from bench.reference import models
    return models.leaf_specs(cfg)[0]


def result_line(spec: Dict, out: Dict, trace: bool, device) -> Dict:
    """The run's JSON result: the end-to-end metrics untraced, the
    cell's per-layer metrics traced; the compared numbers last."""
    import torch
    metrics: Dict[str, Dict] = {}
    if trace:
        units = {m["name"]: m["unit"] for m in spec["manifest"]["per_layer"]}
        for name in spec["per_layer"]:
            v = read_metric(name, out["rec"])
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
    else:
        metrics["rounds_per_s"] = {
            "value": out["rounds"] / out["window_s"], "unit": "rounds/s"}
        metrics["setup_s"] = {"value": out["setup_s"], "unit": "s"}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": spec["cell"]["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"]}
    line: Dict = {"correct": out["correct"] and out["failed"] == 0,
                  "attempted": out["rounds"], "failed": out["failed"],
                  "metrics": metrics, "device": dev}
    if trace:
        t = out["rec"]["trace"] or {"busy_s": 0.0, "window_s": 0.0,
                                    "device_ops": [], "idle_gaps": []}
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    line["checks"] = out["checks"]
    return line
