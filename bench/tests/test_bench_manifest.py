"""BENCHMARK.json against the benchmark's contract, and every cell's
files found by name."""
import importlib
import json
import re

import pytest

from bench import correct, harness
from bench.tests import _tiny

M = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "bench/run.py"]
    assert M["paths"] == ["bench"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in M["configs"]]
             + [w["name"] for w in M["workloads"]]
             + [m["name"] for m in M["end_to_end"] + M["per_layer"]])
    for w in M["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in M["configs"]:
        names += c["reduced"]
    for n in names:
        assert NAME.match(n), n
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in M[group]]
        assert len(got) == len(set(got)), group
    for text in ([w["why"] for w in M["workloads"] + M["configs"]]
                 + [c["source"] for c in M["configs"]]
                 + [m["layer"] for m in M["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entry_keys_and_metrics():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert PATH.match(c["file"]) and c["file"].startswith("bench/")
        assert c["reduced"] == []
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert set(e2e) == {"rounds_per_s", "setup_s"}
    for m in M["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in M["workloads"]}
    assert len(M["per_layer"]) == 8
    for m in M["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] == "rounds_per_s"
        assert set(m["workloads"]) <= cells and m["workloads"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert [w["name"] for w in M["workloads"]] == [
        "vgg16-aa-q4", "vgg16-ss-f32"]
    for w in M["workloads"]:
        assert w["config"] in {c["name"] for c in M["configs"]}
    for c in M["configs"]:
        assert c["name"] in {w["config"] for w in M["workloads"]}


@pytest.mark.parametrize("cell", _tiny.cells())
def test_cell_resolves_by_name(cell):
    spec = _tiny.full_spec(cell)
    cfg = spec["config"]
    assert cfg["name"] == spec["cell"]["config"]
    assert spec["traffic"]["name"] == spec["cell"]["traffic"]
    assert set(spec["limits"]) == set(correct.NUMBERS)
    assert spec["limits"]["schedule_mismatches"] == 0
    for name in spec["per_layer"]:
        mod = importlib.import_module(f"bench.metrics.{name}")
        assert mod.read({}) is None  # nothing to read: left out


def test_traffic_files_are_a_shared_mix_and_what_varies():
    base = harness.load_json(harness.BENCH / "traffic" / "base"
                             / "cifar10-100c.json")
    for w in M["workloads"]:
        own = harness.load_json(harness.BENCH / "traffic"
                                / f"{w['traffic']}.json")
        assert set(own) == {"name", "base", "mode", "aggregation", "wire",
                            "server_lr"}
        tr = harness.load_traffic(w["traffic"])
        assert tr == {**base, **{k: v for k, v in own.items()
                                 if k != "base"}}


def _configs():
    """Every configuration file, and ResNet-18's, which no cell lists."""
    return ([harness.load_json(p) for p in
             sorted((harness.BENCH / "configs").glob("*.json"))]
            + [_tiny.RESNET18])


def test_config_files_state_their_sizes():
    from bench.reference import models
    listed = {c["name"]: c for c in M["configs"]}
    files = sorted((harness.BENCH / "configs").glob("*.json"))
    assert sorted(p.stem for p in files) == sorted(listed)
    for path in files:
        cfg = harness.load_json(path)
        assert cfg["name"] == path.stem
        assert cfg["source"] == listed[cfg["name"]]["source"]
        assert listed[cfg["name"]]["file"] == f"bench/configs/{path.name}"
    for cfg in _configs():
        pspecs, sspecs = models.leaf_specs(cfg)
        d = sum(int(__import__("numpy").prod(s[1])) for s in pspecs)
        assert d == cfg["params_d"]
        assert sum(int(__import__("numpy").prod(s[1]))
                   for s in sspecs) == cfg["state_floats"]
        assert len(sspecs) == cfg["state_leaves"]
        assert cfg["dtype"] == "float32"
        assert not cfg["precision"]["cudnn.allow_tf32"]
        assert not cfg["precision"]["cuda.matmul.allow_tf32"]
