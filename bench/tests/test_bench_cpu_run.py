"""The harness end to end on the CPU at a tiny size: every cell's run,
untraced and traced, and ResNet-18's, come out correct with their
metrics; the same run
with its timed path broken underneath comes out not correct, once for
each fault a training cell can have on one chip (a step that returns
its state unchanged; half of the uploads left out, the mean taken over
the rest; half of each training batch left out of the gradient; an
upload altered where it is produced)."""
import time

import numpy as np
import pytest
import torch

from bench import controls, harness
from bench.tests import _tiny

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cell, trace=False, hook=None, seed=2 ** 31 + 17):
    spec = _tiny.spec(cell) if isinstance(cell, str) else cell
    out = harness.run_cell(spec, seed, 0.5, trace, CPU, time.perf_counter(),
                           program_hook=hook)
    return spec, out, harness.result_line(spec, out, trace, CPU)


#: ResNet-18 under AS on the f32 wire and under SA on the q8 wire, its
#: BatchNorm state riding the wire
RESNET = [("semi_async", "fedsgd", "f32", 0.01),
          ("sync", "fedavg", "q8", 1.0)]


@pytest.mark.parametrize("cell", _tiny.cells())
def test_untraced_run_is_correct(cell):
    _, out, line = _run(cell)
    assert line["correct"] and line["failed"] == 0
    assert set(line) == {"correct", "attempted", "failed", "metrics",
                         "device", "checks"}
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"rounds_per_s", "setup_s"}
    assert line["metrics"]["rounds_per_s"]["value"] > 0
    assert line["attempted"] == out["rounds"] >= 1
    assert all(c["value"] == 0 for c in line["checks"].values())
    assert line["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", ["vgg16-aa-q4", "vgg16-ss-f32"])
def test_traced_run_reads_the_split(cell):
    spec, out, line = _run(cell, trace=True)
    assert line["correct"]
    m = line["metrics"]
    for name in ("client_train_ms", "ingest_ms", "server_round_ms",
                 "eval_ms", "engine_host_ms", "train_mfu"):
        assert name in m and m[name]["value"] >= 0
    # no device trace on the CPU: those readers find nothing
    assert "agg_roofline" not in m and "device_idle_pct" not in m
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    split = out["rec"]["split"]
    assert sum(split.values()) <= out["window_s"]


@pytest.mark.parametrize("cell", _tiny.cells())
@pytest.mark.parametrize("fault", controls.FAULTS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    _, out, line = _run(cell, hook=controls.plant(fault))
    assert not line["correct"], out["numbers"]


@pytest.mark.parametrize("mix", RESNET, ids=["as-f32", "sa-q8"])
@pytest.mark.parametrize("fault", (None,) + controls.FAULTS)
def test_resnet18_runs_are_judged(mix, fault):
    hook = None if fault is None else controls.plant(fault)
    _, out, line = _run(_tiny.resnet_spec(*mix), hook=hook)
    assert line["correct"] == (fault is None), out["numbers"]
    if fault is None:
        assert all(c["value"] == 0 for c in line["checks"].values())


@pytest.mark.parametrize("cell", _tiny.cells())
def test_the_recorder_sees_every_upload_and_first_step(cell):
    from bench import inputs, program
    from bench.reference import models
    spec = _tiny.spec(cell)
    cfg, tr = spec["config"], spec["traffic"]
    data = inputs.make_data(tr, 11, CPU)
    params, state = inputs.make_weights(cfg, 11, CPU)
    eng = program.build_engine(cfg, tr, data, params, state, CPU)
    prog = program.warm_up(eng, tr["warm_rounds"], data["valid"])
    ups = prog["uploads"]
    d = sum(int(np.prod(sp[1])) for sp in models.leaf_specs(cfg)[0])
    assert prog["miscounts"] == 0
    assert len(ups) == tr["k"] * tr["warm_rounds"]
    for u in ups:
        steps = int(data["valid"][u["cid"]].sum()) * tr["local_epochs"]
        assert (u["p1"] is None) == (steps == 1)
        assert u["start"].shape == u["vec"].shape == (d,)
    assert any(u["p1"] is not None for u in ups)
    # the recorder is gone: the engine's own model function and wave call
    assert eng.apply_fn is not None and "_train_wave" not in vars(eng)
