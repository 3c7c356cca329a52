"""The yardstick's arithmetic: model FLOPs against PyTorch's FLOP counter
on the meta device, the server's bytes against PERF.md's Bound column,
and the device trace's reduction on a hand-made trace."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import harness, measure, tracing
from bench.reference import models
from bench.tests import _tiny

D_CNN = 2_154_730  # the paper CNN's D, where PERF.md states the bounds


def _config(name):
    if name == "resnet18-cifar10":
        return _tiny.RESNET18
    return harness.load_json(harness.BENCH / "configs" / f"{name}.json")


@pytest.mark.parametrize("config", ["resnet18-cifar10", "vgg16-cifar10"])
def test_forward_flops_match_the_counter(config):
    cfg = _config(config)
    pspecs, sspecs = models.leaf_specs(cfg)

    def meta(specs):
        return models.unflatten((p, torch.empty(s, device="meta"))
                                for p, s, *_ in specs)

    x = torch.empty((2, *cfg["image"]), device="meta")
    with FlopCounterMode(display=False) as fc:
        models.forward(cfg, meta(pspecs), meta(sspecs), x, True)
    assert fc.get_total_flops() == 2 * measure.forward_flops(cfg)


def test_resnet18_step_flops():
    cfg = _tiny.RESNET18
    # 3 forward passes of a batch of 32: about 107 GFLOP a step
    assert 3 * 32 * measure.forward_flops(cfg) == pytest.approx(107e9,
                                                                rel=0.01)


def test_server_bytes_against_the_bound_column():
    assert measure.agg_bytes("fold", "f32", D_CNN) == 12 * D_CNN  # 25.9 MB
    assert round(measure.agg_bytes("fold", "f32", D_CNN) / 1e6, 1) == 25.9
    step = measure.agg_bytes("step", "f32", D_CNN, k=4, mode="fedsgd")
    assert step == 24 * D_CNN and round(step / 1e6, 1) == 51.7
    assert round(measure.agg_bytes("fold", "q8", D_CNN) / 1e6, 1) == 19.4
    assert round(measure.agg_bytes("fold", "q4", D_CNN) / 1e6, 1) == 18.3
    # the q8 K-row average: rows and scales read, the mean written
    avg = measure.agg_bytes("step", "q8", D_CNN, k=4, mode="avg")
    assert round(avg / 1e6, 1) == 17.3
    assert measure.agg_bytes("finalize", "f32", D_CNN) == 12 * D_CNN
    assert measure.agg_bytes("finalize", "q4", D_CNN, mode="avg") == 8 * D_CNN


def test_merged_union():
    assert measure.merged([(0, 2), (1, 3), (5, 6)]) == 4
    assert measure.merged([]) == 0


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_summary_by_synchronizes_and_correlation():
    # start sync; a client call (pre, post) with one kernel; a server
    # call nested in an ingest call with one kernel each; the stop sync
    calls = ["client_train", "server_ingest", "server.fold"]
    tags = [("start",), ("pre", 0), ("post", 0), ("pre", 1), ("pre", 2),
            ("post", 2), ("post", 1), ("stop",)]
    sync_ts = [0, 10, 100, 110, 120, 200, 210, 300]
    ev = [_x("cuda_runtime", "cudaDeviceSynchronize", t, 2) for t in sync_ts]
    ev += [_x("cuda_runtime", "cudaLaunchKernel", 20, 1, corr=1),
           _x("kernel", "conv", 25, 50, corr=1),
           _x("cuda_runtime", "cudaLaunchKernel", 113, 1, corr=2),
           _x("kernel", "quantize", 115, 4, corr=2),
           _x("cuda_runtime", "cudaLaunchKernel", 130, 1, corr=3),
           _x("kernel", "fold_kernel", 140, 40, corr=3),
           # the profiler's own synchronize as it stops
           _x("cuda_runtime", "cudaDeviceSynchronize", 400, 1)]
    s = tracing.summarize(ev, calls, tags, wall_s=300e-6)
    assert s["sync_match"]
    assert s["server_calls"] == {"fold": 1}
    assert s["server_kernel_s"] == pytest.approx(40e-6)
    assert s["busy_s"] == pytest.approx(94e-6)
    assert s["device_events"] == 3
    # gaps 75-115 (in the client call), 119-140 (in the ingest call),
    # 180 to the wall's end (between calls)
    idle = dict(s["idle_gaps"])
    assert idle == pytest.approx({"client_train": 40e-6,
                                  "server_ingest": 21e-6, "engine": 145e-6})
    assert sum(idle.values()) == pytest.approx(300e-6 - 94e-6)
    # a trace whose synchronizes do not match the log reads no server time
    s = tracing.summarize(ev[2:], calls, tags, wall_s=300e-6)
    assert not s["sync_match"] and s["server_kernel_s"] is None
