#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA GPU and the
CUDA toolkit (nvcc).  It imports nothing of JAX or of the JAX package.
Phases, each of which exits non-zero on failure:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     TF32 is switched off for convolutions and matrix products
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (D = 2,154,730, K = 4) and at a ragged D = 4099
     with K = 3: bitwise, except the poly discount (``powf``):
     ``rtol=1e-5, atol=1e-6``
  4. timings at the main path's shapes: median of CUDA-event-timed
     launches with the 50 MB L2 flushed before each, beside the bytes
     bound at 3.35 TB/s, the plain version and one PyTorch library call
  5. the engine on the card against the engine on the CPU at a small size
     (exact bytes and schedule, params within ``rtol=1e-4, atol=1e-5``),
     and the server's streaming channel against its buffered one at full
     width, bitwise
  6. the main path at full width: the paper CNN (width 32, 32x32 images,
     D = 2,154,730) on synthetic CIFAR-10, 2000 samples, 16 clients,
     k = 4, hetero-Dirichlet alpha 0.3, 5 rounds in each of AS, AA, SS and
     SA, with the launch counters reset before each setting and read after

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  A copy of every number goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
D_FULL = 2_154_730
K_MAIN = 4
D_RAGGED, K_RAGGED = 4099, 3
TIMED_LAUNCHES = 60
REPLACES = {"safl_fold": "src/repro/kernels/safl_agg.py:221",
            "safl_aggregate": "src/repro/kernels/safl_agg.py:136"}
SOURCE = "src/repro_torch/kernels/csrc/safl_agg.cu"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(torch, k_mod, report):
    """Every mode x discount of the aggregate and both fold variants, at
    the main-path and the ragged shape.  Returns the max abs error per
    kernel."""
    g = torch.Generator(device="cuda").manual_seed(0)
    worst = {"safl_fold": 0.0, "safl_aggregate": 0.0}
    for d, k in ((D_FULL, K_MAIN), (D_RAGGED, K_RAGGED)):
        u = torch.randn((k, d), device="cuda", generator=g)
        p = torch.randn((d,), device="cuda", generator=g)
        for beta in (1.0, 0.625):
            got = k_mod.safl_fold(p, u[0], 0.37, beta)
            want = k_mod.safl_fold_plain(p, u[0], 0.37, beta)
            err = float((got - want).abs().max())
            report.append(dict(kernel="safl_fold", d=d, beta=beta,
                               max_abs_err=err, bitwise=err == 0.0))
            print(f"  safl_fold      D={d:>8} beta={beta:<5}  "
                  f"max|err|={err:.3e}  (tolerance: bitwise)")
            if not torch.equal(got, want):
                fail(f"safl_fold D={d} beta={beta} differs from plain")
            worst["safl_fold"] = max(worst["safl_fold"], err)
        # in place into a bank row, as the engine folds
        row = p.clone()
        k_mod.safl_fold(row, u[1], 0.5, out=row)
        if not torch.equal(row, k_mod.safl_fold_plain(p, u[1], 0.5)):
            fail(f"in-place safl_fold D={d} differs from plain")
        for mode in k_mod.MODES:
            for discount in k_mod.DISCOUNTS:
                if discount == "poly":
                    w = torch.randint(0, 6, (k,), device="cuda",
                                      generator=g).float()
                elif mode == "mix":
                    w = torch.rand((k,), device="cuda", generator=g) / k
                else:
                    w = 0.5 + 3.5 * torch.rand((k,), device="cuda",
                                               generator=g)
                kw = dict(server_lr=0.05, mode=mode, alpha=0.5,
                          discount=discount)
                got = k_mod.safl_aggregate(u, w, p, **kw)
                want = k_mod.safl_aggregate_plain(u, w, p, **kw)
                err = float((got - want).abs().max())
                rel = float(((got - want).abs()
                             / want.abs().clamp_min(1e-30)).max())
                exact = torch.equal(got, want)
                tol = "bitwise" if discount == "none" else \
                    "rtol=1e-5, atol=1e-6"
                report.append(dict(kernel="safl_aggregate", d=d, k=k,
                                   mode=mode, discount=discount,
                                   max_abs_err=err, max_rel_err=rel,
                                   bitwise=exact))
                print(f"  safl_aggregate D={d:>8} K={k} {mode:<6} "
                      f"{discount:<4}  max|err|={err:.3e} "
                      f"max rel={rel:.3e}  (tolerance: {tol})")
                ok = exact if discount == "none" else torch.allclose(
                    got, want, rtol=1e-5, atol=1e-6)
                if not ok:
                    fail(f"safl_aggregate {mode}/{discount} D={d} K={k} "
                         "differs from plain")
                worst["safl_aggregate"] = max(worst["safl_aggregate"], err)
    torch.cuda.synchronize()
    return worst


# ---------------------------------------------------------------------------
# phase 4: timings
# ---------------------------------------------------------------------------


def time_ms(torch, fn, flush, n=TIMED_LAUNCHES):
    """Median over ``n`` launches of the CUDA-event time of one call, with
    the L2 cache flushed before each by reading a 256 MB buffer (a read,
    so the evicted lines are clean and cost the timed call no
    write-backs)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def time_kernels(torch, k_mod):
    g = torch.Generator(device="cuda").manual_seed(1)
    d, k = D_FULL, K_MAIN
    flush = torch.zeros(64 * 2 ** 20, device="cuda")  # 256 MB of f32
    u = torch.randn((k, d), device="cuda", generator=g)
    p = torch.randn((d,), device="cuda", generator=g)
    acc = torch.randn((d,), device="cuda", generator=g)
    w_host = 0.37
    ones = torch.ones((k,), device="cuda")
    sizes = torch.tensor([113.0, 58.0, 241.0, 77.0], device="cuda")
    lr = 0.05
    out = {}
    fold_bytes = 3 * d * 4
    fold_ops = 2 * d
    out["safl_fold"] = dict(
        ms=time_ms(torch, lambda: k_mod.safl_fold(acc, u[0], w_host,
                                                  out=acc), flush),
        plain_ms=time_ms(torch, lambda: k_mod.safl_fold_plain(acc, u[0],
                                                              w_host),
                         flush),
        library_ms=time_ms(torch, lambda: torch.add(acc, u[0],
                                                    alpha=w_host), flush),
        bytes=fold_bytes, ops=fold_ops, shape=f"D={d}")
    # fedsgd (SS) is the kernel's main-path record; avg (SA) rides along
    sgd_bytes, sgd_ops = (k + 2) * d * 4, 2 * k * d + 3 * d
    coef = -lr / float(ones.sum())
    out["safl_aggregate"] = dict(
        ms=time_ms(torch, lambda: k_mod.safl_aggregate(
            u, ones, p, server_lr=lr, mode="fedsgd"), flush),
        plain_ms=time_ms(torch, lambda: k_mod.safl_aggregate_plain(
            u, ones, p, server_lr=lr, mode="fedsgd"), flush),
        library_ms=time_ms(torch, lambda: torch.addmv(
            p, u.t(), ones, alpha=coef), flush),
        bytes=sgd_bytes, ops=sgd_ops, shape=f"K={k} D={d} mode=fedsgd")
    wn = sizes / sizes.sum()
    out["safl_aggregate_avg"] = dict(
        ms=time_ms(torch, lambda: k_mod.safl_aggregate(
            u, sizes, mode="avg"), flush),
        plain_ms=time_ms(torch, lambda: k_mod.safl_aggregate_plain(
            u, sizes, mode="avg"), flush),
        library_ms=time_ms(torch, lambda: wn @ u, flush),
        bytes=(k + 1) * d * 4, ops=2 * k * d + d,
        shape=f"K={k} D={d} mode=avg")
    for name, r in out.items():
        b_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        o_ms = r["ops"] / F32_FLOPS * 1e3
        r["bound_ms"] = max(b_ms, o_ms)
        r["bound_by"] = "bytes" if b_ms >= o_ms else "operations"
        print(f"  {name:<19} {r['shape']:<26} kernel {r['ms']:.4f} ms  "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{r['bytes'] / 1e6:.1f} MB)  plain {r['plain_ms']:.4f} ms  "
              f"library {r['library_ms']:.4f} ms  "
              f"achieved {r['bytes'] / r['ms'] / 1e6:.0f} GB/s")
    del flush
    return out


# ---------------------------------------------------------------------------
# phases 5 and 6: the engine
# ---------------------------------------------------------------------------


def make_setup(width, hw, samples, clients):
    from repro_torch.data import (build_client_shards, make_dataset,
                                  train_test_split)
    ds = make_dataset("cifar10", n=samples, seed=0, hw=hw)
    tr, te = train_test_split(ds)
    shards = build_client_shards(tr, "hetero_dirichlet", clients, 32,
                                 seed=0, alpha=0.3)
    return ds, shards, te, width, hw


def build_engine(torch, setup, setting, device, **cfg_kw):
    from repro_torch.configs.paper import MODES
    from repro_torch.core import FLEngine
    from repro_torch.models.vision_cnn import build_paper_model
    ds, shards, te, width, hw = setup
    base = MODES[setting]
    slr = 0.05 if base.aggregation == "fedsgd" else 1.0
    cfg = dataclasses.replace(base, n_clients=len(shards), k=K_MAIN,
                              client_lr=0.05, server_lr=slr,
                              speed_sigma=0.8, **cfg_kw)
    p0, s0, fn = build_paper_model(
        "cnn", torch.Generator().manual_seed(0), device="cpu",
        n_classes=ds.n_classes, in_ch=3, width=width, image_size=hw)
    return FLEngine(cfg, fn, ds.kind, p0, s0, shards, te.x[:400],
                    te.y[:400], device=device)


def check_engine_small(torch):
    """The engine on the card against the engine on the CPU (itself held
    against the JAX reference by the CPU tests)."""
    setup = make_setup(width=4, hw=8, samples=400, clients=6)
    rows = []
    for setting in ("AS", "SS"):
        res = {}
        for dev in ("cpu", "cuda"):
            eng = build_engine(torch, setup, setting, dev)
            r = eng.run(3)
            res[dev] = (eng, r)
        (ec, rc), (eg, rg) = res["cpu"], res["cuda"]
        same_host = (ec.tx_bytes == eg.tx_bytes
                     and ec.rx_bytes == eg.rx_bytes
                     and rc.staleness_hist == rg.staleness_hist
                     and list(rc.participation) == list(rg.participation)
                     and [x.sim_time for x in rc.metrics.records]
                     == [x.sim_time for x in rg.metrics.records])
        pc, pg = ec._flat_params, eg._flat_params.cpu()
        err = float((pc - pg).abs().max())
        close = torch.allclose(pg, pc, rtol=1e-4, atol=1e-5)
        print(f"  {setting} card vs CPU, 3 rounds: bytes/schedule "
              f"{'equal' if same_host else 'DIFFER'}, params max|err|="
              f"{err:.3e} (rtol=1e-4, atol=1e-5)")
        rows.append(dict(setting=setting, host_equal=same_host,
                         params_max_abs_err=err))
        if not (same_host and close):
            fail(f"{setting}: engine on the card disagrees with the CPU")
    return rows


def check_channels(torch):
    """The server's streaming channel (K folds + finalize) against its
    buffered channel (K row writes + one aggregate) on the card, at full
    width: bitwise, since the kernels and the finalize round the same
    operations in the same order.  (Two engine runs on the card are not
    compared: cuDNN's convolution gradients are not bitwise repeatable.)"""
    import numpy as np

    from repro_torch.core.aggregation import FlatServer
    from repro_torch.core.flatbuf import AccumBuffer, alloc_buffer, write_slot
    g = torch.Generator(device="cuda").manual_seed(2)
    u = torch.randn((K_MAIN, D_FULL), device="cuda", generator=g)
    p = torch.randn((D_FULL,), device="cuda", generator=g)
    for mode, w in (("fedsgd", np.ones(K_MAIN, np.float32)),
                    ("fedavg", np.float32([113, 58, 241, 77]))):
        srv = FlatServer(mode, D_FULL, server_lr=0.05, device="cuda")
        acc = AccumBuffer(D_FULL, srv.fold_program, "cuda")
        rows = alloc_buffer(K_MAIN, D_FULL, "cuda")
        for i in range(K_MAIN):
            acc.fold((u[i],), w=w[i])
            write_slot(rows, u[i], i)
        bank, wvec = acc.seal()
        s_new, _, _, _ = srv.finalize(p, bank, wvec, {})
        b_new, _, _ = srv.step(p, rows, w, {})
        exact = torch.equal(s_new, b_new)
        err = float((s_new - b_new).abs().max())
        print(f"  {mode}: streaming vs buffered channel, D={D_FULL} "
              f"K={K_MAIN}: {'bitwise equal' if exact else 'DIFFER'} "
              f"(max|err|={err:.3e})")
        if not exact:
            fail(f"{mode}: streaming channel differs from the buffered one")


def timed(torch, eng, method, bucket, acc):
    """Wrap ``eng.<method>`` to add its synchronized wall time to
    ``acc[bucket]``."""
    inner = getattr(eng, method)

    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        acc[bucket] += time.perf_counter() - t0
        return out

    setattr(eng, method, wrapper)


def run_main_path(torch, k_mod):
    setup = make_setup(width=32, hw=32, samples=2000, clients=16)
    rows = []
    launches = {"safl_fold": 0, "safl_aggregate": 0}
    for setting in ("AS", "AA", "SS", "SA"):
        eng = build_engine(torch, setup, setting, "cuda")
        if eng.codec.d != D_FULL:
            fail(f"full-width CNN has D={eng.codec.d}, expected {D_FULL}")
        split = {"client_train": 0.0, "server_ingest": 0.0,
                 "server_round": 0.0, "eval": 0.0}
        timed(torch, eng, "_run_local", "client_train", split)
        timed(torch, eng, "_enqueue_upload", "server_ingest", split)
        timed(torch, eng, "_aggregate", "server_round", split)
        timed(torch, eng, "_eval_and_record", "eval", split)
        k_mod.safl_fold.launches = 0
        k_mod.safl_aggregate.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run(5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        folds = k_mod.safl_fold.launches
        aggs = k_mod.safl_aggregate.launches
        uploads = int(res.participation.sum())
        recs = res.metrics.records
        acc = [round(r.accuracy, 4) for r in recs]
        print(f"  {setting}: acc/round {acc}  tx_bytes={eng.tx_bytes} "
              f"rx_bytes={eng.rx_bytes}  uploads={uploads}  "
              f"safl_fold launches={folds}  safl_aggregate launches={aggs}")
        print(f"      wall {wall:.3f} s: " + "  ".join(
            f"{k} {v:.3f} s" for k, v in split.items()))
        rows.append(dict(setting=setting, accuracy=acc,
                         loss=[r.loss for r in recs],
                         tx_bytes=eng.tx_bytes, rx_bytes=eng.rx_bytes,
                         uploads=uploads, safl_fold_launches=folds,
                         safl_aggregate_launches=aggs, wall_s=wall,
                         split_s=split,
                         staleness_hist=res.staleness_hist))
        if len(recs) != 5 or any(r.nan_event for r in recs):
            fail(f"{setting}: non-finite eval loss or missing rounds")
        if not bool(torch.isfinite(eng._flat_params).all()):
            fail(f"{setting}: non-finite global parameters")
        if setting in ("AS", "AA"):
            if folds == 0 or folds != uploads or aggs != 0:
                fail(f"{setting}: {folds} fold launches for {uploads} "
                     f"uploads, {aggs} aggregate launches")
        elif aggs == 0 or aggs != 5 or folds != 0:
            fail(f"{setting}: {aggs} aggregate launches for 5 rounds, "
                 f"{folds} fold launches")
        launches["safl_fold"] += folds
        launches["safl_aggregate"] += aggs
    return rows, launches


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no GPU to run on")
    from repro_torch.kernels import build
    from repro_torch.kernels import safl_agg as k_mod

    print("== phase 1: device")
    smi = smi_line()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"python {sys.version.split()[0]}  device {kind}  "
          f"count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32: cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False")

    print("== phase 2: build")
    info = build.compile_source("safl_agg")
    print(f"  built {os.path.relpath(info['path'], ROOT)} in "
          f"{info['seconds']:.2f} s")
    if info["log"]:
        print("  " + info["log"].replace("\n", "\n  "))

    print("== phase 3: kernels against their plain versions")
    check_rows = []
    worst = check_kernels(torch, k_mod, check_rows)

    print("== phase 4: timings (L2 flushed before each launch)")
    timing = time_kernels(torch, k_mod)

    print("== phase 5: engine on the card vs the CPU, small size")
    small = check_engine_small(torch)
    check_channels(torch)

    print("== phase 6: main path, full-width CNN (D = 2,154,730)")
    main_rows, launches = run_main_path(torch, k_mod)

    kernels = [dict(
        name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
        launches=launches[name], max_abs_err=worst[name],
        ms=timing[name]["ms"], plain_ms=timing[name]["plain_ms"],
        bound_ms=timing[name]["bound_ms"],
        bound_by=timing[name]["bound_by"],
        library_ms=timing[name]["library_ms"])
        for name in ("safl_fold", "safl_aggregate")]
    device = {"platform": "gpu", "kind": kind,
              "count": torch.cuda.device_count()}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(dict(smi=smi, torch=torch.__version__,
                       cuda=torch.version.cuda, build_s=info["seconds"],
                       checks=check_rows, timing=timing, small=small,
                       main_path=main_rows, kernels=kernels,
                       device=device), f, indent=1, default=str)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
