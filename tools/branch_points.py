"""How far two correct f32 runs of the paper's conv models part on the
CPU, and why: the branch points of ReLU, max-pool and the q8 wire's
round (:mod:`repro_torch.models.kinks`).

  1. ``steps``: along each client's f64 epoch (``chip_smoke.py`` phase 5's
     ResNet-18 and VGG-16 setups), each step's f32 gradient (oneDNN off,
     PyTorch's own convolution) against the f64 one, the units on the
     other side of a branch point, and what is left of the distance when
     the f64 step takes the f32 step's branches;
  2. ``engines``: phase 5's conv settings run free on the CPU's engine
     with oneDNN on, off, and on one thread: their params' distance from
     the oneDNN run over its movement, and the BatchNorm state's;
  3. ``onednn``: the weight gradient of a 1x1 stride-2 convolution of a
     channels-last batch of 17 (ResNet-18's first ``down`` convolution at
     width 4), four calls, against f64, and of the same input made
     contiguous;
  4. ``horizons``: the paper CNN's q8 Markov + seafl run of
     ``tests/test_torch_horizons.py`` (width 4 on 8x8, 6 clients, k = 3,
     4 rounds, both engines) on torch's thread pool, recorded, and on one
     thread, free and taking the pool run's branches: each one-thread
     run's distance from the pool run over its movement, and how many
     units the replay found on the other side of its own choice;
  5. ``case <test id> ...``: the same for any test that runs the port's
     engine (``FLEngine.run``), named by its pytest id: the test runs
     three times in this process, on torch's pool with every engine run's
     branches recorded, then on one thread free, then on one thread with
     each engine run taking the pool run's branches; for each engine run
     the one-thread runs' distance from the pool run over its movement,
     and each of the three test outcomes (a bound the one-thread run
     breaks and the replay keeps is a branch point, not a port fault).

Run from the repo root: ``PYTHONPATH=src python tools/branch_points.py
[steps] [engines] [onednn] [horizons] [case <test id> ...]`` (the first
three without arguments).  CPU only.
"""
import contextlib
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.core import client  # noqa: E402
from repro_torch.models import kinks  # noqa: E402


def _grad(fn, kind, p, s, x, y, m, dtype, mode):
    leaves, td = tree.tree_flatten(p)
    leaves = [v.to(dtype).detach().requires_grad_(True) for v in leaves]
    with mode:
        loss, s2 = client.make_loss_fn(fn, kind)(
            tree.tree_unflatten(td, leaves),
            tree.tree_map(lambda v: v.to(dtype), s), x.to(dtype), y,
            m.to(dtype))
    g = torch.autograd.grad(loss, leaves)
    return torch.cat([t.double().reshape(-1) for t in g]), s2


def steps():
    for name in ("resnet18", "vgg16"):
        setup = cs.other_setup(name, "small", samples=400, clients=6)
        p, s, fn = setup["model"]
        for c, sh in enumerate(setup["shards"]):
            pp, ss = (tree.tree_map(lambda v: v.double(), t) for t in (p, s))
            for b in np.flatnonzero(np.asarray(sh["mask"]).max(axis=1) > 0):
                x, y, m = (torch.as_tensor(np.asarray(sh[f][b], dt))
                           for f, dt in (("xs", np.float32),
                                         ("ys", np.int64),
                                         ("mask", np.float32)))
                g64, s64 = _grad(fn, "image", pp, ss, x, y, m,
                                 torch.float64, contextlib.nullcontext())
                torch.backends.mkldnn.enabled = False
                rec = kinks.Record()
                g32, _ = _grad(fn, "image", pp, ss, x, y, m, torch.float32,
                               rec)
                torch.backends.mkldnn.enabled = True
                rep = kinks.Replay(rec.choices)
                g64b, _ = _grad(fn, "image", pp, ss, x, y, m,
                                torch.float64, rep)
                print(f"steps {name} client {c} batch {b}: max|g| "
                      f"{float(g64.abs().max()):.3e}, f32 - f64 "
                      f"{float((g32 - g64).abs().max()):.3e}, units flipped "
                      f"{rep.flips}, f32 - f64 on the f32 branches "
                      f"{float((g32 - g64b).abs().max()):.3e}")
                leaves, td = tree.tree_flatten(pp)
                off, new = 0, []
                for v in leaves:
                    new.append(v - 0.05 * g64[off:off + v.numel()].view_as(v))
                    off += v.numel()
                pp, ss = tree.tree_unflatten(td, new), s64


def engines():
    for name in ("resnet18", "vgg16"):
        setup = cs.other_setup(name, "small", samples=400, clients=6)
        names = ("AS", "SA") + (("AA-q8",) if name == "resnet18" else ())
        n_threads = torch.get_num_threads()
        for sname in names:
            setting, kw, _ = cs.OTHER_SETTINGS[sname]
            out = {}
            for var in ("oneDNN", "oneDNN off", "one thread"):
                torch.backends.mkldnn.enabled = var != "oneDNN off"
                torch.set_num_threads(1 if var == "one thread"
                                      else n_threads)
                eng = cs.build_engine(torch, setup, setting, "cpu", **kw)
                p0 = eng._flat_params.clone()
                eng.run(cs.OTHER_ROUNDS)
                out[var] = eng._flat_params, cs.flat_state(
                    torch, eng.global_state)
            torch.backends.mkldnn.enabled = True
            torch.set_num_threads(n_threads)
            ref, sref = out["oneDNN"]
            for var in ("oneDNN off", "one thread"):
                p, st = out[var]
                s_err = float((st - sref).abs().max()) if st.numel() else 0
                print(f"engines {name} {sname} {cs.OTHER_ROUNDS} rounds, "
                      f"{var} vs oneDNN: params rel to movement "
                      f"{float((p - ref).norm() / (ref - p0).norm()):.3e}, "
                      f"max|err| {float((p - ref).abs().max()):.3e}, state "
                      f"max|err| {s_err:.3e}")


def onednn():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((17, 16, 16, 4), generator=g,
                    dtype=torch.float64).permute(0, 3, 1, 2)
    w = torch.randn((8, 4, 1, 1), generator=g, dtype=torch.float64)
    up = torch.randn((17, 8, 8, 8), generator=g, dtype=torch.float64)

    def grad_w(xx, dtype):
        b = w.to(dtype).requires_grad_(True)
        out = F.conv2d(xx.to(dtype), b, stride=2)
        return torch.autograd.grad(out, b, up.to(dtype))[0].double()

    want = grad_w(x, torch.float64)
    for form, xx in (("channels-last", x), ("contiguous", x.contiguous())):
        errs = [float((grad_w(xx, torch.float32) - want).abs().max())
                for _ in range(4)]
        print(f"onednn 1x1 stride-2 weight gradient, {form} input: max|g| "
              f"{float(want.abs().max()):.3e}, f32 - f64 over 4 calls "
              + ", ".join(f"{e:.3e}" for e in errs))


def horizons():
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import FLEngine
    from repro_torch.data import (build_client_shards, make_dataset,
                                  train_test_split)
    from repro_torch.models import vision_cnn
    from repro_torch.prng import prng_key
    ds = make_dataset("cifar10", n=300, seed=0, hw=8)
    tr, te = train_test_split(ds)
    shards = build_client_shards(tr, "hetero_dirichlet", 6, 16, seed=0,
                                 alpha=0.3)
    p, s, fn = vision_cnn.build_paper_model("cnn", prng_key(0), width=4,
                                            image_size=8, device="cpu")
    # resolve the batched engine's wave_impl (a probe forward) outside
    # the recorded runs
    client.model_has_conv(fn, p, s, torch.as_tensor(te.x[:1]))
    n_threads = torch.get_num_threads()
    for batched in (False, True):
        cfg = FLConfig(n_clients=6, k=3, aggregation="fedsgd",
                       client_lr=0.05, server_lr=0.05, target_accuracy=0.9,
                       speed_sigma=0.8, wire="q8", sched_timing="markov",
                       sched_policy="seafl", sched_stale_cap=1,
                       sched_jitter_sigma=0.5, sched_drop_p=0.3,
                       sched_off_mean_s=2.0, batch_clients=batched)

        def run(mode, threads):
            torch.set_num_threads(threads)
            eng = FLEngine(cfg, fn, "image", p, s, shards, te.x[:150],
                           te.y[:150], device="cpu")
            p0 = eng._flat_params.clone()
            with mode:
                eng.run(4)
            torch.set_num_threads(n_threads)
            return eng._flat_params, p0

        rec = kinks.Record()
        pool, p0 = run(rec, n_threads)
        move = float((pool - p0).norm())
        one, _ = run(contextlib.nullcontext(), 1)
        rep = kinks.Replay(rec.choices)
        taken, _ = run(rep, 1)
        label = "batched" if batched else "sequential"
        print(f"horizons cnn q8 markov seafl {label}, {n_threads} threads "
              f"vs one: free {float((one - pool).norm()) / move:.3e} of "
              f"the movement (max|err| {float((one - pool).abs().max()):.3e})"
              f"; on the pool run's {len(rec.choices)} branch points "
              f"{float((taken - pool).norm()) / move:.3e} (max|err| "
              f"{float((taken - pool).abs().max()):.3e}), {rep.flips} units "
              f"the other side of the one-thread run's own, margin "
              f"{rep.margin:.1e}")


def _engine_runs(threads, mode_of):
    """Patch ``FLEngine.run`` so that engine run i runs on ``threads``
    torch threads under ``mode_of(i)``; returns the list that gathers
    each run's (start, end) flat params and mode, and the undo."""
    from repro_torch.core import FLEngine
    real, runs = FLEngine.run, []

    def run(self, *args, **kwargs):
        mode = mode_of(len(runs))
        n = torch.get_num_threads()
        p0 = self._flat_params.clone()
        torch.set_num_threads(threads)
        try:
            with mode:
                out = real(self, *args, **kwargs)
        finally:
            torch.set_num_threads(n)
        runs.append((p0, self._flat_params.clone(), mode))
        return out

    FLEngine.run = run

    def undo():
        FLEngine.run = real
    return runs, undo


def case(test_ids):
    """Part 5: each test id on the pool (recorded), on one thread free and
    on one thread taking the pool run's branches."""
    import pytest
    n_threads = torch.get_num_threads()
    for tid in test_ids:
        out = {}
        for label, threads, mode_of in (
                ("pool", n_threads, lambda i: kinks.Record()),
                ("one thread", 1, lambda i: contextlib.nullcontext()),
                ("one thread on the pool's branches", 1,
                 lambda i: kinks.Replay(out["pool"][1][i][2].choices))):
            runs, undo = _engine_runs(threads, mode_of)
            try:
                rc = pytest.main([tid, "-q", "-p", "no:cacheprovider",
                                  "-p", "no:randomly", "--no-header",
                                  "-o", "console_output_style=classic"])
            finally:
                undo()
            out[label] = ("passed" if rc == 0 else "FAILED", runs)
        pool = out["pool"][1]
        for i, (p0, want, rec) in enumerate(pool):
            move = float((want - p0).norm())
            parts = []
            for label in ("one thread", "one thread on the pool's branches"):
                got = out[label][1][i][1]
                parts.append(f"{label} {float((got - want).norm()) / move:.3e}"
                             f" (max|err| {float((got - want).abs().max()):.3e})")
            rep = out["one thread on the pool's branches"][1][i][2]
            print(f"case {tid} engine run {i} ({n_threads} threads, "
                  f"{len(rec.choices)} branch points): distance from the "
                  f"pool run over its movement: " + "; ".join(parts)
                  + f"; {rep.flips} units the other side of the one-thread "
                  f"run's own, margin {rep.margin:.1e}, every choice taken "
                  f"{rep.done}")
        print(f"case {tid}: test " + ", ".join(
            f"{label} {res}" for label, (res, _) in out.items()))


if __name__ == "__main__":
    args = sys.argv[1:] or ["steps", "engines", "onednn"]
    if args[0] == "case":
        case(args[1:])
    else:
        for part in args:
            {"steps": steps, "engines": engines, "onednn": onednn,
             "horizons": horizons}[part]()
