"""Times the f32 fold's four designs, ``torch.add``, the q4 and q8
folds' designs, the q4 K-row aggregate's designs, the f32 and quantized
screens' designs, the top-k kernels' designs and the flash kernels on
the card, each with and without
``chip_smoke.py`` phase 4's device hold, in one process, so that a
kernel's gain and the timing method's effect can be told apart.

    PYTHONPATH=src python -m repro_torch.kernels.hold_timing [--rounds 7]
        [--only GROUP ...]

``--only`` times some groups of cases alone (``fold``, ``fold_q4``,
``fold_q8``, ``aggregate_q4``, ``screen_f32``, ``screen``, ``topk``,
``flash``; all by default).

It builds ``csrc/safl_agg.cu`` (the package's kernels),
``csrc/fold_variants.cu``, ``csrc/aggregate_variants.cu``,
``csrc/screen_variants.cu`` and ``csrc/topk_variants.cu`` (the other
designs, for timing only), checks each design against its plain version
on the rows it is timed on, then times:

- at D = 2,154,730 (the paper CNN's row), the package's fold (8-byte
  vectors, one a thread over an exact grid, after a scalar head up to
  the output's next 128-byte line) and the three of
  ``fold_variants.cu`` (the first design, a grid-stride loop of 4-byte
  lanes; 16-byte vectors; 8-byte vectors after a head up to the next
  8-byte boundary only), each checked bitwise against
  ``safl_fold_plain``, through ``ctypes`` with their arguments made
  beforehand (the same host cost for each), the package's wrapper
  :func:`repro_torch.kernels.safl_agg.safl_fold` (as phase 4 calls it)
  and ``torch.add(acc, vec, alpha=w)``, on a 16-byte aligned row and in
  place into an odd bank row (row 1 of a (2, D) buffer: 8 bytes off;
  the 16-byte design does not run there);
- the q4 and the q8 fold at Dq = 2,155,008 in place at beta 1 (as the
  engine folds): the package's (4 lanes a thread over an exact grid of
  128) and in ``fold_variants.cu`` the earlier design (one lane a thread
  in a grid-stride loop) and the package's kernel at 2, 4, 8 and 16
  lanes a thread and blocks of 64, 128, 256 and 512, each through
  ``ctypes`` and checked bitwise against ``safl_fold_q4_plain`` /
  ``safl_fold_q8_plain``, and the package's wrapper;
- the q4 K-row aggregate at K = 4 on Dq = 2,155,008 packed lanes, in
  fedsgd over D lanes and avg over Dq: the package's
  (``aggregate_q4_kernel``) and in ``aggregate_variants.cu`` the earlier
  design (``aggregate_kernel<Q4Rows>``, one lane a thread in a
  grid-stride loop) and the package's kernel at 4, 8 and 16 lanes a
  thread, blocks of 128 and 256 and 1 or 4 rows loaded together, each
  through ``ctypes`` and checked bitwise against
  ``safl_aggregate_q4_plain``, and the package's wrapper;
- the f32 screen at K = 1 on the paper CNN's row (16-byte aligned: the
  float4 path), on a copy 4 bytes off and at K = 4 (D mod 4 = 2, so odd
  rows 8 bytes off: both on the lane-by-lane path): the
  package's one launch (8 warps a block, 8 float4 loads a thread)
  through ``ctypes`` and its wrapper, and in ``screen_variants.cu`` the
  earlier two-launch design and the same kernel at 4, 8 and 16 warps
  and 2, 4, 8 and 16 loads (not 16 x 16); each design's sums checked
  against
  ``screen_rows_plain`` (isfinite verdicts exact, finite sums within
  ``rtol=1e-5``), the package's bitwise across the three rows;
- the quantized screens: the package's one-launch kernel
  (``screen_rows_q8`` / ``screen_rows_q4``: 8 warps a block, one 16-byte
  load a lane) through ``ctypes`` and through its wrapper, and through
  ``ctypes`` the same kernel with 2 warps a block and 2 loads a lane and
  the earlier two-launch design (both in ``screen_variants.cu``), at
  K = 1 on the paper CNN's quantized row (Dq = 2,155,008: 4,209 blocks of
  512) and on its top-k upload's values (q8, nk = 215,552), and at K = 4
  on the CNN's row; each design's sums are checked against
  ``screen_rows_q8_plain`` / ``screen_rows_q4_plain`` (isfinite verdicts
  exact, finite sums within ``rtol=1e-5``);
- the top-k kernels on the paper CNN's top-k rows (nk = 215,552 kept
  lanes of D): the fold at beta 1 in place, the package's
  (``safl_fold_topk``) and in ``csrc/topk_variants.cu`` the same kernel
  at 1, 2, 4 and 8 lanes a thread and blocks of 128, 256 and 512, and
  the earlier one-lane grid-stride design; the K-row sum at K = 4 and
  K = 16, the package's cooperative launch (``safl_aggregate_topk``),
  the same at 1, 2 and 4 lanes a thread and blocks of 256, 512 and 1024
  and the earlier design (a memset, then one scatter launch a row); each
  through ``ctypes`` and the package's through its wrapper, each checked
  bitwise against ``safl_fold_topk_plain`` /
  ``safl_aggregate_topk_plain``; then the K-row sum's two costs apart
  (``topk_variants.cu``'s probes): one row's scatter as a
  read-modify-write, its gathers alone and its stores alone, on the
  row's coordinates as ranked and sorted, with the bank flushed from L2
  and left in it; and a cooperative launch of 0, 1, 4 and 16 grid
  barriers on the resident blocks of 256, 512 and 1024 threads and on
  132 blocks of 1024;
- :func:`repro_torch.kernels.flash_attention.flash_attention` in bf16 and
  f32 at the full-width qwen3 prefill's shape (B 8, S 1024, H 16 / 8,
  hd 128, causal).

Each time is the median of 60 CUDA-event-timed launches with the L2
flushed before each (a 256 MB read; the cases named "in L2" are not
flushed), then either the device held for
``HOLD_CYCLES`` (``torch.cuda._sleep``: the host has queued the call
before the device reaches it, so the time is the device's) or not (the
host's time for the call shows wherever it exceeds the flush's).  Each
round times every case once, in turn; the rounds' median and range are
printed with the card's name and power limit and written to
``chiprun_out/hold_timing.json``.  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import safl_agg as k_mod

D = 2_154_730
#: the quantized screens' rows: the CNN's Dq and its top-k upload's nk
QB = 512
DQ = -(-D // QB) * QB
NK = 421 * QB
#: the flash cases' (B, S, H, Hkv, hd): the full-width qwen3 prefill
FLASH_SHAPE = (8, 1024, 16, 8, 128)
LAUNCHES = 60
#: device cycles spun between the L2 flush and a held launch (about 0.5 ms
#: at the H100's clock), as ``chip_smoke.py`` phase 4 spins
HOLD_CYCLES = 1_000_000
#: a case timed without the L2 flush (what it reads stays in L2)
WARM = "warm"
OUT = Path(__file__).resolve().parents[3] / "chiprun_out" / "hold_timing.json"


def time_ms(fn, flush, hold: bool) -> float:
    """Median over :data:`LAUNCHES` of one call's CUDA-event time, the L2
    flushed before each and, with ``hold``, the device then held."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(LAUNCHES):
        flush.sum()
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def raw_fold(fn, acc, vec, out, w):
    """A call of the C fold ``fn`` with its arguments made beforehand."""
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_float] * 2 + [
        ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = (acc.data_ptr(), vec.data_ptr(), out.data_ptr(), w, 1.0,
            acc.numel(), torch.cuda.current_stream().cuda_stream)

    def call():
        if fn(*args):
            raise RuntimeError(f"{fn.__name__}: launch failed")
    return call


def raw_screen(fn, q, s, packed, chunks, counts=None):
    """A call of the C screen ``fn`` over (q, s) with its (K, chunks)
    scratch and arguments made beforehand; ``counts`` (per-row counters)
    for the one-launch kernels, None for the two-launch design.  Returns
    (call, out)."""
    k, nbytes = q.shape
    dq = 2 * nbytes if packed else nbytes
    part = torch.empty((k, chunks), device="cuda")
    out = torch.empty(k, device="cuda")
    ptrs = [q.data_ptr(), s.data_ptr(), part.data_ptr()]
    if counts is not None:
        ptrs.append(counts.data_ptr())
    fn.argtypes = [ctypes.c_void_p] * (len(ptrs) + 1) + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = (*ptrs, out.data_ptr(), k, dq, QB.bit_length() - 1, chunks,
            torch.cuda.current_stream().cuda_stream)

    def call():
        if fn(*args):
            raise RuntimeError(f"{fn.__name__}: launch failed")
    call.tensors = (q, s, part, out, counts)
    return call, out


def raw_screen_f32(fn, u, chunks, counts=None):
    """A call of the C f32 screen ``fn`` over the (K, D) rows ``u`` with
    its (K, chunks) scratch and arguments made beforehand; ``counts``
    (per-row counters) for the one-launch kernels, None for the two-launch
    design.  Returns (call, out)."""
    k, d = u.shape
    part = torch.empty((k, chunks), device="cuda")
    out = torch.empty(k, device="cuda")
    ptrs = [u.data_ptr(), part.data_ptr()]
    if counts is not None:
        ptrs.append(counts.data_ptr())
    fn.argtypes = [ctypes.c_void_p] * (len(ptrs) + 1) + [
        ctypes.c_int64] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = (*ptrs, out.data_ptr(), k, d, chunks,
            torch.cuda.current_stream().cuda_stream)

    def call():
        if fn(*args):
            raise RuntimeError(f"{fn.__name__}: launch failed")
    call.tensors = (u, part, out, counts)
    return call, out


def check_sums(name, got, want):
    """Exit unless a screen's sums match its plain version's: isfinite
    verdicts exact, finite sums within rtol=1e-5."""
    fin = torch.isfinite(want)
    if not (torch.equal(torch.isfinite(got), fin) and torch.allclose(
            got[fin], want[fin], rtol=1e-5, atol=0.0)):
        sys.exit(f"hold_timing: {name} differs from its plain version")


def screen_cases(g) -> dict:
    """The quantized screens' timed calls, each checked first."""
    from repro_torch.kernels import ref
    x = torch.randn((4, DQ), device="cuda", generator=g)
    q8, s8 = ref.quantize_ref(x.view(-1, QB))
    q8, s8 = q8.view(4, DQ), s8.view(4, -1)
    qv, sv = ref.quantize_ref(x[0, :NK].reshape(-1, QB))
    q4 = ref.pack_q4_ref(torch.randint(-7, 8, (4, DQ), device="cuda",
                                       generator=g).to(torch.int8))
    s4 = torch.rand((4, DQ // QB), device="cuda", generator=g)
    rows = {"q8 K=1 Dq": (q8[:1], s8[:1], False),
            "q8 K=1 top-k nk": (qv.view(1, NK), sv.view(1, -1), False),
            "q8 K=4 Dq": (q8, s8, False),
            "q4 K=1 Dq": (q4[:1], s4[:1], True),
            "q4 K=4 Dq": (q4, s4, True)}
    variants = build.load("screen_variants")
    package = k_mod._lib()
    cases = {}
    for row_name, (q, s, packed) in rows.items():
        wire = "q4" if packed else "q8"
        plain = (k_mod.screen_rows_q4_plain if packed
                 else k_mod.screen_rows_q8_plain)
        wrapper = k_mod.screen_rows_q4 if packed else k_mod.screen_rows_q8
        want = plain(q, s, qblock=QB)
        nb, bbytes = s.shape[1], QB // 2 if packed else QB
        counts = k_mod._screen_counts(
            q.device.index, torch.cuda.current_stream().cuda_stream)
        designs = {
            "two launches": raw_screen(
                getattr(variants, f"screen_rows_{wire}_two_launch"), q, s,
                packed, -(-nb // 32)),
            "one launch, 2 warps x 2 loads": raw_screen(
                getattr(variants, f"screen_rows_{wire}_w2l2"), q, s,
                packed, -(-nb // (2 * max(1, 1024 // bbytes))), counts),
            "one launch (package)": raw_screen(
                getattr(package, f"screen_rows_{wire}"), q, s, packed,
                k_mod.screen_q_chunks(nb, bbytes), counts)}
        for name, (call, out) in designs.items():
            call()
            check_sums(f"screen {name}, {row_name}", out, want)
            cases[f"screen {name}, {row_name}"] = call
        check_sums(f"screen wrapper, {row_name}",
                   wrapper(q, s, qblock=QB), want)
        cases[f"screen wrapper, {row_name}"] = (
            lambda q=q, s=s, w=wrapper: w(q, s, qblock=QB))
    return cases


def misaligned(t):
    """A contiguous copy of ``t`` one element past its buffer's aligned
    start."""
    view = torch.empty(t.numel() + 16, dtype=t.dtype,
                       device=t.device)[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def screen_f32_cases(g) -> dict:
    """The f32 screen's timed calls, each checked first: against the
    plain version, and the package's sums bitwise the same on every
    row's path."""
    variants = build.load("screen_variants")
    package = k_mod._lib()
    u = torch.randn((4, D), device="cuda", generator=g)
    u[1, 1000] = float("nan")
    rows = {"f32 K=1 D": u[:1], "f32 K=1 D, 4 bytes off": misaligned(u[:1]),
            "f32 K=4 D": u}
    counts = k_mod._screen_counts(0, torch.cuda.current_stream().cuda_stream)
    designs = {"two launches (parent)": (variants.screen_rows_f32_two_launch,
                                         8192, None)}
    for w in (4, 8, 16):
        for loads in (2, 4, 8, 16):
            if (w, loads) not in ((k_mod.SCREEN_F32_WARPS,
                                   k_mod.SCREEN_F32_LOADS), (16, 16)):
                designs[f"one launch, {w} warps x {loads} loads"] = (
                    getattr(variants, f"screen_rows_f32_w{w}_l{loads}"),
                    w * 128 * loads, counts)
    designs["one launch (package)"] = (package.screen_rows_f32,
                                       k_mod.SCREEN_CHUNK, counts)
    cases, sums = {}, {}
    for row_name, x in rows.items():
        want = k_mod.screen_rows_plain(x)
        for name, (fn, chunk, cnt) in designs.items():
            call, out = raw_screen_f32(fn, x, -(-D // chunk), cnt)
            call()
            check_sums(f"screen {name}, {row_name}", out, want)
            cases[f"screen {name}, {row_name}"] = call
            if name == "one launch (package)":
                sums[row_name] = out.clone()
        check_sums(f"screen wrapper, {row_name}", k_mod.screen_rows(x), want)
        cases[f"screen wrapper screen_rows, {row_name}"] = (
            lambda x=x: k_mod.screen_rows(x))
    first = sums["f32 K=1 D"].view(torch.int32)
    if not (torch.equal(sums["f32 K=1 D, 4 bytes off"].view(torch.int32),
                        first)
            and torch.equal(sums["f32 K=4 D"][:1].view(torch.int32), first)):
        sys.exit("hold_timing: the f32 screen's two paths differ bitwise")
    return cases


def fold_q_cases(g, wire: str) -> dict:
    """A quantized fold's timed calls (``wire`` q4 or q8; in place at beta
    1), each checked bitwise first."""
    from repro_torch.kernels import ref
    variants = build.load("fold_variants")
    package = k_mod._lib()
    acc = torch.randn((DQ,), device="cuda", generator=g)
    if wire == "q4":
        qr = ref.pack_q4_ref(torch.randint(-8, 8, (DQ,), device="cuda",
                                           generator=g).to(torch.int8))
    else:
        qr = torch.randint(-128, 128, (DQ,), device="cuda",
                           generator=g).to(torch.int8)
    sr = torch.rand((DQ // QB,), device="cuda", generator=g)
    w = 0.37
    plain = getattr(k_mod, f"safl_fold_{wire}_plain")
    want = plain(acc, qr, sr, w, qblock=QB)
    designs = {"grid-stride, one lane (parent)":
               getattr(variants, f"safl_fold_{wire}_gridstride")}
    for v in (2, 4, 8, 16):
        for t in (64, 128, 256, 512):
            designs[f"{v} lanes x {t} threads"] = getattr(
                variants, f"safl_fold_{wire}_v{v}_t{t}")
    designs["package"] = getattr(package, f"safl_fold_{wire}")
    p, f = ctypes.c_void_p, ctypes.c_float
    cases = {}
    for name, fn in designs.items():
        fn.argtypes = [p] * 4 + [f, f, ctypes.c_int64, ctypes.c_int, p]
        row = acc.clone()
        call = raw_topk(fn, (row.data_ptr(), qr.data_ptr(), sr.data_ptr(),
                             row.data_ptr(), w, 1.0, DQ,
                             QB.bit_length() - 1), row, qr, sr)
        call()
        if not torch.equal(row, want):
            sys.exit(f"hold_timing: {wire} fold {name} is not bitwise "
                     f"safl_fold_{wire}_plain")
        cases[f"fold_{wire} {name}"] = call
    row = acc.clone()
    wrapper = getattr(k_mod, f"safl_fold_{wire}")
    cases[f"fold_{wire} wrapper safl_fold_{wire}"] = (
        lambda: wrapper(row, qr, sr, w, qblock=QB, out=row))
    return cases


def aggregate_q4_cases(g) -> dict:
    """The q4 K-row aggregate's timed calls at K = 4, fedsgd over D lanes
    (the SS round) and avg over Dq (the SA round), each checked bitwise
    first against ``safl_aggregate_q4_plain``."""
    from repro_torch.kernels import ref
    variants = build.load("aggregate_variants")
    package = k_mod._lib()
    k = 4
    q = ref.pack_q4_ref(torch.randint(-8, 8, (k, DQ), device="cuda",
                                      generator=g).to(torch.int8))
    s = torch.rand((k, DQ // QB), device="cuda", generator=g)
    prm = torch.randn((D,), device="cuda", generator=g)
    ones = torch.ones((k,), device="cuda")
    sizes = torch.tensor([113.0, 58.0, 241.0, 77.0], device="cuda")
    designs = {"grid-stride, one lane (parent)":
               variants.safl_aggregate_q4_gridstride}
    for v in (4, 8, 16):
        for t in (128, 256):
            for r in (1, 4):
                designs[f"{v} lanes x {t} threads x {r} rows"] = getattr(
                    variants, f"safl_aggregate_q4_v{v}_t{t}_r{r}")
    designs["package"] = package.safl_aggregate_q4
    argtypes = package.safl_aggregate_q4.argtypes
    cases = {}
    for mode, w, n in (("fedsgd", ones, D), ("avg", sizes, DQ)):
        kw = dict(server_lr=0.05, mode=mode)
        want = k_mod.safl_aggregate_q4_plain(q, s, w, prm, qblock=QB, **kw)
        for name, fn in designs.items():
            fn.argtypes = argtypes
            out = torch.empty((n,), device="cuda")
            call = raw_topk(fn, (q.data_ptr(), s.data_ptr(), w.data_ptr(),
                                 prm.data_ptr(), out.data_ptr(), k, DQ, n,
                                 0.05, 0.5, k_mod.MODES[mode], 0,
                                 QB.bit_length() - 1), q, s, w, prm, out)
            call()
            if not torch.equal(out, want):
                sys.exit(f"hold_timing: q4 aggregate {name} ({mode}) is "
                         "not bitwise safl_aggregate_q4_plain")
            cases[f"aggregate_q4 {mode} {name}"] = call
        cases[f"aggregate_q4 {mode} wrapper safl_aggregate_q4"] = (
            lambda w=w, kw=kw: k_mod.safl_aggregate_q4(q, s, w, prm,
                                                       qblock=QB, **kw))
    return cases


def topk_rows(k: int, g):
    """k sparse rows of D as ``chip_smoke.py`` makes them: the top-|x|
    NK lanes of random rows, ranked by a stable descending sort, their
    values int8-quantized in compacted blocks; coordinate 5 in every row
    and 6 in all but the last, so the rows collide there.  Returns (idx
    int32, qv int8, scales)."""
    from repro_torch.kernels import ref
    x = torch.zeros((k, DQ), device="cuda")
    x[:, :D] = torch.randn((k, D), device="cuda", generator=g)
    x[:, 5] = 50.0 + torch.arange(k, device="cuda")
    x[:-1, 6] = -40.0
    idx = torch.sort(x.abs(), dim=1, descending=True,
                     stable=True).indices[:, :NK]
    q, s = ref.quantize_ref(torch.gather(x, 1, idx).view(-1, QB))
    return idx.to(torch.int32), q.view(k, NK), s.view(k, -1)


def raw_topk(fn, args, *tensors):
    """A call of the C top-k entry ``fn`` with ``args`` (pointers, then
    the scalars) made beforehand, the stream appended; the call holds
    ``tensors``, whose pointers ``args`` carry, so they outlive it."""
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        if fn(*args, stream):
            raise RuntimeError(f"{fn.__name__}: launch failed")
    call.tensors = tensors
    return call


def topk_cases(g) -> dict:
    """The top-k kernels' timed calls, each checked bitwise first."""
    variants = build.load("topk_variants")
    package = k_mod._lib()
    p, f, i64, i32 = (ctypes.c_void_p, ctypes.c_float, ctypes.c_int64,
                      ctypes.c_int)
    qshift = QB.bit_length() - 1
    idx, qv, sv = topk_rows(16, g)
    acc = torch.randn((D,), device="cuda", generator=g)
    w = 0.37
    folds = {"grid-stride, one lane (parent)":
             variants.safl_fold_topk_gridstride}
    for v in (1, 2, 4, 8):
        for t in (128, 256, 512):
            folds[f"{v} lanes x {t} threads"] = getattr(
                variants, f"safl_fold_topk_v{v}_t{t}")
    folds["package"] = package.safl_fold_topk
    cases = {}
    want = k_mod.safl_fold_topk_plain(acc, idx[0], qv[0], sv[0], w)
    for name, fn in folds.items():
        fn.argtypes = [p] * 5 + [f, f, i64, i64, i32, p]
        row = acc.clone()
        call = raw_topk(fn, (row.data_ptr(), idx[0].data_ptr(),
                             qv[0].data_ptr(), sv[0].data_ptr(),
                             row.data_ptr(), w, 1.0, D, NK, qshift),
                        row, idx, qv, sv)
        call()
        if not torch.equal(row, want):
            sys.exit(f"hold_timing: top-k fold {name} is not bitwise "
                     "safl_fold_topk_plain")
        cases[f"topk fold {name}"] = call
    row = acc.clone()
    cases["topk fold wrapper safl_fold_topk"] = (
        lambda: k_mod.safl_fold_topk(row, idx[0], qv[0], sv[0], w, out=row))
    sums = {"memset + a launch a row (parent)":
            variants.safl_aggregate_topk_memset}
    for v in (1, 2, 4):
        for t in (256, 512, 1024):
            sums[f"coop {v} lanes x {t} threads"] = getattr(
                variants, f"safl_aggregate_topk_v{v}_t{t}")
    sums["package"] = package.safl_aggregate_topk
    for k in (4, 16):
        wk = 0.5 + 3.5 * torch.rand((k,), device="cuda", generator=g)
        ik, qk, sk = idx[:k], qv[:k], sv[:k]
        want = k_mod.safl_aggregate_topk_plain(ik, qk, sk, wk, D)
        for name, fn in sums.items():
            fn.argtypes = [p] * 5 + [i64, i64, i64, i32, p]
            out = torch.empty((D,), device="cuda")
            call = raw_topk(fn, (ik.data_ptr(), qk.data_ptr(),
                                 sk.data_ptr(), wk.data_ptr(),
                                 out.data_ptr(), k, NK, D, qshift),
                            ik, qk, sk, wk, out)
            call()
            if not torch.equal(out, want):
                sys.exit(f"hold_timing: top-k sum {name} at K = {k} is not "
                         "bitwise safl_aggregate_topk_plain")
            cases[f"topk sum K={k} {name}"] = call
        cases[f"topk sum K={k} wrapper safl_aggregate_topk"] = (
            lambda ik=ik, qk=qk, sk=sk, wk=wk:
            k_mod.safl_aggregate_topk(ik, qk, sk, wk, D))
    # the K-row sum's costs apart: one row's scatter (its coordinates as
    # ranked, and sorted) with the bank flushed and in L2, and barriers
    fn = variants.topk_scatter_probe
    fn.argtypes = [i32] + [p] * 4 + [f, i64, i64, i32, p]
    for order, ix in (("ranked", idx[0]),
                      ("sorted", torch.sort(idx[0]).values.contiguous())):
        for mode, part in enumerate(("read-modify-write", "gathers alone",
                                     "stores alone")):
            call = raw_topk(fn, (mode, acc.data_ptr(), ix.data_ptr(),
                                 qv[0].data_ptr(), sv[0].data_ptr(), w, NK,
                                 D, qshift), acc, ix, qv, sv)
            cases[f"topk row {part}, {order}"] = call
            cases[f"topk row {part}, {order}, bank in L2"] = (call, WARM)
    fn = variants.topk_barrier_probe
    fn.argtypes = [i64, i32, i64, p]
    for threads, cap in ((256, 0), (512, 0), (1024, 0), (1024, 132)):
        for k in (0, 1, 4, 16):
            cases[f"topk {k} barriers, {threads} threads" + (
                f" x {cap} blocks" if cap else "")] = raw_topk(
                    fn, (k, threads, cap))
    return cases


def fold_cases(g) -> dict:
    """The f32 fold's timed calls and ``torch.add``, each checked
    bitwise first."""
    variants = build.load("fold_variants")
    package = k_mod._lib()
    vec = torch.randn((D,), device="cuda", generator=g)
    w = 0.37
    rows = {"aligned": torch.randn((D,), device="cuda", generator=g),
            "odd row": torch.randn((2, D), device="cuda", generator=g)[1]}
    kernels = {"gridstride": variants.fold_gridstride_f32,
               "float2, head to 8 bytes": variants.fold_vec2_f32,
               "float4": variants.fold_vec4_f32,
               "float2, head to a line (package)": package.safl_fold_f32}
    cases = {}
    for row_name, row in rows.items():
        want = k_mod.safl_fold_plain(row, vec, w)
        for name, fn in kernels.items():
            if name == "float4" and row.data_ptr() % 16:
                continue
            call = raw_fold(fn, row, vec, row, w)
            before = row.clone()
            call()
            if not torch.equal(row, want):
                sys.exit(f"hold_timing: {name} on the {row_name} is not "
                         "bitwise safl_fold_plain")
            row.copy_(before)
            cases[f"fold {name}, {row_name}"] = call
        cases[f"fold wrapper safl_fold, {row_name}"] = (
            lambda r=row: k_mod.safl_fold(r, vec, w, out=r))
        cases[f"torch.add, {row_name}"] = (
            lambda r=row: torch.add(r, vec, alpha=w))
    return cases


def flash_cases(g) -> dict:
    """Flash attention in bf16 and f32 at the qwen3 prefill's shape."""
    b, s, h, hkv, hd = FLASH_SHAPE
    cases = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((b, s, h, hd), device="cuda", generator=g).to(dtype)
        kv = [torch.randn((b, s, hkv, hd), device="cuda",
                          generator=g).to(dtype) for _ in range(2)]
        cases[f"flash_attention {str(dtype).split('.')[-1]}"] = (
            lambda q=q, kv=kv: fa_mod.flash_attention(q, *kv))
    return cases


#: the groups of cases, in the order they are made and timed
GROUPS = {"fold": fold_cases,
          "fold_q4": lambda g: fold_q_cases(g, "q4"),
          "fold_q8": lambda g: fold_q_cases(g, "q8"),
          "aggregate_q4": aggregate_q4_cases,
          "screen_f32": screen_f32_cases, "screen": screen_cases,
          "topk": topk_cases, "flash": flash_cases}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--only", nargs="+", choices=sorted(GROUPS),
                    default=list(GROUPS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("hold_timing: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    g = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.zeros(64 * 2 ** 20, device="cuda")
    cases = {}
    for group, make in GROUPS.items():
        if group in args.only:
            cases.update(make(g))
    samples = {(c, hold): [] for c in cases for hold in (False, True)}
    no_flush = torch.zeros(1, device="cuda")
    for _ in range(args.rounds):
        for c, fn in cases.items():
            fn, fl = (fn[0], no_flush) if isinstance(fn, tuple) else (fn,
                                                                      flush)
            for hold in (False, True):
                samples[c, hold].append(time_ms(fn, fl, hold))
    rows_out = []
    print(f"medians over {args.rounds} rounds of the median of {LAUNCHES} "
          "launches, ms (range)")
    for c in cases:
        line = {"case": c}
        for hold, key in ((False, "no hold"), (True, "hold")):
            xs = samples[c, hold]
            line[key] = dict(median=statistics.median(xs), min=min(xs),
                             max=max(xs))
        rows_out.append(line)
        print(f"  {c:52s} " + "  ".join(
            f"{k} {line[k]['median']:.5f} ({line[k]['min']:.5f}-"
            f"{line[k]['max']:.5f})" for k in ("no hold", "hold")))
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(dict(smi=smi, torch=torch.__version__,
                                   rounds=args.rounds, launches=LAUNCHES,
                                   groups=args.only,
                                   hold_cycles=HOLD_CYCLES, d=D, dq=DQ,
                                   nk=NK,
                                   cases=rows_out), indent=1))


if __name__ == "__main__":
    main()
