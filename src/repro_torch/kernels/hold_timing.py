"""Times the f32 fold's four designs, ``torch.add``, the quantized
screens' three designs and the flash kernels on the card, each with and
without ``chip_smoke.py`` phase 4's device hold, in one process, so that
a kernel's gain and the timing method's effect can be told apart.

    PYTHONPATH=src python -m repro_torch.kernels.hold_timing [--rounds 7]

It builds ``csrc/safl_agg.cu`` (the package's kernels),
``csrc/fold_variants.cu`` and ``csrc/screen_variants.cu`` (the other
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
- :func:`repro_torch.kernels.flash_attention.flash_attention` in bf16 and
  f32 at the full-width qwen3 prefill's shape (B 8, S 1024, H 16 / 8,
  hd 128, causal).

Each time is the median of 60 CUDA-event-timed launches with the L2
flushed before each (a 256 MB read), then either the device held for
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("hold_timing: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    variants = build.load("fold_variants")
    package = k_mod._lib()
    g = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.zeros(64 * 2 ** 20, device="cuda")
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
    cases.update(screen_cases(g))
    b, s, h, hkv, hd = FLASH_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((b, s, h, hd), device="cuda", generator=g).to(dtype)
        kv = [torch.randn((b, s, hkv, hd), device="cuda",
                          generator=g).to(dtype) for _ in range(2)]
        cases[f"flash_attention {str(dtype).split('.')[-1]}"] = (
            lambda q=q, kv=kv: fa_mod.flash_attention(q, *kv))
    samples = {(c, hold): [] for c in cases for hold in (False, True)}
    for _ in range(args.rounds):
        for c, fn in cases.items():
            for hold in (False, True):
                samples[c, hold].append(time_ms(fn, flush, hold))
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
                                   hold_cycles=HOLD_CYCLES, d=D, dq=DQ,
                                   nk=NK,
                                   cases=rows_out), indent=1))


if __name__ == "__main__":
    main()
