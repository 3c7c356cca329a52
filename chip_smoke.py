#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA GPU and the
CUDA toolkit (nvcc).  It imports nothing of JAX or of the JAX package.
Phases, each of which exits non-zero on failure:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     TF32 is switched off for convolutions and matrix products, and cuDNN
     set to deterministic algorithms picked without timing
     (``cudnn.deterministic``, not ``cudnn.benchmark``), as ``fl_sim``
     sets it
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``, one
     ``nvcc`` per source (``safl_agg.cu``, ``quantize.cu``,
     ``flash_attention.cu``, and ``aggregate_variants.cu``, the q4
     aggregate's parent design), started together; the ptxas report must
     show no spills in the bf16 flash kernel (``FLASH_SYMBOL``), the two
     top-k kernels, the f32 screen, the q4 and q8 folds and the q4
     aggregate
  3. each of the nine aggregation kernels (f32, q8 and packed-int4 q4
     rows) against its plain PyTorch version on the card, at the main
     path's shapes (D = 2,154,730, Dq = 2,155,008, K = 4) and at a
     ragged D = 4099 (Dq = 4608) with K = 3, in every mode, discount and
     beta, the q4 rows holding -8 nibbles (a 0x55-flipped span), and
     the f32 fold in place into an odd bank row (d lanes into a (2, d)
     buffer: 8-byte aligned at the main D, 4-byte at the ragged one):
     bitwise, except the poly discount (``powf``): ``rtol=1e-5,
     atol=1e-6``.  The three screens at the same D and Dq with K = 1, 3
     and 4 (5 on q4), and ``screen_rows_q8`` over the top-k upload's
     values (nk = 215,552) with K = 1, 3 and 4, on clean, corrupted (NaN
     lanes; flipped bytes and an Inf scale), Byzantine, all-zero and (q4)
     flipped-only rows: isfinite verdicts exact, finite sums within
     ``rtol=1e-5``, and each row's sum bitwise the same alone (K = 1) as
     inside the stack, and in three launches back to back; each screen
     also on a copy of the rows 1 element off a 16-byte boundary (the f32
     screen's lane-by-lane path, the quantized screens' byte path):
     against the plain version, and bitwise the aligned calls' sums.
     ``safl_fold_q4`` and ``safl_fold_q8`` at both Dq, at beta 1 in
     place and 0.625 out of place, with acc 0-3 lanes and the quantized
     row 0-15 bytes off alignment (64 placements each): bitwise.
     ``safl_aggregate_q4`` in every mode x discount at K = 1, 4 and 16,
     both Dq, rows and p aligned and 1 byte / 1 lane off: bitwise the
     plain version (discount none) or the parent kernel (poly).  The q4 wire's stochastic-rounding draws made
     on the card (``prng.uniform_torch``) against the numpy threefry at
     the paper CNN's (4209, 512): bitwise.  The two top-k kernels at the main
     path's K = 4, nk = 215,552 (rows colliding on a coordinate in 4 and
     in 3 uploads), at K = 17 there (more rows than the K-row sum loads
     ahead) and at the ragged D with K = 3, nk = Dq (pad lanes ranked)
     and an empty row: the fold at beta 1 and 0.7, in place and not, the
     K-row sum, and the chain of in-place folds against the K-row sum,
     bitwise; and on copies of the rows one lane off (idx and qv, then
     idx alone), bitwise the aligned calls.  The int8 pair at (4209, 512) and 37 rows with a zero
     row, exact .5 ties and a NaN row: bitwise (NaN scales in the same
     rows).  Flash attention in f32 and bf16, causal and not, at the
     reference test sweep's shapes, the full-width qwen3 prefill's (B 8,
     S 1024, H 16, Hkv 8, hd 128), a ragged S = 200 and two odd H / Hkv
     (S = 200 at hd 128, S = 130 at hd 64): within
     ``atol=rtol=2e-5`` (f32) and ``2e-2`` (bf16); at the qwen3 shape in
     bf16, at most 2 % of output lanes differing from the plain version
     (the plain version with p rounded to bf16 must differ in more); and
     causal (outputs before a position unchanged when later keys change)
  4. timings at the main path's shapes: median of CUDA-event-timed
     launches with the 50 MB L2 flushed before each and the device held
     until the host has queued the launch (the f32 fold in
     place into an aligned and into an odd bank row; the timer's floor,
     a one-element ``add_`` timed the same way), beside the bound
     (the larger of the bytes at 3.35 TB/s and the operations at the
     dtype's dense peak: 67 TFLOP/s f32, 989 TFLOP/s bf16), the plain
     version and, where one exists, one PyTorch library call computing
     the same function (the screens at K = 1, the path's shape, and
     K = 4; the q8 screen also over a top-k upload's values), the top-k
     kernels, the int8 pair and flash attention at the
     qwen3 prefill's shape in bf16 (f32 beside it; the library call
     ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``);
     3 calls of each screen (f32, q8, q4; K = 1), of the q4, q8 and top-k
     folds (beta 1, in place), of the q4 aggregate (K = 4, fedsgd) and
     of the top-k K-row sum (K = 4) captured into a CUDA
     graph, whose nodes (read through libcuda's graph API) must be one
     launch of the kernel a call and nothing else (no memset; the K-row
     sum's launch cooperative), its replay equal to the eager outputs,
     and one ``torch.profiler`` pass over 3 calls of each, which must show
     the same where it sees any device activity;
     and the codec's time per upload: the q4 draws alone and the
     whole q4 quantize, the top-k ranking alone and the whole top-k
     upload
  5. the engine on the card against the engine on the CPU at a small size
     in AS, SS, AS-fedasync, SS-sdga, AS-q8, SS-sdga-q8, AS-q4,
     SS-sdga-q4, AS-topk, SS-topk, AS-sdga-topk, SS-sdga-topk and, with
     faults and the screen, AS-chaos-screen and its q8 and q4 siblings
     (exact bytes, schedule and fault / defense counts; params within
     ``rtol=1e-4, atol=1e-5`` on f32 and within 2e-2 of the run's own
     movement on q8, q4 and top-k); the q4 and top-k codecs on the card
     against the CPU on full-width uploads (bitwise); the server's
     streaming channel against its buffered one at full width in all six
     aggregation modes on f32, q8 and q4 and the four gradient modes on
     top-k, with clean rows and with corrupted and Byzantine rows
     screened or clipped (``FlatServer.screen`` -> ``defense_factors`` ->
     skip / fold at w*fac against zeroed rows / facs in the weights),
     bitwise; and ``quantize_pytree`` / ``dequantize_pytree`` of the
     full-width CNN's parameters on the card against the CPU, bitwise
  6. the main path at full width: the paper CNN (width 32, 32x32 images,
     D = 2,154,730) on synthetic CIFAR-10, 2000 samples, 16 clients,
     k = 4, hetero-Dirichlet alpha 0.3, 5 rounds in each of 33 settings
     (the paper's AS, AA, SS, SA; AS and SS with fedbuff, fedasync,
     fedopt and sdga; AS, AA, SS, SA and SS-sdga on the q8 and on the q4
     wire, AS-fedasync on q4; AS, SS, AS-fedbuff and SS-sdga on top-k;
     AS under the fault mix with the screen on f32, q8, q4, top-k and the
     buffered channel; AS-fedbuff with Byzantine uploads clipped), with
     every
     launch counter reset before each setting and read after, each
     setting's launches held to the counts it names, every drawn fault
     kind fired, ``screened == corrupted`` under the screen,
     ``clipped >= byzantine`` under clip, and finite params after every
     round; each setting then runs again from a fresh engine, which must
     repeat the first run bit for bit (final flat params bitwise; every
     round's accuracy and loss, bytes, participation, staleness,
     launches and fault counts equal); then the int8 pair's own path,
     the compression helpers over
     the full-width CNN's parameters, its counters reset before and read
     after (one launch of each kernel per leaf)
  7. the serving path at full width: ``repro_torch.launch.serve.run`` of
     qwen3-1.7b (28 layers, d_model 2048, 2,038,555,648 params, f32
     params and bf16 compute, weights from ``prng_key(0)`` drawn on the
     card), B = 8 prompts of 1024 tokens, 32 greedy tokens, every launch
     counter reset before and read after (flash attention once per layer
     of the prefill, nothing else); then (a) 3 timed passes of a prefill
     and 32 decode steps (medians), 28 flash launches per prefill and 0
     per decode step, the peak memory (beside what earlier phases leave
     allocated once garbage is collected, printed after each phase), and
     a ``torch.profiler`` trace of a prefill and 4 decode steps (device
     busy share, flash's share, which must not be 0);
     (b) a check of model scale: the prefill logits against the same
     prefill with the plain attention on the card no further apart (max
     and relative L2) than the plain prefill in bf16 compute is from the
     same in f32 compute; (c) the reduced qwen3 (f32 compute, TF32 off,
     prompt 200) served on the card against the CPU: logits within
     ``atol=rtol=1e-4`` and the same greedy tokens; (d) the normal draws
     made on the card against numpy's, within 4 ulp

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  A copy of every number goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM dense bf16 on the tensor cores
D_FULL = 2_154_730
K_MAIN = 4
D_RAGGED, K_RAGGED = 4099, 3
QB = 512
ROUNDS = 5
TIMED_LAUNCHES = 60
#: phase 4: device cycles spun between the L2 flush and a timed kernel
#: (about 0.5 ms at the H100's clock), for the host to queue the call
HOLD_CYCLES = 1_000_000
KERNELS = ("safl_fold", "safl_aggregate", "sdga_aggregate", "safl_fold_q8",
           "safl_aggregate_q8", "sdga_aggregate_q8", "screen_rows",
           "screen_rows_q8", "safl_fold_q4", "safl_aggregate_q4",
           "sdga_aggregate_q4", "screen_rows_q4", "safl_fold_topk",
           "safl_aggregate_topk", "quantize_int8", "dequantize_int8",
           "flash_attention")
REPLACES = {"safl_fold": "src/repro/kernels/safl_agg.py:221",
            "safl_aggregate": "src/repro/kernels/safl_agg.py:136",
            "sdga_aggregate": "src/repro/kernels/safl_agg.py:323",
            "safl_fold_q8": "src/repro/kernels/safl_agg.py:257",
            "safl_aggregate_q8": "src/repro/kernels/safl_agg.py:420",
            "sdga_aggregate_q8": "src/repro/kernels/safl_agg.py:488",
            "screen_rows": "src/repro/kernels/safl_agg.py:887",
            "screen_rows_q8": "src/repro/kernels/safl_agg.py:918",
            "safl_fold_q4": "src/repro/kernels/safl_agg.py:658",
            "safl_aggregate_q4": "src/repro/kernels/safl_agg.py:599",
            "sdga_aggregate_q4": "src/repro/kernels/safl_agg.py:709",
            "screen_rows_q4": "src/repro/kernels/safl_agg.py:952",
            "safl_fold_topk": "src/repro/kernels/safl_agg.py:830",
            "safl_aggregate_topk": "src/repro/kernels/safl_agg.py:779",
            "quantize_int8": "src/repro/kernels/quantize.py:96",
            "dequantize_int8": "src/repro/kernels/quantize.py:121",
            "flash_attention": "src/repro/kernels/flash_attention.py:76"}
#: the CUDA sources, each built by its own nvcc, all started together
SOURCES = ("safl_agg", "quantize", "flash_attention")
#: other designs built beside them: the q4 aggregate's parent kernel,
#: which phase 3 holds the new one against under the poly discount
VARIANT_SOURCES = ("aggregate_variants",)
INT8_KERNELS = ("quantize_int8", "dequantize_int8")
#: the source of each kernel: the int8 pair in csrc/quantize.cu, flash
#: attention in csrc/flash_attention.cu, every other in csrc/safl_agg.cu
SOURCE_OF = {name: "quantize" if name in INT8_KERNELS else
             "flash_attention" if name == "flash_attention" else "safl_agg"
             for name in KERNELS}
SDGA_KW = dict(server_lr=0.05, momentum=0.8, ema_anchor=0.05,
               ema_decay=0.95)
AGGREGATIONS = ("fedsgd", "fedavg", "fedbuff", "fedopt", "sdga", "fedasync")
FAULT_COUNTS = ("crashed_uploads", "corrupted_uploads", "byzantine_uploads",
                "screened_uploads", "clipped_uploads")
#: the fault mix of the fault settings; fault_seed 19 fires every kind
#: within 5 rounds on phase 6's schedule (crash 1, straggler 4, corrupt 3,
#: byzantine 2: the schedule depends on the seeds, clients and counters
#: only, so it was read off the scheduler on the CPU)
CHAOS = dict(fault_crash_p=0.1, fault_straggler_p=0.1, fault_corrupt_p=0.15,
             fault_byzantine_p=0.05, fault_seed=19)
FAULT_KINDS = {"fault_crash_p": "crash", "fault_straggler_p": "straggler",
               "fault_corrupt_p": "corrupt", "fault_byzantine_p": "byzantine"}
#: phase 6: (name, paper setting, FLConfig overrides, the launches each
#: kernel must make: "uploads" (admitted uploads), "uploads-screened", or
#: a count); every other counter must stay 0.  ``defense="clip"`` gets its
#: norm cap from a first clean round (3x the median upload norm).
MAIN_SETTINGS = (
    ("AS", "AS", {}, {"safl_fold": "uploads"}),
    ("AA", "AA", {}, {"safl_fold": "uploads"}),
    ("SS", "SS", {}, {"safl_aggregate": ROUNDS}),
    ("SA", "SA", {}, {"safl_aggregate": ROUNDS}),
    ("AS-fedbuff", "AS", {"aggregation": "fedbuff"},
     {"safl_fold": "uploads"}),
    ("AS-fedasync", "AS", {"aggregation": "fedasync"},
     {"safl_fold": "uploads"}),
    ("AS-fedopt", "AS", {"aggregation": "fedopt"}, {"safl_fold": "uploads"}),
    ("AS-sdga", "AS", {"aggregation": "sdga"}, {"safl_fold": "uploads"}),
    ("SS-fedbuff", "SS", {"aggregation": "fedbuff"},
     {"safl_aggregate": ROUNDS}),
    ("SS-fedopt", "SS", {"aggregation": "fedopt"},
     {"safl_aggregate": ROUNDS}),
    ("SS-fedasync", "SS", {"aggregation": "fedasync"},
     {"safl_fold": ROUNDS * K_MAIN}),
    ("SS-sdga", "SS", {"aggregation": "sdga"}, {"sdga_aggregate": ROUNDS}),
    ("AS-q8", "AS", {"wire": "q8"}, {"safl_fold_q8": "uploads"}),
    ("AA-q8", "AA", {"wire": "q8"}, {"safl_fold_q8": "uploads"}),
    ("SS-q8", "SS", {"wire": "q8"}, {"safl_aggregate_q8": ROUNDS}),
    ("SA-q8", "SA", {"wire": "q8"}, {"safl_aggregate_q8": ROUNDS}),
    ("SS-sdga-q8", "SS", {"wire": "q8", "aggregation": "sdga"},
     {"sdga_aggregate_q8": ROUNDS}),
    ("AS-chaos-screen", "AS", dict(CHAOS, defense="screen"),
     {"screen_rows": "uploads", "safl_fold": "uploads-screened"}),
    ("AS-chaos-screen-q8", "AS", dict(CHAOS, defense="screen", wire="q8"),
     {"screen_rows_q8": "uploads", "safl_fold_q8": "uploads-screened"}),
    ("AS-byz-clip", "AS", {"aggregation": "fedbuff", "fault_byzantine_p": 0.2,
                           "defense": "clip"},
     {"screen_rows": "uploads", "safl_fold": "uploads"}),
    ("AS-chaos-screen-buffered", "AS",
     dict(CHAOS, defense="screen", server_channel="buffered"),
     {"screen_rows": "uploads", "safl_aggregate": ROUNDS}),
    ("AS-q4", "AS", {"wire": "q4"}, {"safl_fold_q4": "uploads"}),
    ("AA-q4", "AA", {"wire": "q4"}, {"safl_fold_q4": "uploads"}),
    ("SS-q4", "SS", {"wire": "q4"}, {"safl_aggregate_q4": ROUNDS}),
    ("SA-q4", "SA", {"wire": "q4"}, {"safl_aggregate_q4": ROUNDS}),
    ("SS-sdga-q4", "SS", {"wire": "q4", "aggregation": "sdga"},
     {"sdga_aggregate_q4": ROUNDS}),
    ("AS-fedasync-q4", "AS", {"wire": "q4", "aggregation": "fedasync"},
     {"safl_fold_q4": "uploads"}),
    ("AS-chaos-screen-q4", "AS", dict(CHAOS, defense="screen", wire="q4"),
     {"screen_rows_q4": "uploads", "safl_fold_q4": "uploads-screened"}),
    ("AS-topk", "AS", {"wire": "topk"}, {"safl_fold_topk": "uploads"}),
    ("SS-topk", "SS", {"wire": "topk"}, {"safl_aggregate_topk": ROUNDS}),
    ("AS-fedbuff-topk", "AS", {"wire": "topk", "aggregation": "fedbuff"},
     {"safl_fold_topk": "uploads"}),
    ("SS-sdga-topk", "SS", {"wire": "topk", "aggregation": "sdga"},
     {"safl_aggregate_topk": ROUNDS}),
    ("AS-chaos-screen-topk", "AS",
     dict(CHAOS, defense="screen", wire="topk"),
     {"screen_rows_q8": "uploads", "safl_fold_topk": "uploads-screened"}),
)
#: the paper CNN's q4 draw per upload: (n_qblocks, qblock)
DRAW_SHAPE = (-(-D_FULL // QB), QB)
#: kept coordinates of a full-width top-k upload at the default
#: topk_frac 0.1: ceil(0.1 * D) = 215,473 rounded up to whole blocks
NK_FULL = 421 * QB
#: the aggregation modes the top-k wire carries (gradient targets)
TOPK_AGGREGATIONS = ("fedsgd", "fedbuff", "fedopt", "sdga")
#: rows of the int8 pair's checks and timings: the paper CNN's 4,209
#: blocks of 512, and a ragged count (not a multiple of the 8 rows a
#: quantize block takes)
INT8_ROWS = (-(-D_FULL // QB), 37)
#: flash attention's shapes (B, S, H, Hkv, hd): the reference test
#: sweep's (tests/test_kernels.py), the serving path's full-width qwen3
#: prefill, a ragged S (not a multiple of the kernels' 64-row tiles), and
#: two whose H / Hkv is odd (the bf16 kernel's CTA then takes 128 rows of
#: one head): ragged at hd 128, and at S = 130, where a CTA's second
#: 64 rows lie wholly past S
FLASH_SHAPES = ((2, 128, 4, 4, 64), (2, 256, 8, 2, 32), (2, 64, 2, 1, 128),
                (8, 1024, 16, 8, 128), (2, 200, 16, 8, 128),
                (2, 200, 4, 4, 128), (1, 130, 6, 2, 64))
#: the bf16 flash kernel's symbol: the profiler's flash share sums its
#: device time, and its ptxas report must show no spills
FLASH_SYMBOL = "flash_fwd_wgmma_kernel"
#: flash attention against its plain version: the reference tests'
#: tolerances (atol = rtol), f32 rounding in f32 and a bf16 step in bf16
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: the most of the bf16 output lanes at the qwen3 prefill shape that may
#: differ from the plain version's: with p and the PV sums in f32 only a
#: last-bit flip of the final rounding remains; a kernel that rounds p to
#: bf16 before PV flips far more, yet passes FLASH_TOL
FLASH_BF16_DIFF_SHARE = 0.02
#: phase 7: the full-width qwen3-1.7b served from prng_key(0)
SERVE_ARCH = "qwen3-1.7b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 1024, 32
SERVE_PARAMS = 2_038_555_648
#: phase 7 (a): timed passes (a prefill, then SERVE_NEW decode steps each),
#: and the decode steps traced by the profiler
SERVE_PASSES, SERVE_TRACED_STEPS = 3, 4
#: phase 7 (c): the reduced qwen3 (f32 compute) on the card against the
#: CPU, the CPU tests' bound against the reference
SERVE_F32_TOL = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def spills(log: str, symbol: str) -> dict:
    """Bytes of spill stores and loads per instantiation of ``symbol`` in
    a ptxas ``-v`` report."""
    import re
    found = {}
    for entry in log.split("Compiling entry function")[1:]:
        name = entry.split("'")[1]
        if symbol in name:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", entry)
            found[name] = int(m.group(1)) + int(m.group(2))
    return found


def dq_of(d: int) -> int:
    return -(-d // QB) * QB


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def q8_rows(torch, k, d, g):
    """k random rows on the q8 grid: (q int8 (k, Dq), scales (k, Dq/QB)),
    padding lanes zero, quantized by the port's codec math."""
    from repro_torch.kernels import ref
    x = torch.zeros((k, dq_of(d)), device="cuda")
    x[:, :d] = torch.randn((k, d), device="cuda", generator=g)
    q, s = ref.quantize_ref(x.view(-1, QB))
    return q.view(k, -1), s.view(k, -1)


def q4_rows(torch, k, d, g, flip=False):
    """k random rows on the packed int4 grid: (bytes int8 (k, Dq/2),
    scales (k, Dq/QB)), padding lanes zero, quantized by the port's codec
    math with draws made on the card; ``flip`` XORs a 64-byte span of
    every row with 0x55, as a corrupt upload's, which puts -8 nibbles (a
    level the quantizer never emits) into it."""
    from repro_torch import prng
    from repro_torch.kernels import ref
    dq = dq_of(d)
    x = torch.zeros((k, dq), device="cuda")
    x[:, :d] = torch.randn((k, d), device="cuda", generator=g)
    u = prng.uniform_torch(prng.prng_key(k), (k * dq // QB, QB), "cuda")
    q, s = ref.quantize_q4_ref(x.view(-1, QB), u)
    p = ref.pack_q4_ref(q.view(k, dq))
    if flip:
        p[:, 100:164] ^= 0x55
        if not (ref.unpack_q4_ref(p) == -8).any(dim=1).all():
            fail("a flipped q4 span holds no -8 nibble")
    return p, s.view(k, -1)


def compare(torch, report, worst, kernel, got, want, exact, **info):
    """Hold a kernel's output(s) against its plain version's: bitwise when
    ``exact``, else within rtol=1e-5, atol=1e-6."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    rel = max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
              for a, b in zip(got, want))
    ok = all(torch.equal(a, b) if exact else
             torch.allclose(a, b, rtol=1e-5, atol=1e-6)
             for a, b in zip(got, want))
    report.append(dict(kernel=kernel, max_abs_err=err, max_rel_err=rel,
                       bitwise=all(torch.equal(a, b)
                                   for a, b in zip(got, want)), **info))
    desc = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"  {kernel:<18} {desc:<38} max|err|={err:.3e} max rel="
          f"{rel:.3e}  (tolerance: "
          f"{'bitwise' if exact else 'rtol=1e-5, atol=1e-6'})")
    if not ok:
        fail(f"{kernel} {desc} differs from its plain version")
    worst[kernel] = max(worst.get(kernel, 0.0), err)


def agg_weights(torch, k, mode, discount, g):
    if discount == "poly":  # staleness values
        return torch.randint(0, 6, (k,), device="cuda", generator=g).float()
    if mode == "mix":  # fedasync mix coefficients sum below 1
        return torch.rand((k,), device="cuda", generator=g) / k
    return 0.5 + 3.5 * torch.rand((k,), device="cuda", generator=g)


def check_kernels(torch, k_mod, report):
    """Every mode x discount of the aggregates and both fold variants of
    each wire, at the main-path and the ragged shape.  Returns the max
    abs error per kernel."""
    g = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    for d, k in ((D_FULL, K_MAIN), (D_RAGGED, K_RAGGED)):
        u = torch.randn((k, d), device="cuda", generator=g)
        p, m, e = (torch.randn((d,), device="cuda", generator=g)
                   for _ in range(3))
        quant = {"q8": q8_rows(torch, k, d, g),
                 "q4": q4_rows(torch, k, d, g, flip=True)}
        acc_q = torch.randn((dq_of(d),), device="cuda", generator=g)
        lanes_q = dict(dq=dq_of(d))
        for beta in (1.0, 0.625):
            compare(torch, report, worst, "safl_fold",
                    k_mod.safl_fold(p, u[0], 0.37, beta),
                    k_mod.safl_fold_plain(p, u[0], 0.37, beta), True,
                    d=d, beta=beta)
            for wire, (q, s) in quant.items():
                fold = k_mod.KERNELS["safl_fold_" + wire]
                plain = getattr(k_mod, f"safl_fold_{wire}_plain")
                compare(torch, report, worst, fold.__name__,
                        fold(acc_q, q[0], s[0], 0.37, beta),
                        plain(acc_q, q[0], s[0], 0.37, beta), True,
                        beta=beta, **lanes_q)
        # in place into a bank row, as the engine folds: beta = 1 for
        # every mode's upload, a live beta for fedasync's
        for beta in (1.0, 0.75):
            row = p.clone()
            k_mod.safl_fold(row, u[1], 0.5, beta, out=row)
            compare(torch, report, worst, "safl_fold", row,
                    k_mod.safl_fold_plain(p, u[1], 0.5, beta), True, d=d,
                    beta=beta, in_place=True)
            for wire, (q, s) in quant.items():
                fold = k_mod.KERNELS["safl_fold_" + wire]
                plain = getattr(k_mod, f"safl_fold_{wire}_plain")
                row = acc_q.clone()
                fold(row, q[1], s[1], 0.5, beta, out=row)
                compare(torch, report, worst, fold.__name__, row,
                        plain(acc_q, q[1], s[1], 0.5, beta), True,
                        beta=beta, in_place=True, **lanes_q)
        # in place into an odd bank row: d lanes into a (2, d) buffer, so
        # 8-byte (d even) or 4-byte (d odd) aligned, folding an aligned
        # upload and another buffer's row at the same offset
        bank = torch.randn((2, d), device="cuda", generator=g)
        other = torch.randn((2, d), device="cuda", generator=g)
        for beta in (1.0, 0.75):
            for vec, vec_at in ((u[2], "aligned"), (other[1], "odd row")):
                row = bank.clone()[1]
                k_mod.safl_fold(row, vec, 0.5, beta, out=row)
                compare(torch, report, worst, "safl_fold", row,
                        k_mod.safl_fold_plain(bank[1], vec, 0.5, beta), True,
                        d=d, beta=beta, odd_row=True, vec=vec_at)
        for discount in k_mod.DISCOUNTS:
            exact = discount == "none"
            for mode in k_mod.MODES:
                w = agg_weights(torch, k, mode, discount, g)
                kw = dict(server_lr=0.05, mode=mode, alpha=0.5,
                          discount=discount)
                compare(torch, report, worst, "safl_aggregate",
                        k_mod.safl_aggregate(u, w, p, **kw),
                        k_mod.safl_aggregate_plain(u, w, p, **kw), exact,
                        d=d, k=k, mode=mode, discount=discount)
                for wire, (q, s) in quant.items():
                    name = "safl_aggregate_" + wire
                    compare(torch, report, worst, name,
                            k_mod.KERNELS[name](q, s, w, p, **kw),
                            getattr(k_mod, name + "_plain")(q, s, w, p,
                                                            **kw),
                            exact, k=k, mode=mode, discount=discount,
                            **lanes_q)
            w = agg_weights(torch, k, "avg", discount, g)
            kw = dict(SDGA_KW, alpha=0.5, discount=discount)
            compare(torch, report, worst, "sdga_aggregate",
                    k_mod.sdga_aggregate(u, w, p, m, e, **kw),
                    k_mod.sdga_aggregate_plain(u, w, p, m, e, **kw), exact,
                    d=d, k=k, discount=discount)
            for wire, (q, s) in quant.items():
                name = "sdga_aggregate_" + wire
                compare(torch, report, worst, name,
                        k_mod.KERNELS[name](q, s, w, p, m, e, **kw),
                        getattr(k_mod, name + "_plain")(q, s, w, p, m, e,
                                                        **kw),
                        exact, k=k, discount=discount, **lanes_q)
    torch.cuda.synchronize()
    return worst


def check_draws(torch, report):
    """The q4 wire's draws made on the card against the numpy threefry
    (itself equal to ``jax.random.uniform`` in the CPU tests), bitwise,
    at the paper CNN's draw shape, for a few (seed, client, counter)
    keys."""
    import numpy as np

    from repro_torch import prng
    for seed, cid, ctr in ((0, 0, 0), (7, 5, 3), (2 ** 31 - 1, 15, 250)):
        key = prng.fold_in(prng.fold_in(prng.prng_key(seed), cid), ctr)
        got = prng.uniform_torch(key, DRAW_SHAPE, "cuda").cpu().numpy()
        want = prng.uniform(key, DRAW_SHAPE)
        same = bool(np.array_equal(got.view(np.uint32),
                                    want.view(np.uint32)))
        print(f"  q4 draws {DRAW_SHAPE} key ({seed}, {cid}, {ctr}): card "
              f"vs numpy {'bitwise equal' if same else 'DIFFER'}")
        report.append(dict(kernel="uniform_torch", key=[seed, cid, ctr],
                           shape=list(DRAW_SHAPE), bitwise=same))
        if not same:
            fail(f"q4 draws on the card differ from numpy for key "
                 f"({seed}, {cid}, {ctr})")


def topk_rows(torch, k, d, nk, g, empty=()):
    """k sparse rows by the port's codec math: the top-|x| nk lanes of
    random padded (Dq,) rows, ranked by a stable descending sort, their
    values int8-quantized in compacted blocks.  Coordinate 5 is the
    largest lane of every row and coordinate 6 of all rows but the last,
    so rows collide there (4 and 3 of them at K = 4); nk near Dq ranks pad
    lanes >= d.  Rows in ``empty`` are the buffer's empty rows (idx = d,
    values and scales 0).  Returns (idx int32, qv int8, scales)."""
    from repro_torch.kernels import ref
    x = torch.zeros((k, dq_of(d)), device="cuda")
    x[:, :d] = torch.randn((k, d), device="cuda", generator=g)
    x[:, 5] = 50.0 + torch.arange(k, device="cuda")
    x[:-1, 6] = -40.0
    idx = torch.sort(x.abs(), dim=1, descending=True,
                     stable=True).indices[:, :nk]
    q, s = ref.quantize_ref(torch.gather(x, 1, idx).view(-1, QB))
    idx, q, s = idx.to(torch.int32), q.view(k, nk), s.view(k, -1)
    for r in empty:
        idx[r], q[r], s[r] = d, 0, 0.0
    return idx, q, s


def collisions(torch, idx, d):
    """Most rows that hit one coordinate, and how many coordinates are hit
    by exactly 3 rows."""
    valid = idx[(idx >= 0) & (idx < d)].long()
    hits = torch.bincount(valid, minlength=d)
    return int(hits.max()), int((hits == 3).sum())


def check_topk(torch, k_mod, report, worst):
    """The two top-k kernels against their plain versions at the main
    path's shape (K = 4, nk = 215,552), at K = 17 there (more rows than
    the K-row sum loads ahead) and at the ragged D = 4099 with K = 3, nk
    = Dq = 4608 (pad lanes ranked) and an empty row: the fold at beta 1
    and 0.7, in place and not, the K-row sum, and the chain of in-place
    folds from zeros against the K-row sum, all bitwise; then both
    kernels on copies of the rows one lane off their boundaries (idx and
    qv: the K-row sum's scalar head and tail around its vectors; idx
    alone: every lane alone), bitwise the aligned calls."""
    g = torch.Generator(device="cuda").manual_seed(5)
    for d, k, nk, empty in ((D_FULL, K_MAIN, NK_FULL, ()),
                            (D_FULL, 17, NK_FULL, ()),
                            (D_RAGGED, K_RAGGED, dq_of(D_RAGGED), (1,))):
        idx, q, s = topk_rows(torch, k, d, nk, g, empty)
        most, threes = collisions(torch, idx, d)
        if most != k - len(empty) or (most >= 4 and not threes):
            fail(f"top-k rows d={d}: most hits {most}, {threes} coordinates "
                 "hit by 3 rows")
        pads = int((idx >= d).sum())
        lanes = dict(d=d, k=k, nk=nk)
        print(f"  top-k rows d={d} k={k} nk={nk}: a coordinate hit by "
              f"{most} rows, {threes} by 3; {pads} lanes >= d dropped")
        report.append(dict(kernel="topk_rows", most_hits=most,
                           coords_hit_by_3=threes, lanes_dropped=pads,
                           **lanes))
        acc = torch.randn((d,), device="cuda", generator=g)
        for beta in (1.0, 0.7):
            compare(torch, report, worst, "safl_fold_topk",
                    k_mod.safl_fold_topk(acc, idx[0], q[0], s[0], 0.37, beta),
                    k_mod.safl_fold_topk_plain(acc, idx[0], q[0], s[0], 0.37,
                                               beta), True, beta=beta,
                    **lanes)
            row = acc.clone()
            k_mod.safl_fold_topk(row, idx[-1], q[-1], s[-1], 0.5, beta,
                                 out=row)
            compare(torch, report, worst, "safl_fold_topk", row,
                    k_mod.safl_fold_topk_plain(acc, idx[-1], q[-1], s[-1],
                                               0.5, beta), True, beta=beta,
                    in_place=True, **lanes)
        w = 0.5 + 3.5 * torch.rand((k,), device="cuda", generator=g)
        agg = k_mod.safl_aggregate_topk(idx, q, s, w, d)
        compare(torch, report, worst, "safl_aggregate_topk", agg,
                k_mod.safl_aggregate_topk_plain(idx, q, s, w, d), True,
                **lanes)
        chain = torch.zeros((d,), device="cuda")
        for r, wr in enumerate(w.tolist()):
            k_mod.safl_fold_topk(chain, idx[r], q[r], s[r], wr, out=chain)
        compare(torch, report, worst, "safl_aggregate_topk", agg, chain, True,
                vs="fold_chain", **lanes)
        aligned = acc.clone()
        k_mod.safl_fold_topk(aligned, idx[0], q[0], s[0], 0.37, out=aligned)
        for rows, (mi, mq) in (
                ("idx and qv one lane off", (misaligned(torch, idx),
                                             misaligned(torch, q))),
                ("idx one lane off", (misaligned(torch, idx), q))):
            row = acc.clone()
            k_mod.safl_fold_topk(row, mi[0], mq[0], s[0], 0.37, out=row)
            compare(torch, report, worst, "safl_fold_topk", row, aligned,
                    True, rows=rows, vs="aligned", **lanes)
            compare(torch, report, worst, "safl_aggregate_topk",
                    k_mod.safl_aggregate_topk(mi, mq, s, w, d), agg, True,
                    rows=rows, vs="aligned", **lanes)
    torch.cuda.synchronize()


def check_fold_q(torch, k_mod, report, worst, wire):
    """``safl_fold_q4`` / ``safl_fold_q8`` (``wire``) at the main path's
    and the ragged Dq, at beta 1 in place and at beta 0.625 out of place
    (out at acc's offset where the quantized row's is even, 1 lane past it
    where odd: there out and acc disagree mod 16 bytes and every lane goes
    alone), with acc 0-3 lanes and the quantized row 0-15 bytes off their
    buffers' start (64 placements: the vector path from a head of 0-3
    lanes, vectors straddling a qblock, and every lane alone where the
    rows disagree), the q4 row holding -8 nibbles and the q8 row -128
    bytes (levels the quantizers never emit; a corrupt upload's can):
    bitwise its plain version in every placement."""
    name = "safl_fold_" + wire
    fold = k_mod.KERNELS[name]
    plain = getattr(k_mod, name + "_plain")
    g = torch.Generator(device="cuda").manual_seed(7 if wire == "q4" else 8)
    for d in (D_FULL, D_RAGGED):
        dq = dq_of(d)
        if wire == "q4":
            qr, sr = q4_rows(torch, 1, d, g, flip=True)
        else:
            qr, sr = q8_rows(torch, 1, d, g)
            qr[:, 100:164:3] = -128
        acc = torch.randn((dq,), device="cuda", generator=g)
        for beta, in_place in ((1.0, True), (0.625, False)):
            want = plain(acc, qr[0], sr[0], 0.37, beta)
            bad, err = [], 0.0
            for a_off in range(4):
                for q_off in range(16):
                    row = misaligned(torch, acc, a_off)
                    qp = misaligned(torch, qr[0], q_off)
                    if in_place:
                        fold(row, qp, sr[0], 0.37, beta, out=row)
                        got = row
                    else:
                        got = misaligned(torch, torch.zeros_like(acc),
                                         (a_off + q_off % 2) % 4)
                        fold(row, qp, sr[0], 0.37, beta, out=got)
                        if not torch.equal(row, acc):
                            bad.append((a_off, q_off, "acc written"))
                    err = max(err, float((got - want).abs().max()))
                    if not torch.equal(got, want):
                        bad.append((a_off, q_off))
            info = dict(dq=dq, beta=beta, in_place=in_place, placements=64)
            report.append(dict(kernel=name, max_abs_err=err,
                               bitwise=not bad, differing=bad, **info))
            print(f"  {name:<18} dq={dq} beta={beta} in_place={in_place}: "
                  f"acc 0-3 lanes x {wire} row 0-15 bytes off, "
                  f"{64 - len(bad)}/64 placements bitwise (tolerance: "
                  "bitwise)")
            if bad:
                fail(f"{name} dq={dq} beta={beta}: placements {bad} differ "
                     "from the plain version")
            worst[name] = max(worst.get(name, 0.0), err)
    torch.cuda.synchronize()


def parent_aggregate_q4(torch, k_mod, lib):
    """The q4 aggregate's parent kernel (``csrc/aggregate_variants.cu``'s
    ``safl_aggregate_q4_gridstride``, ``aggregate_kernel<Q4Rows>``) as a
    function of the wrapper's arguments."""
    fn = lib.safl_aggregate_q4_gridstride
    fn.argtypes = k_mod._lib().safl_aggregate_q4.argtypes
    fn.restype = ctypes.c_int

    def call(q, s, w, p, *, server_lr, mode, alpha, discount):
        dq = 2 * q.shape[1]
        n = p.shape[0] if mode in ("fedsgd", "mix") else dq
        out = torch.empty(n, device="cuda")
        rc = fn(q.data_ptr(), s.data_ptr(), w.data_ptr(),
                None if p is None else p.data_ptr(), out.data_ptr(),
                q.shape[0], dq, n, server_lr, alpha, k_mod.MODES[mode],
                int(discount == "poly"), QB.bit_length() - 1,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            fail(f"safl_aggregate_q4_gridstride: launch returned {rc}")
        return out
    return call


def check_aggregate_q4(torch, k_mod, report, worst, variants):
    """``safl_aggregate_q4`` in every mode x discount at K = 1, 4 and 16,
    at the main path's D (Dq = 2,155,008; fedsgd / mix over D lanes, so
    a tail past the last whole vector) and the ragged D, on the rows and p
    as allocated (the vector path, as in the engine) and on copies one
    byte (rows) and one lane (p) off (lane by lane), the rows holding -8
    nibbles: bitwise its plain version with discount none; with poly
    weights (``powf``, within 1.9e-6 of ``torch.pow``: ``check_kernels``
    holds that) bitwise the parent's kernel (``variants``:
    ``csrc/aggregate_variants.cu``)."""
    parent = parent_aggregate_q4(torch, k_mod, variants)
    g = torch.Generator(device="cuda").manual_seed(9)
    for d in (D_FULL, D_RAGGED):
        dq = dq_of(d)
        p = torch.randn((d,), device="cuda", generator=g)
        q16, s16 = q4_rows(torch, 16, d, g, flip=True)
        for k in (1, 4, 16):
            q, s = q16[:k], s16[:k]
            for rows, (qq, pp) in (("aligned", (q, p)),
                                   ("rows 1 byte, p 1 lane off",
                                    (misaligned(torch, q),
                                     misaligned(torch, p)))):
                for discount in k_mod.DISCOUNTS:
                    for mode in k_mod.MODES:
                        w = agg_weights(torch, k, mode, discount, g)
                        kw = dict(server_lr=0.05, mode=mode, alpha=0.5,
                                  discount=discount)
                        got = k_mod.safl_aggregate_q4(qq, s, w, pp, **kw)
                        info = dict(dq=dq, k=k, mode=mode,
                                    discount=discount, rows=rows)
                        if discount == "poly":
                            want = parent(qq, s, w, pp, **kw)
                            info["vs"] = "parent kernel"
                        else:
                            want = k_mod.safl_aggregate_q4_plain(q, s, w, p,
                                                                 **kw)
                        compare(torch, report, worst, "safl_aggregate_q4",
                                got, want, True, **info)
    torch.cuda.synchronize()


def check_int8(torch, q_mod, report, worst):
    """The int8 pair against its plain versions at (4209, 512) and at a
    ragged 37 rows, with an all-zero row (scale 1e-12), a row of exact .5
    ties and a NaN row (NaN scale: the absmax propagates it; its lanes
    store 0): int8 rows bitwise, scales bitwise with NaN in the same
    rows, dequantized rows bitwise."""
    import math

    import numpy as np

    from repro_torch.kernels.ref import INV_127
    # row 1's absmax 127 gives it the scale fl(127 * f32(1/127)); lanes of
    # +-scale/2 then divide to exactly +-0.5 and round half to even, to 0
    s_tie = float(np.float32(127.0) * np.float32(INV_127))
    g = torch.Generator(device="cuda").manual_seed(6)
    for rows in INT8_ROWS:
        x = torch.randn((rows, QB), device="cuda", generator=g)
        x[0] = 0.0
        x[1, 0] = 127.0
        x[1, 1::2] = 0.5 * s_tie
        x[1, 2::2] = -0.5 * s_tie
        x[2, 7] = math.nan
        q, s = q_mod.quantize_int8(x)
        pq, ps = q_mod.quantize_int8_plain(x)
        nan_same = torch.equal(torch.isnan(s), torch.isnan(ps))
        fin = ~torch.isnan(ps)
        compare(torch, report, worst, "quantize_int8", (q.float(), s[fin]),
                (pq.float(), ps[fin]), True, rows=rows,
                nan_rows_equal=nan_same)
        if not (nan_same and bool(torch.isnan(s[2]))
                and float(s[0]) == float(np.float32(1e-12))
                and float(s[1]) == s_tie and not q[1, 1:].any()):
            fail(f"quantize_int8 rows={rows}: zero row scale {float(s[0])}, "
                 f"tie row {q[1, :4].tolist()} scale {float(s[1])}, NaN row "
                 f"scale {float(s[2])}")
        s = torch.where(fin, s, 1.0)
        compare(torch, report, worst, "dequantize_int8",
                q_mod.dequantize_int8(q, s),
                q_mod.dequantize_int8_plain(q, s), True, rows=rows)
    torch.cuda.synchronize()


def flash_inputs(torch, shape, dtype, g):
    b, s, h, hkv, hd = shape
    return tuple(torch.randn((b, s, n, hd), device="cuda",
                             generator=g).to(dtype) for n in (h, hkv, hkv))


def flash_plain_bf16_p(torch, q, k, v):
    """The plain causal attention with p rounded to bf16 before the PV
    product: what a kernel that keeps p in bf16 computes."""
    import numpy as np
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    k = torch.repeat_interleave(k, rep, dim=2).float()
    v = torch.repeat_interleave(v, rep, dim=2).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / float(
        np.sqrt(hd))
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    p = p.to(torch.bfloat16).float()
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def check_flash(torch, fa_mod, report, worst):
    """Flash attention against its plain version on every shape of
    :data:`FLASH_SHAPES`, f32 and bf16, causal and not, within
    :data:`FLASH_TOL`; at the qwen3 prefill shape in bf16, at most
    :data:`FLASH_BF16_DIFF_SHARE` of the output lanes differ from the
    plain version's, a share that the plain version with p rounded to
    bf16 must exceed; and causality: on S = 128, outputs before
    position 100 unchanged when the keys and values after it change."""
    g = torch.Generator(device="cuda").manual_seed(9)
    by_dtype = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol = FLASH_TOL[name]
        for causal in (True, False):
            for shape in FLASH_SHAPES:
                q, k, v = flash_inputs(torch, shape, dtype, g)
                got = fa_mod.flash_attention(q, k, v, causal=causal)
                want = fa_mod.flash_attention_plain(q, k, v, causal=causal)
                got, want = got.float(), want.float()
                err = float((got - want).abs().max())
                ok = (got.dtype == want.dtype and torch.allclose(
                    got, want, atol=tol, rtol=tol))
                info = dict(shape=list(shape), dtype=name, causal=causal)
                report.append(dict(kernel="flash_attention",
                                   max_abs_err=err, tolerance=tol, **info))
                print(f"  flash_attention (B,S,H,Hkv,hd)={shape} {name} "
                      f"causal={causal}: max|err|={err:.3e}  (tolerance: "
                      f"atol=rtol={tol})")
                if not ok:
                    fail(f"flash_attention {info} differs from its plain "
                         "version")
                worst["flash_attention"] = max(
                    worst.get("flash_attention", 0.0), err)
                by_dtype[name] = max(by_dtype.get(name, 0.0), err)
    q, k, v = flash_inputs(torch, FLASH_SHAPES[3], torch.bfloat16, g)
    want = fa_mod.flash_attention_plain(q, k, v)
    share_kernel = float((fa_mod.flash_attention(q, k, v) != want).float()
                         .mean())
    share_bf16_p = float((flash_plain_bf16_p(torch, q, k, v) != want)
                         .float().mean())
    del q, k, v, want
    print(f"  flash_attention bf16 {FLASH_SHAPES[3]} causal: output lanes "
          f"that differ from the plain version: kernel {share_kernel:.4%}, "
          f"plain with p in bf16 {share_bf16_p:.4%} (tolerance: the "
          f"kernel at most {FLASH_BF16_DIFF_SHARE:.0%}, p in bf16 above)")
    report.append(dict(kernel="flash_attention", shape=list(FLASH_SHAPES[3]),
                       dtype="bfloat16", differing_lanes=share_kernel,
                       differing_lanes_bf16_p=share_bf16_p,
                       tolerance=FLASH_BF16_DIFF_SHARE))
    if share_kernel > FLASH_BF16_DIFF_SHARE:
        fail("flash_attention's bf16 output differs from the plain "
             "version's in more lanes than f32 p and PV allow")
    if share_bf16_p <= FLASH_BF16_DIFF_SHARE:
        fail("the differing-lanes check cannot tell p in bf16 from f32")
    q, k, v = flash_inputs(torch, (1, 128, 2, 2, 32), torch.float32, g)
    out1 = fa_mod.flash_attention(q, k, v)
    k[:, 100:], v[:, 100:] = 99.0, -99.0
    out2 = fa_mod.flash_attention(q, k, v)
    causal_ok = torch.equal(out1[:, :100], out2[:, :100])
    print(f"  flash_attention causality (S=128, keys after 100 changed): "
          f"outputs before 100 {'bitwise equal' if causal_ok else 'DIFFER'}"
          f"; worst error {by_dtype}")
    report.append(dict(kernel="flash_attention", causality_bitwise=causal_ok,
                       worst_by_dtype=by_dtype))
    if not causal_ok:
        fail("flash_attention reads keys past the causal triangle")
    torch.cuda.synchronize()


def poisoned(payload, kind, loc=0.37):
    """One upload's payload ((vec,) f32, (q_row, s_row) q8 / q4 or
    (idx_row, qv_row, s_row) top-k) with a corrupt or Byzantine fault
    applied as the engine applies it (a K = 1 stack through the port's
    appliers; top-k indices untouched); ``kind`` None leaves it clean."""
    from repro_torch import faults
    if kind is None:
        return payload
    rows = tuple(a[None] for a in payload)
    c, b = [kind == "corrupt"], [kind == "byzantine"]
    if len(rows) == 3:
        rows = rows[:1] + faults.apply_faults_q(*rows[1:], c, b, [loc], 10.0)
    elif len(rows) == 2:
        rows = faults.apply_faults_q(*rows, c, b, [loc], 10.0)
    else:
        rows = (faults.apply_faults_flat(rows[0], c, b, [loc], 10.0),)
    return tuple(a[0] for a in rows)


def compare_sums(torch, report, worst, kernel, got, want, **info):
    """A screen against its plain version: isfinite verdicts exact, finite
    sums within rtol=1e-5."""
    fin = torch.isfinite(want)
    verdicts = torch.equal(torch.isfinite(got), fin)
    g, w = got[fin], want[fin]
    err = float((g - w).abs().max()) if g.numel() else 0.0
    rel = (float(((g - w).abs() / w.abs().clamp_min(1e-30)).max())
           if g.numel() else 0.0)
    ok = verdicts and (not g.numel()
                       or torch.allclose(g, w, rtol=1e-5, atol=0.0))
    report.append(dict(kernel=kernel, max_abs_err=err, max_rel_err=rel,
                       verdicts_equal=verdicts,
                       finite=fin.tolist(), **info))
    desc = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"  {kernel:<18} {desc:<38} verdicts "
          f"{'equal' if verdicts else 'DIFFER'} {fin.tolist()} "
          f"max|err|={err:.3e} max rel={rel:.3e}  (tolerance: rtol=1e-5)")
    if not ok:
        fail(f"{kernel} {desc} differs from its plain version")
    worst[kernel] = max(worst.get(kernel, 0.0), err)


def misaligned(torch, t, elements=1):
    """A contiguous copy of ``t`` that starts ``elements`` (< 16) elements
    past the (512-byte aligned) start of its buffer: by one, int8 rows 1
    byte off (the quantized screens then take their byte path), f32 rows
    and int32 top-k coordinates one lane (4 bytes) off."""
    view = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)[
        elements:elements + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def check_screens(torch, k_mod, report, worst):
    """The three screens at the main path's and the ragged shape, and
    ``screen_rows_q8`` over the top-k upload's values (nk = 215,552), on a
    stack of rows (clean, corrupted, Byzantine, all zero; q4 adds a row
    whose 0x55-flipped span holds -8 nibbles under finite scales), its
    first three rows, and each row alone: against the plain versions, and
    each row's sum bitwise the same alone as in the stack and in three
    launches back to back (the per-row counters are back at zero after
    each).  Each screen also runs once on a copy of the stack 1 element
    off a 16-byte boundary (the f32 screen's lane-by-lane path, the
    quantized screens' byte path): against the plain version, and
    bitwise the aligned calls' sums (the f32 stack at the main D, D mod
    4 = 2, takes the lane-by-lane path, its rows alone the float4 path on
    even rows and the lane-by-lane path on odd ones)."""
    from repro_torch.kernels.ref import unpack_q4_ref as unpack_q4
    g = torch.Generator(device="cuda").manual_seed(3)
    kinds = (None, "corrupt", "byzantine", None)
    cases = []
    for d in (D_FULL, D_RAGGED):
        u = torch.randn((4, d), device="cuda", generator=g)
        q, s = q8_rows(torch, 4, d, g)
        p4, s4 = q4_rows(torch, 5, d, g)
        for i, kind in enumerate(kinds):
            u[i], = poisoned((u[i],), kind)
            q[i], s[i] = poisoned((q[i], s[i]), kind)
            p4[i], s4[i] = poisoned((p4[i], s4[i]), kind)
        u[3].zero_()
        q[3].zero_()
        p4[3].zero_()
        p4[4, 100:164] ^= 0x55
        if not (unpack_q4(p4[4]) == -8).any():
            fail("the flipped q4 row holds no -8 nibble")
        cases += [("screen_rows", (u,), dict(d=d)),
                  ("screen_rows_q8", (q, s), dict(dq=dq_of(d))),
                  ("screen_rows_q4", (p4, s4), dict(dq=dq_of(d)))]
    idx, qv, sv = topk_rows(torch, 4, D_FULL, NK_FULL, g)
    for i, kind in enumerate(kinds):
        idx[i], qv[i], sv[i] = poisoned((idx[i], qv[i], sv[i]), kind)
    qv[3].zero_()
    cases.append(("screen_rows_q8", (qv, sv), dict(nk=NK_FULL)))
    for name, args, lanes in cases:
        fn = k_mod.KERNELS[name]
        plain = getattr(k_mod, name + "_plain")
        kw = {} if name == "screen_rows" else {"qblock": QB}
        launches = [fn(*args, **kw) for _ in range(3)]
        full = launches[0]
        n = args[0].shape[0]
        for k in (n, 3):
            rows = tuple(a[:k] for a in args)
            compare_sums(torch, report, worst, name, fn(*rows, **kw),
                         plain(*rows, **kw), k=k, **lanes)
        alone = torch.cat([fn(*(a[i:i + 1] for a in args), **kw)
                           for i in range(n)])
        compare_sums(torch, report, worst, name, alone,
                     plain(*args, **kw), k=1, **lanes)
        same = all(torch.equal(x.view(torch.int32), full.view(torch.int32))
                   for x in (alone, *launches[1:]))
        print(f"  {name:<18} {lanes}: K=1 rows vs K={n} stack and three "
              f"launches: {'bitwise equal' if same else 'DIFFER'}")
        report.append(dict(kernel=name, row_independent_bitwise=same,
                           **lanes))
        if not same:
            fail(f"{name} {lanes}: a row's sum depends on the stack or "
                 "the launch")
        off = (misaligned(torch, args[0]), *args[1:])
        if off[0].data_ptr() % 16 == 0:
            fail("the misaligned copy is 16-byte aligned")
        path = "lanes" if name == "screen_rows" else "bytes"
        one_by_one = fn(*off, **kw)
        compare_sums(torch, report, worst, name, one_by_one,
                     plain(*args, **kw), k=n, path=path, **lanes)
        same = torch.equal(one_by_one.view(torch.int32),
                           full.view(torch.int32))
        print(f"  {name:<18} {lanes}: {path} path (rows 1 element off 16 "
              f"bytes) vs the aligned calls: "
              f"{'bitwise equal' if same else 'DIFFER'}")
        report.append(dict(kernel=name, one_by_one_path_bitwise=same,
                           path=path, **lanes))
        if not same:
            fail(f"{name} {lanes}: the {path} path's sums differ from the "
                 "aligned calls'")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 4: timings
# ---------------------------------------------------------------------------


def time_ms(torch, fn, flush, n=TIMED_LAUNCHES, hold=False):
    """Median over ``n`` launches of the CUDA-event time of one call, with
    the L2 cache flushed before each by reading a 256 MB buffer (a read,
    so the evicted lines are clean and cost the timed call no
    write-backs).  ``hold`` then keeps the device spinning for
    :data:`HOLD_CYCLES`, so that the host has queued the call and the end
    event before the device reaches the start event: the time is then the
    device's alone, whatever the host's speed (without it a Python
    wrapper slower than the flush adds its own time)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
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


def time_kernels(torch, k_mod, q_mod, fa_mod):
    g = torch.Generator(device="cuda").manual_seed(1)
    d, k = D_FULL, K_MAIN
    dq = dq_of(d)
    nb = dq // QB
    flush = torch.zeros(64 * 2 ** 20, device="cuda")  # 256 MB of f32
    u = torch.randn((k, d), device="cuda", generator=g)
    p, m, e = (torch.randn((d,), device="cuda", generator=g)
               for _ in range(3))
    acc = torch.randn((d,), device="cuda", generator=g)
    q, s = q8_rows(torch, k, d, g)
    acc_q = torch.randn((dq,), device="cuda", generator=g)
    w_host = 0.37
    ones = torch.ones((k,), device="cuda")
    sizes = torch.tensor([113.0, 58.0, 241.0, 77.0], device="cuda")
    disc = torch.tensor([1.0, 0.70710677, 0.57735026, 0.5], device="cuda")
    lr = 0.05

    def t(fn):
        return time_ms(torch, fn, flush, hold=True)

    # the timer's floor: a one-element kernel under the same timing
    one = torch.zeros(1, device="cuda")
    floor_ms = t(lambda: one.add_(1.0))
    print(f"  timer floor (one-element add_, L2 flushed before it): "
          f"{floor_ms:.5f} ms")
    out = {}
    out["safl_fold"] = dict(
        ms=t(lambda: k_mod.safl_fold(acc, u[0], w_host, out=acc)),
        plain_ms=t(lambda: k_mod.safl_fold_plain(acc, u[0], w_host)),
        library_ms=t(lambda: torch.add(acc, u[0], alpha=w_host)),
        bytes=3 * d * 4, ops=2 * d, shape=f"D={d}")
    # in place into an odd bank row (8 bytes off a 16-byte boundary)
    odd = torch.randn((2, d), device="cuda", generator=g)[1]
    out["safl_fold_odd_row"] = dict(
        ms=t(lambda: k_mod.safl_fold(odd, u[0], w_host, out=odd)),
        plain_ms=t(lambda: k_mod.safl_fold_plain(odd, u[0], w_host)),
        library_ms=t(lambda: torch.add(odd, u[0], alpha=w_host)),
        bytes=3 * d * 4, ops=2 * d, shape=f"D={d} odd bank row")
    # fedsgd (SS) is the aggregate's main-path record; avg (SA) rides along
    coef = -lr / float(ones.sum())
    out["safl_aggregate"] = dict(
        ms=t(lambda: k_mod.safl_aggregate(u, ones, p, server_lr=lr,
                                          mode="fedsgd")),
        plain_ms=t(lambda: k_mod.safl_aggregate_plain(
            u, ones, p, server_lr=lr, mode="fedsgd")),
        library_ms=t(lambda: torch.addmv(p, u.t(), ones, alpha=coef)),
        bytes=(k + 2) * d * 4, ops=2 * k * d + 3 * d,
        shape=f"K={k} D={d} mode=fedsgd")
    wn = sizes / sizes.sum()
    out["safl_aggregate_avg"] = dict(
        ms=t(lambda: k_mod.safl_aggregate(u, sizes, mode="avg")),
        plain_ms=t(lambda: k_mod.safl_aggregate_plain(u, sizes,
                                                      mode="avg")),
        library_ms=t(lambda: wn @ u), bytes=(k + 1) * d * 4,
        ops=2 * k * d + d, shape=f"K={k} D={d} mode=avg")
    # no single PyTorch call computes the four kernels below
    kw = dict(SDGA_KW, discount="none")
    out["sdga_aggregate"] = dict(
        ms=t(lambda: k_mod.sdga_aggregate(u, disc, p, m, e, **kw)),
        plain_ms=t(lambda: k_mod.sdga_aggregate_plain(u, disc, p, m, e,
                                                      **kw)),
        library_ms=None, bytes=(k + 6) * d * 4, ops=2 * k * d + 10 * d,
        shape=f"K={k} D={d}")
    out["safl_fold_q8"] = dict(
        ms=t(lambda: k_mod.safl_fold_q8(acc_q, q[0], s[0], w_host,
                                        out=acc_q)),
        plain_ms=t(lambda: k_mod.safl_fold_q8_plain(acc_q, q[0], s[0],
                                                    w_host)),
        library_ms=None, bytes=9 * dq + nb * 4, ops=3 * dq,
        shape=f"Dq={dq}")
    out["safl_aggregate_q8"] = dict(
        ms=t(lambda: k_mod.safl_aggregate_q8(q, s, ones, p, server_lr=lr,
                                             mode="fedsgd")),
        plain_ms=t(lambda: k_mod.safl_aggregate_q8_plain(
            q, s, ones, p, server_lr=lr, mode="fedsgd")),
        library_ms=None, bytes=k * dq + k * nb * 4 + 2 * d * 4,
        ops=3 * k * d + 3 * d, shape=f"K={k} Dq={dq} mode=fedsgd")
    out["safl_aggregate_q8_avg"] = dict(
        ms=t(lambda: k_mod.safl_aggregate_q8(q, s, sizes, mode="avg")),
        plain_ms=t(lambda: k_mod.safl_aggregate_q8_plain(q, s, sizes,
                                                         mode="avg")),
        library_ms=None, bytes=k * dq + k * nb * 4 + dq * 4,
        ops=3 * k * dq + dq, shape=f"K={k} Dq={dq} mode=avg")
    out["sdga_aggregate_q8"] = dict(
        ms=t(lambda: k_mod.sdga_aggregate_q8(q, s, disc, p, m, e, **kw)),
        plain_ms=t(lambda: k_mod.sdga_aggregate_q8_plain(q, s, disc, p, m,
                                                         e, **kw)),
        library_ms=None, bytes=k * dq + k * nb * 4 + 6 * d * 4,
        ops=3 * k * d + 10 * d, shape=f"K={k} Dq={dq}")
    # the screens at K = 1 (one upload, the path's shape) and K = 4; the
    # q8 screen's library column is "none": no PyTorch call fuses the
    # dequantize into the reduction
    for kk, sfx in ((1, ""), (k, "_k4")):
        rows = u[:kk]
        out["screen_rows" + sfx] = dict(
            ms=t(lambda: k_mod.screen_rows(rows)),
            plain_ms=t(lambda: k_mod.screen_rows_plain(rows)),
            library_ms=t(lambda: torch.linalg.vecdot(rows, rows, dim=1)),
            bytes=kk * d * 4 + kk * 4, ops=2 * kk * d,
            shape=f"K={kk} D={d}")
        qr, sr = q[:kk], s[:kk]
        out["screen_rows_q8" + sfx] = dict(
            ms=t(lambda: k_mod.screen_rows_q8(qr, sr, qblock=QB)),
            plain_ms=t(lambda: k_mod.screen_rows_q8_plain(qr, sr,
                                                          qblock=QB)),
            library_ms=None, bytes=kk * dq + kk * nb * 4 + kk * 4,
            ops=2 * kk * dq + 3 * kk * nb, shape=f"K={kk} Dq={dq}")
    # the q4 wire, packed int4 rows (none of these has a library call)
    p4, s4 = q4_rows(torch, k, d, g)
    out["safl_fold_q4"] = dict(
        ms=t(lambda: k_mod.safl_fold_q4(acc_q, p4[0], s4[0], w_host,
                                        out=acc_q)),
        plain_ms=t(lambda: k_mod.safl_fold_q4_plain(acc_q, p4[0], s4[0],
                                                    w_host)),
        library_ms=None, bytes=8 * dq + dq // 2 + nb * 4, ops=3 * dq,
        shape=f"Dq={dq}")
    out["safl_aggregate_q4"] = dict(
        ms=t(lambda: k_mod.safl_aggregate_q4(p4, s4, ones, p, server_lr=lr,
                                             mode="fedsgd")),
        plain_ms=t(lambda: k_mod.safl_aggregate_q4_plain(
            p4, s4, ones, p, server_lr=lr, mode="fedsgd")),
        library_ms=None, bytes=k * dq // 2 + k * nb * 4 + 2 * d * 4,
        ops=3 * k * d + 3 * d, shape=f"K={k} Dq={dq} mode=fedsgd")
    out["safl_aggregate_q4_avg"] = dict(
        ms=t(lambda: k_mod.safl_aggregate_q4(p4, s4, sizes, mode="avg")),
        plain_ms=t(lambda: k_mod.safl_aggregate_q4_plain(p4, s4, sizes,
                                                         mode="avg")),
        library_ms=None, bytes=k * dq // 2 + k * nb * 4 + dq * 4,
        ops=3 * k * dq + dq, shape=f"K={k} Dq={dq} mode=avg")
    out["sdga_aggregate_q4"] = dict(
        ms=t(lambda: k_mod.sdga_aggregate_q4(p4, s4, disc, p, m, e, **kw)),
        plain_ms=t(lambda: k_mod.sdga_aggregate_q4_plain(p4, s4, disc, p, m,
                                                         e, **kw)),
        library_ms=None, bytes=k * dq // 2 + k * nb * 4 + 6 * d * 4,
        ops=3 * k * d + 10 * d, shape=f"K={k} Dq={dq}")
    for kk, sfx in ((1, ""), (k, "_k4")):
        qr, sr = p4[:kk], s4[:kk]
        out["screen_rows_q4" + sfx] = dict(
            ms=t(lambda: k_mod.screen_rows_q4(qr, sr, qblock=QB)),
            plain_ms=t(lambda: k_mod.screen_rows_q4_plain(qr, sr,
                                                          qblock=QB)),
            library_ms=None, bytes=kk * dq // 2 + kk * nb * 4 + kk * 4,
            ops=2 * kk * dq + 3 * kk * nb, shape=f"K={kk} Dq={dq}")
    # the top-k wire (no single PyTorch call scatters int8 values with
    # their block scales): the fold as the engine runs it, in place at
    # beta = 1, and the K-row sum; bytes count the lanes this data keeps
    idx, qv, sv = topk_rows(torch, k, d, NK_FULL, g)
    nkb = NK_FULL // QB
    kept = int(((idx >= 0) & (idx < d)).sum())
    out["safl_fold_topk"] = dict(
        ms=t(lambda: k_mod.safl_fold_topk(acc, idx[0], qv[0], sv[0], w_host,
                                          out=acc)),
        plain_ms=t(lambda: k_mod.safl_fold_topk_plain(acc, idx[0], qv[0],
                                                      sv[0], w_host)),
        library_ms=None, bytes=5 * NK_FULL + 4 * nkb + 8 * (kept // k),
        ops=3 * (kept // k), shape=f"D={d} nk={NK_FULL} beta=1 in place")
    # the q8 screen over one top-k upload's values, as FlatServer.screen
    # runs it on that wire
    out["screen_rows_q8_topk"] = dict(
        ms=t(lambda: k_mod.screen_rows_q8(qv[:1], sv[:1], qblock=QB)),
        plain_ms=t(lambda: k_mod.screen_rows_q8_plain(qv[:1], sv[:1],
                                                      qblock=QB)),
        library_ms=None, bytes=NK_FULL + nkb * 4 + 4,
        ops=2 * NK_FULL + 3 * nkb, shape=f"K=1 nk={NK_FULL}")
    out["safl_aggregate_topk"] = dict(
        ms=t(lambda: k_mod.safl_aggregate_topk(idx, qv, sv, sizes, d)),
        plain_ms=t(lambda: k_mod.safl_aggregate_topk_plain(idx, qv, sv,
                                                           sizes, d)),
        library_ms=None, bytes=4 * d + k * (5 * NK_FULL + 4 * nkb),
        ops=3 * kept, shape=f"K={k} D={d} nk={NK_FULL}")
    # the int8 pair over the paper CNN's (4209, 512) blocks; dequantize's
    # library call is one broadcast multiply of the int8 rows by the scales
    rows = INT8_ROWS[0]
    x8 = torch.randn((rows, QB), device="cuda", generator=g)
    q8r, s8r = q_mod.quantize_int8(x8)
    out["quantize_int8"] = dict(
        ms=t(lambda: q_mod.quantize_int8(x8)),
        plain_ms=t(lambda: q_mod.quantize_int8_plain(x8)),
        library_ms=None, bytes=5 * rows * QB + 4 * rows, ops=4 * rows * QB,
        shape=f"R={rows} B={QB}")
    out["dequantize_int8"] = dict(
        ms=t(lambda: q_mod.dequantize_int8(q8r, s8r)),
        plain_ms=t(lambda: q_mod.dequantize_int8_plain(q8r, s8r)),
        library_ms=t(lambda: torch.mul(q8r, s8r[:, None])),
        bytes=5 * rows * QB + 4 * rows, ops=rows * QB,
        shape=f"R={rows} B={QB}")
    # flash attention at the serving path's prefill shape (bf16, causal;
    # f32 rides along); the library call is PyTorch's fused attention on
    # the same tensors (heads moved ahead of the sequence by a view)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype, sfx, peak in ((torch.bfloat16, "", BF16_FLOPS),
                             (torch.float32, "_f32", F32_FLOPS)):
        fq, fk, fv = flash_inputs(torch, FLASH_SHAPES[3], dtype, g)
        b, s_, h, hkv, hd = FLASH_SHAPES[3]
        tq, tk, tv = (x.transpose(1, 2) for x in (fq, fk, fv))
        out["flash_attention" + sfx] = dict(
            ms=t(lambda: fa_mod.flash_attention(fq, fk, fv)),
            plain_ms=t(lambda: fa_mod.flash_attention_plain(fq, fk, fv)),
            library_ms=t(lambda: sdpa(tq, tk, tv, is_causal=True,
                                      enable_gqa=True)),
            bytes=2 * (fq.numel() + fk.numel()) * fq.element_size(),
            ops=4 * b * h * hd * s_ * (s_ + 1) // 2, peak=peak,
            shape=f"B={b} S={s_} H={h}/{hkv} hd={hd} "
                  f"{str(dtype).split('.')[-1]} causal")
        del fq, fk, fv, tq, tk, tv
    for name, r in out.items():
        b_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        o_ms = r["ops"] / r.get("peak", F32_FLOPS) * 1e3
        r["bound_ms"] = max(b_ms, o_ms)
        r["bound_by"] = "bytes" if b_ms >= o_ms else "operations"
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"  {name:<22} {r['shape']:<28} kernel {r['ms']:.4f} ms  "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{r['bytes'] / 1e6:.1f} MB)  plain {r['plain_ms']:.4f} ms  "
              f"library {lib}  "
              f"achieved {r['bytes'] / r['ms'] / 1e6:.0f} GB/s")
    del flush
    return out, floor_ms


class _KernelNodeParams(ctypes.Structure):
    """libcuda's ``CUDA_KERNEL_NODE_PARAMS_v2``."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _cu_name(cu, params):
    """A kernel node's mangled symbol through ``cuFuncGetName`` or
    ``cuKernelGetName`` (CUDA 12.3 on), else None."""
    for getter, handle in (("cuFuncGetName", params.func),
                           ("cuKernelGetName", params.kern)):
        name = ctypes.c_char_p()
        if handle and hasattr(cu, getter) and not getattr(cu, getter)(
                ctypes.byref(name), ctypes.c_void_p(handle)):
            return name.value.decode()
    return None


def graph_kernels(torch, fn, calls, restore=None, cooperative=False):
    """``calls`` calls of ``fn`` captured into one CUDA graph on a side
    stream (after eager calls there, which make that stream's per-row
    counters), the graph's nodes read back through libcuda: a list of
    (node type, grid, block, symbol or None, the cooperative launch
    attribute or None where libcuda does not say), and whether one replay
    of the graph gives each call's output bitwise equal to the eager
    calls' (``restore`` puts an in-place call's state back before the
    eager calls and before the replay; all its calls return the one
    tensor, held after the last call).  With ``cooperative``, a kernel
    node whose attribute reads 0 fails before the replay (a grid barrier
    outside a cooperative launch is undefined)."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc:
            fail(f"{what} returned CUresult {rc}")

    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        if restore:
            restore()
        want = [fn().clone() for _ in range(calls)]
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=side):
        outs = [fn() for _ in range(calls)]
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    found = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            found.append((kind.value, None, None, None, None))
            continue
        params = _KernelNodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                               ctypes.byref(params)),
              "cuGraphKernelNodeGetParams_v2")
        # CU_LAUNCH_ATTRIBUTE_COOPERATIVE (2) into a CUlaunchAttributeValue
        value = (ctypes.c_ubyte * 64)()
        coop = (None if cu.cuGraphKernelNodeGetAttribute(
            ctypes.c_void_p(node), 2, ctypes.byref(value))
            else int.from_bytes(bytes(value[:4]), "little"))
        found.append((0, tuple(params.grid), tuple(params.block),
                      _cu_name(cu, params), coop))
    if cooperative and any(f[0] == 0 and f[4] == 0 for f in found):
        fail(f"captured kernel nodes {found} lost the cooperative launch "
             "attribute")
    if restore:
        with torch.cuda.stream(side):
            restore()
    torch.cuda.synchronize()
    g.replay()
    torch.cuda.synchronize()
    if restore:
        same = torch.equal(outs[-1], want[-1])
    else:
        same = all(torch.equal(o, w) for o, w in zip(outs, want))
    del g, outs
    return found, same


def check_one_launch(torch, k_mod, calls=3):
    """Each screen (f32, q8, q4) at the main path's K = 1, the q4, q8 and
    top-k folds at beta 1 in place (as the engine folds), the q4
    aggregate (fedsgd) and the top-k K-row sum at the main path's K = 4
    issue one device kernel a call and
    nothing else (no memset, no copy, no second kernel), seen two ways:
    ``calls`` calls of each captured into a CUDA graph, whose nodes must
    be ``calls`` launches of the kernel (the screens on their (chunks, K)
    grid, each fold and the K-row sum on one grid in every call, the
    K-row sum's nodes
    cooperative where libcuda reads the attribute), a replay giving the
    eager outputs bitwise; and one ``torch.profiler`` pass over ``calls``
    calls of each (after a warm-up call), whose device events, where it
    sees any, must be exactly those launches.  A profiler that sees no
    device activity at all (CUPTI taken or missing) is reported, not
    counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device="cuda").manual_seed(5)
    q, s = q8_rows(torch, 1, D_FULL, g)
    p4, s4 = q4_rows(torch, 1, D_FULL, g)
    idx, qv, sv = topk_rows(torch, K_MAIN, D_FULL, NK_FULL, g)
    p4k, s4k = q4_rows(torch, K_MAIN, D_FULL, g)
    params = torch.randn((D_FULL,), device="cuda", generator=g)
    acc = torch.randn((D_FULL,), device="cuda", generator=g)
    base = acc.clone()
    u = torch.randn((1, D_FULL), device="cuda", generator=g)
    acc_q = torch.randn((dq_of(D_FULL),), device="cuda", generator=g)
    base_q = acc_q.clone()
    w = 0.5 + 3.5 * torch.rand((K_MAIN,), device="cuda", generator=g)
    nb = dq_of(D_FULL) // QB
    # wrapper: (call, restore, symbols (demangled, mangled), grid or None
    # (the same in every call), block or None)
    cases = {
        "screen_rows": (
            lambda: k_mod.screen_rows(u), None, ("screen_f32_kernel",),
            (k_mod.screen_chunks(D_FULL), 1, 1),
            (k_mod.SCREEN_F32_WARPS * 32, 1, 1)),
        "screen_rows_q8": (
            lambda: k_mod.screen_rows_q8(q, s, qblock=QB), None,
            ("screen_q_kernel<false", "screen_q_kernelILb0"),
            (k_mod.screen_q_chunks(nb, QB), 1, 1),
            (k_mod.SCREEN_QWARPS * 32, 1, 1)),
        "screen_rows_q4": (
            lambda: k_mod.screen_rows_q4(p4, s4, qblock=QB), None,
            ("screen_q_kernel<true", "screen_q_kernelILb1"),
            (k_mod.screen_q_chunks(nb, QB // 2), 1, 1),
            (k_mod.SCREEN_QWARPS * 32, 1, 1)),
        "safl_fold_q4": (
            lambda: k_mod.safl_fold_q4(acc_q, p4[0], s4[0], 0.37, qblock=QB,
                                       out=acc_q),
            lambda: acc_q.copy_(base_q), ("fold_q4_kernel",), None, None),
        "safl_fold_q8": (
            lambda: k_mod.safl_fold_q8(acc_q, q[0], s[0], 0.37, qblock=QB,
                                       out=acc_q),
            lambda: acc_q.copy_(base_q), ("fold_q8_kernel",), None, None),
        "safl_aggregate_q4": (
            lambda: k_mod.safl_aggregate_q4(p4k, s4k, w, params,
                                            server_lr=0.05, qblock=QB),
            None, ("aggregate_q4_kernel",), None, None),
        "safl_fold_topk": (
            lambda: k_mod.safl_fold_topk(acc, idx[0], qv[0], sv[0], 0.37,
                                         out=acc),
            lambda: acc.copy_(base), ("fold_topk_kernel",), None, None),
        "safl_aggregate_topk": (
            lambda: k_mod.safl_aggregate_topk(idx, qv, sv, w, D_FULL), None,
            ("aggregate_topk_kernel",), None, None)}

    def is_kernel(name, wrapper):
        return any(sym in name for sym in cases[wrapper][2])

    graphs = {}
    for wrapper, (fn, restore, _, grid, block) in cases.items():
        found, same = graph_kernels(
            torch, fn, calls, restore,
            cooperative=wrapper == "safl_aggregate_topk")
        names = sorted({str(f[3]) for f in found})
        grids = sorted({f[1] for f in found if f[1]})
        blocks = sorted({f[2] for f in found if f[2]})
        coop = sorted({str(f[4]) for f in found})
        print(f"  CUDA graph of {calls} calls of {wrapper}: {len(found)} "
              f"nodes, types {sorted({f[0] for f in found})}, grids "
              f"{grids} (want {grid or 'one grid'}), blocks {blocks}, "
              f"cooperative {coop}, symbols {names}; replay bitwise equal "
              f"to the eager calls: {same}")
        if (len(found) != calls
                or any(f[0] != 0 or (grid and f[1] != grid)
                       or (block and f[2] != block)
                       or (f[3] is not None and not is_kernel(f[3], wrapper))
                       for f in found)
                or len(grids) != 1 or len(blocks) != 1 or not same):
            fail(f"{wrapper} captured as {found}, not one kernel a call, or "
                 "its replay differs")
        graphs[wrapper] = dict(nodes=len(found), grid=grids[0],
                               block=blocks[0], symbols=names,
                               cooperative=coop, replay_equal=same)

    for fn, *_ in cases.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn, *_ in cases.values():
            for _ in range(calls):
                fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    got = {wrapper: sum(is_kernel(n, wrapper) for n in names)
           for wrapper in cases}
    if not names:
        print(f"  profiler: no device events over {calls} calls of each of "
              f"{sorted(cases)} (no device activity traced): not counted")
    else:
        print(f"  profiler: {len(names)} device events over {calls} calls "
              f"of each of {sorted(cases)}: {got} (tolerance: exactly "
              f"{calls} each, nothing else)")
        if (got != dict.fromkeys(cases, calls)
                or len(names) != len(cases) * calls):
            fail(f"the one-launch kernels issued {sorted(set(names))}, not "
                 "one kernel per call")
    return dict(calls=calls, graphs=graphs, kernels=got,
                device_events=len(names))


def time_codec(torch):
    """The codec's cost per upload at full width, L2 flushed before each:
    on q4 the (4209, 512) draws alone (threefry in int64 PyTorch ops) and
    a whole gradient upload (ravel of the delta, the draws, the
    stochastic-rounding quantize, the pack and the error-feedback
    residual), beside the q8 upload's quantize; on top-k the ranking
    alone (a stable sort of the (Dq,) magnitudes) and a whole gradient
    upload (ravel, ranking, gather, quantize, residual)."""
    from repro_torch import prng
    from repro_torch.core.flatbuf import PytreeCodec
    from repro_torch.models.vision_cnn import build_paper_model
    start, _, _ = build_paper_model("cnn", prng.prng_key(0), device="cuda",
                                    width=32, image_size=32)
    end = {k: v * 0.99 for k, v in start.items()}
    codec = PytreeCodec(start)
    res = torch.zeros(codec.dq, device="cuda")
    key = prng.fold_in(prng.fold_in(prng.prng_key(0), 3), 7)
    flush = torch.zeros(64 * 2 ** 20, device="cuda")
    out = {
        "q4_draws": time_ms(torch, lambda: prng.uniform_torch(
            key, DRAW_SHAPE, "cuda"), flush),
        "q4_upload": time_ms(torch, lambda: codec.ravel_delta_q4(
            start, end, 0.05, res, 0, 3, 7), flush),
        "q8_upload": time_ms(torch, lambda: codec.ravel_delta_q8(
            start, end, 0.05, res), flush),
        "topk_rank": time_ms(torch, lambda: codec._rank(res), flush),
        "topk_upload": time_ms(torch, lambda: codec.ravel_delta_topk(
            start, end, 0.05, res), flush),
    }
    for name, ms in out.items():
        print(f"  {name:<22} D={codec.d} {ms:.4f} ms per upload")
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
    """The engine of paper setting ``setting`` with ``cfg_kw`` on top, the
    server lr from the launcher's table."""
    from repro_torch.configs.paper import MODES
    from repro_torch.core import FLEngine
    from repro_torch.launch.fl_sim import SERVER_LR
    from repro_torch.models.vision_cnn import build_paper_model
    from repro_torch.prng import prng_key
    ds, shards, te, width, hw = setup
    cfg = dataclasses.replace(MODES[setting], n_clients=len(shards),
                              k=K_MAIN, client_lr=0.05, speed_sigma=0.8,
                              **cfg_kw)
    cfg = dataclasses.replace(
        cfg, server_lr=SERVER_LR.get(cfg.aggregation, 1.0))
    p0, s0, fn = build_paper_model(
        "cnn", prng_key(0), device="cpu",
        n_classes=ds.n_classes, in_ch=3, width=width, image_size=hw)
    return FLEngine(cfg, fn, ds.kind, p0, s0, shards, te.x[:400],
                    te.y[:400], device=device)


def check_engine_small(torch):
    """The engine on the card against the engine on the CPU (itself held
    against the JAX reference by the CPU tests)."""
    setup = make_setup(width=4, hw=8, samples=400, clients=6)
    rows = []
    for name, setting, kw in (
            ("AS", "AS", {}), ("SS", "SS", {}),
            ("AS-fedasync", "AS", {"aggregation": "fedasync"}),
            ("SS-sdga", "SS", {"aggregation": "sdga"}),
            ("AS-q8", "AS", {"wire": "q8"}),
            ("SS-sdga-q8", "SS", {"wire": "q8", "aggregation": "sdga"}),
            ("AS-q4", "AS", {"wire": "q4"}),
            ("SS-sdga-q4", "SS", {"wire": "q4", "aggregation": "sdga"}),
            ("AS-chaos-screen", "AS", dict(CHAOS, defense="screen")),
            ("AS-chaos-screen-q8", "AS",
             dict(CHAOS, defense="screen", wire="q8")),
            ("AS-chaos-screen-q4", "AS",
             dict(CHAOS, defense="screen", wire="q4")),
            ("AS-topk", "AS", {"wire": "topk"}),
            ("SS-topk", "SS", {"wire": "topk"}),
            ("AS-sdga-topk", "AS", {"wire": "topk", "aggregation": "sdga"}),
            ("SS-sdga-topk", "SS", {"wire": "topk", "aggregation": "sdga"})):
        res = {}
        for dev in ("cpu", "cuda"):
            eng = build_engine(torch, setup, setting, dev, **kw)
            p0 = eng._flat_params.cpu()
            r = eng.run(3)
            res[dev] = (eng, r)
        (ec, rc), (eg, rg) = res["cpu"], res["cuda"]
        counts = {key: (rc.sched_stats[key], rg.sched_stats[key])
                  for key in FAULT_COUNTS}
        same_host = (all(a == b for a, b in counts.values())
                     and ec.tx_bytes == eg.tx_bytes
                     and ec.rx_bytes == eg.rx_bytes
                     and rc.staleness_hist == rg.staleness_hist
                     and list(rc.participation) == list(rg.participation)
                     and [x.sim_time for x in rc.metrics.records]
                     == [x.sim_time for x in rg.metrics.records])
        pc, pg = ec._flat_params, eg._flat_params.cpu()
        err = float((pc - pg).abs().max())
        rel = float((pc - pg).norm() / (pc - p0).norm())
        if kw.get("wire") in ("q8", "q4", "topk"):
            # a gradient that differs in its last bits (cuDNN) can round
            # to the next int8 / int4 level or cross the top-k cut: hold
            # the distance to the run's own movement, the reference's q8
            # bound
            close, tol = rel <= 2e-2, f"relative {rel:.3e} <= 2e-2"
        else:
            close = torch.allclose(pg, pc, rtol=1e-4, atol=1e-5)
            tol = "rtol=1e-4, atol=1e-5"
        print(f"  {name} card vs CPU, 3 rounds: bytes/schedule/fault "
              f"counts {'equal' if same_host else 'DIFFER'}, params "
              f"max|err|={err:.3e} ({tol})")
        if kw.get("defense"):
            print("      (cpu, card) " + "  ".join(
                f"{key.split('_')[0]} {v}" for key, v in counts.items()))
        rows.append(dict(setting=name, host_equal=same_host,
                         params_max_abs_err=err,
                         params_rel_to_movement=rel, fault_counts=counts))
        if not (same_host and close):
            fail(f"{name}: engine on the card disagrees with the CPU")
    return rows


def check_codec(torch):
    """One full-width upload through the q4 and the top-k codec on the
    card and on the CPU, from the same weights, residual and (q4) (seed,
    client, counter) key: bitwise equal outputs (q4: packed bytes, scales
    and residual, the draws, the quantize and the f64 residual being
    exact on both; top-k: indices, int8 values, scales and residual, the
    stable sort ranking alike on both), for gradient uploads with and
    without error feedback and a q4 model upload."""
    from repro_torch.core.flatbuf import PytreeCodec
    from repro_torch.models.vision_cnn import build_paper_model
    from repro_torch.prng import prng_key
    start, _, _ = build_paper_model("cnn", prng_key(4), device="cpu",
                                    width=32, image_size=32)
    g = torch.Generator().manual_seed(5)
    end = {k: v - 0.01 * torch.randn(v.shape, generator=g)
           for k, v in start.items()}
    codec = PytreeCodec(start)
    if codec.nk != NK_FULL:
        fail(f"full-width top-k codec keeps {codec.nk} lanes, expected "
             f"{NK_FULL}")
    res = 1e-3 * torch.randn(codec.dq, generator=g)
    rows = []
    for name, args in (
            ("ravel_delta_q4", (start, end, 0.05, res, 0, 3, 7)),
            ("ravel_q4_nores", (end, 11, 2, 0)),
            ("ravel_delta_topk", (start, end, 0.05, res)),
            ("ravel_delta_topk_nores", (start, end, 0.05))):
        fn = getattr(codec, name)
        want = fn(*args)
        got = fn(*(
            {k: v.to("cuda") for k, v in a.items()} if isinstance(a, dict)
            else a.to("cuda") if isinstance(a, torch.Tensor) else a
            for a in args))
        same = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
        print(f"  {name} D={codec.d}: card vs CPU ({len(want)} outputs) "
              f"{'bitwise equal' if same else 'DIFFER'}")
        rows.append(dict(program=name, bitwise=same))
        if not same:
            fail(f"{name}: the codec on the card differs from the CPU")
    return rows


def check_channels(torch):
    """The server's streaming channel (K folds + finalize) against its
    buffered channel (K row writes + one aggregate) on the card, at full
    width, in every aggregation mode on the f32, q8 and q4 wires and in
    the four gradient modes on top-k, for two rounds (so sdga's and
    fedopt's slow state is carried): with clean rows, and with
    row 1 corrupted and row 2 Byzantine under each defense (each row
    screened alone through ``FlatServer.screen`` -> ``defense_factors``;
    streaming: skip a factor-0 row, else fold at w*fac; buffered: zero a
    factor-0 row's payload (the q8 / q4 / top-k scales), weights times
    the factors;
    the clip cap 3x the median clean norm).  Bitwise, since the kernels
    and the PyTorch ops of the finalize round the same operations in the
    same order.  (Two engine runs on the card are not compared: cuDNN's
    convolution gradients are not bitwise repeatable.)"""
    import numpy as np

    from repro_torch.core.aggregation import FlatServer
    from repro_torch.core.flatbuf import (AccumBuffer, QuantBuffer,
                                          TopkBuffer, alloc_buffer,
                                          write_slot)
    from repro_torch.faults import defense_factors
    from repro_torch.launch.fl_sim import SERVER_LR
    g = torch.Generator(device="cuda").manual_seed(2)
    rng = np.random.default_rng(2)
    kinds = (None, "corrupt", "byzantine", None)
    rows_out = []
    for wire in ("f32", "q8", "q4", "topk"):
        for mode in (TOPK_AGGREGATIONS if wire == "topk" else AGGREGATIONS):
            for defense in ("none", "screen", "clip"):
                srv = FlatServer(mode, D_FULL,
                                 server_lr=SERVER_LR.get(mode, 1.0),
                                 wire=wire, device="cuda")
                p = torch.randn((D_FULL,), device="cuda", generator=g)
                ps, pb = p, p
                os_, ob = srv.init_opt(p), srv.init_opt(p)
                facs_seen = []
                for _ in range(2):
                    tau = rng.integers(0, 5, K_MAIN).astype(np.float32)
                    w = {"fedsgd": np.ones(K_MAIN, np.float32),
                         "fedavg": np.float32([113, 58, 241, 77]),
                         "fedasync": np.asarray(
                             0.6 * np.power(tau + 1.0, -np.float32(0.5)),
                             np.float32)}.get(mode, np.asarray(
                                 np.power(tau + 1.0, -np.float32(0.5)),
                                 np.float32))
                    acc = AccumBuffer(srv.bank_width, srv.fold_program,
                                      "cuda")
                    if wire == "topk":
                        rows = topk_rows(torch, K_MAIN, D_FULL, NK_FULL, g)
                        buf = TopkBuffer(K_MAIN, D_FULL, NK_FULL, QB,
                                         device="cuda")
                        payloads = [tuple(a[i] for a in rows)
                                    for i in range(K_MAIN)]
                    elif wire != "f32":
                        q, s = (q8_rows if wire == "q8" else q4_rows)(
                            torch, K_MAIN, D_FULL, g)
                        buf = QuantBuffer(K_MAIN, D_FULL, QB, device="cuda",
                                          packed=wire == "q4")
                        payloads = [(q[i], s[i]) for i in range(K_MAIN)]
                    else:
                        u = 0.1 * torch.randn((K_MAIN, D_FULL),
                                              device="cuda", generator=g)
                        buf = alloc_buffer(K_MAIN, D_FULL, "cuda")
                        payloads = [(u[i],) for i in range(K_MAIN)]
                    facs = np.ones(K_MAIN, np.float32)
                    if defense != "none":
                        payloads = [poisoned(pl, kind)
                                    for pl, kind in zip(payloads, kinds)]
                        sums = np.concatenate(
                            [srv.screen(tuple(a[None] for a in pl))
                             .cpu().numpy() for pl in payloads])
                        clean = np.sqrt(sums[[0, 3]])
                        cap = (float(3.0 * np.median(clean))
                               if defense == "clip" else 0.0)
                        facs = np.concatenate([defense_factors(
                            sums[i:i + 1], defense, cap)[0]
                            for i in range(K_MAIN)])
                        facs_seen.append(facs.tolist())
                    for i, pl in enumerate(payloads):
                        if facs[i] == np.float32(0.0):
                            acc.skip()
                            pl = pl[:-1] + (torch.zeros_like(pl[-1]),)
                        else:
                            wi = np.float32(w[i] * facs[i])
                            beta = (np.float32(1.0) - wi
                                    if mode == "fedasync" else 1.0)
                            acc.fold(pl, w=wi, beta=beta)
                        if wire != "f32":
                            buf.write(*pl, i)
                        else:
                            write_slot(buf, pl[0], i)
                    bank, wvec, stats = acc.seal()
                    ps, os_, _, _ = srv.finalize(ps, bank, wvec, os_,
                                                 pprod=stats["pprod"])
                    pb, ob, _ = srv.step(
                        pb, buf if wire == "f32" else buf.views, w * facs,
                        ob)
                exact = torch.equal(ps, pb) and all(
                    os_[key] == ob[key] if key == "step"
                    else torch.equal(os_[key], ob[key]) for key in ob)
                finite = bool(torch.isfinite(ps).all())
                err = float((ps - pb).abs().max())
                print(f"  {mode:<8} {wire} defense={defense:<6}: streaming "
                      f"vs buffered channel, D={D_FULL} K={K_MAIN}, 2 "
                      f"rounds: {'bitwise equal' if exact else 'DIFFER'} "
                      f"(max|err|={err:.3e}, slow state {sorted(ob)}"
                      + (f", factors {facs_seen}" if facs_seen else "")
                      + ")")
                rows_out.append(dict(mode=mode, wire=wire, defense=defense,
                                     bitwise=exact, max_abs_err=err,
                                     factors=facs_seen))
                if not (exact and finite):
                    fail(f"{mode}/{wire}/{defense}: streaming channel "
                         "differs from the buffered one or is not finite")
    return rows_out


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


def clean_clip_cap(torch, setup, setting, kw):
    """defense_norm_cap for a clip setting: 3x the median upload norm of
    a first clean round (the setting without its faults, screened for
    integrity only)."""
    import numpy as np
    clean = {k: v for k, v in kw.items()
             if not k.startswith("fault_") and k != "defense"}
    eng = build_engine(torch, setup, setting, "cuda", defense="screen",
                       **clean)
    norms, inner = [], eng._server.screen

    def screen(payload):
        out = inner(payload)
        norms.extend(torch.sqrt(out).tolist())
        return out

    eng._server.screen = screen
    eng.run(1)
    cap = float(3.0 * np.median(norms))
    print(f"      clip cap {cap:.4f} = 3 x median of the first clean "
          f"round's upload norms {[round(n, 4) for n in norms]}")
    return cap


def expected_launches(spec, uploads, screened):
    """A setting's launch counts: every kernel 0 except those it names."""
    out = dict.fromkeys(KERNELS, 0)
    for name, want in spec.items():
        out[name] = {"uploads": uploads,
                     "uploads-screened": uploads - screened}.get(want, want)
    return out


def cnn_params(torch, seed, device):
    """The full-width paper CNN's parameters, drawn on the CPU."""
    from repro_torch.models.vision_cnn import build_paper_model
    from repro_torch.prng import prng_key
    params, _, _ = build_paper_model(
        "cnn", prng_key(seed), device=device, width=32,
        image_size=32)
    return params


def compress_pytree(q_mod, params):
    """The pytree compression path: quantize_pytree, then
    dequantize_pytree -> (the quantized dict, its wire bytes, the
    dequantized dict)."""
    qs, nbytes = q_mod.quantize_pytree(params)
    return qs, nbytes, q_mod.dequantize_pytree(qs)


def check_pytree(torch, q_mod):
    """quantize_pytree / dequantize_pytree of the full-width CNN's
    parameters on the card against the CPU: every leaf's int8 rows,
    scales and dequantized values bitwise equal, and the same wire
    bytes."""
    params = cnn_params(torch, 7, "cpu")
    want = compress_pytree(q_mod, params)
    got = compress_pytree(q_mod, {k: v.to("cuda") for k, v in
                                  params.items()})
    same = got[1] == want[1] and all(
        torch.equal(a.cpu(), b) for key in params
        for a, b in zip(got[0][key][:2] + (got[2][key],),
                        want[0][key][:2] + (want[2][key],)))
    print(f"  quantize_pytree + dequantize_pytree, {len(params)} leaves, "
          f"D={sum(v.numel() for v in params.values())}: card vs CPU "
          f"{'bitwise equal' if same else 'DIFFER'}, {got[1]} wire bytes "
          f"(CPU {want[1]})")
    if not same:
        fail("the pytree compression helpers on the card differ from the "
             "CPU")
    return dict(bitwise=same, nbytes=got[1])


def run_compression_path(torch, q_mod, wrappers):
    """The int8 pair's path: the compression helpers over the full-width
    CNN's parameters on the card, every launch counter reset before and
    read after; each helper launches its kernel once per leaf."""
    params = cnn_params(torch, 8, "cuda")
    for f in wrappers.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qs, nbytes, back = compress_pytree(q_mod, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: f.launches for n, f in wrappers.items()}
    expected = expected_launches({k: len(params) for k in INT8_KERNELS},
                                 0, 0)
    err = max(float((back[k] - v).abs().max() / v.abs().max())
              for k, v in params.items() if v.abs().max() > 0)
    print(f"  compression path: {len(params)} leaves, {nbytes} wire bytes, "
          f"wall {wall:.4f} s, max |deq - x| / max |x| per leaf {err:.3e}, "
          "launches " + " ".join(f"{n}={c}" for n, c in counts.items() if c))
    if counts != expected:
        fail(f"compression path: launches {counts}, expected {expected}")
    if not all(bool(torch.isfinite(v).all()) for v in back.values()) or \
            err > 1.0 / 127:
        fail(f"compression path: dequantized leaves off by {err}")
    return dict(launches=counts, nbytes=nbytes, wall_s=wall,
                max_rel_err=err)


def run_setting(torch, setup, setting, kw, wrappers):
    """One run of ROUNDS rounds from a fresh engine of ``setting`` with
    ``kw``, every launch counter reset before and read after.  Returns
    the engine, its result, the counts, the wall seconds and their split,
    whether the global params were finite after each round and the fault
    kinds the plan drew."""
    eng = build_engine(torch, setup, setting, "cuda", **kw)
    if eng.codec.d != D_FULL:
        fail(f"full-width CNN has D={eng.codec.d}, expected {D_FULL}")
    split = {"client_train": 0.0, "server_ingest": 0.0,
             "server_round": 0.0, "eval": 0.0}
    timed(torch, eng, "_run_local", "client_train", split)
    timed(torch, eng, "_enqueue_upload", "server_ingest", split)
    timed(torch, eng, "_aggregate", "server_round", split)
    timed(torch, eng, "_eval_and_record", "eval", split)
    # finite global params after every round, checked outside the timed
    # span; the fault kinds the plan draws, tallied
    finite, drawn = [], {}
    agg = eng._aggregate

    def aggregate(*a, _agg=agg, _eng=eng, _finite=finite):
        out = _agg(*a)
        _finite.append(bool(torch.isfinite(_eng._flat_params).all()))
        return out

    eng._aggregate = aggregate
    if eng.sched.faults is not None:
        draw = eng.sched.faults.draw

        def tally(cid, _draw=draw, _drawn=drawn):
            f = _draw(cid)
            _drawn[f.kind] = _drawn.get(f.kind, 0) + 1
            return f

        eng.sched.faults.draw = tally
    for f in wrappers.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run(ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: f.launches for n, f in wrappers.items()}
    return eng, res, counts, wall, split, finite, drawn


def run_record(eng, res, counts, drawn):
    """What a run must repeat: every round's accuracy and loss, bytes,
    uploads, staleness, launches and fault counts."""
    recs = res.metrics.records
    return dict(accuracy=[r.accuracy for r in recs],
                loss=[r.loss for r in recs], tx_bytes=eng.tx_bytes,
                rx_bytes=eng.rx_bytes,
                uploads=int(res.participation.sum()),
                participation=res.participation.tolist(),
                staleness_hist=dict(res.staleness_hist),
                launches=counts, faults_drawn=drawn,
                fault_counts={key.split("_")[0]: res.sched_stats[key]
                              for key in FAULT_COUNTS})


def run_main_path(torch, wrappers):
    """Every setting of ``MAIN_SETTINGS`` run twice, each time from a fresh
    engine: the first run is checked (launch counts, faults, finite
    params) and counted; the second must repeat it bit for bit (the final
    flat params bitwise, every round's accuracy and loss, and the bytes,
    uploads, participation, staleness, launches and fault counts equal)."""
    setup = make_setup(width=32, hw=32, samples=2000, clients=16)
    rows = []
    launches = dict.fromkeys(KERNELS, 0)
    for name, setting, kw, spec in MAIN_SETTINGS:
        if kw.get("defense") == "clip":
            kw = dict(kw, defense_norm_cap=clean_clip_cap(torch, setup,
                                                          setting, kw))
        eng, res, counts, wall, split, finite, drawn = run_setting(
            torch, setup, setting, kw, wrappers)
        rec = run_record(eng, res, counts, drawn)
        uploads = rec["uploads"]
        st = res.sched_stats
        faults = rec["fault_counts"]
        recs = res.metrics.records
        acc = [round(a, 4) for a in rec["accuracy"]]
        print(f"  {name}: acc/round {acc}  tx_bytes={eng.tx_bytes} "
              f"rx_bytes={eng.rx_bytes}  uploads={uploads}  launches "
              + " ".join(f"{n}={c}" for n, c in counts.items() if c))
        if drawn:
            print(f"      faults drawn {drawn}; counts {faults}")
        print(f"      wall {wall:.3f} s: " + "  ".join(
            f"{k} {v:.3f} s" for k, v in split.items()))
        if len(recs) != ROUNDS or any(r.nan_event for r in recs):
            fail(f"{name}: non-finite eval loss or missing rounds")
        if len(finite) != ROUNDS or not all(finite):
            fail(f"{name}: non-finite global parameters after a round "
                 f"({finite})")
        expected = expected_launches(spec, uploads, st["screened_uploads"])
        if counts != expected or not all(counts[n] for n in spec):
            fail(f"{name}: launches {counts}, expected {expected}")
        for field, kind in FAULT_KINDS.items():
            if kw.get(field) and not drawn.get(kind):
                fail(f"{name}: no {kind} fault was drawn ({drawn})")
        if kw.get("defense") == "screen" and \
                st["screened_uploads"] != st["corrupted_uploads"]:
            fail(f"{name}: screened {st['screened_uploads']} != corrupted "
                 f"{st['corrupted_uploads']} under the screen with cap 0")
        if kw.get("defense") == "clip" and \
                st["clipped_uploads"] < st["byzantine_uploads"]:
            fail(f"{name}: clipped {st['clipped_uploads']} < byzantine "
                 f"{st['byzantine_uploads']}")
        for n, c in counts.items():
            launches[n] += c
        params = eng._flat_params.clone()
        del eng, res
        eng2, res2, counts2, wall2, split2, _, drawn2 = run_setting(
            torch, setup, setting, kw, wrappers)
        rec2 = run_record(eng2, res2, counts2, drawn2)
        same_params = torch.equal(params.view(torch.int32),
                                  eng2._flat_params.view(torch.int32))
        differ = [key for key in rec if rec[key] != rec2[key]]
        print(f"      repeat from a fresh engine: params "
              f"{'bitwise equal' if same_params else 'DIFFER'}, "
              f"{'every record equal' if not differ else f'differ in {differ}'}"
              f"; wall {wall2:.3f} s: " + "  ".join(
                  f"{k} {v:.3f} s" for k, v in split2.items()))
        rows.append(dict(setting=name, **rec, wall_s=wall, split_s=split,
                         defense_norm_cap=kw.get("defense_norm_cap", 0.0),
                         repeat=dict(params_bitwise=same_params,
                                     differing=differ, wall_s=wall2,
                                     split_s=split2,
                                     accuracy=rec2["accuracy"])))
        if not same_params or differ:
            fail(f"{name}: a second run from a fresh engine does not "
                 f"repeat the first (params bitwise {same_params}, "
                 f"differing {differ})")
        del eng2, res2
    return rows, launches


# ---------------------------------------------------------------------------
# phase 7: serving the full-width qwen3-1.7b
# ---------------------------------------------------------------------------


def ms_of(torch, fn):
    """Host-clock milliseconds of one call, the device synchronized before
    and after; returns (ms, the call's result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def profiled(torch, fn):
    """One call of ``fn`` under ``torch.profiler``: (its result, the device
    busy ms (the union of every kernel, copy and memset interval), the
    flash kernel's device ms, the number of device events).  The times are
    None when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    spans, flash_us = [], 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        if FLASH_SYMBOL in e.name:
            flash_us += e.time_range.elapsed_us()
    if not spans:
        return out, None, None, 0
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return out, busy_us / 1e3, flash_us / 1e3, len(spans)


def max_ulp(a, b) -> int:
    import numpy as np
    ia, ib = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(
        np.int64)
    return int(np.abs(ia - ib).max())


def run_serve(torch, fa_mod, wrappers):
    """The serving path: ``serve.run`` of the full-width qwen3-1.7b (B 8,
    prompt 1024, 32 greedy tokens, weights from prng_key(0) drawn on the
    card), every launch counter reset before and read after; then (a)
    :data:`SERVE_PASSES` passes of a prefill and the 32 decode steps,
    each timed on the host clock (medians kept), with flash launches
    counted per prefill and per decode step, and one prefill and
    :data:`SERVE_TRACED_STEPS` decode steps under the profiler: the
    device busy time, the flash kernel's share and the device events per
    step; (b) the prefill with the plain attention on the card against
    the kernel's: the kernel's logits no further from the plain
    attention's (max and relative L2) than bf16 compute's are from f32
    compute's, a check of model scale only (phase 3 holds the kernel
    itself); (c) the reduced
    qwen3 served on the card against the CPU (f32, TF32 off); (d) the
    card's normal draws against numpy's."""
    import numpy as np

    from repro_torch import prng
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.transformer import DecoderLM
    cfg = get_config(SERVE_ARCH)
    B, S, new = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    # the engines of phase 6 are reference cycles (their patched
    # methods close over them): collected here, so that the peaks below
    # do not depend on when the collector last ran
    gc.collect()
    torch.cuda.empty_cache()
    # what earlier phases left allocated; the peaks below include it
    base_run = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for f in wrappers.values():
        f.launches = 0
    wall_ms, res = ms_of(torch, lambda: serve.run(cfg, B, S, new, "cuda"))
    counts = {n: f.launches for n, f in wrappers.items()}
    peak_run = torch.cuda.max_memory_allocated()
    model = res.model
    n_params = model.param_count()
    run_times = (res.t_prefill * 1e3, res.t_decode * 1e3)
    print(f"  serve.run {SERVE_ARCH} full width ({n_params:,} params, "
          f"{cfg.n_layers} layers, B={B}, prompt {S}, {new} new tokens): "
          f"wall {wall_ms / 1e3:.2f} s (init included), prefill "
          f"{res.t_prefill * 1e3:.1f} ms, decode {res.t_decode * 1e3:.1f} "
          f"ms; launches " + " ".join(f"{n}={c}" for n, c in counts.items()
                                      if c))
    print("  sample token ids[0]:", res.gen[0][:16].tolist())
    expected = dict.fromkeys(KERNELS, 0)
    expected["flash_attention"] = cfg.n_layers
    if counts != expected:
        fail(f"serve.run: launches {counts}, expected {expected}")
    if n_params != SERVE_PARAMS:
        fail(f"serve.run: {n_params} params, expected {SERVE_PARAMS}")
    if tuple(res.logits.shape) != (B, cfg.padded_vocab) or \
            not bool(torch.isfinite(res.logits).all()) or \
            res.gen.shape != (B, new):
        fail(f"serve.run: logits {tuple(res.logits.shape)}, gen "
             f"{res.gen.shape}, or non-finite logits")

    with torch.inference_mode():
        # (a) steady-state prefill and decode, launches per call; then
        # one prefill and a few decode steps under the profiler
        base_prefill = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        prefill_samples, step_samples = [], []
        per_prefill, decode_launches = set(), 0
        for _ in range(SERVE_PASSES):
            fa_mod.flash_attention.launches = 0
            ms, (logits, cache) = ms_of(
                torch, lambda: model.prefill(res.tokens, capacity=S + new))
            prefill_samples.append(ms)
            per_prefill.add(fa_mod.flash_attention.launches)
            fa_mod.flash_attention.launches = 0
            tok = torch.argmax(logits, dim=-1)
            for i in range(new):
                ms, (last, cache) = ms_of(
                    torch, lambda: model.decode_step(cache, tok, S + i))
                tok = torch.argmax(last, dim=-1)
                step_samples.append(ms)
            decode_launches += fa_mod.flash_attention.launches
            del cache
        peak_prefill = torch.cuda.max_memory_allocated()
        per_prefill = per_prefill.pop() if len(per_prefill) == 1 else \
            sorted(per_prefill)
        per_decode = decode_launches / (SERVE_PASSES * new)
        prefill_ms = statistics.median(prefill_samples)
        decode_ms = statistics.median(step_samples)
        (logits, cache), pre_busy, pre_flash, pre_events = profiled(
            torch, lambda: model.prefill(res.tokens, capacity=S + new))
        tok = torch.argmax(logits, dim=-1)

        def steps():
            nonlocal tok, cache
            for i in range(SERVE_TRACED_STEPS):
                out, cache = model.decode_step(cache, tok, S + i)
                tok = torch.argmax(out, dim=-1)
            return out

        _, dec_busy, _, dec_events = profiled(torch, steps)
        del cache
        # (b) the same prefill with the plain attention, in bf16 and, as
        # the yardstick of bf16's own rounding, in f32 compute
        kernel_fn = ops.flash_attention
        ops.flash_attention = lambda q, k, v, causal=True, **_: \
            fa_mod.flash_attention_plain(q, k, v, causal=causal)
        try:
            plain_ms, (plain_logits, _) = ms_of(
                torch, lambda: model.prefill(res.tokens))
            f32_model = DecoderLM(
                dataclasses.replace(cfg, compute_dtype="float32"),
                model.top.tree, [layer.tree for layer in model.layers])
            f32_logits, _ = f32_model.prefill(res.tokens)
            del f32_model
        finally:
            ops.flash_attention = kernel_fn
    err_b = float((logits - plain_logits).abs().max())
    err_f32 = float((plain_logits - f32_logits).abs().max())
    rel_b = float((logits - plain_logits).norm() / plain_logits.norm())
    rel_f32 = float((plain_logits - f32_logits).norm() / f32_logits.norm())
    top1 = int((logits.argmax(-1) == plain_logits.argmax(-1)).sum())
    print(f"  (a) flash launches: {per_prefill} per prefill, {per_decode:g} "
          f"per decode step; over {SERVE_PASSES} passes, median prefill "
          f"{prefill_ms:.2f} ms (range {min(prefill_samples):.2f}-"
          f"{max(prefill_samples):.2f}), median decode step "
          f"{decode_ms:.3f} ms per token (B={B}; range "
          f"{min(step_samples):.3f}-{max(step_samples):.3f}); peak memory "
          f"{peak_run / 2**30:.2f} GiB in serve.run (from "
          f"{base_run / 2**30:.2f} GiB allocated before it), "
          f"{peak_prefill / 2**30:.2f} GiB in prefill and decode (from "
          f"{base_prefill / 2**30:.2f} GiB)")
    if pre_busy is None or dec_busy is None:
        trace = None
        print("  (a) profiler: no device activity seen; busy shares not "
              "measured")
    else:
        dec_step = dec_busy / SERVE_TRACED_STEPS
        trace = dict(prefill_busy_ms=pre_busy, prefill_flash_ms=pre_flash,
                     prefill_device_events=pre_events,
                     prefill_busy_share=pre_busy / prefill_ms,
                     prefill_flash_share=pre_flash / pre_busy,
                     decode_busy_ms_per_step=dec_step,
                     decode_device_events_per_step=dec_events /
                     SERVE_TRACED_STEPS,
                     decode_busy_share=dec_step / decode_ms)
        print(f"  (a) profiler: prefill device busy {pre_busy:.2f} ms "
              f"({trace['prefill_busy_share']:.1%} of the median prefill), "
              f"flash {pre_flash:.2f} ms ({trace['prefill_flash_share']:.1%}"
              f" of the busy time), {pre_events} device events; decode "
              f"device busy {dec_step:.3f} ms per step "
              f"({trace['decode_busy_share']:.1%} of the median step), "
              f"{trace['decode_device_events_per_step']:g} device events "
              "per step")
    print(f"  (b) prefill logits (max |logit| "
          f"{float(plain_logits.abs().max()):.3f}), kernel vs plain "
          f"attention, bf16 compute: max|err|={err_b:.3e}, relative L2 "
          f"{rel_b:.3e}; bf16 vs f32 compute (plain): max|err|="
          f"{err_f32:.3e}, relative L2 {rel_f32:.3e} (tolerance: the "
          f"first within the second); greedy token equal in {top1}/{B} "
          f"rows; plain prefill {plain_ms:.2f} ms")
    if trace is not None and not trace["prefill_flash_ms"]:
        fail(f"the profiler saw device time but none in {FLASH_SYMBOL}")
    if per_prefill != cfg.n_layers or per_decode != 0:
        fail(f"flash launches {per_prefill} per prefill, {per_decode} per "
             f"decode step; expected {cfg.n_layers} and 0")
    if not (err_b <= err_f32 and rel_b <= rel_f32
            and bool(torch.isfinite(last).all())):
        fail("the kernel moves the prefill logits further from the plain "
             "attention than bf16 compute moves them from f32, or decode "
             "logits are not finite")
    del model, res, logits, plain_logits, f32_logits, last
    torch.cuda.empty_cache()

    # (c) the reduced qwen3 on the card against the CPU
    rcfg = reduced_config(cfg)
    fa_mod.flash_attention.launches = 0
    on_card = serve.run(rcfg, 4, 200, 8, "cuda")
    reduced_launches = fa_mod.flash_attention.launches
    on_cpu = serve.run(rcfg, 4, 200, 8, "cpu")
    err_c = float((on_card.logits.cpu() - on_cpu.logits).abs().max())
    same_gen = bool(np.array_equal(on_card.gen, on_cpu.gen))
    ok_c = torch.allclose(on_card.logits.cpu(), on_cpu.logits,
                          atol=SERVE_F32_TOL, rtol=SERVE_F32_TOL)
    print(f"  (c) reduced {SERVE_ARCH} (f32, B=4, prompt 200, 8 new), card "
          f"vs CPU: prefill logits max|err|={err_c:.3e} (tolerance "
          f"atol=rtol={SERVE_F32_TOL}), greedy tokens "
          f"{'equal' if same_gen else 'DIFFER'}, {reduced_launches} flash "
          "launches on the card")
    if not (ok_c and same_gen and reduced_launches == rcfg.n_layers):
        fail("the reduced model served on the card disagrees with the CPU")

    # (d) normal draws on the card against numpy (the embedding's key)
    key = prng.split(prng.prng_key(0), 5)[0]
    shape = (2048, 2048)
    got = prng.normal_torch(key, shape, "cuda").cpu().numpy()
    want = prng.normal(key, shape)
    ulp = max_ulp(got, want)
    same = float((got.view(np.uint32) == want.view(np.uint32)).mean())
    print(f"  (d) normal_torch on the card vs prng.normal (numpy), {shape}: "
          f"max {ulp} ulp (tolerance 4), {same:.2%} of lanes bitwise")
    if ulp > 4:
        fail(f"normal draws on the card {ulp} ulp from numpy's")
    return dict(arch=SERVE_ARCH, params=n_params, batch=B, prompt=S,
                new_tokens=new, launches=counts, wall_ms=wall_ms,
                run_prefill_ms=run_times[0], run_decode_ms=run_times[1],
                prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
                prefill_ms_samples=prefill_samples,
                decode_ms_samples=step_samples, trace=trace,
                plain_prefill_ms=plain_ms, peak_bytes_run=peak_run,
                peak_bytes_prefill=peak_prefill, base_bytes_run=base_run,
                base_bytes_prefill=base_prefill,
                flash_per_prefill=per_prefill, flash_per_decode=per_decode,
                kernel_vs_plain_logits_max_abs=err_b,
                kernel_vs_plain_logits_rel_l2=rel_b,
                bf16_vs_f32_logits_max_abs=err_f32,
                bf16_vs_f32_logits_rel_l2=rel_f32, top1_equal_rows=top1,
                reduced_card_vs_cpu_max_abs=err_c, reduced_gen_equal=same_gen,
                normal_max_ulp=ulp, normal_bitwise_share=same)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no GPU to run on")
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import quantize as q_mod
    from repro_torch.kernels import safl_agg as k_mod
    wrappers = {**k_mod.KERNELS, **q_mod.KERNELS, **fa_mod.KERNELS}
    if sorted(wrappers) != sorted(KERNELS):
        fail(f"kernel wrappers {sorted(wrappers)} are not {sorted(KERNELS)}")

    print("== phase 1: device")
    smi = smi_line()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"python {sys.version.split()[0]}  device {kind}  "
          f"count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    print("TF32: cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False; "
          f"cudnn.deterministic={torch.backends.cudnn.deterministic}, "
          f"cudnn.benchmark={torch.backends.cudnn.benchmark}")

    print("== phase 2: build (one nvcc per source, started together)")
    t0 = time.perf_counter()
    built = SOURCES + VARIANT_SOURCES
    with ThreadPoolExecutor(len(built)) as pool:
        infos = dict(zip(built, pool.map(build.compile_source, built)))
    build_s = time.perf_counter() - t0
    for info in infos.values():
        rel = os.path.relpath(info["path"], ROOT)
        print(f"  {rel}: built before this run, its ptxas report read back"
              if info["cached"] else
              f"  built {rel} in {info['seconds']:.2f} s")
        if info["log"]:
            print("  " + info["log"].replace("\n", "\n  "))
    print(f"  build wall {build_s:.2f} s")
    spilled = spills(infos["flash_attention"]["log"], FLASH_SYMBOL)
    print(f"  {FLASH_SYMBOL}: {len(spilled)} instantiations, spill "
          f"bytes {sorted(spilled.values())} (tolerance: 0)")
    if not spilled or any(spilled.values()):
        fail(f"{FLASH_SYMBOL} spills or is missing from the ptxas report")
    spilled = spills(infos["safl_agg"]["log"], "topk_kernel")
    print(f"  top-k kernels: {len(spilled)} instantiations, spill bytes "
          f"{sorted(spilled.values())} (tolerance: 0)")
    if len(spilled) != 2 or any(spilled.values()):
        fail("the top-k kernels spill or are missing from the ptxas report")
    # the f32 screen's two load paths, the quantized folds' two beta
    # variants each, the q4 aggregate's one shape
    for symbol, n in (("screen_f32_kernel", 2), ("fold_q4_kernel", 2),
                      ("fold_q8_kernel", 2), ("aggregate_q4_kernel", 1)):
        spilled = spills(infos["safl_agg"]["log"], symbol)
        print(f"  {symbol}: {len(spilled)} instantiations, spill bytes "
              f"{sorted(spilled.values())} (tolerance: 0)")
        if len(spilled) != n or any(spilled.values()):
            fail(f"{symbol} spills or is missing from the ptxas report")

    # device memory each phase leaves allocated once its garbage is
    # collected (phase 7's peaks include what is left when it starts)
    allocated = {}

    def left(phase):
        gc.collect()
        allocated[phase] = torch.cuda.memory_allocated()
        print(f"  allocated after phase {phase}: "
              f"{allocated[phase] / 2**30:.3f} GiB")

    print("== phase 3: kernels against their plain versions; q4 draws; "
          "flash attention")
    check_rows = []
    worst = check_kernels(torch, k_mod, check_rows)
    check_screens(torch, k_mod, check_rows, worst)
    for wire in ("q4", "q8"):
        check_fold_q(torch, k_mod, check_rows, worst, wire)
    check_aggregate_q4(torch, k_mod, check_rows, worst,
                       ctypes.CDLL(infos["aggregate_variants"]["path"]))
    check_topk(torch, k_mod, check_rows, worst)
    check_int8(torch, q_mod, check_rows, worst)
    check_draws(torch, check_rows)
    check_flash(torch, fa_mod, check_rows, worst)
    left(3)

    print("== phase 4: timings (L2 flushed before each launch)")
    timing, floor_ms = time_kernels(torch, k_mod, q_mod, fa_mod)
    one_launch = check_one_launch(torch, k_mod)
    codec_ms = time_codec(torch)
    left(4)

    print("== phase 5: engine on the card vs the CPU, small size; q4 and "
          "top-k codecs, server channels and pytree compression at full "
          "width")
    small = check_engine_small(torch)
    codec = check_codec(torch)
    channels = check_channels(torch)
    pytree = check_pytree(torch, q_mod)
    left(5)

    print(f"== phase 6: main path, full-width CNN (D = {D_FULL:,}), "
          f"{len(MAIN_SETTINGS)} settings; the compression path")
    main_rows, launches = run_main_path(torch, wrappers)
    compression = run_compression_path(torch, q_mod, wrappers)
    for name in INT8_KERNELS:
        launches[name] = compression["launches"][name]
    left(6)

    print(f"== phase 7: serving, full-width {SERVE_ARCH} (B = {SERVE_BATCH}, "
          f"prompt {SERVE_PROMPT}, {SERVE_NEW} greedy tokens)")
    serving = run_serve(torch, fa_mod, wrappers)
    launches["flash_attention"] = serving["launches"]["flash_attention"]

    kernels = [dict(
        name=name, route="cuda",
        source=f"src/repro_torch/kernels/csrc/{SOURCE_OF[name]}.cu",
        replaces=REPLACES[name],
        launches=launches[name], max_abs_err=worst[name],
        ms=timing[name]["ms"], plain_ms=timing[name]["plain_ms"],
        bound_ms=timing[name]["bound_ms"],
        bound_by=timing[name]["bound_by"],
        library_ms=timing[name]["library_ms"]) for name in KERNELS]
    device = {"platform": "gpu", "kind": kind,
              "count": torch.cuda.device_count()}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(dict(smi=smi, torch=torch.__version__,
                       cuda=torch.version.cuda, build_s=build_s,
                       checks=check_rows, timing=timing,
                       timer_floor_ms=floor_ms, codec_ms=codec_ms,
                       one_launch=one_launch,
                       small=small, codec=codec, channels=channels,
                       pytree=pytree, main_path=main_rows,
                       compression_path=compression, serving=serving,
                       allocated_bytes=allocated, kernels=kernels, device=device), f, indent=1,
                  default=str)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
