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
     ``flash_attention.cu``, ``int8dot.cu``, and ``aggregate_variants.cu``
     and ``quantize_variants.cu``, the q4 and q8 aggregates' and
     quantize's parent designs), started together; the ptxas report must
     show no spills in the bf16 flash kernel (``FLASH_SYMBOL``), the two
     top-k kernels, the f32 screen, the q4 and q8 folds, the q4 and q8
     aggregates, the int8 pair's B = 512 kernels and the two int8-dot
     kernels
  3. each of the nine aggregation kernels (f32, q8 and packed-int4 q4
     rows) against its plain PyTorch version on the card, at the main
     path's shapes (D = 2,154,730, Dq = 2,155,008, K = 4) and at a
     ragged D = 4099 (Dq = 4608) with K = 3, in every mode, discount and
     beta, the q4 rows holding -8 nibbles (a 0x55-flipped span), and
     the f32 fold in place into an odd bank row (d lanes into a (2, d)
     buffer: 8-byte aligned at the main D, 4-byte at the ragged one):
     bitwise, except the poly discount (``powf``): ``rtol=1e-5,
     atol=1e-6``; ``safl_fold``, ``safl_aggregate`` (fedsgd and avg)
     and ``safl_fold_q8`` bitwise at the other models' D (11,173,962
     and 15,240,906), as their main path calls them.  The three
     screens at the same D and Dq with K = 1, 3
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
     ``safl_aggregate_q4`` and ``safl_aggregate_q8`` in every mode x
     discount at K = 1, 4 and 16, both Dq, rows and p aligned and 1 byte
     / 1 lane off (the q8 rows holding -128 and +-127 bytes): bitwise the
     plain version (discount none) or the parent kernel (poly).  The q4 wire's stochastic-rounding draws made
     on the card (``prng.uniform_torch``) against the numpy threefry at
     the paper CNN's (4209, 512): bitwise.  The two top-k kernels at the main
     path's K = 4, nk = 215,552 (rows colliding on a coordinate in 4 and
     in 3 uploads), at K = 17 there (more rows than the K-row sum loads
     ahead) and at the ragged D with K = 3, nk = Dq (pad lanes ranked)
     and an empty row: the fold at beta 1 and 0.7, in place and not, the
     K-row sum, and the chain of in-place folds against the K-row sum,
     bitwise; and on copies of the rows one lane off (idx and qv, then
     idx alone), bitwise the aligned calls.  The int8 pair at (4209,
     512) and 37 rows: quantize with a zero row, exact .5 ties, a NaN and
     a -Inf row, bitwise (NaN scales in the same rows); dequantize with
     levels -128 and +-127, a zero row and scales NaN, Inf, -Inf, 0 and
     negative, every non-NaN lane bitwise and NaN lanes in the same
     places; each on its B = 512 path, on a copy one element in and at
     B = 100 (the general path).  The int8-dot kernel of the q8 round's
     large-K regime at the CNN's D for K = 32, 33, 64 and 128, its
     coefficient scales made and given (the mesh's form), and at the odd
     D = 4099 with K = 64 and at qblock 64: bitwise; rows one byte in
     refused.
     Flash attention in f32 and bf16, causal and not, at the
     reference test sweep's shapes, the full-width qwen3 prefill's (B 8,
     S 1024, H 16, Hkv 8, hd 128), a ragged S = 200 and two odd H / Hkv
     (S = 200 at hd 128, S = 130 at hd 64), zamba2's hd 80 (H 32 /
     32) and kimi-k2's hd 112 (H 64 / 8) at S = 256 and 200, and phase
     11's batched serving prefill (B 16, S 32, H 16 / 8, hd 128); and at
     every shape, causality and dtype that phase 7e's prefills launch it
     with (bf16, B 4: S 512 for eight archs, the enc-dec's encoder
     non-causal, internvl2's S 1536 after its patches): within
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
     dtype's dense peak: 67 TFLOP/s f32, 989 TFLOP/s bf16, 1,979 TOP/s
     int8), the plain
     version and, where one exists, one PyTorch library call computing
     the same function (the screens at K = 1, the path's shape, and
     K = 4; the q8 screen also over a top-k upload's values), the top-k
     kernels, the int8 pair and flash attention at the
     qwen3 prefill's shape in bf16 (f32 beside it; the library call
     ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``)
     and at zamba2's shared-attention prefill (B 4, S 512, H 32 / 32,
     hd 80, bf16), and the int8-dot kernel at K = 32, 64 and 128 beside
     ``safl_aggregate_q8`` (fedsgd) on the same rows;
     the parent designs of the q8 aggregate (fedsgd and avg), of
     quantize and of dequantize beside the package's kernels, through
     ``ctypes``;
     3 calls of each screen (f32, q8, q4; K = 1), of the q4, q8 and top-k
     folds (beta 1, in place), of the q4 and q8 aggregates (K = 4,
     fedsgd), of quantize and dequantize at (4209, 512) and
     of the top-k K-row sum (K = 4) captured into a CUDA
     graph, whose nodes (read through libcuda's graph API) must be one
     launch of the kernel a call and nothing else (no memset; the K-row
     sum's launch cooperative), its replay equal to the eager outputs,
     and one ``torch.profiler`` pass over 3 calls of each, which must show
     the same where it sees any device activity;
     and the codec's time per upload: the q4 draws alone and the
     whole q4 quantize, the top-k ranking alone and the whole top-k
     upload; and ``safl_fold``, ``safl_aggregate`` (fedsgd, K = 4) and
     ``safl_fold_q8`` at the full-width ResNet-18's and VGG-16's D
     (11,173,962 and 15,240,906)
  5. the engine on the card against the engine on the CPU at a small size:
     the sequential engine in AS, SS, AS-fedasync, SS-sdga, AS-q8,
     SS-sdga-q8, AS-q4, SS-sdga-q4, AS-topk, SS-topk, AS-sdga-topk,
     SS-sdga-topk, with faults and the screen, AS-chaos-screen and
     its q8 and q4 siblings, and the scheduler's AS-markov-seafl (Markov
     availability, staleness cap 1) and AS-fedbuff-timeout-ratelimit (a
     timeout horizon of about k arrivals, 2 admitted a round); the
     batched engine (``vmap`` waves on the card, ``map`` on the CPU) in
     AS, SS, AS-fedasync, AS-q8, SS-q4, AS-topk, AS-chaos-screen and the
     same two scheduler settings, on a schedule that puts clients twice
     into a horizon (exact bytes, schedule, staleness bins, wave sizes,
     fault / defense counts and the rejected, idle and no-show counts;
     params within ``rtol=1e-4, atol=1e-5``
     on f32 and within 2e-2 of the run's own movement on q8, q4 and
     top-k); the q4 and top-k codecs on the card
     against the CPU on full-width uploads (bitwise); the server's
     streaming channel against its buffered one at full width in all six
     aggregation modes on f32, q8 and q4 and the four gradient modes on
     top-k, with clean rows and with corrupted and Byzantine rows
     screened or clipped (``FlatServer.screen`` -> ``defense_factors`` ->
     skip / fold at w*fac against zeroed rows / facs in the weights),
     bitwise; ``quantize_pytree`` / ``dequantize_pytree`` of the
     full-width CNN's parameters on the card against the CPU, bitwise;
     and the paper's other models on the card against the CPU:
     ResNet-18 (width 4, 16x16), VGG-16 (width 1/8, 32x32), the LSTM's
     sentiment head (Sentiment140, ``lognormal_text``) and char head
     (Shakespeare, ``by_role``) at embed 32, hidden 64: one SGD step
     from the same weights (logits in train and eval, params and
     BatchNorm state within ``rtol=1e-4, atol=1e-5``), then AS and SA
     (ResNet-18 also AA on q8, its state on the q8 wire) on the
     sequential and the batched engine (``auto`` waves on both devices),
     3 rounds, both engines free-running (a conv model's CPU run takes
     the card run's ReLU, max-pool and q8 ``round`` branches,
     ``repro_torch.models.kinks``): bytes, schedule, staleness and waves
     exact, params within the bounds above, the global BatchNorm state
     within ``rtol=1e-4, atol=1e-5``, each unit that the CPU would have
     put on the other side of a branch within 1e-3 of its branch point;
     and the paper's four settings on the sequential engine for 10 rounds
     on the card against the CPU taking the card's branches: bytes,
     schedule, staleness and simulated times exact, params within
     ``rtol=1e-4, atol=1e-5``
  6. the main path at full width on the batched engine (``fl_sim``'s
     default; ``wave_impl="auto"`` runs ``map`` waves for the CNN): the
     paper CNN (width 32, 32x32 images,
     D = 2,154,730) on synthetic CIFAR-10, 2000 samples, 16 clients,
     k = 4, hetero-Dirichlet alpha 0.3, 5 rounds in each of 33 settings
     (the paper's AS, AA, SS, SA; AS and SS with fedbuff, fedasync,
     fedopt and sdga; AS, AA, SS, SA and SS-sdga on the q8 and on the q4
     wire, AS-fedasync on q4; AS, SS, AS-fedbuff and SS-sdga on top-k;
     AS under the fault mix with the screen on f32, q8, q4, top-k and the
     buffered channel; AS-fedbuff with Byzantine uploads clipped; the
     scheduler's AS-lognormal-fedqs, AS-markov-seafl-q8, AS-uniform
     (C = 8), AS-fedbuff under a timeout horizon of about k arrivals
     with ratelimit 2, AS-hybrid-q4, AA-queue on the buffered channel
     (queue 2) and SS-lognormal), with every
     launch counter reset before each setting and read after, each
     setting's launches held to the counts it names (a screen launches
     once a wave, a fold once an ADMITTED upload: none for a rejected,
     idled, crashed or no-show event), every drawn fault
     kind and every setting's verdict (seafl and uniform reject,
     ratelimit idles, Markov no-shows) fired, the admitted uploads and
     arrivals per horizon printed, ``screened == corrupted`` under the
     screen,
     ``clipped >= byzantine`` under clip, and finite params after every
     round; each setting then runs again from a fresh engine, which must
     repeat the first run bit for bit (final flat params bitwise; every
     round's accuracy and loss, bytes, participation, staleness,
     waves, launches and fault counts equal); each setting then runs once
     on the sequential engine (``batch_clients=False``), checked the same
     way with a screen launched once an upload, its bytes, uploads,
     participation, staleness, simulated times, fault and verdict counts
     equal to the batched run's and its params within phase 5's bounds
     of them; then kill and resume on both engines (AS-markov-seafl-q8
     and AS-lognormal-q4: a snapshot under ``chiprun_out/`` at round 2,
     loaded by a fresh engine that runs to round 5, which must end
     bitwise where the uninterrupted run ends; the snapshot's bytes and
     save / load seconds printed); then the
     paper's four settings once on the batched engine with ``vmap``
     waves, checked the same way, and the three engines' wall split
     (client_train, server_ingest, server_round, eval) printed on a line
     each; then the int8 pair's own path,
     the compression helpers over
     the full-width CNN's parameters, its counters reset before and read
     after (one launch of each kernel per leaf); then the paper's other
     models at full width, each in the paper's four settings for 3
     rounds on the batched engine (ResNet-18 also AA on q8): ResNet-18
     (width 64, D = 11,173,962, 9,600 state floats in 40 leaves) and
     VGG-16 (width 1, D = 15,240,906) on 32x32 CIFAR-10, the LSTM at
     the reference's defaults (embed 64, hidden 128; char D = 114,256,
     sentiment D = 163,074) on Shakespeare / Sentiment140; 2000 samples,
     16 clients, k = 4; launch counts held (a fold an upload, an
     aggregate a sync round), finite params and state after every round,
     a second run from a fresh engine bitwise the first (params, state,
     every record), each setting's wall split printed
  6b. the main path traced (``repro_torch.obs``, level ``upload``, in
     memory): AS-chaos-screen-q8, AS-markov-seafl-q8,
     AS-fedbuff-timeout-ratelimit and SS-lognormal on the batched engine
     (``map`` waves) and on the sequential engine, each checked as phase 6
     checks it and held bitwise to phase 6's untraced run of the same
     setting and engine (params, bytes, staleness, verdict and fault
     counts, launches, every record), its wall printed beside the
     untraced run's (the tracer's overhead); the two engines' canonical
     streams equal; the stream equal to a width-1 CPU run's on every key
     that does not scale with the width (``fac`` and ``w`` within
     ``atol=1e-5``); the ingest bytes summing to ``tx_bytes``, the
     scheduler's instants counting its rejected, idled, no-show and
     crashed totals, the Chrome export valid, one ``metrics_ring.flush``
     a batched semi-async run and none otherwise; then one untraced run
     of AS-markov-seafl-q8 plain and under ``torch.profiler`` (the
     device events, merged, over the wall: the FL engine's busy share;
     where the profiler sees none, CUDA event pairs around every op read
     it without CUPTI), its Chrome trace in
     ``chiprun_out/torch_profile/``
  6c. the mesh (``repro_torch.sharding.flat``), every shard on the one
     card (``[cuda:0] * N``): ``FlatServer`` on the (2, 2), (1, 4) and
     ``devices=2`` meshes at the CNN's full D, K = 4, in every mode x
     wire (top-k: the gradient modes), bitwise the same round on the CPU
     (params and slow state), the counters showing one ``sum`` partial
     launch a shard (fedasync: K folds); then the full-width CNN in AS,
     SS, AS-q8 and SS-q4 on the batched engine for 5 rounds: the
     single-device run again with its ReLU / max-pool / ``round``
     branches recorded (``repro_torch.models.kinks``), bitwise phase 6's
     run; the (2, 2) mesh taking those branches, its bytes, uploads,
     staleness and simulated times phase 6's, its params within phase
     5's bounds of phase 6's, run twice (the repeat bitwise);
     ``devices=4`` free-running (one row a shard, so the shards add in
     the single device's order): bitwise phase 6's run; ``mesh_shape=(1,
     4)`` bitwise ``devices=4``; AS also on the sequential engine, the
     (2, 2) mesh on the sequential single-device run's branches; every
     launch counter reset before each mesh run and read after (a fold an
     admitted upload, one partial a shard a sync round), each run's
     wall split and the traffic record printed
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
     made on the card against numpy's, bitwise
  7e. the zoo: ``serve.run`` of each of the nine other architectures
     from ``prng_key(0)`` at full width (``ZOO_FULL_DEPTH`` at full depth,
     ``ZOO_DEPTH`` served as the same config with fewer layers, listed as
     ``reduced``), B = 4 prompts of 512 tokens (the VLM's 1024 patch
     embeddings before them), 16 greedy tokens, every launch counter
     reset before and read after (flash attention once per
     self-attention layer of the prefill: the decoder LMs' layers, the
     hybrid's groups, the enc-dec's encoder and decoder layers; none in
     the xLSTM), then ``serve.generate`` run again on the same model and
     inputs and timed warm (prefill ms, decode ms per token, flash
     launches per serve, peak GiB); then each of the ten reduced
     configs (f32, TF32 off, B = 4, prompt 192, 8 new tokens) served on
     the card against the CPU: the same greedy tokens, logits within
     ``SERVE_F32_TOL``; xlstm-125m and granite-moe-1b-a400m sampled at T
     = 0.8 on both, the same tokens, the card's Gumbel noise within 1 ulp
     of the CPU's
  8. the training path: (a) ``repro_torch.launch.train.run`` of the
     full-width qwen3-1.7b (28 layers, f32 params, bf16 compute, AdamW,
     remat, weights from ``prng_key(0)``), B = 4 x 1024 tokens of the
     synthetic stream, 6 steps, the launch counters reset before and
     read after (training launches no kernel of the port: its attention
     is the PyTorch form, never flash), every loss finite, each step's
     loss, the median step time without the first, tokens/s and the
     peak memory printed beside the card's name and power limit; then
     the same run again, its losses and params bitwise the first's; then
     a step's split, ``value_and_grad`` against the AdamW update (medians
     of 3), and one step under ``torch.profiler`` (busy share, GEMM
     time, the top kernels);
     (b) ``launch.steps.make_fl_train_step`` at qwen3-1.7b's full width
     cut to 8 of its 28 layers (``reduced``), 2 pods, fedsgd (1 inner
     step) and fedavg (2), weights (1, 1) and (1, 0), 2 rounds each of B
     = 8 x 256 timed (round time; the peak memory read after them),
     then a third round whose ``safl_aggregate`` output is held bitwise
     against the plain version on the same rows: exactly one
     ``safl_aggregate`` launch a round, the pods in sync (drift 0),
     finite losses; (c) the ten reduced
     configs (f32, TF32 off, B = 4 x 64, 2 steps) on the card against
     the CPU: at each step the loss and metrics within 1e-5 relative and
     every gradient leaf within 1e-4 of the CPU's largest, both devices
     then updated with the CPU's gradients: params and optimizer state
     within ``rtol=1e-5, atol=1e-6`` (bitwise expected: the optimizer's
     FMAs round from f64 on both devices); (d) the flash wrapper raises on a
     differentiable bf16 input and launches nothing
  9. the dry run (``repro_torch.launch.dryrun``, on the meta device, no
     GPU): (a) ``run_pair`` of one pair of each kind (``DRYRUN_PAIRS``:
     train, prefill, decode and long-context decode over four families,
     seamless' sanctioned long_500k SKIP among them) on both production
     meshes, records into ``chiprun_out/dryrun_torch``; a FAIL fails the
     script; (b) its accounting held against one more, untimed step on
     the card: phase 8a's full-width qwen3-1.7b, B = 4 x 1024 tokens of
     the same stream (int32, as the dry run's specs), AdamW, on a
     one-device mesh: the record's FLOPs exactly a ``FlopCounterMode``
     count around the card step, its ``memory.argument_size_B`` exactly
     the bytes of the real params, optimizer state and batch (nothing
     else allocated), and its ``peak_live_B_global`` against
     ``torch.cuda.max_memory_allocated()`` over the step, the ratio
     within ``DRYRUN_PEAK_RATIO``
  10. the q8 round's large-K int8-dot regime, ``REPRO_INT8_DOT=1`` set in
     the process and removed after: (a) the full-width CNN (phase 6's
     setup with 64 clients), sync, q8 wire, K = 64, 3 rounds of fedsgd
     and fedavg: one int8-dot launch a round and no fused q8 aggregate,
     every other counter 0; (b) ``fl_sim --mode sync --wire q8 --clients
     64 --k 64`` the same; (c) both settings at phase 5's size card
     against CPU (host fields equal, params within ``REGIME_CPU_RTOL`` of
     the run's movement); (d) the server round at the CNN's D on one
     device and on the (2, 2) mesh, every shard on cuda:0: card bitwise
     the CPU, the mesh within ``REGIME_MESH_LEVELS`` coefficient levels
     of the single device; (e) the variable unset: the same fedsgd run
     makes no int8-dot launch
  11. the examples: ``examples/torch_serve_batched.py`` with its
     defaults, and its loop on the full-width qwen3-1.7b (16 requests of
     8-32 tokens, 48 new, one flash launch a layer); and
     ``examples/torch_distributed_pretrain.py`` under fedsgd and fedavg,
     20 steps each, one ``safl_aggregate`` launch a step, drift 0

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  A copy of every number goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import collections
import contextlib
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
INT8_OPS = 1979e12  # H100 SXM dense int8 on the tensor cores
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
           "flash_attention", "weighted_sum_q8_int8dot")
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
            "flash_attention": "src/repro/kernels/flash_attention.py:76",
            # not a TPU kernel: the reference's XLA int8 einsum
            "weighted_sum_q8_int8dot": "src/repro/kernels/ref.py:224"}
#: the CUDA sources, each built by its own nvcc, all started together
SOURCES = ("safl_agg", "quantize", "flash_attention", "int8dot")
#: other designs built beside them: the q4 and q8 aggregates' parent
#: kernels, which phase 3 holds the new ones against under the poly
#: discount, and the quantize kernel's; phase 4 times the parents
VARIANT_SOURCES = ("aggregate_variants", "quantize_variants")
INT8_KERNELS = ("quantize_int8", "dequantize_int8")
#: the source of each kernel: the int8 pair in csrc/quantize.cu, flash
#: attention in csrc/flash_attention.cu, the int8-dot reduction in
#: csrc/int8dot.cu, every other in csrc/safl_agg.cu
SOURCE_OF = {name: "quantize" if name in INT8_KERNELS else
             name if name == "flash_attention" else
             "int8dot" if name == "weighted_sum_q8_int8dot" else "safl_agg"
             for name in KERNELS}
SDGA_KW = dict(server_lr=0.05, momentum=0.8, ema_anchor=0.05,
               ema_decay=0.95)
AGGREGATIONS = ("fedsgd", "fedavg", "fedbuff", "fedopt", "sdga", "fedasync")
FAULT_COUNTS = ("crashed_uploads", "corrupted_uploads", "byzantine_uploads",
                "screened_uploads", "clipped_uploads")
#: the scheduler's verdict counts (a crash is counted in FAULT_COUNTS)
SCHED_COUNTS = ("rejected_uploads", "idle_requests", "no_shows")
#: a clock horizon's ``horizon_timeout_s`` placeholder: resolved per setup
#: to the time K uploads take to arrive (:func:`resolve_timeout`)
K_ARRIVALS = "k-arrivals"
#: the scheduler settings' Markov + seafl: 30 % of transitions go offline,
#: staleness above 2 is rejected (both fire within 5 rounds at full width)
MARKOV_SEAFL = dict(sched_timing="markov", sched_drop_p=0.3,
                    sched_policy="seafl", sched_stale_cap=2)
#: the fault mix of the fault settings; fault_seed 19 fires every kind
#: within 5 rounds on phase 6's schedule (crash 1, straggler 4, corrupt 3,
#: byzantine 2: the schedule depends on the seeds, clients and counters
#: only, so it was read off the scheduler on the CPU)
CHAOS = dict(fault_crash_p=0.1, fault_straggler_p=0.1, fault_corrupt_p=0.15,
             fault_byzantine_p=0.05, fault_seed=19)
FAULT_KINDS = {"fault_crash_p": "crash", "fault_straggler_p": "straggler",
               "fault_corrupt_p": "corrupt", "fault_byzantine_p": "byzantine"}
#: phase 6: (name, paper setting, FLConfig overrides, the launches each
#: kernel must make on the batched engine: "uploads" (admitted uploads),
#: "uploads-screened", "waves" (the wave calls the engine reports: a
#: screen launches once a wave), or a count); every other counter must
#: stay 0.  ``defense="clip"`` gets its norm cap from a first clean round
#: (3x the median upload norm).
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
     {"screen_rows": "waves", "safl_fold": "uploads-screened"}),
    ("AS-chaos-screen-q8", "AS", dict(CHAOS, defense="screen", wire="q8"),
     {"screen_rows_q8": "waves", "safl_fold_q8": "uploads-screened"}),
    ("AS-byz-clip", "AS", {"aggregation": "fedbuff", "fault_byzantine_p": 0.2,
                           "defense": "clip"},
     {"screen_rows": "waves", "safl_fold": "uploads"}),
    ("AS-chaos-screen-buffered", "AS",
     dict(CHAOS, defense="screen", server_channel="buffered"),
     {"screen_rows": "waves", "safl_aggregate": ROUNDS}),
    ("AS-q4", "AS", {"wire": "q4"}, {"safl_fold_q4": "uploads"}),
    ("AA-q4", "AA", {"wire": "q4"}, {"safl_fold_q4": "uploads"}),
    ("SS-q4", "SS", {"wire": "q4"}, {"safl_aggregate_q4": ROUNDS}),
    ("SA-q4", "SA", {"wire": "q4"}, {"safl_aggregate_q4": ROUNDS}),
    ("SS-sdga-q4", "SS", {"wire": "q4", "aggregation": "sdga"},
     {"sdga_aggregate_q4": ROUNDS}),
    ("AS-fedasync-q4", "AS", {"wire": "q4", "aggregation": "fedasync"},
     {"safl_fold_q4": "uploads"}),
    ("AS-chaos-screen-q4", "AS", dict(CHAOS, defense="screen", wire="q4"),
     {"screen_rows_q4": "waves", "safl_fold_q4": "uploads-screened"}),
    ("AS-topk", "AS", {"wire": "topk"}, {"safl_fold_topk": "uploads"}),
    ("SS-topk", "SS", {"wire": "topk"}, {"safl_aggregate_topk": ROUNDS}),
    ("AS-fedbuff-topk", "AS", {"wire": "topk", "aggregation": "fedbuff"},
     {"safl_fold_topk": "uploads"}),
    ("SS-sdga-topk", "SS", {"wire": "topk", "aggregation": "sdga"},
     {"safl_aggregate_topk": ROUNDS}),
    ("AS-chaos-screen-topk", "AS",
     dict(CHAOS, defense="screen", wire="topk"),
     {"screen_rows_q8": "waves", "safl_fold_topk": "uploads-screened"}),
    # the scheduler's timings, policies and horizons: a fold an ADMITTED
    # upload, nothing for a rejected, idled, crashed or no-show event
    ("AS-lognormal-fedqs", "AS",
     {"sched_timing": "lognormal", "sched_policy": "fedqs"},
     {"safl_fold": "uploads"}),
    ("AS-markov-seafl-q8", "AS", dict(MARKOV_SEAFL, wire="q8"),
     {"safl_fold_q8": "uploads"}),
    ("AS-uniform", "AS", {"sched_policy": "uniform", "sched_c": 8},
     {"safl_fold": "uploads"}),
    ("AS-fedbuff-timeout-ratelimit", "AS",
     {"aggregation": "fedbuff", "horizon": "timeout",
      "horizon_timeout_s": K_ARRIVALS, "sched_policy": "ratelimit",
      "sched_rate_limit": 2},
     {"safl_fold": "uploads"}),
    ("AS-hybrid-q4", "AS",
     {"wire": "q4", "horizon": "hybrid", "horizon_timeout_s": K_ARRIVALS},
     {"safl_fold_q4": "uploads"}),
    ("AA-queue-buffered", "AA",
     {"horizon": "queue", "horizon_queue": 2, "server_channel": "buffered"},
     {"safl_aggregate": ROUNDS}),
    ("SS-lognormal", "SS", {"sched_timing": "lognormal"},
     {"safl_aggregate": ROUNDS}),
)
#: each of these settings must fire its verdict in a run: (field, value,
#: the count that must not be 0)
VERDICT_FIRES = (("sched_policy", "seafl", "rejected_uploads"),
                 ("sched_policy", "uniform", "rejected_uploads"),
                 ("sched_policy", "ratelimit", "idle_requests"),
                 ("sched_timing", "markov", "no_shows"))
#: phase 6: kill and resume on the card, both engines: a snapshot under
#: chiprun_out/ at round RESUME_AT, a fresh engine loads it and runs on
RESUME_AT = 2
RESUME_SETTINGS = (
    ("AS-markov-seafl-q8", "AS", dict(MARKOV_SEAFL, wire="q8")),
    ("AS-lognormal-q4", "AS", {"sched_timing": "lognormal", "wire": "q4"}))
#: phase 6: the paper's four settings, run again on the batched engine
#: with ``vmap`` waves (the default on the card is ``map``), their wall
#: split printed beside the ``map`` and sequential engines'
PAPER_SETTINGS = tuple(row for row in MAIN_SETTINGS
                       if row[0] in ("AS", "AA", "SS", "SA"))
#: phase 5: the batched engine on the card (vmap) against the CPU (map);
#: short uploads and spread speeds put clients twice into a horizon, so
#: the waves past the first run
BATCHED_SMALL = (
    ("AS", "AS", {}), ("SS", "SS", {}),
    ("AS-fedasync", "AS", {"aggregation": "fedasync"}),
    ("AS-q8", "AS", {"wire": "q8"}), ("SS-q4", "SS", {"wire": "q4"}),
    ("AS-topk", "AS", {"wire": "topk"}),
    ("AS-chaos-screen", "AS", dict(CHAOS, defense="screen")),
    ("AS-markov-seafl", "AS", dict(MARKOV_SEAFL, sched_stale_cap=1)),
    ("AS-fedbuff-timeout-ratelimit", "AS",
     {"aggregation": "fedbuff", "horizon": "timeout",
      "horizon_timeout_s": K_ARRIVALS, "sched_policy": "ratelimit",
      "sched_rate_limit": 2}))
BATCHED_SCHEDULE = dict(speed_sigma=1.5, comm_mean_s=0.05)
#: phase 5: the paper's four settings held past 3 rounds, card against
#: the CPU taking the card's branches
LONG_ROUNDS = 10
#: the traced phase (6b): the paper's four fault / scheduler settings
#: traced at level "upload" on both engines
TRACED_SETTINGS = ("AS-chaos-screen-q8", "AS-markov-seafl-q8",
                   "AS-fedbuff-timeout-ratelimit", "SS-lognormal")
#: phase 6c: the mesh runs' settings: (name, paper setting, FLConfig
#: overrides, the launches each kernel must make: "uploads", or
#: "shards" = one partial a shard a sync round)
MESH_SETTINGS = (
    ("AS", "AS", {}, {"safl_fold": "uploads"}),
    ("SS", "SS", {}, {"safl_aggregate": "shards"}),
    ("AS-q8", "AS", {"wire": "q8"}, {"safl_fold_q8": "uploads"}),
    ("SS-q4", "SS", {"wire": "q4"}, {"safl_aggregate_q4": "shards"}),
)
MESH_NAMES = tuple(row[0] for row in MESH_SETTINGS)
#: phase 6c: the meshes the server round is held on (a shape, or N)
MESH_SERVER = {"2x2": (2, 2), "1x4": (1, 4), "devices2": 2}
#: a record's keys that scale with the model's width (the payload's
#: bytes, D), left out where a stream is held to the width-1 CPU run's
WIDTH_KEYS = ("bytes", "d", "tx_bytes", "rx_bytes")
#: the paper's other three models (the LSTM with both heads), each on its
#: dataset and partition: builder, builder kwargs at phase 5's small size
#: and at phase 6's full width, the image side (images only), and the
#: full width's D and model-state floats
OTHER_MODELS = {
    "resnet18": dict(dataset="cifar10", dist=("hetero_dirichlet",
                                              {"alpha": 0.3}),
                     small=dict(width=4), small_hw=16, full=dict(width=64),
                     d_full=11_173_962, state_full=9_600),
    "vgg16": dict(dataset="cifar10", dist=("hetero_dirichlet",
                                           {"alpha": 0.3}),
                  small=dict(width_mult=0.125, image_size=32), small_hw=32,
                  full=dict(width_mult=1.0, image_size=32),
                  d_full=15_240_906, state_full=0),
    "lstm-sentiment": dict(dataset="sentiment140",
                           dist=("lognormal_text", {"sigma": 0.5}),
                           small=dict(embed=32, hidden=64), full={},
                           d_full=163_074, state_full=0),
    "lstm-char": dict(dataset="shakespeare", dist=("by_role", {}),
                      small=dict(embed=32, hidden=64, vocab=80, n_out=80),
                      full=dict(vocab=80, n_out=80), d_full=114_256,
                      state_full=0),
}
#: phase 5 and 6 settings of the other models: (name, paper setting,
#: FLConfig overrides, launches on ``OTHER_ROUNDS`` rounds); ResNet-18
#: also runs AA on q8, where its BatchNorm state rides the q8 wire
OTHER_ROUNDS = 3
OTHER_SETTINGS = {
    "AS": ("AS", {}, {"safl_fold": "uploads"}),
    "AA": ("AA", {}, {"safl_fold": "uploads"}),
    "SS": ("SS", {}, {"safl_aggregate": OTHER_ROUNDS}),
    "SA": ("SA", {}, {"safl_aggregate": OTHER_ROUNDS}),
    "AA-q8": ("AA", {"wire": "q8"}, {"safl_fold_q8": "uploads"}),
}
#: the phase-6 wall split: the engine's methods timed into each bucket
#: (the sequential engine's, then the batched engine's)
SPLIT = {"client_train": ("_run_local", "_train_wave"),
         "server_ingest": ("_enqueue_upload", "_payload_rows",
                           "_ingest_wave"),
         "server_round": ("_aggregate",),
         "eval": ("_eval_and_record", "_eval_round")}
#: the paper CNN's q4 draw per upload: (n_qblocks, qblock)
DRAW_SHAPE = (-(-D_FULL // QB), QB)
#: kept coordinates of a full-width top-k upload at the default
#: topk_frac 0.1: ceil(0.1 * D) = 215,473 rounded up to whole blocks
NK_FULL = 421 * QB
#: the aggregation modes the top-k wire carries (gradient targets)
TOPK_AGGREGATIONS = ("fedsgd", "fedbuff", "fedopt", "sdga")
#: phase 3 and 4: the int8-dot kernel's row counts at the CNN's D (the
#: regime's threshold, one past it, the regime's K = 64 and twice that)
INT8DOT_K = (32, 33, 64, 128)
#: phase 10: the q8 round's int8-dot regime (REPRO_INT8_DOT=1): K = 64
#: clients, all aggregated each sync round, 3 rounds, under fedsgd (SS)
#: and fedavg (SA)
REGIME_K, REGIME_ROUNDS, REGIME_SETTINGS = 64, 3, ("SS", "SA")
#: phase 10: the card's regime runs against the CPU's at phase 5's size,
#: relative to the run's own movement (a gradient that differs in its
#: last bits can round to the next int8 level, on the wire or among the
#: coefficients): 5x the largest reading on one H100, 7.864e-4 (SA; SS
#: 4.030e-5), well inside phase 5's q8 bound of 2e-2
REGIME_CPU_RTOL = 4e-3
#: phase 10: the (2, 2) mesh round against the single device's, in
#: coefficient levels: the mesh quantizes each block's coefficients w_k *
#: s_kb on the grid of the unnormalized weights, the single device on that
#: of w / sum(w), so a coefficient may land one level apart, which moves
#: a lane by at most 127 levels of the block's coefficient scale (times
#: the server lr under fedsgd).  The reference's own bound for this
#: parity, atol = rtol = 2e-5 at D = 5000 (tests/test_multidevice.py),
#: does not hold at the CNN's D: fedavg read 8.356e-4 on one H100, 0.999
#: levels (one coefficient one level apart; fedsgd's unit weights give
#: both the same grid: 0 levels, 2.384e-7 of f32 rounding)
REGIME_MESH_LEVELS = 4
#: phase 11: the batched serving example's requests and new tokens
SERVE_BATCHED_REQUESTS, SERVE_BATCHED_NEW = 16, 48
#: phase 11: the pretraining example's steps under each aggregation
PRETRAIN_STEPS = 20
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
                (2, 200, 4, 4, 128), (1, 130, 6, 2, 64),
                # zamba2's hd 80 (32 / 32 heads) and kimi-k2's hd 112
                # (64 / 8), each also at a ragged S
                (2, 256, 32, 32, 80), (2, 256, 64, 8, 112),
                (1, 200, 32, 32, 80), (1, 200, 64, 8, 112),
                # phase 11's batched serving of the full-width qwen3: 16
                # requests left-padded to the longest prompt, 32 tokens
                (SERVE_BATCHED_REQUESTS, 32, 16, 8, 128))
#: phase 4: the zamba2 shared attention's prefill shape (B 4, prompt 512)
FLASH_HD80_SHAPE = (4, 512, 32, 32, 80)
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
#: phase 7e: the zoo's nine other architectures at full width: B 4,
#: prompt 512, 16 greedy tokens (cut from phase 7's shape so that nine
#: models stay within the script's time)
ZOO_BATCH, ZOO_PROMPT, ZOO_NEW = 4, 512, 16
ZOO_FULL_DEPTH = ("xlstm-125m", "seamless-m4t-medium",
                  "granite-moe-1b-a400m", "zamba2-2.7b", "starcoder2-3b",
                  "minitron-4b")
#: the depth each of the others is cut to (the same config with fewer
#: layers, drawn from its own key split; the card holds about 39 GiB of
#: each): internlm2 24 of 48 layers (f32),
#: internvl2 22 of 80 (bf16), kimi-k2 2 of 61 (its dense layer and one
#: MoE layer of 384 experts, bf16)
ZOO_DEPTH = {"internlm2-20b": 24, "internvl2-76b": 22, "kimi-k2-1t-a32b": 2}
#: phase 7e: the reduced configs on the card against the CPU (B x prompt
#: a multiple of the reduced MoE's groups of 64), and the archs sampled
ZOO_REDUCED_SHAPE = (4, 192, 8)
ZOO_SAMPLED, ZOO_TEMPERATURE = ("xlstm-125m", "granite-moe-1b-a400m"), 0.8
#: phase 8 (a): the full-width qwen3-1.7b trained through train.run (f32
#: params, bf16 compute, AdamW, remat), B 4 x S 1024 of the synthetic
#: stream for 6 steps, then the same run again (bitwise)
TRAIN_ARCH = "qwen3-1.7b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 1024, 6, 3e-3
#: phase 8 (b): the FL train step at qwen3-1.7b's full width, its depth
#: cut to FL_LAYERS of 28 layers; 2 pods, B 8 x S 256 a round, FL_ROUNDS
#: timed rounds of each (aggregation, inner steps, pod weights), then one
#: round that holds the aggregate against its plain version
FL_LAYERS, FL_BATCH, FL_SEQ, FL_ROUNDS = 8, 8, 256, 2
FL_SETTINGS = (("fedsgd", 1, (1.0, 1.0)), ("fedsgd", 1, (1.0, 0.0)),
               ("fedavg", 2, (1.0, 1.0)), ("fedavg", 2, (1.0, 0.0)))
#: phase 8 (c): the reduced configs trained on the card against the CPU
#: (B x S; f32, TF32 off), 2 steps; the CPU tests' bounds against the
#: reference: the loss 1e-5 relative, a gradient 1e-4 of its leaf's
#: largest, params rtol 1e-5 / atol 1e-6
TRAIN_REDUCED_SHAPE, TRAIN_REDUCED_STEPS = (4, 64), 2
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-4
TRAIN_RTOL, TRAIN_ATOL = 1e-5, 1e-6
#: phase 9 (a): one dry-run pair of each kind (arch, shape), on both
#: production meshes
DRYRUN_PAIRS = (("xlstm-125m", "train_4k"), ("qwen3-1.7b", "prefill_32k"),
                ("seamless-m4t-medium", "decode_32k"),
                ("granite-moe-1b-a400m", "long_500k"),
                ("seamless-m4t-medium", "long_500k"))
#: phase 9 (b): the bounds of the dry run's peak live bytes over the card
#: step's max_memory_allocated, set from the first reading on one H100
#: (0.9991: the card adds its cuBLAS workspace and 512-byte rounding)
DRYRUN_PEAK_RATIO = (0.99, 1.01)


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
    # the other models' main path at their full widths' D (ResNet-18's,
    # VGG-16's): the three kernels it launches, as it launches them (a
    # fold in place into the accumulator at beta 1, the K-row aggregate
    # of the sync round's two modes, the q8 fold in place)
    for d in (OTHER_MODELS["resnet18"]["d_full"],
              OTHER_MODELS["vgg16"]["d_full"]):
        u = torch.randn((K_MAIN, d), device="cuda", generator=g)
        p = torch.randn((d,), device="cuda", generator=g)
        row = p.clone()
        k_mod.safl_fold(row, u[0], 0.5, 1.0, out=row)
        compare(torch, report, worst, "safl_fold", row,
                k_mod.safl_fold_plain(p, u[0], 0.5, 1.0), True, d=d,
                in_place=True)
        for mode, kw in (("fedsgd", dict(p=p, server_lr=0.05)),
                         ("avg", {})):
            w = agg_weights(torch, K_MAIN, mode, "none", g)
            compare(torch, report, worst, "safl_aggregate",
                    k_mod.safl_aggregate(u, w, mode=mode, **kw),
                    k_mod.safl_aggregate_plain(u, w, mode=mode, **kw), True,
                    d=d, k=K_MAIN, mode=mode)
        del u, p, row
        q, s = q8_rows(torch, 1, d, g)
        acc_q = torch.randn((dq_of(d),), device="cuda", generator=g)
        row = acc_q.clone()
        k_mod.safl_fold_q8(row, q[0], s[0], 0.5, 1.0, out=row)
        compare(torch, report, worst, "safl_fold_q8", row,
                k_mod.safl_fold_q8_plain(acc_q, q[0], s[0], 0.5, 1.0), True,
                dq=dq_of(d), in_place=True)
        del q, s, acc_q, row
    # the mesh's per-shard partials (phase 6c): mode "sum" over the block
    # of K/N rows a shard holds (K = 1 on the (2, 2) mesh at k = 4, K = 2
    # on devices=2), the first and the last block of the K rows
    u = torch.randn((K_MAIN, D_FULL), device="cuda", generator=g)
    quant = {"q8": q8_rows(torch, K_MAIN, D_FULL, g),
             "q4": q4_rows(torch, K_MAIN, D_FULL, g)}
    sparse = topk_rows(torch, K_MAIN, D_FULL, NK_FULL, g)
    for k in (1, 2):
        for lo in (0, K_MAIN - k):
            w = agg_weights(torch, k, "sum", "none", g)
            block = dict(k=k, rows=f"{lo}-{lo + k - 1}", mode="sum")
            compare(torch, report, worst, "safl_aggregate",
                    k_mod.safl_aggregate(u[lo:lo + k], w, mode="sum"),
                    k_mod.safl_aggregate_plain(u[lo:lo + k], w, mode="sum"),
                    True, d=D_FULL, **block)
            for wire, (q, s) in quant.items():
                name = "safl_aggregate_" + wire
                compare(torch, report, worst, name,
                        k_mod.KERNELS[name](q[lo:lo + k], s[lo:lo + k], w,
                                            mode="sum"),
                        getattr(k_mod, name + "_plain")(
                            q[lo:lo + k], s[lo:lo + k], w, mode="sum"),
                        True, dq=dq_of(D_FULL), **block)
            rows = tuple(a[lo:lo + k] for a in sparse)
            compare(torch, report, worst, "safl_aggregate_topk",
                    k_mod.safl_aggregate_topk(*rows, w, D_FULL, qblock=QB),
                    k_mod.safl_aggregate_topk_plain(*rows, w, D_FULL,
                                                    qblock=QB),
                    True, d=D_FULL, nk=NK_FULL, **block)
    del u, quant, sparse
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


def parent_aggregate(torch, k_mod, lib, wire):
    """The q4 or q8 aggregate's parent kernel (``wire``;
    ``csrc/aggregate_variants.cu``'s ``safl_aggregate_q4_gridstride`` /
    ``safl_aggregate_q8_gridstride``, ``aggregate_kernel<Q4Rows>`` /
    ``<Q8Rows>``) as a function of the wrapper's arguments."""
    name = f"safl_aggregate_{wire}_gridstride"
    fn = getattr(lib, name)
    fn.argtypes = k_mod._lib().safl_aggregate_q4.argtypes
    fn.restype = ctypes.c_int

    def call(q, s, w, p, *, server_lr, mode, alpha, discount):
        dq = 2 * q.shape[1] if wire == "q4" else q.shape[1]
        n = p.shape[0] if mode in ("fedsgd", "mix") else dq
        out = torch.empty(n, device="cuda")
        rc = fn(q.data_ptr(), s.data_ptr(), w.data_ptr(),
                None if p is None else p.data_ptr(), out.data_ptr(),
                q.shape[0], dq, n, server_lr, alpha, k_mod.MODES[mode],
                int(discount == "poly"), QB.bit_length() - 1,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            fail(f"{name}: launch returned {rc}")
        return out
    return call


def check_aggregate_q(torch, k_mod, report, worst, variants, wire):
    """``safl_aggregate_q4`` / ``safl_aggregate_q8`` (``wire``) in every
    mode x discount at K = 1, 4 and 16, at the main path's D (Dq =
    2,155,008; fedsgd / mix over D lanes, so a tail past the last whole
    vector) and the ragged D, on the rows and p as allocated (the vector
    path, as in the engine) and on copies one byte (rows) and one lane
    (p) off (lane by lane), the q4 rows holding -8 nibbles and the q8
    rows -128 and +-127 bytes: bitwise its plain version with discount
    none; with poly weights (``powf``, within 1.9e-6 of ``torch.pow``:
    ``check_kernels`` holds that) bitwise the parent's kernel
    (``variants``: ``csrc/aggregate_variants.cu``)."""
    name = "safl_aggregate_" + wire
    kernel = k_mod.KERNELS[name]
    plain = getattr(k_mod, name + "_plain")
    parent = parent_aggregate(torch, k_mod, variants, wire)
    g = torch.Generator(device="cuda").manual_seed(9 if wire == "q4" else 10)
    for d in (D_FULL, D_RAGGED):
        dq = dq_of(d)
        p = torch.randn((d,), device="cuda", generator=g)
        if wire == "q4":
            q16, s16 = q4_rows(torch, 16, d, g, flip=True)
        else:
            q16, s16 = q8_rows(torch, 16, d, g)
            q16[:, 100:164:3] = -128
            if not ((q16 == -128).any(dim=1).all()
                    and (q16.abs() == 127).any(dim=1).all()):
                fail("the q8 rows hold no -128 or no +-127 byte")
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
                        got = kernel(qq, s, w, pp, **kw)
                        info = dict(dq=dq, k=k, mode=mode,
                                    discount=discount, rows=rows)
                        if discount == "poly":
                            want = parent(qq, s, w, pp, **kw)
                            info["vs"] = "parent kernel"
                        else:
                            want = plain(q, s, w, p, **kw)
                        compare(torch, report, worst, name, got, want, True,
                                **info)
    torch.cuda.synchronize()


def check_int8(torch, q_mod, report, worst):
    """The int8 pair against its plain versions at (4209, 512) and at a
    ragged 37 rows (each on its B = 512 path; also on a copy of the rows
    one element in, and at B = 100: the general path).  quantize with an
    all-zero row (scale 1e-12), a row of exact .5 ties, a NaN row (NaN
    scale: the absmax propagates it; its lanes store 0) and a row holding
    -Inf (Inf scale; its lanes store 0): int8 rows bitwise, scales
    bitwise with NaN in the same rows.  dequantize with levels -128 and
    +-127, a zero row and scales NaN, Inf, -Inf, 0 and negative: every
    non-NaN lane bitwise, NaN lanes in the same places (NaN x q, Inf x
    0)."""
    import math

    import numpy as np

    from repro_torch.kernels.ref import INV_127
    # row 1's absmax 127 gives it the scale fl(127 * f32(1/127)); lanes of
    # +-scale/2 then divide to exactly +-0.5 and round half to even, to 0
    s_tie = float(np.float32(127.0) * np.float32(INV_127))
    g = torch.Generator(device="cuda").manual_seed(6)
    cases = [(rows, QB, path) for rows in INT8_ROWS
             for path in ("b512", "general: x one float in")]
    cases.append((INT8_ROWS[1], 100, "general: B = 100"))
    for rows, b, path in cases:
        x = torch.randn((rows, b), device="cuda", generator=g)
        x[0] = 0.0
        x[1, 0] = 127.0
        x[1, 1::2] = 0.5 * s_tie
        x[1, 2::2] = -0.5 * s_tie
        x[2, 7] = math.nan
        x[3, 5] = -math.inf
        xin = misaligned(torch, x) if "one float in" in path else x
        q, s = q_mod.quantize_int8(xin)
        pq, ps = q_mod.quantize_int8_plain(x)
        nan_same = all(torch.equal(f(s), f(ps)) for f in (
            torch.isnan, torch.isposinf, torch.isneginf))
        fin = torch.isfinite(ps)
        compare(torch, report, worst, "quantize_int8", (q.float(), s[fin]),
                (pq.float(), ps[fin]), True, rows=rows, b=b, path=path,
                nonfinite_rows_equal=nan_same)
        if not (nan_same and bool(torch.isnan(s[2]))
                and float(s[0]) == float(np.float32(1e-12))
                and float(s[1]) == s_tie and not q[1, 1:].any()
                and not q[2].any() and math.isinf(float(s[3]))
                and not q[3].any()):
            fail(f"quantize_int8 rows={rows} b={b} {path}: zero row scale "
                 f"{float(s[0])}, tie row {q[1, :4].tolist()} scale "
                 f"{float(s[1])}, NaN row scale {float(s[2])}, -Inf row "
                 f"scale {float(s[3])}")
    # dequantize: random levels with a row of -128 and the extremes in
    # another, a zero row, scales NaN, Inf, -Inf, 0 and negative; at B =
    # 512 on the warp-a-row path (fresh q and output), on a copy of q one
    # level in and at B = 100 (the general path): bitwise, NaN lanes in
    # the same places
    dcases = [(rows, QB, path) for rows in INT8_ROWS
              for path in ("b512", "general: q one level in")]
    dcases.append((INT8_ROWS[1], 100, "general: B = 100"))
    for rows, b, path in dcases:
        q = torch.randint(-128, 128, (rows, b), dtype=torch.int8,
                          device="cuda", generator=g)
        q[0] = -128
        q[1, :4] = torch.tensor([-128, 127, -127, 0], dtype=torch.int8)
        q[5] = 0
        s = torch.rand((rows,), device="cuda", generator=g) * 2.0 + 1e-4
        s[2], s[3], s[4] = math.nan, math.inf, -math.inf
        s[5], s[6] = 0.0, -0.25
        qin = misaligned(torch, q) if "one level in" in path else q
        got = q_mod.dequantize_int8(qin, s)
        want = q_mod.dequantize_int8_plain(q, s)
        nan_same = torch.equal(torch.isnan(got), torch.isnan(want))
        live = ~torch.isnan(want)
        compare(torch, report, worst, "dequantize_int8",
                got[live].view(torch.int32), want[live].view(torch.int32),
                True, rows=rows, b=b, path=path, nan_lanes_equal=nan_same)
        if not (nan_same and bool(torch.isnan(got[2]).all())
                and float(got[0, 0]) == -128.0 * float(s[0])
                and bool(torch.isnan(got[3][q[3] == 0]).all())
                and bool(torch.isinf(got[4][q[4] != 0]).all())):
            fail(f"dequantize_int8 rows={rows} b={b} {path}: NaN lanes "
                 f"equal {nan_same}, -128 row {float(got[0, 0])}")
    torch.cuda.synchronize()


def check_int8dot(torch, i8_mod, report, worst):
    """The int8-dot kernel against its plain version: at the CNN's D
    (Dq = 2,155,008, its last block 234 lanes of 512 and the rest
    padding) for each K of :data:`INT8DOT_K`, with the coefficient scales
    the kernel makes and with given ones (the mesh's form: 1.5 times the
    rows' own, so every level moves); at the odd D = 4099 with K = 64 and
    read as qblock 64 (16 threads a block): bitwise; a copy of those rows
    one byte in is refused without a launch."""
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(11)
    name = "weighted_sum_q8_int8dot"

    def held(q, s, w, qblock=QB, cs=None, **info):
        compare(torch, report, worst, name,
                i8_mod.weighted_sum_q8_int8dot(q, s, w, qblock, cs),
                i8_mod.weighted_sum_q8_int8dot_plain(q, s, w, qblock, cs),
                True, **info)

    for k in INT8DOT_K:
        q, s = q8_rows(torch, k, D_FULL, g)
        w = agg_weights(torch, k, "avg", "none", g)
        held(q, s, w, k=k, dq=dq_of(D_FULL))
        held(q, s, w, cs=ref.int8dot_coeff_scale(s, w) * 1.5, k=k,
             dq=dq_of(D_FULL), coeff_scale="given")
        del q, s
    q, s = q8_rows(torch, REGIME_K, D_RAGGED, g)
    w = agg_weights(torch, REGIME_K, "avg", "none", g)
    held(q, s, w, k=REGIME_K, d=D_RAGGED)
    before = i8_mod.weighted_sum_q8_int8dot.launches
    try:
        i8_mod.weighted_sum_q8_int8dot(misaligned(torch, q), s, w)
        fail(f"{name} took rows one byte in")
    except ValueError as e:
        print(f"  {name} on rows one byte in: refused ({e})")
    if i8_mod.weighted_sum_q8_int8dot.launches != before:
        fail(f"{name} launched on rows one byte in")
    s64 = torch.rand((REGIME_K, dq_of(D_RAGGED) // 64), device="cuda",
                     generator=g) * 0.01
    held(q, s64, w, qblock=64, k=REGIME_K, d=D_RAGGED)
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


def zoo_flash_shapes():
    """{((B, S, H, Hkv, hd), causal, compute dtype): archs} for every
    flash launch of phase 7e's prefills: the decoder LMs' and the
    hybrid's causal self-attention over the prompt (after the VLM's
    patches), the enc-dec's non-causal encoder over its frames and its
    causal decoder.  No zoo prompt passes its config's window or
    ``attn_chunk``, so each of these layers runs the kernel."""
    from repro_torch.configs import ARCHS, get_config
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        if arch == SERVE_ARCH or cfg.family == "ssm":
            continue
        S = ZOO_PROMPT + (cfg.n_prefix_tokens if cfg.family == "vlm" else 0)
        assert S <= min(cfg.sliding_window or S, cfg.attn_chunk or S)
        shape = (ZOO_BATCH, S, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
        for causal in (False, True) if cfg.family == "audio" else (True,):
            out.setdefault((shape, causal, cfg.compute_dtype), []).append(
                arch)
    return out


def check_flash(torch, fa_mod, report, worst):
    """Flash attention against its plain version on every shape of
    :data:`FLASH_SHAPES`, f32 and bf16, causal and not, and at every
    shape, causality and dtype that phase 7e's prefills launch it with
    (:func:`zoo_flash_shapes`), within :data:`FLASH_TOL`; at the qwen3
    prefill shape in bf16, at most
    :data:`FLASH_BF16_DIFF_SHARE` of the output lanes differ from the
    plain version's, a share that the plain version with p rounded to
    bf16 must exceed; and causality: on S = 128, outputs before
    position 100 unchanged when the keys and values after it change."""
    g = torch.Generator(device="cuda").manual_seed(9)
    by_dtype = {}
    cases = [(shape, causal, name)
             for name in ("float32", "bfloat16") for causal in (True, False)
             for shape in FLASH_SHAPES]
    zoo = zoo_flash_shapes()
    cases += list(zoo)
    for shape, causal, name in cases:
        tol = FLASH_TOL[name]
        q, k, v = flash_inputs(torch, shape, getattr(torch, name), g)
        got = fa_mod.flash_attention(q, k, v, causal=causal)
        want = fa_mod.flash_attention_plain(q, k, v, causal=causal)
        del q, k, v
        got, want = got.float(), want.float()
        err = float((got - want).abs().max())
        ok = (got.dtype == want.dtype and torch.allclose(
            got, want, atol=tol, rtol=tol))
        del got, want
        archs = zoo.get((shape, causal, name))
        info = dict(shape=list(shape), dtype=name, causal=causal)
        report.append(dict(kernel="flash_attention", max_abs_err=err,
                           tolerance=tol, zoo=archs, **info))
        print(f"  flash_attention (B,S,H,Hkv,hd)={shape} {name} "
              f"causal={causal}"
              + (f" ({', '.join(archs)} prefill)" if archs else "")
              + f": max|err|={err:.3e}  (tolerance: atol=rtol={tol})")
        if not ok:
            fail(f"flash_attention {info} differs from its plain version")
        worst["flash_attention"] = max(worst.get("flash_attention", 0.0),
                                       err)
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


def raw_call(torch, fn, argtypes, *args):
    """A call of the C entry ``fn`` (``argtypes`` as the package's entry
    declares them) with ``args`` (pointers, then the scalars) made
    beforehand, the stream appended."""
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        if fn(*args, stream):
            fail(f"{fn.__name__}: launch failed")
    return call


def time_kernels(torch, k_mod, q_mod, fa_mod, i8_mod, variants):
    """Phase 4's timings: the records by kernel, the timer's floor, and the
    parent designs of the kernels this slice redesigned (``variants``:
    the variant sources' libraries), timed in the same way through
    ``ctypes`` beside the package's kernels through ``ctypes``."""
    from repro_torch.kernels.ref import INV_127
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
    # the q8 aggregate's parent (aggregate_kernel<Q8Rows>) and the
    # package's kernel, both through ctypes, on the same rows
    parents = {}
    agg_args = k_mod._lib().safl_aggregate_q8.argtypes
    for mode, w, n in (("fedsgd", ones, d), ("avg", sizes, dq)):
        o = torch.empty((n,), device="cuda")
        args = (q.data_ptr(), s.data_ptr(), w.data_ptr(), p.data_ptr(),
                o.data_ptr(), k, dq, n, lr, 0.5, k_mod.MODES[mode], 0,
                QB.bit_length() - 1)
        for design, fn in (
                ("parent", variants["aggregate_variants"]
                 .safl_aggregate_q8_gridstride),
                ("package", k_mod._lib().safl_aggregate_q8)):
            parents[f"safl_aggregate_q8 {mode}, {design} (ctypes)"] = t(
                raw_call(torch, fn, agg_args, *args))
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
    qx = torch.empty((rows, QB), dtype=torch.int8, device="cuda")
    sx = torch.empty((rows,), device="cuda")
    args = (x8.data_ptr(), qx.data_ptr(), sx.data_ptr(), rows, QB, INV_127)
    for design, fn in (("parent", variants["quantize_variants"]
                        .quantize_int8_general),
                       ("package", q_mod._lib().quantize_int8)):
        parents[f"quantize_int8, {design} (ctypes)"] = t(raw_call(
            torch, fn, q_mod._lib().quantize_int8.argtypes, *args))
    out["dequantize_int8"] = dict(
        ms=t(lambda: q_mod.dequantize_int8(q8r, s8r)),
        plain_ms=t(lambda: q_mod.dequantize_int8_plain(q8r, s8r)),
        library_ms=t(lambda: torch.mul(q8r, s8r[:, None])),
        bytes=5 * rows * QB + 4 * rows, ops=rows * QB,
        shape=f"R={rows} B={QB}")
    dx = torch.empty((rows, QB), device="cuda")
    args = (q8r.data_ptr(), s8r.data_ptr(), dx.data_ptr(), rows, QB)
    for design, fn in (("parent", variants["quantize_variants"]
                        .dequantize_int8_general),
                       ("package", q_mod._lib().dequantize_int8)):
        parents[f"dequantize_int8, {design} (ctypes)"] = t(raw_call(
            torch, fn, q_mod._lib().dequantize_int8.argtypes, *args))
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
    # the zamba2 shared attention's prefill (hd 80: the kernels' 128-wide
    # tiles with the upper 48 columns zero)
    fq, fk, fv = flash_inputs(torch, FLASH_HD80_SHAPE, torch.bfloat16, g)
    b, s_, h, hkv, hd = FLASH_HD80_SHAPE
    tq, tk, tv = (x.transpose(1, 2) for x in (fq, fk, fv))
    out["flash_attention hd80"] = dict(
        ms=t(lambda: fa_mod.flash_attention(fq, fk, fv)),
        plain_ms=t(lambda: fa_mod.flash_attention_plain(fq, fk, fv)),
        library_ms=t(lambda: sdpa(tq, tk, tv, is_causal=True,
                                  enable_gqa=True)),
        bytes=2 * (fq.numel() + fk.numel()) * fq.element_size(),
        ops=4 * b * h * hd * s_ * (s_ + 1) // 2, peak=BF16_FLOPS,
        shape=f"B={b} S={s_} H={h}/{hkv} hd={hd} bfloat16 causal")
    del fq, fk, fv, tq, tk, tv
    # the int8-dot regime's kernel at K = 32, 64 (its record) and 128,
    # beside the fused q8 aggregate it stands in for (fedsgd, unit
    # weights) on the same rows; no one PyTorch call computes it (each
    # block is its own (1, K) x (K, 512) integer product)
    for kk in INT8DOT_K[0:1] + INT8DOT_K[2:]:
        qk, sk = q8_rows(torch, kk, d, g)
        wk = 0.5 + 3.5 * torch.rand((kk,), device="cuda", generator=g)
        onesk = torch.ones((kk,), device="cuda")
        key = ("weighted_sum_q8_int8dot" if kk == REGIME_K
               else f"weighted_sum_q8_int8dot K={kk}")
        out[key] = dict(
            ms=t(lambda: i8_mod.weighted_sum_q8_int8dot(qk, sk, wk)),
            plain_ms=t(lambda: i8_mod.weighted_sum_q8_int8dot_plain(
                qk, sk, wk)),
            library_ms=None, bytes=kk * dq + kk * nb * 4 + kk * 4 + dq * 4,
            ops=2 * kk * dq, peak=INT8_OPS, shape=f"K={kk} Dq={dq}")
        out[f"safl_aggregate_q8 K={kk}"] = dict(
            ms=t(lambda: k_mod.safl_aggregate_q8(
                qk, sk, onesk, p, server_lr=lr, mode="fedsgd")),
            plain_ms=t(lambda: k_mod.safl_aggregate_q8_plain(
                qk, sk, onesk, p, server_lr=lr, mode="fedsgd")),
            library_ms=None, bytes=kk * dq + kk * nb * 4 + 2 * d * 4,
            ops=3 * kk * d + 3 * d, shape=f"K={kk} Dq={dq} mode=fedsgd")
        del qk, sk
    # the main path's three kernels of the other models at their full
    # widths' D: ResNet-18's and VGG-16's (the LSTM's rows are 114,256
    # and 163,074 lanes, launch-bound)
    for dd in (OTHER_MODELS["resnet18"]["d_full"],
               OTHER_MODELS["vgg16"]["d_full"]):
        ddq = dq_of(dd)
        uu = torch.randn((k, dd), device="cuda", generator=g)
        pp, aa = (torch.randn((dd,), device="cuda", generator=g)
                  for _ in range(2))
        qq, ss = q8_rows(torch, 1, dd, g)
        aq = torch.randn((ddq,), device="cuda", generator=g)
        cf = -lr / float(ones.sum())
        out[f"safl_fold D={dd}"] = dict(
            ms=t(lambda: k_mod.safl_fold(aa, uu[0], w_host, out=aa)),
            plain_ms=t(lambda: k_mod.safl_fold_plain(aa, uu[0], w_host)),
            library_ms=t(lambda: torch.add(aa, uu[0], alpha=w_host)),
            bytes=3 * dd * 4, ops=2 * dd, shape=f"D={dd}")
        out[f"safl_aggregate D={dd}"] = dict(
            ms=t(lambda: k_mod.safl_aggregate(uu, ones, pp, server_lr=lr,
                                              mode="fedsgd")),
            plain_ms=t(lambda: k_mod.safl_aggregate_plain(
                uu, ones, pp, server_lr=lr, mode="fedsgd")),
            library_ms=t(lambda: torch.addmv(pp, uu.t(), ones, alpha=cf)),
            bytes=(k + 2) * dd * 4, ops=2 * k * dd + 3 * dd,
            shape=f"K={k} D={dd} mode=fedsgd")
        out[f"safl_fold_q8 D={dd}"] = dict(
            ms=t(lambda: k_mod.safl_fold_q8(aq, qq[0], ss[0], w_host,
                                            out=aq)),
            plain_ms=t(lambda: k_mod.safl_fold_q8_plain(aq, qq[0], ss[0],
                                                        w_host)),
            library_ms=None, bytes=9 * ddq + (ddq // QB) * 4, ops=3 * ddq,
            shape=f"Dq={ddq}")
        del uu, pp, aa, qq, ss, aq
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
    for name, ms in parents.items():
        print(f"  {name:<52} {ms:.5f} ms")
    del flush
    return out, floor_ms, parents


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

    def clone(o):  # an output: a tensor or a tuple of tensors
        return tuple(t.clone() for t in o) if isinstance(o, tuple) else \
            o.clone()

    def equal(a, b):
        return all(map(torch.equal, a, b)) if isinstance(a, tuple) else \
            torch.equal(a, b)

    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        if restore:
            restore()
        want = [clone(fn()) for _ in range(calls)]
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
        same = equal(outs[-1], want[-1])
    else:
        same = all(equal(o, w) for o, w in zip(outs, want))
    del g, outs
    return found, same


def check_one_launch(torch, k_mod, q_mod, calls=3):
    """Each screen (f32, q8, q4) at the main path's K = 1, the q4, q8 and
    top-k folds at beta 1 in place (as the engine folds), the q4 and q8
    aggregates (fedsgd) and the top-k K-row sum at the main path's K = 4,
    and ``quantize_int8`` and ``dequantize_int8`` over the paper CNN's
    (4209, 512) blocks issue one device kernel a call and
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
    q8k, s8k = q8_rows(torch, K_MAIN, D_FULL, g)
    x8 = torch.randn((INT8_ROWS[0], QB), device="cuda", generator=g)
    q8x, s8x = q_mod.quantize_int8(x8)
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
        "safl_aggregate_q8": (
            lambda: k_mod.safl_aggregate_q8(q8k, s8k, w, params,
                                            server_lr=0.05, qblock=QB),
            None, ("aggregate_q8_kernel",), None, None),
        # (quantize's name is a substring of dequantize's: match it with
        # the namespace's "::" or the mangled length prefix)
        "quantize_int8": (
            lambda: q_mod.quantize_int8(x8), None,
            ("::quantize_int8_b512_kernel", "25quantize_int8_b512_kernel"),
            None, None),
        "dequantize_int8": (
            lambda: q_mod.dequantize_int8(q8x, s8x), None,
            ("dequantize_int8_b512_kernel",), None, None),
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
    """The paper CNN's setup: synthetic CIFAR-10 at ``hw``, split and
    partitioned, and the CNN at ``width`` drawn from prng_key(0) on the
    CPU (each engine moves it to its device)."""
    from repro_torch.data import (build_client_shards, make_dataset,
                                  train_test_split)
    from repro_torch.models.vision_cnn import build_paper_model
    from repro_torch.prng import prng_key
    ds = make_dataset("cifar10", n=samples, seed=0, hw=hw)
    tr, te = train_test_split(ds)
    shards = build_client_shards(tr, "hetero_dirichlet", clients, 32,
                                 seed=0, alpha=0.3)
    model = build_paper_model("cnn", prng_key(0), device="cpu",
                              n_classes=ds.n_classes, in_ch=3, width=width,
                              image_size=hw)
    return dict(ds=ds, shards=shards, te=te, model=model)


def build_engine(torch, setup, setting, device, **cfg_kw):
    """The engine of paper setting ``setting`` with ``cfg_kw`` on top over
    the setup's model, the server lr from the launcher's table."""
    from repro_torch.configs.paper import MODES
    from repro_torch.core import FLEngine
    from repro_torch.launch.fl_sim import SERVER_LR
    cfg = dataclasses.replace(MODES[setting], **{
        **dict(n_clients=len(setup["shards"]), k=K_MAIN, client_lr=0.05,
               speed_sigma=0.8), **cfg_kw})
    cfg = dataclasses.replace(
        cfg, server_lr=SERVER_LR.get(cfg.aggregation, 1.0))
    p0, s0, fn = setup["model"]
    te = setup["te"]
    return FLEngine(cfg, fn, setup["ds"].kind, p0, s0, setup["shards"],
                    te.x[:400], te.y[:400], device=device)


def resolve_timeout(torch, setup, setting, kw) -> dict:
    """``kw`` with a K_ARRIVALS timeout replaced by its seconds for
    ``setup``: the simulated time in which K_MAIN uploads arrive at the
    static schedule's mean rate (the sum over clients of 1 / (compute +
    comm)), so that a horizon takes about k arrivals; read off an engine
    built on the CPU."""
    if kw.get("horizon_timeout_s") != K_ARRIVALS:
        return kw
    eng = build_engine(torch, setup, setting, "cpu",
                       **{k: v for k, v in kw.items()
                          if not k.startswith(("horizon", "sched_"))})
    rate = sum(1.0 / (eng._base_compute(c) + c.comm_time)
               for c in eng.clients)
    return dict(kw, horizon_timeout_s=K_MAIN / rate)


def check_engine_small(torch):
    """The engine on the card against the engine on the CPU (itself held
    against the JAX reference by the CPU tests): the sequential engine in
    its settings, then the batched engine (``vmap`` waves on the card,
    ``map`` on the CPU) in ``BATCHED_SMALL``."""
    setup = make_setup(width=4, hw=8, samples=400, clients=6)
    rows = []
    sequential = tuple((name, setting, dict(kw, batch_clients=False))
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
            ("SS-sdga-topk", "SS", {"wire": "topk", "aggregation": "sdga"}),
            ("AS-markov-seafl", "AS", dict(MARKOV_SEAFL, sched_stale_cap=1)),
            ("AS-fedbuff-timeout-ratelimit", "AS",
             {"aggregation": "fedbuff", "horizon": "timeout",
              "horizon_timeout_s": K_ARRIVALS, "sched_policy": "ratelimit",
              "sched_rate_limit": 2})))
    batched = tuple((f"{name} batched", setting,
                     dict(kw, batch_clients=True, **BATCHED_SCHEDULE))
                    for name, setting, kw in BATCHED_SMALL)
    for name, setting, kw in sequential + batched:
        kw = resolve_timeout(torch, setup, setting, kw)
        res = {}
        for dev in ("cpu", "cuda"):
            # the card's batched engine runs vmap waves (auto would pick
            # map for the CNN there too); the CPU's run map
            dev_kw = (dict(kw, wave_impl="vmap")
                      if dev == "cuda" and kw["batch_clients"] else kw)
            eng = build_engine(torch, setup, setting, dev, **dev_kw)
            p0 = eng._flat_params.cpu()
            r = eng.run(3)
            res[dev] = (eng, r)
        (ec, rc), (eg, rg) = res["cpu"], res["cuda"]
        counts = {key: (rc.sched_stats[key], rg.sched_stats[key])
                  for key in FAULT_COUNTS + SCHED_COUNTS}
        same_host = (all(a == b for a, b in counts.values())
                     and ec.tx_bytes == eg.tx_bytes
                     and ec.rx_bytes == eg.rx_bytes
                     and rc.staleness_hist == rg.staleness_hist
                     and list(rc.participation) == list(rg.participation)
                     and list(rc.sched_stats["staleness_bins"])
                     == list(rg.sched_stats["staleness_bins"])
                     and ec.wave_size_hist == eg.wave_size_hist
                     and [x.sim_time for x in rc.metrics.records]
                     == [x.sim_time for x in rg.metrics.records])
        impls = (ec.wave_impl_resolved, eg.wave_impl_resolved)
        if kw["batch_clients"] and impls != ("map", "vmap"):
            fail(f"{name}: waves ran as {ec.wave_impl_resolved} on the CPU "
                 f"and {eg.wave_impl_resolved} on the card")
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
        waves = (f", waves {dict(sorted(eg.wave_size_hist.items()))}"
                 if eg.wave_size_hist else "")
        print(f"  {name} card vs CPU, 3 rounds: bytes/schedule/fault "
              f"counts {'equal' if same_host else 'DIFFER'}, params "
              f"max|err|={err:.3e} rel {rel:.3e} ({tol}){waves}")
        if kw.get("defense") or kw.get("sched_policy"):
            print("      (cpu, card) " + "  ".join(
                f"{key.replace('_uploads', '').replace('_requests', '')} "
                f"{v}" for key, v in counts.items()))
        rows.append(dict(setting=name, host_equal=same_host,
                         params_max_abs_err=err,
                         params_rel_to_movement=rel, fault_counts=counts,
                         batched=kw["batch_clients"],
                         wave_sizes=eg.wave_size_hist))
        if not (same_host and close):
            fail(f"{name}: engine on the card disagrees with the CPU")
    return rows


def check_paper_long(torch):
    """The paper's four settings on the sequential engine at phase 5's
    small size for LONG_ROUNDS rounds, on the card (its ReLU and max-pool
    branches recorded) and on the CPU taking the card's branches
    (:mod:`repro_torch.models.kinks`): bytes, schedule, staleness and
    simulated times exact, params within phase 5's f32 bound."""
    from repro_torch.models import kinks
    setup = make_setup(width=4, hw=8, samples=400, clients=6)
    rows = []
    for name, setting, kw, _ in PAPER_SETTINGS:
        kw = dict(kw, batch_clients=False)
        eg = build_engine(torch, setup, setting, "cuda", **kw)
        p0 = eg._flat_params.cpu()
        record = kinks.Record()
        with record:
            rg = eg.run(LONG_ROUNDS)
        ec = build_engine(torch, setup, setting, "cpu", **kw)
        replay = kinks.Replay(record.choices)
        with replay:
            rc = ec.run(LONG_ROUNDS)
        same_host = (ec.tx_bytes == eg.tx_bytes
                     and ec.rx_bytes == eg.rx_bytes
                     and rc.staleness_hist == rg.staleness_hist
                     and list(rc.participation) == list(rg.participation)
                     and [x.sim_time for x in rc.metrics.records]
                     == [x.sim_time for x in rg.metrics.records]
                     and len(rc.metrics.records) == LONG_ROUNDS)
        err, rel, close, tol = params_distance(
            torch, kw, eg._flat_params.cpu(), ec._flat_params, p0)
        print(f"  {name} card vs CPU, {LONG_ROUNDS} rounds, the CPU on the "
              f"card's {len(record.choices)} branch points ({replay.flips} "
              f"units the other side of its own, margin "
              f"{replay.margin:.1e}): bytes/schedule "
              f"{'equal' if same_host else 'DIFFER'}, params "
              f"max|err|={err:.3e} rel {rel:.3e} ({tol})")
        rows.append(dict(setting=name, rounds=LONG_ROUNDS,
                         host_equal=same_host, params_max_abs_err=err,
                         params_rel_to_movement=rel, flips=replay.flips,
                         margin=replay.margin))
        if not (same_host and close and replay.done):
            fail(f"{name}: {LONG_ROUNDS} rounds on the card disagree with "
                 "the CPU taking the card's branches")
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


def expected_launches(spec, uploads, screened, waves=0):
    """A setting's launch counts: every kernel 0 except those it names."""
    out = dict.fromkeys(KERNELS, 0)
    for name, want in spec.items():
        out[name] = {"uploads": uploads,
                     "uploads-screened": uploads - screened,
                     "waves": waves}.get(want, want)
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
    ``kw`` (the full-width CNN's), as :func:`run_engine` runs it."""
    eng = build_engine(torch, setup, setting, "cuda", **kw)
    if eng.codec.d != D_FULL:
        fail(f"full-width CNN has D={eng.codec.d}, expected {D_FULL}")
    return run_engine(torch, eng, wrappers, ROUNDS)


def state_finite(torch, state) -> bool:
    from repro_torch import tree
    return all(bool(torch.isfinite(v).all()) for v in tree.tree_leaves(state))


def run_engine(torch, eng, wrappers, rounds):
    """``rounds`` rounds of the fresh engine ``eng``, every launch counter
    reset before and read after.  Returns the engine, its result, the
    counts, the wall seconds and their split, whether the global params
    and the global model state were finite after each round (the state
    read as each server round starts, and once more at the end: the
    batched semi-async engine closes a round's state after its server
    round) and the fault kinds the plan drew."""
    split = dict.fromkeys(SPLIT, 0.0)
    for bucket, methods in SPLIT.items():
        for method in methods:
            timed(torch, eng, method, bucket, split)
    # the scheduler's pops (host only: timing draws, verdicts, the heap)
    split["scheduler"] = 0.0
    pop = eng.sched.pop

    def timed_pop(rnd, _pop=pop, _split=split):
        t0 = time.perf_counter()
        ev = _pop(rnd)
        _split["scheduler"] += time.perf_counter() - t0
        return ev

    eng.sched.pop = timed_pop
    # finite global params after every round, checked outside the timed
    # span; the fault kinds the plan draws, tallied
    finite, drawn = [], {}
    agg = eng._aggregate

    def aggregate(*a, _agg=agg, _eng=eng, _finite=finite, **k):
        state_ok = state_finite(torch, _eng.global_state)
        out = _agg(*a, **k)
        _finite.append(bool(torch.isfinite(_eng._flat_params).all())
                       and state_ok)
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
    res = eng.run(rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: f.launches for n, f in wrappers.items()}
    if finite:
        finite[-1] = finite[-1] and state_finite(torch, eng.global_state)
    return eng, res, counts, wall, split, finite, drawn


def run_record(eng, res, counts, drawn):
    """What a run must repeat: every round's accuracy and loss, bytes,
    uploads, staleness, launches and fault counts."""
    recs = res.metrics.records
    return dict(accuracy=[r.accuracy for r in recs],
                loss=[r.loss for r in recs], tx_bytes=eng.tx_bytes,
                rx_bytes=eng.rx_bytes,
                uploads=int(res.participation.sum()),
                waves=sum(eng.wave_size_hist.values()),
                participation=res.participation.tolist(),
                staleness_hist=dict(res.staleness_hist),
                staleness_bins=res.sched_stats["staleness_bins"].tolist(),
                sim_time=[r.sim_time for r in recs],
                launches=counts, faults_drawn=drawn,
                fault_counts={key.split("_")[0]: res.sched_stats[key]
                              for key in FAULT_COUNTS},
                sched_counts={key: res.sched_stats[key]
                              for key in SCHED_COUNTS})


def check_run(torch, name, kw, spec, eng, res, counts, finite, drawn,
              rounds=ROUNDS):
    """A run's checks: finite eval, params and state every round, the
    launches its setting names, every drawn fault kind fired, the
    screen's and clip's counts."""
    st = res.sched_stats
    recs = res.metrics.records
    if len(recs) != rounds or any(r.nan_event for r in recs):
        fail(f"{name}: non-finite eval loss or missing rounds")
    if len(finite) != rounds or not all(finite):
        fail(f"{name}: non-finite global parameters or state after a "
             f"round ({finite})")
    uploads = int(res.participation.sum())
    # the sequential engine screens each upload as a wave of one
    waves = (sum(eng.wave_size_hist.values()) if eng.cfg.batch_clients
             else uploads)
    expected = expected_launches(spec, uploads, st["screened_uploads"],
                                 waves)
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
    for field, value, key in VERDICT_FIRES:
        if kw.get(field) == value and not st[key]:
            fail(f"{name}: {field}={value} gave no {key}")


def split_line(split) -> str:
    return "  ".join(f"{k} {v:.3f} s" for k, v in split.items())


def params_distance(torch, kw, got, want, p0):
    """(max |got - want|, |got - want| / |want - p0|, within the bound,
    the bound's text): phase 5's bounds, ``rtol=1e-4, atol=1e-5`` on f32
    and 2e-2 of the run's movement on the lossy wires."""
    err = float((got - want).abs().max())
    rel = float((got - want).norm() / (want - p0).norm())
    if kw.get("wire") in ("q8", "q4", "topk"):
        return err, rel, rel <= 2e-2, "relative <= 2e-2"
    return (err, rel, torch.allclose(got, want, rtol=1e-4, atol=1e-5),
            "rtol=1e-4, atol=1e-5")


#: the fields two engines' runs of one setting must share
HOST_FIELDS = ("tx_bytes", "rx_bytes", "uploads", "participation",
               "staleness_hist", "fault_counts", "sched_counts", "sim_time")


def run_main_path(torch, wrappers):
    """Every setting of ``MAIN_SETTINGS`` run twice on the batched engine
    (the default; ``map`` waves on the card for the CNN), each time from a
    fresh engine: the first run is checked (launch counts, screens once a
    wave, faults, finite params) and counted; the second must repeat it
    bit for bit (the final flat params bitwise, every round's accuracy
    and loss, and the bytes, uploads, waves, participation, staleness,
    launches and fault counts equal).  Then once on the sequential engine
    (``batch_clients=False``): checked the same way with a screen
    launched once an upload, its bytes, uploads, participation,
    staleness and fault counts equal to the batched run's, and its params
    within phase 5's bounds of them.  Then the paper's four settings once
    on the batched engine with ``vmap`` waves, checked the same way, their
    wall split printed beside the ``map`` and sequential engines'."""
    setup = make_setup(width=32, hw=32, samples=2000, clients=16)
    p0 = build_engine(torch, setup, "AS", "cuda")._flat_params.clone()
    rows, sequential = [], []
    launches = dict.fromkeys(KERNELS, 0)
    settings_kw = {}
    # the traced phase's settings: each engine's untraced run (its params
    # on the card, its record and wall)
    untraced = {}
    for name, setting, kw, spec in MAIN_SETTINGS:
        if kw.get("defense") == "clip":
            kw = dict(kw, defense_norm_cap=clean_clip_cap(torch, setup,
                                                          setting, kw))
        kw = resolve_timeout(torch, setup, setting, kw)
        settings_kw[name] = kw
        eng, res, counts, wall, split, finite, drawn = run_setting(
            torch, setup, setting, kw, wrappers)
        rec = run_record(eng, res, counts, drawn)
        acc = [round(a, 4) for a in rec["accuracy"]]
        print(f"  {name}: acc/round {acc}  tx_bytes={eng.tx_bytes} "
              f"rx_bytes={eng.rx_bytes}  uploads={rec['uploads']}  waves "
              f"{dict(sorted(eng.wave_size_hist.items()))} "
              f"({eng.wave_impl_resolved})  launches "
              + " ".join(f"{n}={c}" for n, c in counts.items() if c))
        if drawn:
            print(f"      faults drawn {drawn}; counts "
                  f"{rec['fault_counts']}")
        if kw.get("sched_timing") or kw.get("sched_policy") or \
                kw.get("horizon"):
            sc = rec["sched_counts"]
            arrivals = (rec["uploads"] + sc["rejected_uploads"]
                        + sc["idle_requests"])
            print(f"      verdicts {sc}; per horizon: {rec['uploads'] / ROUNDS:.2f} "
                  f"admitted of {arrivals / ROUNDS:.2f} arrivals"
                  + (f" (timeout {kw['horizon_timeout_s']:.6f} s)"
                     if "horizon_timeout_s" in kw else ""))
        print(f"      wall {wall:.3f} s: {split_line(split)}")
        if eng.wave_impl_resolved != "map":
            fail(f"{name}: wave_impl auto resolved "
                 f"{eng.wave_impl_resolved} for the CNN on the card, not "
                 "map")
        check_run(torch, name, kw, spec, eng, res, counts, finite, drawn)
        for n, c in counts.items():
            launches[n] += c
        params = eng._flat_params.clone()
        if name in TRACED_SETTINGS or name in MESH_NAMES:
            untraced[name, "batched"] = dict(params=params, rec=rec,
                                             wall=wall)
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
              f"; wall {wall2:.3f} s: {split_line(split2)}")
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
        # the sequential engine, once
        skw = dict(kw, batch_clients=False)
        eng, res, counts, wall, split, finite, drawn = run_setting(
            torch, setup, setting, skw, wrappers)
        check_run(torch, name, skw, spec, eng, res, counts, finite, drawn)
        srec = run_record(eng, res, counts, drawn)
        host_differ = [key for key in HOST_FIELDS if srec[key] != rec[key]]
        bitwise = torch.equal(params.view(torch.int32),
                              eng._flat_params.view(torch.int32))
        err, rel, close, tol = params_distance(torch, kw, params,
                                               eng._flat_params, p0)
        print(f"      sequential engine: launches "
              + " ".join(f"{n}={c}" for n, c in counts.items() if c)
              + f"; bytes/uploads/staleness/faults "
              f"{'equal' if not host_differ else f'DIFFER in {host_differ}'}; "
              f"params {'bitwise equal' if bitwise else 'differ'} "
              f"(max|err|={err:.3e} rel {rel:.3e}, {tol}); wall "
              f"{wall:.3f} s: {split_line(split)}")
        sequential.append(dict(setting=name, **srec, wall_s=wall,
                               split_s=split, params_bitwise=bitwise,
                               params_max_abs_err=err,
                               params_rel_to_movement=rel))
        if name in TRACED_SETTINGS or name in MESH_NAMES:
            untraced[name, "sequential"] = dict(
                params=eng._flat_params.clone(), rec=srec, wall=wall)
        if host_differ or not close:
            fail(f"{name}: the sequential engine disagrees with the "
                 f"batched one (host fields {host_differ}, params {err})")
        del eng, res, params
    resume = check_resume(torch, setup)
    batched = {row["setting"]: row for row in rows}
    seq = {row["setting"]: row for row in sequential}
    vmapped = []
    for name, setting, _, spec in PAPER_SETTINGS:
        kw = dict(settings_kw[name], wave_impl="vmap")
        eng, res, counts, wall, split, finite, drawn = run_setting(
            torch, setup, setting, kw, wrappers)
        check_run(torch, name, kw, spec, eng, res, counts, finite, drawn)
        rec = run_record(eng, res, counts, drawn)
        b = batched[name]
        host_differ = [key for key in HOST_FIELDS if rec[key] != b[key]]
        print(f"  {name} sequential:    wall {seq[name]['wall_s']:.3f} s: "
              f"{split_line(seq[name]['split_s'])}")
        print(f"  {name} batched, map:  wall {b['wall_s']:.3f} s: "
              f"{split_line(b['split_s'])}")
        print(f"  {name} batched, vmap: wall {wall:.3f} s: "
              f"{split_line(split)}; acc/round "
              f"{[round(a, 4) for a in rec['accuracy']]}; bytes/uploads/"
              f"staleness "
              f"{'equal' if not host_differ else f'DIFFER in {host_differ}'}")
        if host_differ or eng.wave_impl_resolved != "vmap":
            fail(f"{name}: the vmapped engine's run differs from the map "
                 f"engine's in {host_differ} or ran {eng.wave_impl_resolved}")
        vmapped.append(dict(setting=name, **rec, wall_s=wall, split_s=split))
        del eng, res
    return (rows, launches, sequential, vmapped, resume,
            dict(runs=untraced, kw=settings_kw))


def run_outcome(eng, res) -> dict:
    """What a resumed run must end with: every record, the counters, the
    staleness bins and histogram, bytes, waves and the clock."""
    stats = dict(res.sched_stats)
    bins = stats.pop("staleness_bins").tolist()
    return dict(records=[dataclasses.asdict(r) for r in res.metrics.records],
                stats=stats, bins=bins, hist=dict(res.staleness_hist),
                tx=eng.tx_bytes, rx=eng.rx_bytes,
                waves=dict(eng.wave_size_hist), last_agg=eng._last_agg_time)


def check_resume(torch, setup):
    """Kill and resume on the card: each of ``RESUME_SETTINGS`` on both
    engines runs ROUNDS rounds uninterrupted; then a fresh engine runs
    RESUME_AT rounds and snapshots under ``chiprun_out/``, a second fresh
    engine loads the snapshot and runs to ROUNDS.  Its flat params must
    be bitwise the uninterrupted run's, and its records, counters,
    staleness, bytes and waves (the first engine's and its own) equal.
    The snapshot's bytes and the save and load seconds are printed; the
    snapshot is removed afterwards."""
    import shutil
    rows = []
    for name, setting, kw in RESUME_SETTINGS:
        for batched in (True, False):
            label = f"{name} {'batched' if batched else 'sequential'}"
            skw = dict(kw, batch_clients=batched)
            full = build_engine(torch, setup, setting, "cuda", **skw)
            want = run_outcome(full, full.run(ROUNDS))
            want_params = full._flat_params.clone()
            del full
            ckpt = os.path.join(ROOT, "chiprun_out", "snapshots",
                                label.replace(" ", "-"))
            shutil.rmtree(ckpt, ignore_errors=True)
            first = build_engine(torch, setup, setting, "cuda", **skw)
            first.run(RESUME_AT)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first.save_snapshot(ckpt)
            save_s = time.perf_counter() - t0
            first_waves = collections.Counter(first.wave_size_hist)
            del first
            nbytes = sum(os.path.getsize(os.path.join(ckpt, f))
                         for f in os.listdir(ckpt))
            again = build_engine(torch, setup, setting, "cuda", **skw)
            t0 = time.perf_counter()
            step = again.load_snapshot(ckpt)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            got = run_outcome(again, again.run(ROUNDS))
            # the wave histogram is not in a snapshot (as the
            # reference's): the resumed engine counts the waves after it
            got["waves"] = dict(first_waves
                                + collections.Counter(got["waves"]))
            bitwise = torch.equal(want_params.view(torch.int32),
                                  again._flat_params.view(torch.int32))
            differ = [key for key in want if want[key] != got[key]]
            print(f"  resume {label}: snapshot at round {step}, {nbytes:,} "
                  f"bytes, save {save_s:.3f} s, load {load_s:.3f} s; params "
                  f"{'bitwise equal' if bitwise else 'DIFFER'}, "
                  f"{'every record equal' if not differ else f'differ in {differ}'}"
                  f"; verdicts {dict((k, got['stats'][k]) for k in SCHED_COUNTS)}")
            rows.append(dict(setting=label, step=step, snapshot_bytes=nbytes,
                             save_s=save_s, load_s=load_s,
                             params_bitwise=bitwise, differing=differ))
            shutil.rmtree(ckpt, ignore_errors=True)
            del again
            if step != RESUME_AT or not bitwise or differ:
                fail(f"resume {label}: the resumed run does not end where "
                     f"the uninterrupted run ends (params bitwise "
                     f"{bitwise}, differing {differ})")
    return rows


# ---------------------------------------------------------------------------
# phase 6b: the main path traced (repro_torch.obs)
# ---------------------------------------------------------------------------


def host_stream(stream):
    """A canonical stream without what scales with the model's width
    (``WIDTH_KEYS``) and without ``fac`` and ``w`` (held apart at the
    params' bound): what a run of the same schedule at width 1 gives."""
    out = []
    for rec in stream:
        rec = {k: v for k, v in rec.items()
               if k not in WIDTH_KEYS + ("fac", "w")}
        if "counts" in rec:
            rec["counts"] = {k: v for k, v in rec["counts"].items()
                             if k not in WIDTH_KEYS}
        out.append(rec)
    return out


def factors_distance(a, b):
    """(the same records carry ``fac`` / ``w``, the largest difference of
    their values) between two streams of one schedule."""
    same_keys, err = len(a) == len(b), 0.0
    for ra, rb in zip(a, b):
        for key in ("fac", "w"):
            if (key in ra) != (key in rb):
                same_keys = False
            elif key in ra:
                err = max(err, abs(ra[key] - rb[key]))
    return same_keys, err


def reconcile(eng, res):
    """What disagrees between a traced run's stream and its engine: the
    ingest records' bytes against ``tx_bytes``, the scheduler's instants
    against its rejected / idled / no-show / crashed totals, the fac = 0
    ingests against the screened count.  Returns (the problems, the
    instants' counts)."""
    recs = eng.tracer.records
    ingests = [r for r in recs if r.get("name") == "ingest"]
    sched = collections.Counter(r["name"] for r in recs
                                if r.get("cat") == "sched")
    st = res.sched_stats
    problems = []
    if sum(i["bytes"] for i in ingests) != eng.tx_bytes:
        problems.append("ingest bytes != tx_bytes")
    for inst, key in (("reject", "rejected_uploads"),
                      ("idle", "idle_requests"), ("offline", "no_shows"),
                      ("crash", "crashed_uploads")):
        if sched[inst] != st[key]:
            problems.append(f"{inst} instants {sched[inst]} != {key} "
                            f"{st[key]}")
    if sum(1 for i in ingests if i.get("fac") == 0.0) != \
            eng.screened_uploads:
        problems.append("fac = 0 ingests != screened_uploads")
    return problems, dict(sched)


def merged_ms(spans) -> float:
    """Milliseconds of the union of (start, end) microsecond spans."""
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us / 1e3


def event_busy(torch, libs, fn):
    """``fn()`` with a pair of CUDA events on the current stream around
    each aten op on a card tensor and each call into the kernel
    libraries ``libs`` (their ``ctypes`` functions): (its result, the sum
    of the pairs' device milliseconds, the pairs).  It needs no CUPTI.
    A pair also holds the wait between its start event and its op's
    launch, so it reads high where the host paces the device."""
    from torch.utils._python_dispatch import TorchDispatchMode
    pairs = []

    def timed(call):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = call()
        b.record()
        pairs.append((a, b))
        return out

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(isinstance(t, torch.Tensor) and t.is_cuda
                   for t in list(args) + list(kwargs.values())):
                return timed(lambda: func(*args, **kwargs))
            return func(*args, **kwargs)

    patched = []
    for lib in libs:
        for name, f in list(vars(lib).items()):
            if isinstance(f, ctypes._CFuncPtr):
                setattr(lib, name,
                        lambda *a, _f=f: timed(lambda: _f(*a)))
                patched.append((lib, name, f))
    try:
        with Mode():
            out = fn()
        torch.cuda.synchronize()
    finally:
        for lib, name, f in patched:
            setattr(lib, name, f)
    return out, sum(a.elapsed_time(b) for a, b in pairs), len(pairs)


def run_traced(torch, k_mod, wrappers, untraced):
    """Phase 6b: each of ``TRACED_SETTINGS`` traced at level "upload"
    (in memory) on the batched engine (``map`` waves) and on the
    sequential engine, checked as phase 6 checks it, and held:

      * bitwise to phase 6's untraced run of the same setting and engine
        (params; bytes, uploads, staleness, simulated times, verdict and
        fault counts, launches, every round's accuracy and loss);
      * the two engines' ``canonical`` streams equal;
      * the stream equal to a width-1 CPU run's (batched, same schedule)
        on every key that does not scale with the width, ``fac`` and
        ``w`` within phase 5's f32 bound (``atol=1e-5``);
      * the stream reconciled with its engine (:func:`reconcile`), the
        Chrome export valid, one ``metrics_ring.flush`` per batched
        semi-async run and none on the other runs, and
        ``engine_compile_log``'s counts real: the wave program once on
        the batched engine, each kernel library loaded once.

    Then one run of AS-markov-seafl-q8 (batched, untraced, no phase
    instrumentation) plain and under ``repro_torch.obs.profile.
    torch_profile``: its device events, merged, over the run's wall (the
    busy share); where the profiler sees no device event, a third run
    under :func:`event_busy` reads the share without CUPTI."""
    from repro_torch.obs import export as obs_export
    from repro_torch.obs import profile as obs_profile
    from repro_torch.obs.trace import canonical
    setup = make_setup(width=32, hw=32, samples=2000, clients=16)
    narrow = make_setup(width=1, hw=32, samples=2000, clients=16)
    spec_of = {row[0]: row for row in MAIN_SETTINGS}
    rows = []
    for name in TRACED_SETTINGS:
        _, setting, _, spec = spec_of[name]
        kw = dict(untraced["kw"][name], trace_level="upload")
        streams = {}
        for engine in ("batched", "sequential"):
            ekw = dict(kw, batch_clients=engine == "batched")
            label = f"{name} {engine} traced"
            with obs_profile.TransferScope() as ts:
                eng, res, counts, wall, split, finite, drawn = run_setting(
                    torch, setup, setting, ekw, wrappers)
            check_run(torch, label, ekw, spec, eng, res, counts, finite,
                      drawn)
            rec = run_record(eng, res, counts, drawn)
            base = untraced["runs"][name, engine]
            bitwise = torch.equal(base["params"].view(torch.int32),
                                  eng._flat_params.view(torch.int32))
            differ = [key for key in rec if rec[key] != base["rec"][key]]
            problems, instants = reconcile(eng, res)
            n_events = obs_export.validate_chrome_trace(
                obs_export.export_chrome_trace(eng.tracer.records))
            want_flush = int(engine == "batched"
                             and eng.cfg.mode == "semi_async")
            flushes = ts.count("metrics_ring.flush")
            # what the process built: the wave program once a batched
            # engine, each kernel library once (phase 3 loaded them)
            builds = obs_profile.engine_compile_log(eng).counts()
            want_builds = {"wave": int(engine == "batched"),
                           **{f"kernels.{n}": 1
                              for n in obs_profile.KERNEL_LIBRARIES}}
            if builds != want_builds:
                problems.append(f"build counts {builds} != {want_builds}")
            streams[engine] = canonical(eng.tracer.records)
            print(f"  {label}: {len(eng.tracer.records)} records, sched "
                  f"instants {instants}, {n_events} Chrome events, "
                  f"{flushes} ring flush, builds {builds}; wall "
                  f"{wall:.3f} s against the "
                  f"untraced {base['wall']:.3f} s "
                  f"({100 * (wall / base['wall'] - 1):+.1f} %); params "
                  f"{'bitwise the untraced run' if bitwise else 'DIFFER'}, "
                  f"{'every record equal' if not differ else f'differ in {differ}'}"
                  f"{'; ' + ', '.join(problems) if problems else ''}")
            rows.append(dict(setting=name, engine=engine,
                             records=len(eng.tracer.records),
                             instants=instants, chrome_events=n_events,
                             ring_flushes=flushes, builds=builds,
                             wall_s=wall,
                             untraced_wall_s=base["wall"], split_s=split,
                             params_bitwise=bitwise, differing=differ,
                             problems=problems))
            if not bitwise or differ or problems or flushes != want_flush:
                fail(f"{label}: the traced run differs from the untraced "
                     f"one ({differ}, params bitwise {bitwise}), or its "
                     f"stream from its engine ({problems}), or it flushed "
                     f"the ring {flushes} times (expected {want_flush})")
            del eng, res
        if streams["batched"] != streams["sequential"]:
            fail(f"{name}: the batched and sequential engines' traces "
                 "differ")
        cpu = build_engine(torch, narrow, setting, "cpu",
                           **dict(kw, batch_clients=True))
        t0 = time.perf_counter()
        cpu.run(ROUNDS)
        cpu_s = time.perf_counter() - t0
        narrow_stream = canonical(cpu.tracer.records)
        same_host = (host_stream(streams["batched"])
                     == host_stream(narrow_stream))
        same_keys, ferr = factors_distance(streams["batched"], narrow_stream)
        print(f"  {name}: batched and sequential streams equal; against "
              f"the width-1 CPU run ({cpu_s:.2f} s): host keys "
              f"{'equal' if same_host else 'DIFFER'}, fac / w "
              f"{'on the same records' if same_keys else 'on OTHER records'}"
              f", max|err| {ferr:.3e} (atol=1e-5)")
        if not (same_host and same_keys and ferr <= 1e-5):
            fail(f"{name}: the card's trace differs from the width-1 CPU "
                 "run's")
        del cpu

    # the busy share of one untraced run, three ways
    name = "AS-markov-seafl-q8"
    _, setting, _, _ = spec_of[name]
    kw = untraced["kw"][name]

    def run(eng):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(ROUNDS)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def build():
        return build_engine(torch, setup, setting, "cuda", **kw)

    plain_s = run(build())
    prof_dir = os.path.join(ROOT, "chiprun_out", "torch_profile")
    eng = build()
    with obs_profile.torch_profile(prof_dir) as prof:
        prof_s = run(eng)
    from torch.autograd import DeviceType
    spans = ([(e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == DeviceType.CUDA] if prof is not None
             else [])
    prof_busy = merged_ms(spans) if spans else None
    prof_line = (f"{len(spans)} device events, busy {prof_busy:.1f} ms of "
                 f"{prof_s * 1e3:.1f} ms "
                 f"({100 * prof_busy / 1e3 / prof_s:.1f} %)" if spans else
                 "the profiler saw NO device event (CUPTI blind here)")
    busy = dict(setting=name, plain_wall_s=plain_s, profiled_wall_s=prof_s,
                profiler_device_events=len(spans),
                profiler_busy_ms=prof_busy,
                profile_trace=os.path.relpath(
                    os.path.join(prof_dir, obs_profile.PROFILE_TRACE), ROOT))
    print(f"  busy share, {name} batched untraced, {ROUNDS} rounds: plain "
          f"wall {plain_s * 1e3:.1f} ms; torch.profiler: {prof_line}"
          + (f"; the device busy {100 * prof_busy / 1e3 / plain_s:.1f} % "
             "of the plain wall" if spans else ""))
    if not spans:
        # the profiler is blind: event pairs, which need no CUPTI
        eng = build()
        events_s, ev_busy, n_pairs = event_busy(torch, [k_mod._lib()],
                                                lambda: run(eng))
        del eng
        print(f"  busy share without CUPTI (event pairs, high where the "
              f"host paces the device): {n_pairs} pairs, {ev_busy:.1f} ms "
              f"= {100 * ev_busy / 1e3 / events_s:.1f} % of its own wall "
              f"{events_s * 1e3:.1f} ms, "
              f"{100 * ev_busy / 1e3 / plain_s:.1f} % of the plain wall")
        busy.update(event_pairs=n_pairs, event_busy_ms=ev_busy,
                    event_wall_s=events_s)
    return dict(runs=rows, busy=busy)


# ---------------------------------------------------------------------------
# phase 6c: the mesh, every shard on the one card
# ---------------------------------------------------------------------------


def card_mesh(torch, spec, devices):
    """The mesh of ``spec`` ((E, P), or N for the 1-D mesh) over
    ``devices``."""
    from repro_torch.sharding import flat
    if isinstance(spec, tuple):
        return flat.make_hier_mesh(*spec, devices=devices)
    return flat.make_pod_mesh(spec, devices=devices)


def check_mesh_server(torch, wrappers):
    """``FlatServer`` on each mesh of ``MESH_SERVER`` with every shard on
    cuda:0, at the CNN's full D, K = 4, in every mode x wire (top-k: the
    gradient modes): one round from fresh slow state, bitwise the same
    round on a CPU mesh of the same shape (params and slow state: the
    kernels are bitwise their plain versions, the tree and the step body
    are the same ops in the same order on both), the counters reset
    before the card's round and read after: one ``sum`` partial a shard
    (fedasync: its K folds)."""
    import numpy as np

    from repro_torch.core.aggregation import FlatServer
    from repro_torch.launch.fl_sim import SERVER_LR
    from repro_torch.sharding import flat
    g = torch.Generator(device="cuda").manual_seed(6)
    tau = np.random.default_rng(6).integers(0, 5, K_MAIN).astype(np.float32)
    disc = np.asarray(np.power(tau + 1.0, -np.float32(0.5)), np.float32)
    weights = {"fedsgd": np.ones(K_MAIN, np.float32),
               "fedavg": np.float32([113, 58, 241, 77]),
               "fedasync": np.asarray(0.6 * disc, np.float32)}
    p = torch.randn((D_FULL,), device="cuda", generator=g)
    payloads = {
        "f32": (0.1 * torch.randn((K_MAIN, D_FULL), device="cuda",
                                  generator=g),),
        "q8": q8_rows(torch, K_MAIN, D_FULL, g),
        "q4": q4_rows(torch, K_MAIN, D_FULL, g),
        "topk": topk_rows(torch, K_MAIN, D_FULL, NK_FULL, g)}
    on_cpu = {wire: tuple(a.cpu() for a in rows)
              for wire, rows in payloads.items()}
    partial = {"f32": "safl_aggregate", "q8": "safl_aggregate_q8",
               "q4": "safl_aggregate_q4", "topk": "safl_aggregate_topk"}
    fold = {"f32": "safl_fold", "q8": "safl_fold_q8", "q4": "safl_fold_q4"}
    rows_out = []
    for mesh_name, spec in MESH_SERVER.items():
        n = spec[0] * spec[1] if isinstance(spec, tuple) else spec
        meshes = {"cuda": card_mesh(torch, spec,
                                    [torch.device("cuda", 0)] * n),
                  "cpu": card_mesh(torch, spec, "cpu")}
        for wire in ("f32", "q8", "q4", "topk"):
            modes = TOPK_AGGREGATIONS if wire == "topk" else AGGREGATIONS
            for mode in modes:
                got = {}
                for where, mesh in meshes.items():
                    rows = payloads[wire] if where == "cuda" else \
                        on_cpu[wire]
                    pp = p if where == "cuda" else p.cpu()
                    srv = FlatServer(mode, D_FULL,
                                     server_lr=SERVER_LR.get(mode, 1.0),
                                     wire=wire, mesh=mesh)
                    buf = flat.shard_rows(rows[0] if wire == "f32" else rows,
                                          mesh)
                    for f in wrappers.values():
                        f.launches = 0
                    new, opt, _ = srv.step(pp, buf,
                                           weights.get(mode, disc),
                                           srv.init_opt(pp))
                    torch.cuda.synchronize()
                    got[where] = (new, opt, {nm: f.launches for nm, f
                                             in wrappers.items()
                                             if f.launches})
                (new, opt, counts), (new_c, opt_c, _) = (got["cuda"],
                                                         got["cpu"])
                want = ({fold[wire]: K_MAIN} if mode == "fedasync"
                        else {partial[wire]: n})
                bitwise = torch.equal(new.cpu(), new_c) and all(
                    opt[key] == opt_c[key] if key == "step"
                    else torch.equal(opt[key].cpu(), opt_c[key])
                    for key in opt_c)
                err = float((new.cpu() - new_c).abs().max())
                rows_out.append(dict(mesh=mesh_name, wire=wire, mode=mode,
                                     bitwise=bitwise, max_abs_err=err,
                                     launches=counts,
                                     traffic=srv.traffic))
                if not bitwise or counts != want or \
                        not bool(torch.isfinite(new).all()):
                    fail(f"mesh server {mesh_name} {mode}/{wire}: card vs "
                         f"CPU bitwise {bitwise} (max|err|={err:.3e}), "
                         f"launches {counts}, expected {want}")
            print(f"  server on {mesh_name} ({n} shards on cuda:0), {wire}: "
                  f"{' '.join(modes)} bitwise the CPU's round; launches a "
                  f"round {partial[wire]}={n}"
                  + (f", fedasync {fold[wire]}={K_MAIN}"
                     if "fedasync" in modes else "")
                  + f"; traffic {srv.traffic}")
    del payloads, on_cpu
    return rows_out


def run_mesh(torch, wrappers, untraced):
    """The full-width CNN on the meshes (every shard on cuda:0), 5 rounds
    a run, each setting of ``MESH_SETTINGS`` on the batched engine (AS
    also on the sequential one): the single-device run again with its
    branch points recorded (bitwise phase 6's run), then the (2, 2) mesh
    on those branches twice (host fields phase 6's, params within phase
    5's bounds, the repeat bitwise), ``devices=4`` free-running (bitwise
    phase 6's run: a row a shard, added in the single device's order)
    and ``mesh_shape=(1, 4)`` (bitwise ``devices=4``).  Every mesh run's
    counters are reset before it and read after (a fold an admitted
    upload; one partial a shard a sync round).  Returns the rows and the
    mesh runs' launch counts."""
    from repro_torch.models import kinks
    setup = make_setup(width=32, hw=32, samples=2000, clients=16)
    # the wave program resolved once outside the recorded runs (``auto``
    # runs one forward pass per model), and the initial params
    warm = build_engine(torch, setup, "AS", "cuda")
    warm._wave_program()
    p0 = warm._flat_params.clone()
    del warm
    launches = dict.fromkeys(KERNELS, 0)
    rows = []

    def same(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    for name, setting, kw, spec in MESH_SETTINGS:
        for engine, batched in (("batched", True), ("sequential", False)):
            if not batched and name != "AS":
                continue
            skw = dict(kw, batch_clients=batched)
            base = untraced["runs"][name, engine]
            record = kinks.Record()
            with record:
                eng, res, _, _, _, _, _ = run_setting(torch, setup, setting,
                                                      skw, wrappers)
            if not same(eng._flat_params, base["params"]):
                fail(f"{name} {engine}: the recorded single-device run is "
                     "not phase 6's")
            del eng, res
            out = {}
            for label, n, mesh_kw, replayed in (
                    ("(2, 2)", 4, dict(mesh_shape=(2, 2)), True),
                    ("(2, 2) repeat", 4, dict(mesh_shape=(2, 2)), True),
                    ("devices=4", 4, dict(devices=4), False),
                    ("(1, 4)", 4, dict(mesh_shape=(1, 4)), False)):
                if not batched and label in ("(2, 2) repeat", "(1, 4)"):
                    continue
                eng = build_engine(torch, setup, setting,
                                   [torch.device("cuda", 0)] * n,
                                   **skw, **mesh_kw)
                replay = (kinks.Replay(record.choices) if replayed
                          else contextlib.nullcontext())
                with replay:
                    eng, res, counts, wall, split, finite, drawn = \
                        run_engine(torch, eng, wrappers, ROUNDS)
                want = {k: ROUNDS * n if v == "shards" else v
                        for k, v in spec.items()}
                check_run(torch, f"{name} {engine} {label}", skw, want, eng,
                          res, counts, finite, drawn)
                for k, c in counts.items():
                    launches[k] += c
                rec = run_record(eng, res, counts, drawn)
                host_differ = [key for key in HOST_FIELDS
                               if rec[key] != base["rec"][key]]
                err, rel, close, tol = params_distance(
                    torch, kw, eng._flat_params, base["params"], p0)
                params = eng._flat_params.clone()
                out[label] = dict(params=params, rec=rec)
                bitwise = same(params, base["params"])
                flips = (f"; the recorded branches: {replay.flips} units "
                         f"flipped, margin {replay.margin:.1e}"
                         if replayed else "")
                print(f"  {name} {engine} mesh {label}: launches "
                      + " ".join(f"{k}={c}" for k, c in counts.items() if c)
                      + f"; bytes/uploads/staleness/times "
                      f"{'equal' if not host_differ else f'DIFFER in {host_differ}'}"
                      f"; params {'bitwise' if bitwise else 'max|err|='}"
                      + ("" if bitwise else f"{err:.3e} rel {rel:.3e} ({tol})")
                      + f" vs phase 6{flips}; wall {wall:.3f} s "
                      f"(phase 6: {base['wall']:.3f}): {split_line(split)}")
                row = dict(setting=name, engine=engine, mesh=label,
                           host_equal=not host_differ,
                           params_bitwise=bitwise, params_max_abs_err=err,
                           params_rel_to_movement=rel, wall_s=wall,
                           phase6_wall_s=base["wall"], split_s=split,
                           launches=counts, traffic=eng._server.traffic)
                if replayed:
                    row.update(flips=replay.flips, margin=replay.margin)
                rows.append(row)
                if label == "(2, 2)" and (not batched or name == "AS"):
                    print(f"      traffic {eng._server.traffic}")
                if host_differ or not close:
                    fail(f"{name} {engine} mesh {label}: host fields "
                         f"{host_differ}, params {err} ({tol})")
                if replayed and not replay.done:
                    fail(f"{name} {engine} mesh {label}: the recorded "
                         "branches were not all taken")
                if label == "devices=4" and not bitwise:
                    fail(f"{name} {engine} devices=4: not bitwise phase 6's "
                         "single-device run")
                del eng, res
            if batched:
                rep, first = out["(2, 2) repeat"], out["(2, 2)"]
                if not same(rep["params"], first["params"]) or \
                        rep["rec"] != first["rec"]:
                    fail(f"{name}: the (2, 2) mesh run does not repeat")
                if not same(out["(1, 4)"]["params"],
                            out["devices=4"]["params"]) or \
                        out["(1, 4)"]["rec"] != out["devices=4"]["rec"]:
                    fail(f"{name}: mesh_shape=(1, 4) is not devices=4 "
                         "bitwise")
                print(f"      (2, 2) repeat bitwise; (1, 4) bitwise "
                      "devices=4")
            del record, out
    return rows, launches


# ---------------------------------------------------------------------------
# phases 5 and 6: the paper's other models (ResNet-18, VGG-16, the LSTM)
# ---------------------------------------------------------------------------


def other_model(name, size, n_classes):
    """(params, state, apply_fn) of ``name`` at ``size`` ("small" or
    "full"), drawn from prng_key(0) on the CPU."""
    from repro_torch.models.lstm import build_lstm
    from repro_torch.models.vision_cnn import build_paper_model
    from repro_torch.prng import prng_key
    kw = dict(OTHER_MODELS[name][size])
    if name.startswith("lstm"):
        return build_lstm(prng_key(0), name.split("-")[1], device="cpu",
                          **kw)
    return build_paper_model(name, prng_key(0), device="cpu",
                             n_classes=n_classes, in_ch=3, **kw)


def other_setup(name, size, samples, clients):
    """The model's dataset (images at 32x32, or the small ResNet's
    16x16), split and partitioned, and its CPU-drawn model."""
    from repro_torch.data import (build_client_shards, make_dataset,
                                  train_test_split)
    spec = OTHER_MODELS[name]
    kw = {}
    if spec["dataset"] == "cifar10":
        kw["hw"] = spec.get("small_hw", 32) if size == "small" else 32
    ds = make_dataset(spec["dataset"], n=samples, seed=0, **kw)
    tr, te = train_test_split(ds)
    dist, dist_kw = spec["dist"]
    shards = build_client_shards(tr, dist, clients, 32, seed=0, **dist_kw)
    return dict(ds=ds, shards=shards, te=te,
                model=other_model(name, size, ds.n_classes))


def flat_state(torch, state):
    from repro_torch import tree
    leaves = tree.tree_leaves(state)
    return (torch.cat([v.reshape(-1).cpu() for v in leaves]) if leaves
            else torch.zeros(0))


def check_one_step(torch, name, setup):
    """Train- and eval-mode logits and one local SGD step (one batch) of
    the model on the card against the CPU from the same weights: within
    ``rtol=1e-4, atol=1e-5`` (the model state too)."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.core import client
    p, s, fn = setup["model"]
    shard = setup["shards"][0]
    x = np.asarray(shard["xs"][0])
    x = x.astype(np.int64 if x.dtype.kind in "iu" else np.float32)
    y = np.asarray(shard["ys"][0], np.int64)
    kind = setup["ds"].kind
    out = {}
    for dev in ("cpu", "cuda"):
        to = lambda t, dev=dev: tree.tree_map(lambda v: v.to(dev), t)
        xs = torch.as_tensor(x, device=dev)
        lt, _ = fn(to(p), to(s), xs, True)
        le, _ = fn(to(p), to(s), xs, False)
        step = client.local_epoch(
            client.make_loss_fn(fn, kind), to(p), to(s), xs[None],
            torch.as_tensor(y, device=dev)[None],
            torch.as_tensor(shard["mask"][:1], device=dev),
            np.array([True]), 0.05)
        out[dev] = [t.detach().cpu() for t in (
            lt, le, torch.cat([v.reshape(-1) for v in
                               tree.tree_leaves(step[0])]))] + [
            flat_state(torch, step[1])]
    errs = [float((a - b).abs().max()) if a.numel() else 0.0
            for a, b in zip(out["cuda"], out["cpu"])]
    ok = all(torch.allclose(a, b, rtol=1e-4, atol=1e-5)
             for a, b in zip(out["cuda"], out["cpu"]))
    print(f"  {name} one step, card vs CPU: max|err| logits train "
          f"{errs[0]:.2e} eval {errs[1]:.2e}, params {errs[2]:.2e}, state "
          f"{errs[3]:.2e} (rtol=1e-4, atol=1e-5): "
          f"{'within' if ok else 'OUTSIDE'}")
    return ok, errs


def check_models_small(torch):
    """Phase 5 for the other models: ResNet-18 (width 4, 16x16), VGG-16
    (width 1/8, 32x32), the LSTM's sentiment head (Sentiment140,
    ``lognormal_text``) and char head (Shakespeare, ``by_role``), each in
    AS and SA (ResNet-18 also AA on q8) on the sequential and the
    batched engine (``auto`` waves: ``map`` for the conv models, ``vmap``
    for the LSTM, on both devices), the card against the CPU for
    OTHER_ROUNDS rounds.  One SGD step of each model on the card against
    the CPU from the same weights, within ``rtol=1e-4, atol=1e-5``.
    Then each setting, both engines free-running: bytes, schedule,
    staleness and waves exact, params within phase 5's bounds of the
    CPU's and the global BatchNorm state within ``rtol=1e-4,
    atol=1e-5``.  A conv model's CPU run takes the card run's ReLU and
    max-pool branches (:mod:`repro_torch.models.kinks`): a unit whose
    input lies within rounding of its kink lands on either side in two
    correct f32 runs and moves the step's gradient by its whole term, and
    free-running CPU runs of these settings that differ only so (oneDNN
    on and off) part by up to 1.2 of their movement; the q8 wire's
    ``round`` is taken likewise.  The units whose branch the CPU would
    have taken the other way are counted, and each must lie within 1e-3
    of its branch point (relative to its call's largest input), where a
    run that computes other values flips at order 1.  Every setting
    runs; the phase then fails if any missed."""
    from repro_torch.core import client
    from repro_torch.models import kinks
    rows, missed = [], []
    for name in OTHER_MODELS:
        setup = other_setup(name, "small", samples=400, clients=6)
        ok, errs = check_one_step(torch, name, setup)
        rows.append(dict(model=name, one_step_max_abs_err=errs,
                         one_step_within=ok))
        if not ok:
            missed.append(f"{name} one step")
        conv = not name.startswith("lstm")
        if conv:  # resolve auto's conv test outside the recorded runs
            p, s, fn = setup["model"]
            client.model_has_conv(fn, p, s,
                                  torch.as_tensor(setup["te"].x[:1]))
        names = ("AS", "SA") + (("AA-q8",) if name == "resnet18" else ())
        for sname in names:
            setting, kw, _ = OTHER_SETTINGS[sname]
            for batched in (False, True):
                eg = build_engine(torch, setup, setting, "cuda",
                                  batch_clients=batched, **kw)
                p0 = eg._flat_params.cpu()
                record = kinks.Record() if conv else contextlib.nullcontext()
                with record:
                    rg = eg.run(OTHER_ROUNDS)
                ec = build_engine(torch, setup, setting, "cpu",
                                  batch_clients=batched, **kw)
                replay = (kinks.Replay(record.choices) if conv
                          else contextlib.nullcontext())
                with replay:
                    rc = ec.run(OTHER_ROUNDS)
                same_host = (
                    ec.tx_bytes == eg.tx_bytes
                    and ec.rx_bytes == eg.rx_bytes
                    and rc.staleness_hist == rg.staleness_hist
                    and list(rc.participation) == list(rg.participation)
                    and list(rc.sched_stats["staleness_bins"])
                    == list(rg.sched_stats["staleness_bins"])
                    and ec.wave_size_hist == eg.wave_size_hist
                    and ec.wave_impl_resolved == eg.wave_impl_resolved
                    and [x.sim_time for x in rc.metrics.records]
                    == [x.sim_time for x in rg.metrics.records])
                err, rel, close, tol = params_distance(
                    torch, kw, eg._flat_params.cpu(), ec._flat_params, p0)
                sg, sc = (flat_state(torch, e.global_state)
                          for e in (eg, ec))
                s_err = float((sg - sc).abs().max()) if sc.numel() else 0.0
                s_close = torch.allclose(sg, sc, rtol=1e-4, atol=1e-5)
                taken = (f"the card's {len(record.choices)} branch points "
                         f"taken, {replay.flips} units the other side of "
                         f"the CPU's own, margin {replay.margin:.1e}"
                         if conv else "no branch points")
                label = (f"{name} {sname} "
                         f"{'batched' if batched else 'sequential'}")
                print(f"  {label} card vs CPU, {OTHER_ROUNDS} rounds: "
                      f"bytes/schedule {'equal' if same_host else 'DIFFER'}"
                      f", params max|err|={err:.3e} rel {rel:.3e}, state "
                      f"max|err|={s_err:.3e} ({tol}; state rtol=1e-4, "
                      f"atol=1e-5); {taken}"
                      + (f", waves {ec.wave_impl_resolved}"
                         if batched else ""))
                if not (same_host and close and s_close and (
                        not conv or (replay.done and replay.margin <= 1e-3))):
                    missed.append(label)
                rows.append(dict(
                    setting=f"{name} {sname}", batched=batched,
                    wave_impl=ec.wave_impl_resolved, host_equal=same_host,
                    params_max_abs_err=err, params_rel_to_movement=rel,
                    state_max_abs_err=s_err, within=close and s_close,
                    branch_points=len(record.choices) if conv else 0,
                    flipped_units=replay.flips if conv else 0,
                    flip_margin=replay.margin if conv else 0.0))
    if missed:
        fail(f"the other models on the card disagree with the CPU: "
             f"{missed}")
    return rows


def run_other_models(torch, wrappers):
    """Phase 6 for the other models at full width: ResNet-18 (width 64,
    D = 11,173,962, 9,600 state floats in 40 leaves) and VGG-16 (width 1,
    D = 15,240,906) on 32x32 synthetic CIFAR-10, the LSTM at the
    reference's defaults (embed 64, hidden 128: char D = 114,256,
    sentiment D = 163,074); 2000 samples, 16 clients, k = 4; the paper's
    four settings (ResNet-18 also AA on q8), OTHER_ROUNDS rounds each on
    the batched engine, every launch counter reset before and read after
    (a fold an upload, an aggregate a sync round), finite params and
    state after every round, then again from a fresh engine, which must
    repeat the first bit for bit (params, state, every record).  Returns
    the rows and the first runs' launches summed."""
    from repro_torch import tree
    rows = []
    launches = dict.fromkeys(KERNELS, 0)
    for name, spec in OTHER_MODELS.items():
        setup = other_setup(name, "full", samples=2000, clients=16)
        p0, s0, _ = setup["model"]
        d = sum(v.numel() for v in tree.tree_leaves(p0))
        n_state = sum(v.numel() for v in tree.tree_leaves(s0))
        if (d, n_state) != (spec["d_full"], spec["state_full"]):
            fail(f"{name}: D={d} and {n_state} state floats, expected "
                 f"{spec['d_full']} and {spec['state_full']}")
        names = ("AS", "AA", "SS", "SA") + (
            ("AA-q8",) if name == "resnet18" else ())
        print(f"  {name}: D = {d:,}, {n_state:,} state floats in "
              f"{len(tree.tree_leaves(s0))} leaves")
        for sname in names:
            setting, kw, spec_l = OTHER_SETTINGS[sname]
            runs = []
            for _ in range(2):
                eng = build_engine(torch, setup, setting, "cuda", **kw)
                out = run_engine(torch, eng, wrappers, OTHER_ROUNDS)
                runs.append(out)
            (eng, res, counts, wall, split, finite, drawn), \
                (eng2, res2, counts2, wall2, split2, _, drawn2) = runs
            label = f"{name} {sname}"
            check_run(torch, label, kw, spec_l, eng, res, counts, finite,
                      drawn, rounds=OTHER_ROUNDS)
            rec, rec2 = (run_record(e, r, c, dr) for e, r, c, dr in
                         ((eng, res, counts, drawn),
                          (eng2, res2, counts2, drawn2)))
            same = (torch.equal(eng._flat_params.view(torch.int32),
                                eng2._flat_params.view(torch.int32))
                    and torch.equal(
                        flat_state(torch, eng.global_state).view(torch.int32),
                        flat_state(torch, eng2.global_state).view(
                            torch.int32)))
            differ = [key for key in rec if rec[key] != rec2[key]]
            print(f"  {label}: acc/round "
                  f"{[round(a, 4) for a in rec['accuracy']]}  tx_bytes="
                  f"{eng.tx_bytes} uploads={rec['uploads']} waves "
                  f"{dict(sorted(eng.wave_size_hist.items()))} "
                  f"({eng.wave_impl_resolved})  launches "
                  + " ".join(f"{n}={c}" for n, c in counts.items() if c))
            print(f"      wall {wall:.3f} s: {split_line(split)}")
            records = ("every record equal" if not differ
                       else f"differ in {differ}")
            print(f"      repeat from a fresh engine: params and state "
                  f"{'bitwise equal' if same else 'DIFFER'}, {records}; "
                  f"wall {wall2:.3f} s: {split_line(split2)}")
            rows.append(dict(setting=label, d=d, state_floats=n_state,
                             **rec, wall_s=wall, split_s=split,
                             repeat=dict(bitwise=same, differing=differ,
                                         wall_s=wall2, split_s=split2)))
            if not same or differ:
                fail(f"{label}: a second run from a fresh engine does not "
                     f"repeat the first (params and state bitwise {same}, "
                     f"differing {differ})")
            for n, c in counts.items():
                launches[n] += c
            del eng, res, eng2, res2, runs
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
          f"max {ulp} ulp (tolerance 0), {same:.2%} of lanes bitwise")
    if ulp:
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


# ---------------------------------------------------------------------------
# phase 7e: the zoo
# ---------------------------------------------------------------------------


def expected_flash(cfg) -> int:
    """Flash launches of one prefill: one per self-attention layer."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    if cfg.family == "audio":
        return (cfg.enc_layers or cfg.n_layers) + cfg.n_layers
    return cfg.n_layers


def run_zoo(torch, fa_mod, wrappers):
    """Phase 7e: each of the nine other architectures served at full
    width (:data:`ZOO_DEPTH` cut), then the ten reduced configs and two
    sampled ones on the card against the CPU.  Returns (rows, the flash
    launches of the served runs)."""
    import numpy as np

    from repro_torch import prng
    from repro_torch.configs import ARCHS, get_config, reduced_config
    from repro_torch.launch import serve
    B, S, new = ZOO_BATCH, ZOO_PROMPT, ZOO_NEW
    smi = smi_line()
    rows, flash_total = [], 0
    for arch in ARCHS:
        if arch == SERVE_ARCH:
            continue
        cfg = get_config(arch)
        depth = ZOO_DEPTH.get(arch)
        served = cfg if depth is None else dataclasses.replace(
            cfg, n_layers=depth, first_k_dense=min(cfg.first_k_dense, depth))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for f in wrappers.values():
            f.launches = 0
        wall_ms, res = ms_of(torch, lambda: serve.run(served, B, S, new,
                                                      "cuda"))
        counts = {n: f.launches for n, f in wrappers.items() if f.launches}
        want = expected_flash(served)
        flash_total += counts.get("flash_attention", 0)
        n_params = res.model.param_count()
        tokens, inputs, prefix = serve.make_inputs(served, B, S, "cuda")
        fa_mod.flash_attention.launches = 0
        logits, gen, pre_s, dec_s = serve.generate(res.model, tokens, inputs,
                                                   prefix, new)
        per_serve = fa_mod.flash_attention.launches
        pre_ms, dec_ms = pre_s * 1e3, dec_s * 1e3 / new
        finite = bool(torch.isfinite(logits).all()
                      and torch.isfinite(res.logits).all())
        del logits, tokens, inputs
        peak = torch.cuda.max_memory_allocated()
        row = dict(arch=arch, family=cfg.family, params=n_params,
                   layers=served.n_layers, full_layers=cfg.n_layers,
                   reduced=(f"depth {depth} of {cfg.n_layers} layers"
                            if depth else None),
                   param_dtype=cfg.param_dtype, hd=cfg.hd, batch=B,
                   prompt=S, prefix=prefix, new_tokens=new, wall_ms=wall_ms,
                   run_prefill_ms=res.t_prefill * 1e3,
                   run_decode_ms=res.t_decode * 1e3, prefill_ms=pre_ms,
                   decode_ms_per_token=dec_ms, flash_per_serve=per_serve,
                   launches=counts,
                   peak_gib=peak / 2 ** 30, gen0=res.gen[0].tolist(),
                   smi=smi)
        rows.append(row)
        print(f"  {arch} ({cfg.family}, {n_params:,} params {cfg.param_dtype}"
              f", {served.n_layers}"
              + (f" of {cfg.n_layers} (reduced)" if depth else "")
              + f" layers, hd {cfg.hd}): serve.run wall {wall_ms / 1e3:.2f} s"
              f" (init included; its prefill {res.t_prefill * 1e3:.1f} ms); "
              f"prefill {pre_ms:.2f} ms, decode {dec_ms:.3f} ms per token "
              f"(B={B}, prompt {S}{f' + {prefix} prefix' if prefix else ''}"
              f"), flash {per_serve} per serve (expected {want}, all in "
              f"the prefill); peak {peak / 2 ** 30:.2f} GiB; "
              f"tokens[0] {res.gen[0].tolist()}; {smi}")
        if counts.get("flash_attention", 0) != want or per_serve != want \
                or set(counts) - {"flash_attention"}:
            fail(f"{arch}: launches {counts}, {per_serve} in the warm "
                 f"serve; expected {want} flash launches a serve and no "
                 "other")
        if not finite or gen.shape != (B, new) \
                or res.gen.shape != (B, new):
            fail(f"{arch}: non-finite logits or gen {res.gen.shape}")
        del res
    gc.collect()
    torch.cuda.empty_cache()

    # the ten reduced configs on the card against the CPU
    rb, rs, rn = ZOO_REDUCED_SHAPE
    reduced_rows = []
    for arch in ARCHS:
        rcfg = reduced_config(get_config(arch))
        temps = [0.0] + ([ZOO_TEMPERATURE] if arch in ZOO_SAMPLED else [])
        for temp in temps:
            on_card = serve.run(rcfg, rb, rs, rn, "cuda", temperature=temp)
            on_cpu = serve.run(rcfg, rb, rs, rn, "cpu", temperature=temp)
            err = float((on_card.logits.cpu() - on_cpu.logits).abs().max())
            ok = torch.allclose(on_card.logits.cpu(), on_cpu.logits,
                                atol=SERVE_F32_TOL, rtol=SERVE_F32_TOL)
            same = bool(np.array_equal(on_card.gen, on_cpu.gen))
            row = dict(arch=arch, temperature=temp, max_abs_err=err,
                       tokens_equal=same)
            note = ""
            if not same:
                i, j = np.argwhere(on_card.gen != on_cpu.gen)[0]
                top2 = torch.topk(on_cpu.logits[i], 2).values
                row["first_differing"] = [int(i), int(j)]
                note = (f" (first at row {i} step {j}; the prefill's top-2 "
                        f"margin {float(top2[0] - top2[1]):.3e})")
            if temp:
                keys = serve.sample_keys(rn)
                shape = tuple(on_cpu.logits.shape)
                noise_ulp = max(max_ulp(
                    prng.gumbel_torch(k, shape, "cuda").cpu().numpy(),
                    prng.gumbel_torch(k, shape, "cpu").numpy())
                    for k in keys)
                row["gumbel_max_ulp"] = noise_ulp
                note += f"; Gumbel noise card vs CPU max {noise_ulp} ulp " \
                        "(tolerance 1)"
            reduced_rows.append(row)
            print(f"  reduced {arch} (f32, B={rb}, prompt {rs}, {rn} new"
                  f"{f', T={temp}' if temp else ', greedy'}), card vs CPU: "
                  f"prefill logits max|err|={err:.3e} (tolerance "
                  f"atol=rtol={SERVE_F32_TOL}), tokens "
                  f"{'equal' if same else 'DIFFER'}{note}")
            if not (ok and same) or row.get("gumbel_max_ulp", 0) > 1:
                fail(f"reduced {arch} T={temp} on the card disagrees with "
                     "the CPU")
            del on_card, on_cpu
    return dict(served=rows, reduced=reduced_rows), flash_total


# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------


def train_full(torch, wrappers, smi):
    """Phase 8 (a): the full-width qwen3-1.7b through train.run, twice."""
    import numpy as np

    from repro_torch import tree as treemod
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    cfg = get_config(TRAIN_ARCH)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    runs = []
    for rep in range(2):
        gc.collect()
        torch.cuda.empty_cache()
        for f in wrappers.values():
            f.launches = 0
        t0 = time.perf_counter()
        res = train.run(cfg, steps=TRAIN_STEPS, batch=B, seq=S, lr=TRAIN_LR,
                        device="cuda", log_every=1,
                        log=(lambda line: print("  " + line)) if rep == 0
                        else None)
        wall = time.perf_counter() - t0
        counts = {n: f.launches for n, f in wrappers.items() if f.launches}
        if counts:
            fail(f"training launched kernels {counts}; expected none (its "
                 "attention is the PyTorch form)")
        if not all(np.isfinite(res.losses)):
            fail(f"non-finite training loss: {res.losses}")
        med = statistics.median(res.step_s[1:])
        runs.append(dict(losses=res.losses, step_ms=[t * 1e3 for t in
                                                     res.step_s],
                         median_step_ms=med * 1e3, tokens_per_s=B * S / med,
                         peak_gib=res.peak_bytes / 2 ** 30, wall_s=wall,
                         params=res.n_params))
        host = [leaf.cpu() for leaf in treemod.tree_leaves(res.params)]
        del res
        runs[-1]["host_params"] = host
        print(f"  run {rep + 1}: {TRAIN_STEPS} steps, B={B} x S={S}: "
              f"median step {med * 1e3:.1f} ms without the first "
              f"(first {runs[-1]['step_ms'][0]:.1f} ms), {B * S / med:,.0f} "
              "tokens/s,"
              f" peak {runs[-1]['peak_gib']:.2f} GiB, wall {wall:.1f} s "
              f"(init included); {smi}")
    same_loss = runs[0]["losses"] == runs[1]["losses"]
    same_params = all(torch.equal(a, b) for a, b in
                      zip(runs[0].pop("host_params"),
                          runs[1].pop("host_params")))
    print(f"  repeat: losses {'bitwise' if same_loss else 'DIFFER'}, "
          f"params {'bitwise' if same_params else 'DIFFER'}")
    if not (same_loss and same_params):
        fail("a second training run from the same key and stream is not "
             "bitwise the first")
    split = train_split(torch, cfg, smi)
    row = dict(arch=TRAIN_ARCH, batch=B, seq=S, steps=TRAIN_STEPS,
               lr=TRAIN_LR, optimizer=cfg.optimizer, remat=cfg.remat,
               runs=runs, repeat_bitwise=True, split=split, smi=smi)
    print(json.dumps({"phase": "8a", "arch": TRAIN_ARCH,
                      "losses": runs[0]["losses"],
                      "median_step_ms": runs[0]["median_step_ms"],
                      "tokens_per_s": runs[0]["tokens_per_s"],
                      "peak_gib": runs[0]["peak_gib"],
                      "repeat_bitwise": True, "smi": smi}))
    return row


def train_split(torch, cfg, smi):
    """Where a full-width training step's time goes: ``value_and_grad``
    and the AdamW update (in place) timed apart (host clock, device
    synchronized; medians of 3 after a warm step), then one step under
    ``torch.profiler``: the device's busy share and its top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps, train
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.prng import prng_key
    import numpy as np
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(cfg)
    params = model.init_params(prng_key(0), "cuda")
    vg = steps.value_and_grad(model.train_loss)
    opt = make_optimizer(cfg.optimizer, lr=TRAIN_LR)
    state = opt.init(params)
    batch = train.to_device(train.synthetic_lm_batch(
        np.random.default_rng(0), cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ),
        "cuda")
    vg_ms, upd_ms = [], []
    for i in range(4):
        ms, (_, grads) = ms_of(torch, lambda: vg(params, batch))
        vg_ms.append(ms)
        ms, _ = ms_of(torch, lambda: opt.update(params, grads, state, i))
        upd_ms.append(ms)
        del grads
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, grads = vg(params, batch)
        opt.update(params, grads, state, 4)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    del grads, params, state
    spans, by_name = [], collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += (b - max(a, end)) / 1e3
            end = b
    top = by_name.most_common(6)
    gemm = sum(v for k, v in by_name.items()
               if any(t in k.lower() for t in ("gemm", "xmma", "cutlass")))
    out = dict(vg_ms=statistics.median(vg_ms[1:]),
               update_ms=statistics.median(upd_ms[1:]),
               profiled_wall_ms=wall_ms, busy_ms=busy if spans else None,
               device_events=len(spans), gemm_ms=gemm,
               top=[[k, v] for k, v in top])
    print(f"  step split (medians of 3 after a warm step): value_and_grad "
          f"{out['vg_ms']:.1f} ms, AdamW update {out['update_ms']:.1f} ms; "
          f"one profiled step: wall {wall_ms:.1f} ms, "
          + (f"device busy {busy:.1f} ms ({busy / wall_ms:.1%}), GEMM "
             f"kernels {gemm:.1f} ms, {len(spans)} device events; top: "
             + "; ".join(f"{k} {v:.1f} ms" for k, v in top)
             if spans else "the profiler saw no device activity")
          + f"; {smi}")
    return out


def train_fl(torch, k_mod, wrappers, smi):
    """Phase 8 (b): the FL train step at qwen3-1.7b's full width, depth
    cut: FL_ROUNDS timed rounds of each setting, the peak read after
    them, then one round whose aggregate is held against its plain
    version (its check outside the times and the peak).  Returns (rows,
    its safl_aggregate launches)."""
    import numpy as np

    from repro_torch import tree as treemod
    from repro_torch.configs import get_config
    from repro_torch.launch import steps, train
    from repro_torch.models import build_model
    from repro_torch.prng import prng_key
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=FL_LAYERS)
    model = build_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    init = model.init_params(prng_key(0), "cuda")
    d = model.param_count(init)
    held = []
    real = steps.ops.safl_aggregate

    def checked(u, w, *a, **k):
        out = real(u, w, *a, **k)
        want = k_mod.safl_aggregate_plain(u, w, *a, **k)
        same = bool(torch.equal(out, want))
        held.append(dict(bitwise=same, max_abs_err=0.0 if same else
                         float((out - want).abs().max())))
        del want
        return out

    rows, total = [], 0
    try:
        for agg, inner, weights in FL_SETTINGS:
            step, opt = steps.make_fl_train_step(
                model, cfg, aggregation=agg, lr=TRAIN_LR, inner_steps=inner)
            ps = treemod.tree_map(lambda x: torch.stack([x, x]), init)
            os_ = treemod.tree_map(lambda x: torch.stack([x, x]),
                                   opt.init(init))
            rng = np.random.default_rng(0)
            torch.cuda.reset_peak_memory_stats()
            for f in wrappers.values():
                f.launches = 0
            round_ms, losses, peak = [], [], None
            for rnd in range(FL_ROUNDS + 1):
                if rnd == FL_ROUNDS:  # the held round
                    peak = torch.cuda.max_memory_allocated() / 2 ** 30
                    steps.ops.safl_aggregate = checked
                batch = train.to_device(train.synthetic_lm_batch(
                    rng, cfg.vocab_size, FL_BATCH, FL_SEQ), "cuda")
                before = k_mod.safl_aggregate.launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ps, os_, met = step(ps, os_, batch, rnd, weights)
                loss = float(met["loss"])
                torch.cuda.synchronize()
                if rnd < FL_ROUNDS:
                    round_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(loss)
                n = k_mod.safl_aggregate.launches - before
                synced = all(torch.equal(leaf[0], leaf[1])
                             for leaf in treemod.tree_leaves(ps))
                drift = 0.0 if synced else max(
                    float((leaf[0] - leaf[1]).abs().max())
                    for leaf in treemod.tree_leaves(ps))
                if n != 1 or drift or not np.isfinite(loss):
                    fail(f"FL {agg} inner {inner} w={weights} round {rnd}: "
                         f"{n} safl_aggregate launches (expected 1), pod "
                         f"drift {drift}, loss {loss}")
            steps.ops.safl_aggregate = real
            if not held[-1]["bitwise"]:
                fail(f"FL {agg} w={weights}: safl_aggregate "
                     f"{held[-1]['max_abs_err']:.3e} from its plain version "
                     "on the same rows")
            counts = {k: f.launches for k, f in wrappers.items()
                      if f.launches}
            if set(counts) != {"safl_aggregate"}:
                fail(f"FL {agg}: launches {counts}")
            total += counts["safl_aggregate"]
            rows.append(dict(aggregation=agg, inner_steps=inner,
                             weights=list(weights), losses=losses,
                             round_ms=round_ms, launches=counts,
                             peak_gib=peak, d=d))
            print(f"  FL {agg} (inner {inner}) weights {weights}: "
                  f"{FL_ROUNDS} timed rounds and 1 held, B={FL_BATCH} x "
                  f"S={FL_SEQ} on 2 pods, losses "
                  f"{[round(x, 4) for x in losses]}, round ms "
                  f"{[round(x, 1) for x in round_ms]}, safl_aggregate "
                  f"{counts['safl_aggregate']} launches (1 a round; "
                  f"(2, {d:,}) f32 rows, bitwise the plain version in the "
                  f"held round), pod drift 0, peak {peak:.2f} GiB over the "
                  f"timed rounds; {smi}")
            del ps, os_, step, opt
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        steps.ops.safl_aggregate = real
    del init
    # the kernel at the FL step's shape: K = 2 rows of D, mode avg
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(8)
    u = torch.randn((2, d), device="cuda", generator=g)
    w = torch.tensor([1.0, 0.5], device="cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    before = k_mod.safl_aggregate.launches
    kernel_ms = time_ms(torch, lambda: k_mod.safl_aggregate(u, w, mode="avg"),
                        flush, n=10, hold=True)
    k_mod.safl_aggregate.launches = before  # timing, not the path
    plain_ms = time_ms(torch, lambda: k_mod.safl_aggregate_plain(
        u, w, mode="avg"), flush, n=5)
    bound_ms = 3 * d * 4 / HBM_BYTES_PER_S * 1e3
    timing = dict(d=d, k=2, kernel_ms=kernel_ms, plain_ms=plain_ms,
                  bound_ms=bound_ms, share=bound_ms / kernel_ms)
    print(f"  safl_aggregate (avg) at the FL step's shape (2, {d:,}): "
          f"{kernel_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes, "
          f"{3 * d * 4 / 1e9:.2f} GB), {bound_ms / kernel_ms:.1%} of it; "
          f"plain {plain_ms:.4f} ms; {smi}")
    del u, w, flush
    print(json.dumps({"phase": "8b", "arch": TRAIN_ARCH,
                      "reduced": f"depth {FL_LAYERS} of 28 layers",
                      "d": d, "safl_aggregate_launches": total,
                      "round_ms": {f"{r['aggregation']}{r['weights']}":
                                   r["round_ms"] for r in rows},
                      "safl_aggregate_ms": kernel_ms, "smi": smi}))
    return dict(arch=TRAIN_ARCH, layers=FL_LAYERS, full_layers=28,
                reduced=f"depth {FL_LAYERS} of 28 layers", pods=2,
                batch=FL_BATCH, seq=FL_SEQ, settings=rows,
                safl_aggregate_timing=timing, smi=smi), total


def train_reduced(torch):
    """Phase 8 (c): the ten reduced configs, card against CPU."""
    import numpy as np

    from repro_torch import tree as treemod
    from repro_torch.configs import ARCHS, get_config, reduced_config
    from repro_torch.launch import steps, train
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.prng import prng_key
    B, S = TRAIN_REDUCED_SHAPE
    rows = []
    for arch in ARCHS:
        cfg = reduced_config(get_config(arch))
        model = build_model(cfg)
        vg = steps.value_and_grad(model.train_loss)
        opt = make_optimizer(cfg.optimizer, lr=TRAIN_LR)
        p_cpu = model.init_params(prng_key(0), "cpu")
        p_gpu = treemod.tree_map(lambda x: x.to("cuda"), p_cpu)
        s_cpu, s_gpu = opt.init(p_cpu), opt.init(p_gpu)
        rng = np.random.default_rng(0)
        worst = dict(loss=0.0, grad=0.0, params=0.0)
        bitwise = True
        for step in range(TRAIN_REDUCED_STEPS):
            data = train.add_extras(train.synthetic_lm_batch(
                rng, cfg.vocab_size, B, S), cfg, rng)
            (lc, mc), gc_ = vg(p_cpu, train.to_device(data, "cpu"))
            (lg, mg), gg = vg(p_gpu, train.to_device(data, "cuda"))
            for name, a, b in [("total", lg, lc)] + [
                    (k, mg[k], mc[k]) for k in mc]:
                rel = abs(float(a) - float(b)) / max(abs(float(b)), 1e-6)
                worst["loss"] = max(worst["loss"], rel)
                if rel > TRAIN_LOSS_RTOL:
                    fail(f"reduced {arch} step {step}: {name} "
                         f"{float(a)} on the card, {float(b)} on the CPU")
            for a, b in zip(treemod.tree_leaves(gg),
                            treemod.tree_leaves(gc_)):
                scale = max(float(b.abs().max()), 1e-30)
                err = float((a.cpu() - b).abs().max()) / scale
                worst["grad"] = max(worst["grad"], err)
                if err > TRAIN_GRAD_TOL:
                    fail(f"reduced {arch} step {step}: a gradient leaf "
                         f"{err:.3e} of its largest from the CPU's")
            p_cpu, s_cpu = opt.update(p_cpu, gc_, s_cpu, step)
            p_gpu, s_gpu = opt.update(
                p_gpu, treemod.tree_map(lambda x: x.to("cuda"), gc_), s_gpu,
                step)
            for a, b in zip(treemod.tree_leaves((p_gpu, s_gpu)),
                            treemod.tree_leaves((p_cpu, s_cpu))):
                a = a.cpu()
                bitwise = bitwise and torch.equal(a, b)
                err = float(((a - b).abs() - TRAIN_RTOL * b.abs()).max())
                worst["params"] = max(worst["params"], err)
                if err > TRAIN_ATOL:
                    fail(f"reduced {arch} step {step}: params or optimizer "
                         "state outside rtol=1e-5, atol=1e-6 of the CPU's")
        rows.append(dict(arch=arch, optimizer=cfg.optimizer, batch=B, seq=S,
                         steps=TRAIN_REDUCED_STEPS,
                         loss_max_rel=worst["loss"],
                         grad_max_rel=worst["grad"],
                         params_bitwise=bitwise))
        print(f"  reduced {arch} ({cfg.family}, {cfg.optimizer}, B={B} x "
              f"S={S}, {TRAIN_REDUCED_STEPS} steps), card vs CPU: loss max "
              f"rel {worst['loss']:.2e} (tolerance {TRAIN_LOSS_RTOL}), "
              f"gradients max {worst['grad']:.2e} of a leaf's largest "
              f"(tolerance {TRAIN_GRAD_TOL}), params and state after the "
              f"same gradients {'bitwise' if bitwise else 'within bounds'}")
    print(json.dumps({"phase": "8c", "reduced": [
        {k: r[k] for k in ("arch", "loss_max_rel", "grad_max_rel",
                           "params_bitwise")} for r in rows]}))
    return rows


def check_flash_refusal(torch, fa_mod):
    """Phase 8 (d): a differentiable bf16 input raises, launching
    nothing."""
    from repro_torch.kernels import ops
    q = torch.randn(1, 128, 2, 64, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.randn(1, 128, 2, 64, device="cuda", dtype=torch.bfloat16)
    before = fa_mod.flash_attention.launches
    for fn in (fa_mod.flash_attention, ops.flash_attention):
        try:
            fn(q, k, k)
        except RuntimeError as e:
            msg = str(e)
        else:
            fail("flash_attention took a differentiable input")
    if fa_mod.flash_attention.launches != before:
        fail("the refused flash_attention call launched")
    with torch.no_grad():
        out = fa_mod.flash_attention(q, k, k)
    print(f"  (d) flash_attention with a bf16 q that requires grad: "
          f"RuntimeError ({msg[:60]}...), no launch; under no_grad it runs "
          f"({tuple(out.shape)})")
    print(json.dumps({"phase": "8d", "flash_refuses_grad": True}))
    return dict(refused=True, message=msg)


def run_training(torch, k_mod, fa_mod, wrappers):
    """Phase 8: (a)-(d).  Returns (rows, the FL step's safl_aggregate
    launches)."""
    smi = smi_line()
    t0 = time.perf_counter()
    full = train_full(torch, wrappers, smi)
    print(f"  (a): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fl, fl_launches = train_fl(torch, k_mod, wrappers, smi)
    print(f"  (b): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    reduced = train_reduced(torch)
    print(f"  (c): {time.perf_counter() - t0:.1f} s")
    refusal = check_flash_refusal(torch, fa_mod)
    return dict(full=full, fl=fl, reduced=reduced,
                flash_refusal=refusal), fl_launches


# ---------------------------------------------------------------------------
# phase 9: the dry run, and its accounting against a step on the card
# ---------------------------------------------------------------------------


def run_dryrun(torch, smi):
    """Phase 9: (a) the dry run's pairs on both production meshes; (b) its
    accounting of phase 8a's step against one more step on the card."""
    from torch.utils.flop_counter import FlopCounterMode

    import numpy as np

    from repro_torch import tree as treemod
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.mesh import AxisMesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.prng import prng_key

    out_dir = os.path.join(ROOT, "chiprun_out", "dryrun_torch")
    t0 = time.perf_counter()
    pairs = []
    for arch, shape in DRYRUN_PAIRS:
        for mesh in ("single", "multi"):
            rec = dryrun.run_pair(arch, shape, mesh, out_dir)
            pairs.append({k: rec.get(k) for k in (
                "arch", "shape", "mesh", "status", "reason", "error",
                "trace_s", "model_flops", "flops_global",
                "useful_flops_ratio", "peak_live_B_global", "memory",
                "collective_bytes", "bottleneck")})
            print(f"  [{rec['status']}] {arch} x {shape} x {mesh}: "
                  + (f"{rec['trace_s']} s, flops {rec['flops_global']:.4e}"
                     f" (model {rec['model_flops']:.4e}), peak live "
                     f"{rec['peak_live_B_global'] / 2**30:,.1f} GiB, "
                     f"argument {rec['memory']['argument_size_B']:,} B a "
                     f"device, {rec['bottleneck']}"
                     if rec["status"] == "OK" else
                     rec.get("reason") or rec.get("error")))
            if rec["status"] == "FAIL" or (
                    rec["status"] == "SKIP" and (arch, shape) != (
                        "seamless-m4t-medium", "long_500k")):
                fail(f"dry run {arch} x {shape} x {mesh}: {rec['status']} "
                     f"{rec.get('error', rec.get('reason'))}")
    wall_a = time.perf_counter() - t0
    print(json.dumps({"phase": "9a", "records": len(pairs),
                      "ok": sum(r["status"] == "OK" for r in pairs),
                      "skip": sum(r["status"] == "SKIP" for r in pairs),
                      "wall_s": wall_a}))

    # (b) phase 8a's step: the dry run's record on a one-device mesh ...
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    shape = InputShape("phase9b", TRAIN_SEQ, TRAIN_BATCH, "train")
    rec = dryrun.measure(cfg, shape, AxisMesh({"data": 1, "model": 1}))
    # ... and the same step on the card: phase 8a's model, optimizer and
    # first batch (int32 tokens, as the dry run's specs give them)
    gc.collect()
    torch.cuda.empty_cache()
    if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):
        torch._C._cuda_clearCublasWorkspaces()
    before = torch.cuda.memory_allocated()
    model = build_model(cfg)
    params = model.init_params(prng_key(0), "cuda")
    step_fn, opt = make_train_step(model, cfg, lr=TRAIN_LR)
    state = opt.init(params)
    toks = train.synthetic_lm_batch(np.random.default_rng(0),
                                    cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    batch = {"tokens": torch.as_tensor(toks["tokens"]).to("cuda")}
    args = treemod.tree_leaves(params) + treemod.tree_leaves(state) + [
        batch["tokens"]]
    arg_bytes = sum(t.numel() * t.element_size() for t in args)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        step_fn(params, state, batch, 0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    flops = fc.get_total_flops()
    del params, state, batch, args
    gc.collect()
    torch.cuda.empty_cache()
    ratio = rec["peak_live_B_global"] / peak
    row = dict(arch=TRAIN_ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               optimizer=cfg.optimizer, meta_flops=rec["flops_global"],
               card_flops=flops, meta_argument_B=rec["memory"][
                   "argument_size_B"], card_argument_B=arg_bytes,
               card_allocated_B=held,
               meta_peak_live_B=rec["peak_live_B_global"],
               card_peak_B=peak, peak_ratio=ratio,
               meta_trace_s=rec["trace_s"], op_bytes=rec["op_bytes_global"],
               model_flops=rec["model_flops"],
               wall_s=time.perf_counter() - t0, smi=smi)
    print(f"  (b) {TRAIN_ARCH} B {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"{cfg.optimizer}: FLOPs dry run {rec['flops_global']:,.0f} / "
          f"card {flops:,}; argument bytes dry run "
          f"{rec['memory']['argument_size_B']:,} / card {arg_bytes:,} "
          f"(allocated {held:,}); peak live dry run "
          f"{rec['peak_live_B_global']:,} B "
          f"({rec['peak_live_B_global'] / 2**30:.2f} GiB) / card "
          f"max_memory_allocated {peak:,} B ({peak / 2**30:.2f} GiB): "
          f"ratio {ratio:.4f} (bounds {DRYRUN_PEAK_RATIO}); op bytes "
          f"{rec['op_bytes_global']:,.0f}; {smi}")
    print(json.dumps({"phase": "9b", **{k: v for k, v in row.items()
                                        if k != "smi"}}))
    if flops != rec["flops_global"]:
        fail(f"the dry run's FLOPs {rec['flops_global']} are not the card "
             f"step's {flops}")
    if arg_bytes != rec["memory"]["argument_size_B"]:
        fail(f"the dry run's argument bytes "
             f"{rec['memory']['argument_size_B']} are not the card's "
             f"{arg_bytes}")
    if not DRYRUN_PEAK_RATIO[0] <= ratio <= DRYRUN_PEAK_RATIO[1]:
        fail(f"the dry run's peak over the card's, {ratio:.4f}, is outside "
             f"{DRYRUN_PEAK_RATIO}")
    return dict(pairs=pairs, wall_a_s=wall_a, step=row)


# ---------------------------------------------------------------------------
# phase 10: the q8 round's int8-dot regime on the card
# ---------------------------------------------------------------------------


def per_round_launches(eng, kernels):
    """Count, server round by server round, the launches each wrapper of
    ``kernels`` makes: a list of tuples, one a round."""
    seen = []
    agg = eng._aggregate

    def aggregate(*a, _agg=agg, **k):
        before = [f.launches for f in kernels]
        out = _agg(*a, **k)
        seen.append(tuple(f.launches - b for f, b in zip(kernels, before)))
        return out

    eng._aggregate = aggregate
    return seen


def regime_mesh_server(torch, i8_mod, wrappers):
    """The regime's server round at the CNN's full D on K = 64 q8 rows,
    fedsgd (unit weights) and fedavg (data sizes): on one device and on
    the (2, 2) mesh with every shard on cuda:0, each on the card and on
    the CPU.  Card and CPU bitwise (the kernel is bitwise its plain
    version, the rest the same ops); one int8-dot launch on the single
    device, one a shard on the mesh; the mesh round within
    :data:`REGIME_MESH_LEVELS` coefficient levels of the single device's
    in every lane (plus 1e-6 of f32 rounding)."""
    import numpy as np

    from repro_torch.core.aggregation import FlatServer
    from repro_torch.kernels import ref
    from repro_torch.launch.fl_sim import SERVER_LR
    from repro_torch.sharding import flat
    name = "weighted_sum_q8_int8dot"
    g = torch.Generator(device="cuda").manual_seed(12)
    rows = q8_rows(torch, REGIME_K, D_FULL, g)
    on_cpu = tuple(a.cpu() for a in rows)
    p = torch.randn((D_FULL,), device="cuda", generator=g)
    sizes = np.random.default_rng(12).integers(
        1, 100, REGIME_K).astype(np.float32)
    out = []
    for mode, w in (("fedsgd", np.ones(REGIME_K, np.float32)),
                    ("fedavg", sizes)):
        got = {}
        for where in ("cuda", "cpu"):
            for shape in (None, (2, 2)):
                mesh = None if shape is None else card_mesh(
                    torch, shape, "cpu" if where == "cpu"
                    else [torch.device("cuda", 0)] * 4)
                srv = FlatServer(mode, D_FULL,
                                 server_lr=SERVER_LR.get(mode, 1.0),
                                 wire="q8", device=where, mesh=mesh)
                buf = flat.shard_rows(rows if where == "cuda" else on_cpu,
                                      mesh)
                pp = p if where == "cuda" else p.cpu()
                for f in wrappers.values():
                    f.launches = 0
                new, _, _ = srv.step(pp, buf, w, srv.init_opt(pp))
                torch.cuda.synchronize()
                got[where, shape] = (new.cpu(), {
                    n: f.launches for n, f in wrappers.items()
                    if f.launches})
        single, mesh22 = got["cuda", None], got["cuda", (2, 2)]
        bitwise = all(torch.equal(got["cuda", sh][0], got["cpu", sh][0])
                      for sh in (None, (2, 2)))
        diff = (mesh22[0] - single[0]).abs()
        err = float(diff.max())
        # a lane's move for one coefficient level on the single device's
        # grid (its weights normalized as FlatServer normalizes them)
        wn = w / max(flat.xla_sum(w), np.float32(1e-12))
        level = 127 * ref.int8dot_coeff_scale(
            rows[1], torch.from_numpy(wn).cuda()).repeat_interleave(QB)
        level = (level[:D_FULL] * (1.0 if mode == "fedavg"
                                   else SERVER_LR[mode])).cpu()
        levels = float(((diff - 1e-6).clamp_min(0) / level).max())
        launches = (single[1], mesh22[1])
        print(f"  regime server {mode} K={REGIME_K} D={D_FULL:,}: card vs "
              f"CPU {'bitwise' if bitwise else 'DIFFER'} (single device "
              f"and (2, 2)); (2, 2) on cuda:0 vs the single device "
              f"max|err|={err:.3e}, {levels:.3f} coefficient levels "
              f"(tolerance {REGIME_MESH_LEVELS} levels + 1e-6); launches "
              f"single {single[1]}, (2, 2) {mesh22[1]}")
        out.append(dict(mode=mode, card_cpu_bitwise=bitwise,
                        mesh_vs_single_max_abs_err=err,
                        mesh_vs_single_levels=levels,
                        launches_single=single[1], launches_mesh=mesh22[1]))
        if not (bitwise and levels <= REGIME_MESH_LEVELS
                and launches == ({name: 1}, {name: 4})):
            fail(f"regime server {mode}: card vs CPU bitwise {bitwise}, "
                 f"mesh vs single {err:.3e} ({levels:.3f} levels), "
                 f"launches {launches}")
    del rows, on_cpu, p
    return out


def run_int8dot_regime(torch, i8_mod, k_mod, wrappers, smi):
    """Phase 10: the q8 round's int8-dot regime, ``REPRO_INT8_DOT=1`` set
    in this process and removed after.  (a) the full-width CNN engine
    (phase 6's setup with 64 clients), sync, q8 wire, K = 64, 3 rounds of
    fedsgd (SS) and fedavg (SA): every round one int8-dot launch and no
    fused q8 aggregate, every other counter 0, finite params and eval;
    (b) ``fl_sim`` as its CLI runs the regime (``--mode sync --wire q8
    --clients 64 --k 64``); (c) the same two settings at phase 5's size
    (64 clients) on the card and on the CPU: host fields equal, params
    within :data:`REGIME_CPU_RTOL` of the CPU run's movement; (d)
    :func:`regime_mesh_server`.  Then (e) with the variable unset, run (a)'s
    fedsgd again: no int8-dot launch, the fused q8 aggregate once a round.
    Returns (rows, the int8-dot launches of the regime's runs)."""
    import io

    from repro_torch.launch import fl_sim
    name = "weighted_sum_q8_int8dot"
    per_kernels = (i8_mod.weighted_sum_q8_int8dot, k_mod.safl_aggregate_q8)
    kw = dict(k=REGIME_K, wire="q8")
    rows, total = dict(full=[], small=[]), 0
    setup = make_setup(width=32, hw=32, samples=2000, clients=REGIME_K)
    os.environ["REPRO_INT8_DOT"] = "1"
    try:
        for setting in REGIME_SETTINGS:
            eng = build_engine(torch, setup, setting, "cuda", **kw)
            per = per_round_launches(eng, per_kernels)
            eng, res, counts, wall, split, finite, drawn = run_engine(
                torch, eng, wrappers, REGIME_ROUNDS)
            check_run(torch, f"regime {setting}", kw, {name: REGIME_ROUNDS},
                      eng, res, counts, finite, drawn, rounds=REGIME_ROUNDS)
            if per != [(1, 0)] * REGIME_ROUNDS:
                fail(f"regime {setting}: (int8-dot, safl_aggregate_q8) "
                     f"launches by round {per}")
            total += counts[name]
            acc = [round(r.accuracy, 4) for r in res.metrics.records]
            print(f"  regime {setting} full width (D = {D_FULL:,}), K = "
                  f"{REGIME_K}, {REGIME_ROUNDS} rounds: acc/round {acc}, "
                  f"(int8-dot, safl_aggregate_q8) launches by round {per}, "
                  f"wall {wall:.3f} s: {split_line(split)}; {smi}")
            rows["full"].append(dict(setting=setting, accuracy=acc,
                                     per_round=per, wall_s=wall,
                                     split_s=split, launches=counts))
            del eng
        for f in wrappers.values():
            f.launches = 0
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            summary = fl_sim.main([
                "--mode", "sync", "--wire", "q8", "--clients",
                str(REGIME_K), "--k", str(REGIME_K), "--rounds",
                str(REGIME_ROUNDS), "--device", "cuda"])
        wall = time.perf_counter() - t0
        counts = {n: f.launches for n, f in wrappers.items() if f.launches}
        print(f"  fl_sim --mode sync --wire q8 --clients {REGIME_K} --k "
              f"{REGIME_K} --rounds {REGIME_ROUNDS} (REPRO_INT8_DOT=1): "
              f"launches {counts}, wall {wall:.3f} s")
        if counts != {name: REGIME_ROUNDS}:
            fail(f"fl_sim in the regime: launches {counts}")
        total += counts[name]
        rows["fl_sim"] = dict(launches=counts, wall_s=wall,
                              log=log.getvalue()[-4000:],
                              summary_keys=sorted(summary))
        small = make_setup(width=4, hw=8, samples=2000, clients=REGIME_K)
        for setting in REGIME_SETTINGS:
            runs = {}
            for dev in ("cpu", "cuda"):
                eng = build_engine(torch, small, setting, dev, **kw)
                p0 = eng._flat_params.cpu()
                for f in wrappers.values():
                    f.launches = 0
                res = eng.run(REGIME_ROUNDS)
                counts = {n: f.launches for n, f in wrappers.items()
                          if f.launches}
                runs[dev] = (eng, run_record(eng, res, counts, {}))
            (ec, rc), (eg, rg) = runs["cpu"], runs["cuda"]
            host_differ = [key for key in HOST_FIELDS if rc[key] != rg[key]]
            pc, pg = ec._flat_params, eg._flat_params.cpu()
            rel = float((pc - pg).norm() / (pc - p0).norm())
            print(f"  regime {setting} small (width 4, 8x8, {REGIME_K} "
                  f"clients) card vs CPU, {REGIME_ROUNDS} rounds: host "
                  f"fields {'equal' if not host_differ else host_differ}, "
                  f"params relative to the CPU run's movement {rel:.3e} "
                  f"(tolerance {REGIME_CPU_RTOL}); launches card "
                  f"{rg['launches']}, CPU {rc['launches']}")
            rows["small"].append(dict(setting=setting, rel=rel,
                                      host_differ=host_differ,
                                      launches=rg["launches"]))
            if host_differ or not rel <= REGIME_CPU_RTOL or \
                    rg["launches"] != {name: REGIME_ROUNDS} or \
                    rc["launches"]:
                fail(f"regime {setting} small: card vs CPU {host_differ}, "
                     f"rel {rel:.3e}, launches {rg['launches']} / "
                     f"{rc['launches']}")
            total += rg["launches"][name]
            del runs, ec, eg
        rows["mesh_server"] = regime_mesh_server(torch, i8_mod, wrappers)
        total += sum(r["launches_single"][name] + r["launches_mesh"][name]
                     for r in rows["mesh_server"])
    finally:
        del os.environ["REPRO_INT8_DOT"]
    eng = build_engine(torch, setup, "SS", "cuda", **kw)
    per = per_round_launches(eng, per_kernels)
    eng, res, counts, wall, _, finite, drawn = run_engine(
        torch, eng, wrappers, REGIME_ROUNDS)
    check_run(torch, "SS q8 K=64, REPRO_INT8_DOT unset", kw,
              {"safl_aggregate_q8": REGIME_ROUNDS}, eng, res, counts, finite,
              drawn, rounds=REGIME_ROUNDS)
    print(f"  REPRO_INT8_DOT unset, SS full width K = {REGIME_K}: "
          f"(int8-dot, safl_aggregate_q8) launches by round {per}")
    rows["unset"] = dict(per_round=per, launches=counts)
    del eng
    print(json.dumps({"phase": "10", "int8dot_launches": total,
                      "full_width_wall_s": [r["wall_s"]
                                            for r in rows["full"]],
                      "small_rel": [r["rel"] for r in rows["small"]],
                      "mesh_vs_single_levels": [
                          r["mesh_vs_single_levels"]
                          for r in rows["mesh_server"]],
                      "unset_per_round": per, "smi": smi}))
    return rows, total


# ---------------------------------------------------------------------------
# phase 11: the two LLM examples
# ---------------------------------------------------------------------------


def load_example(name):
    """``examples/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_examples(torch, wrappers, smi):
    """Phase 11: (a) ``examples/torch_serve_batched.py`` with its defaults
    (the reduced xlstm-125m, 16 requests, 48 new tokens) on the card;
    (b) its loop on the full-width qwen3-1.7b: 16 requests of 8-32
    tokens, 48 new, one flash launch a layer in the prefill, every id
    inside the vocabulary; (c) ``examples/torch_distributed_pretrain.py``
    under fedsgd and fedavg, 20 steps each: one ``safl_aggregate`` launch
    a step, the drift between the pods 0.  Returns (rows, flash launches,
    safl_aggregate launches)."""
    import math

    from repro_torch.configs import get_config
    serve_ex = load_example("torch_serve_batched")
    pretrain_ex = load_example("torch_distributed_pretrain")
    rows = {}

    def counts():
        return {n: f.launches for n, f in wrappers.items() if f.launches}

    def reset():
        for f in wrappers.values():
            f.launches = 0

    reset()
    t0 = time.perf_counter()
    out = serve_ex.main([])
    wall = time.perf_counter() - t0
    if counts() or out["batch"] != SERVE_BATCHED_REQUESTS:
        fail(f"torch_serve_batched defaults: launches {counts()}, batch "
             f"{out['batch']}")
    rows["serve_defaults"] = dict(wall_s=wall, lens=out["lens"],
                                  steps=out["steps"],
                                  t_prefill=out["t_prefill"],
                                  t_decode=out["t_decode"])
    print(json.dumps({"phase": "11a", "example": "torch_serve_batched",
                      "arch": "xlstm-125m (reduced)", "wall_s": wall,
                      "prefill_s": out["t_prefill"],
                      "decode_s": out["t_decode"], "steps": out["steps"],
                      "smi": smi}))
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(SERVE_ARCH)
    reset()
    t0 = time.perf_counter()
    out = serve_ex.run(cfg, SERVE_BATCHED_REQUESTS, SERVE_BATCHED_NEW,
                       "cuda")
    wall = time.perf_counter() - t0
    flash = counts().get("flash_attention", 0)
    shape = (out["batch"], out["prompt"], cfg.n_heads, cfg.n_kv_heads,
             cfg.hd)
    if counts() != {"flash_attention": expected_flash(cfg)} or \
            shape not in FLASH_SHAPES or min(out["lens"]) <= 0:
        fail(f"torch_serve_batched on full-width {SERVE_ARCH}: launches "
             f"{counts()}, prefill shape {shape}, lengths {out['lens']}")
    tokens = sum(out["lens"])
    rows["serve_full"] = dict(arch=SERVE_ARCH, wall_s=wall, lens=out["lens"],
                              steps=out["steps"], prefill_shape=shape,
                              t_prefill=out["t_prefill"],
                              t_decode=out["t_decode"], launches=counts())
    print(json.dumps({"phase": "11b", "example": "torch_serve_batched",
                      "arch": SERVE_ARCH, "full_width": True,
                      "requests": out["batch"], "max_prompt": out["prompt"],
                      "tokens": tokens, "steps": out["steps"],
                      "wall_s": wall, "prefill_s": out["t_prefill"],
                      "decode_s": out["t_decode"],
                      "decode_tokens_per_s": tokens / out["t_decode"],
                      "flash_launches": flash, "smi": smi}))
    gc.collect()
    torch.cuda.empty_cache()
    safl = 0
    rows["pretrain"] = []
    for agg in ("fedsgd", "fedavg"):
        reset()
        out = pretrain_ex.run(steps=PRETRAIN_STEPS, aggregation=agg,
                              device="cuda")
        if out["drift"] != 0.0 or counts() != {
                "safl_aggregate": PRETRAIN_STEPS} or \
                not all(math.isfinite(x) for x in out["losses"]):
            fail(f"torch_distributed_pretrain {agg}: drift {out['drift']}, "
                 f"launches {counts()}, losses {out['losses']}")
        safl += PRETRAIN_STEPS
        rows["pretrain"].append(dict(aggregation=agg, **out))
        print(json.dumps({"phase": "11c", "example":
                          "torch_distributed_pretrain", "aggregation": agg,
                          "steps": PRETRAIN_STEPS, "wall_s": out["wall_s"],
                          "loss_first_last": [out["losses"][0],
                                              out["losses"][-1]],
                          "drift": out["drift"], "smi": smi}))
    return rows, flash, safl


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no GPU to run on")
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import int8dot as i8_mod
    from repro_torch.kernels import quantize as q_mod
    from repro_torch.kernels import safl_agg as k_mod
    wrappers = {**k_mod.KERNELS, **q_mod.KERNELS, **fa_mod.KERNELS,
                **i8_mod.KERNELS}
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
    # variants each, the quantized aggregates' and quantize's one shape
    for source, symbol, n in (
            ("safl_agg", "screen_f32_kernel", 2),
            ("safl_agg", "fold_q4_kernel", 2),
            ("safl_agg", "fold_q8_kernel", 2),
            ("safl_agg", "aggregate_q4_kernel", 1),
            ("safl_agg", "aggregate_q8_kernel", 1),
            # the mangled names' length prefixes tell the pair apart
            # (quantize_int8_b512_kernel is a substring of the other)
            ("quantize", "25quantize_int8_b512_kernel", 1),
            ("quantize", "27dequantize_int8_b512_kernel", 1),
            # the coefficient scales made or given
            ("int8dot", "int8dot_kernel", 2)):
        spilled = spills(infos[source]["log"], symbol)
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
    variants = {name: ctypes.CDLL(infos[name]["path"])
                for name in VARIANT_SOURCES}
    for wire in ("q4", "q8"):
        check_aggregate_q(torch, k_mod, check_rows, worst,
                          variants["aggregate_variants"], wire)
    check_topk(torch, k_mod, check_rows, worst)
    check_int8(torch, q_mod, check_rows, worst)
    check_int8dot(torch, i8_mod, check_rows, worst)
    check_draws(torch, check_rows)
    check_flash(torch, fa_mod, check_rows, worst)
    left(3)

    print("== phase 4: timings (L2 flushed before each launch)")
    timing, floor_ms, parent_ms = time_kernels(torch, k_mod, q_mod, fa_mod,
                                               i8_mod, variants)
    one_launch = check_one_launch(torch, k_mod, q_mod)
    codec_ms = time_codec(torch)
    left(4)

    print("== phase 5: engine on the card vs the CPU, small size; q4 and "
          "top-k codecs, server channels and pytree compression at full "
          "width")
    small = check_engine_small(torch)
    t0 = time.perf_counter()
    long_rows = check_paper_long(torch)
    print(f"  the paper's four for {LONG_ROUNDS} rounds: "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    small_models = check_models_small(torch)
    print(f"  the other models' phase 5: {time.perf_counter() - t0:.1f} s")
    codec = check_codec(torch)
    channels = check_channels(torch)
    pytree = check_pytree(torch, q_mod)
    left(5)

    print(f"== phase 6: main path, full-width CNN (D = {D_FULL:,}), "
          f"{len(MAIN_SETTINGS)} settings; the compression path")
    (main_rows, launches, sequential_rows, vmap_rows, resume,
     untraced) = run_main_path(torch, wrappers)
    t0 = time.perf_counter()
    other_rows, other_launches = run_other_models(torch, wrappers)
    print(f"  the other models' phase 6: {time.perf_counter() - t0:.1f} s")
    for name, c in other_launches.items():
        launches[name] += c
    compression = run_compression_path(torch, q_mod, wrappers)
    for name in INT8_KERNELS:
        launches[name] = compression["launches"][name]
    left(6)

    print(f"== phase 6b: the main path traced (level upload), "
          f"{len(TRACED_SETTINGS)} settings on both engines; busy share")
    t0 = time.perf_counter()
    traced = run_traced(torch, k_mod, wrappers, untraced)
    print(f"  phase 6b: {time.perf_counter() - t0:.1f} s")
    left("6b")

    print(f"== phase 6c: the mesh, every shard on cuda:0 ({len(MESH_SERVER)} "
          f"server meshes; {len(MESH_SETTINGS)} settings on (2, 2), "
          "devices=4 and (1, 4))")
    t0 = time.perf_counter()
    mesh_server = check_mesh_server(torch, wrappers)
    mesh_rows, mesh_launches = run_mesh(torch, wrappers, untraced)
    del untraced
    for name, c in mesh_launches.items():
        launches[name] += c
    print(f"  phase 6c: {time.perf_counter() - t0:.1f} s; its launches "
          + " ".join(f"{k}={c}" for k, c in mesh_launches.items() if c))
    left("6c")

    print(f"== phase 7: serving, full-width {SERVE_ARCH} (B = {SERVE_BATCH}, "
          f"prompt {SERVE_PROMPT}, {SERVE_NEW} greedy tokens)")
    serving = run_serve(torch, fa_mod, wrappers)
    launches["flash_attention"] = serving["launches"]["flash_attention"]
    left(7)

    print(f"== phase 7e: the zoo at full width (B = {ZOO_BATCH}, prompt "
          f"{ZOO_PROMPT}, {ZOO_NEW} greedy tokens; depth cut: "
          + ", ".join(f"{a} {d} layers" for a, d in ZOO_DEPTH.items())
          + "); the reduced configs on the card vs the CPU")
    t0 = time.perf_counter()
    zoo, zoo_flash = run_zoo(torch, fa_mod, wrappers)
    launches["flash_attention"] += zoo_flash
    print(f"  phase 7e: {time.perf_counter() - t0:.1f} s")
    left("7e")

    print(f"== phase 8: training: full-width {TRAIN_ARCH} (B = {TRAIN_BATCH}"
          f", S {TRAIN_SEQ}, {TRAIN_STEPS} steps, twice); the FL step at "
          f"its full width, {FL_LAYERS} of 28 layers, 2 pods; the reduced "
          "configs on the card vs the CPU; the flash refusal")
    t0 = time.perf_counter()
    training, fl_launches = run_training(torch, k_mod, fa_mod, wrappers)
    launches["safl_aggregate"] += fl_launches
    print(f"  phase 8: {time.perf_counter() - t0:.1f} s")
    left(8)

    print(f"== phase 9: the dry run ({len(DRYRUN_PAIRS)} pairs x 2 meshes, "
          f"meta device); its accounting of {TRAIN_ARCH}'s step (B = "
          f"{TRAIN_BATCH}, S {TRAIN_SEQ}) against the card")
    t0 = time.perf_counter()
    dry = run_dryrun(torch, smi_line())
    print(f"  phase 9: {time.perf_counter() - t0:.1f} s")
    left(9)

    print(f"== phase 10: the q8 round's int8-dot regime (REPRO_INT8_DOT=1), "
          f"K = {REGIME_K}, {REGIME_ROUNDS} rounds of "
          f"{', '.join(REGIME_SETTINGS)}")
    t0 = time.perf_counter()
    regime, launches["weighted_sum_q8_int8dot"] = run_int8dot_regime(
        torch, i8_mod, k_mod, wrappers, smi_line())
    regime["wall_s"] = time.perf_counter() - t0
    print(f"  phase 10: {regime['wall_s']:.1f} s")
    left(10)

    print(f"== phase 11: the examples: batched serving (defaults, and "
          f"{SERVE_ARCH} at full width), cross-pod pretraining")
    t0 = time.perf_counter()
    examples, ex_flash, ex_safl = run_examples(torch, wrappers, smi_line())
    examples["wall_s"] = time.perf_counter() - t0
    launches["flash_attention"] += ex_flash
    launches["safl_aggregate"] += ex_safl
    print(f"  phase 11: {examples['wall_s']:.1f} s")

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
                       timer_floor_ms=floor_ms, parent_ms=parent_ms,
                       codec_ms=codec_ms,
                       one_launch=one_launch,
                       small=small, small_long=long_rows,
                       small_models=small_models,
                       codec=codec, channels=channels,
                       pytree=pytree, main_path=main_rows,
                       main_path_sequential=sequential_rows,
                       main_path_vmap=vmap_rows, resume=resume,
                       other_models=other_rows, traced=traced,
                       mesh_server=mesh_server, mesh=mesh_rows,
                       compression_path=compression, serving=serving,
                       zoo=zoo, training=training, dryrun=dry,
                       int8dot_regime=regime, examples=examples,
                       allocated_bytes=allocated, kernels=kernels, device=device), f, indent=1,
                  default=str)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
