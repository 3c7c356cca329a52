"""SAFL server-channel kernels: hand-written CUDA for Hopper, each beside
its plain PyTorch version.

  * :func:`safl_fold` replaces ``repro/kernels/safl_agg.py:221 safl_fold``
    (the streaming accumulate-on-arrival fold, once per semi-async upload;
    with a live beta = 1 - a_i for fedasync).
  * :func:`safl_fold_q8` replaces ``safl_agg.py:257 safl_fold_q8`` (the
    same fold of one int8 row, once per semi-async upload on the q8 wire).
  * :func:`safl_aggregate` replaces ``safl_agg.py:136 safl_aggregate``
    (the buffered K-way reduction with the server step fused, once per
    sync round of fedsgd / fedavg / fedbuff / fedopt).
  * :func:`safl_aggregate_q8` replaces ``safl_agg.py:420
    safl_aggregate_q8`` (the same over int8 rows, the q8 sync round).
  * :func:`sdga_aggregate` replaces ``safl_agg.py:323 sdga_aggregate``
    (the SDGA round in one pass: mean, momentum, step, EMA anchor).
  * :func:`sdga_aggregate_q8` replaces ``safl_agg.py:488
    sdga_aggregate_q8`` (the same over int8 rows).
  * :func:`screen_rows` replaces ``safl_agg.py:887 screen_rows`` (the
    defense's per-row sum of squares, once per semi-async upload with
    ``defense`` on: ``isfinite`` of it is the integrity verdict, its
    square root the norm).
  * :func:`screen_rows_q8` replaces ``safl_agg.py:918 screen_rows_q8``
    (the same over int8 rows, dequantize fused blockwise).
  * :func:`safl_fold_q4`, :func:`safl_aggregate_q4`,
    :func:`sdga_aggregate_q4` and :func:`screen_rows_q4` replace
    ``safl_agg.py:658 safl_fold_q4``, ``:599 safl_aggregate_q4``,
    ``:709 sdga_aggregate_q4`` and ``:952 screen_rows_q4``: their q8
    siblings over packed int4 rows ((K, Dq/2) bytes of two lanes each,
    :func:`repro_torch.kernels.ref.unpack_q4_ref`'s layout), the nibbles
    unpacked and sign-extended in registers.
  * :func:`safl_fold_topk` and :func:`safl_aggregate_topk` replace
    ``safl_agg.py:830 safl_fold_topk`` and ``:779 safl_aggregate_topk``:
    the fold and the K-row sum on the sparse top-k wire, whose rows are
    (nk,) int32 coordinates, (nk,) int8 compacted values and one scale
    per qblock of the compacted array, scattered into the dense (d,) row
    (coordinates outside [0, d) drop).

Routing: a wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel (``csrc/safl_agg.cu``, built at first use
by :mod:`repro_torch.kernels.build`) or raises.  There is no other switch.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.

Every kernel is bound by memory bandwidth (a few flops per element
against 1 or 4 bytes per operand); the wrappers' docstrings give the
bytes.  The design is a simple coalesced streaming pass with a
grid-stride loop, the int8 and int4 rows dequantized in registers; TMA
and ``wgmma`` buy nothing a bandwidth-bound pass needs first.  The f32
fold moves 8-byte vectors, one a thread over an exact grid, from the
output's first 128-byte line on (a bank row may start anywhere in a
line); the grid-stride loop and 16-byte vectors timed slower
(:mod:`repro_torch.kernels.hold_timing`).  The q4 and q8 folds take 4
lanes a thread over an exact grid of 128-thread blocks: one load of the
vector's bytes (2 packed bytes, a 4-byte int8 word), a float4 load of acc
and the lanes' scale before any arithmetic, the lanes sign-extended from
the word; the lanes around the aligned vectors (every lane where the rows
disagree mod a vector) one a thread in the same launch; 2, 8 and 16 lanes
a thread and the grid-stride loop timed slower.  The q4 K-row aggregate
takes 8 lanes a thread over an exact grid of 128-thread blocks the same
way: a vector's ``p`` and its first 4 rows' words and scales loaded
before the block's weights are computed in parallel into shared memory,
the levels made as floats without a conversion instruction, each lane
still summed in row order; lane by lane where the rows, ``p`` or the
output are not vector-aligned; other lane, block and row-group shapes
and the grid-stride loop timed slower.  The three screens are
one launch a call (blocks of 8 warps; the f32 screen 8 float4 loads a
thread in groups of 4 lanes,
the quantized ones a 16-byte load a lane summed by ``__dp4a``), the
row's last block summing its partials (an integer counter per row, no
float atomics).  The top-k kernels scatter
each kept lane into the bank instead, one launch a call: the fold one
lane a thread over an exact grid of 128-thread blocks (more lanes a
thread timed slower: the scattered gathers want the most warps), the
K-row sum one cooperative launch of the card's resident blocks that
zeroes the output and adds the rows, two lanes a thread, with a
grid-wide barrier before each row, so rows that collide on a coordinate
add in row order (no float atomics).
Every product and sum in the kernels uses round-to-nearest intrinsics
that are never contracted into an FMA, and the plain versions below do
the same operations in the same order, so kernel and plain version agree
bitwise (the polynomial discount's ``powf`` excepted), and a chain of
folds followed by the server step in PyTorch ops equals one aggregate
bitwise.  The screens are reductions over a row: they sum in a fixed
tree that depends on the row length only (see ``csrc/safl_agg.cu``), so
a row's sum is bitwise the same alone or stacked and in every launch,
and within ``rtol=1e-5`` of the plain versions' ``torch.sum``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.kernels.checks import (check as _check, f32 as _f32,
                                        on_cuda as _on_cuda,
                                        raise_on as _raise_on,
                                        stream_of as _stream)
from repro_torch.kernels.quantize import BLOCK

DISCOUNTS = ("none", "poly")
MODES = {"fedsgd": 0, "avg": 1, "mix": 2, "sum": 3}
#: most rows the aggregate kernels take: their K weights live in one
#: block's shared memory (48 KB without an opt-in)
MAX_K = 4096
#: warps per block of the f32 screen and float4 loads per thread: the
#: kernel's kScreenF32Warps and kScreenF32Loads
SCREEN_F32_WARPS = 8
SCREEN_F32_LOADS = 8
#: f32 lanes per chunk of a screened row (a block's loads of 4 lanes),
#: which sizes the f32 screen's (K, chunks) scratch of partial sums
SCREEN_CHUNK = SCREEN_F32_WARPS * 32 * SCREEN_F32_LOADS * 4
#: warps per block of the quantized screens, and the bytes of a row each
#: warp covers: the kernel's kScreenQWarps and kScreenQLoads * 512, which
#: size their (K, chunks) scratch (see :func:`screen_q_chunks`)
SCREEN_QWARPS = 8
SCREEN_WARP_BYTES = 512


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with every function's C signature declared
    (pointers and the stream as void*, lengths and K as int64)."""
    lib = build.load("safl_agg")
    p, f, i64, i32 = (ctypes.c_void_p, ctypes.c_float, ctypes.c_int64,
                      ctypes.c_int)
    sigs = {
        "safl_fold_f32": [p, p, p, f, f, i64, p],
        "safl_fold_q8": [p, p, p, p, f, f, i64, i32, p],
        "safl_aggregate_f32": [p, p, p, p, i64, i64, f, f, i32, i32, p],
        "safl_aggregate_q8": [p, p, p, p, p, i64, i64, i64, f, f, i32, i32,
                              i32, p],
        "sdga_aggregate_f32": [p, p, p, p, p, p, p, p, i64, i64, f, f, f, f,
                               f, f, i32, p],
        "sdga_aggregate_q8": [p, p, p, p, p, p, p, p, p, i64, i64, i64, f, f,
                              f, f, f, f, i32, i32, p],
        "screen_rows_f32": [p, p, p, p, i64, i64, i64, p],
        "screen_rows_q8": [p, p, p, p, p, i64, i64, i32, i64, p],
        "safl_fold_topk": [p, p, p, p, p, f, f, i64, i64, i32, p],
        "safl_aggregate_topk": [p, p, p, p, p, i64, i64, i64, i32, p],
    }
    # the q4 kernels take the q8 kernels' arguments (Dq: lanes per row)
    for name in ("safl_fold", "safl_aggregate", "sdga_aggregate",
                 "screen_rows"):
        sigs[name + "_q4"] = sigs[name + "_q8"]
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _qshift(qblock: int) -> int:
    if qblock < 1 or qblock & (qblock - 1):
        raise ValueError(f"qblock={qblock} must be a power of two")
    return qblock.bit_length() - 1


def _check_q(q: torch.Tensor, scales: torch.Tensor, qblock: int,
             packed: bool):
    """Shapes of a quantized buffer, (K, Dq) int8 or (K, Dq/2) packed int4
    bytes -> (K, Dq)."""
    if q.dim() != 2:
        raise ValueError(f"q: expected (K, row bytes), got {tuple(q.shape)}")
    k, nbytes = q.shape
    dq = 2 * nbytes if packed else nbytes
    if dq % qblock:
        raise ValueError(f"Dq={dq} is not a multiple of qblock={qblock}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K={k} outside [1, {MAX_K}]")
    _check("q", q, (k, nbytes), q.device, torch.int8)
    _check("scales", scales, (k, dq // qblock), q.device)
    return k, dq


def _check_discount(discount: str) -> None:
    if discount not in DISCOUNTS:
        raise ValueError(f"discount {discount!r} not in {DISCOUNTS}")


def _check_mode(mode: str, discount: str, p) -> None:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {tuple(MODES)}")
    _check_discount(discount)
    if mode in ("fedsgd", "mix") and p is None:
        raise ValueError(f"mode={mode!r} needs params p")


# ---------------------------------------------------------------------------
# streaming fold: o = beta*acc + w*vec
# ---------------------------------------------------------------------------

#: Plain version of :func:`safl_fold` (any device).
safl_fold_plain = ref.fold_ref


def safl_fold(acc: torch.Tensor, vec: torch.Tensor, w, beta=1.0, *,
              out: torch.Tensor = None) -> torch.Tensor:
    """acc (D,) f32 running sum, vec (D,) one arriving upload, w its final
    ingest weight, beta the decay on acc -> beta*acc + w*vec.  Replaces
    the TPU kernel ``repro/kernels/safl_agg.py:221 safl_fold``.

    ``out`` may be ``acc`` itself (the in-place fold into a bank row).
    beta == 1 runs a separate kernel instantiation that never multiplies
    acc, as the reference keeps beta a compile-time constant outside
    fedasync.  Bound: 3*D*4 bytes."""
    if not _on_cuda(acc, "safl_fold"):
        res = safl_fold_plain(acc, vec, w, beta)
        if out is None:
            return res
        out.copy_(res)
        return out
    d = acc.shape[0]
    _check("acc", acc, (d,), acc.device)
    _check("vec", vec, (d,), acc.device)
    if out is None:
        out = torch.empty_like(acc)
    _check("out", out, (d,), acc.device)
    rc = _lib().safl_fold_f32(
        acc.data_ptr(), vec.data_ptr(), out.data_ptr(), _f32(w), _f32(beta),
        d, _stream(acc))
    _raise_on(rc, "safl_fold")
    safl_fold.launches += 1
    return out


safl_fold.launches = 0


def safl_fold_q8_plain(acc: torch.Tensor, q_row: torch.Tensor,
                       s_row: torch.Tensor, w, beta=1.0, *,
                       qblock: int = BLOCK) -> torch.Tensor:
    """Plain version of :func:`safl_fold_q8` (any device)."""
    return ref.fold_q8_ref(acc, q_row, s_row, w, qblock, beta)


def safl_fold_q4_plain(acc: torch.Tensor, q_row: torch.Tensor,
                       s_row: torch.Tensor, w, beta=1.0, *,
                       qblock: int = BLOCK) -> torch.Tensor:
    """Plain version of :func:`safl_fold_q4` (any device)."""
    return ref.fold_q4_ref(acc, q_row, s_row, w, qblock, beta)


def _fold_q(wrapper, plain, packed: bool, acc, q_row, s_row, w, beta,
            qblock, out):
    """A quantized fold: ``plain`` on the CPU, else the kernel named
    like ``wrapper``, which counts the launch."""
    name = wrapper.__name__
    if not _on_cuda(acc, name):
        res = plain(acc, q_row, s_row, w, beta, qblock=qblock)
        if out is None:
            return res
        out.copy_(res)
        return out
    dq = acc.shape[0]
    qshift = _qshift(qblock)
    if packed and qblock < 2:
        raise ValueError(f"{name}: qblock={qblock} is less than a byte")
    if dq % qblock:
        raise ValueError(f"Dq={dq} is not a multiple of qblock={qblock}")
    _check("acc", acc, (dq,), acc.device)
    _check("q_row", q_row, (dq // 2 if packed else dq,), acc.device,
           torch.int8)
    _check("s_row", s_row, (dq // qblock,), acc.device)
    if out is None:
        out = torch.empty_like(acc)
    _check("out", out, (dq,), acc.device)
    rc = getattr(_lib(), name)(
        acc.data_ptr(), q_row.data_ptr(), s_row.data_ptr(), out.data_ptr(),
        _f32(w), _f32(beta), dq, qshift, _stream(acc))
    _raise_on(rc, name)
    wrapper.launches += 1
    return out


def safl_fold_q8(acc: torch.Tensor, q_row: torch.Tensor,
                 s_row: torch.Tensor, w, beta=1.0, *, qblock: int = BLOCK,
                 out: torch.Tensor = None) -> torch.Tensor:
    """acc (Dq,) f32, q_row (Dq,) int8, s_row (Dq/qblock,) f32 scales ->
    beta*acc + w*dequant(q_row), the dequantize ((float)q * scale) fused
    into the pass.  Replaces ``repro/kernels/safl_agg.py:257
    safl_fold_q8``.  ``out`` may be ``acc``; a row may start at any lane
    or byte.  4 lanes a thread (one 4-byte load of the int8 lanes) over an
    exact grid from the first lane where acc, out and q_row are all
    vector-aligned, the lanes around those vectors (every lane where the
    three disagree) one a thread in the same launch.  Bound: 9*Dq +
    4*Dq/qblock bytes."""
    return _fold_q(safl_fold_q8, safl_fold_q8_plain, False, acc, q_row,
                   s_row, w, beta, qblock, out)


safl_fold_q8.launches = 0


def safl_fold_q4(acc: torch.Tensor, q_row: torch.Tensor,
                 s_row: torch.Tensor, w, beta=1.0, *, qblock: int = BLOCK,
                 out: torch.Tensor = None) -> torch.Tensor:
    """:func:`safl_fold_q8` over one packed int4 row, q_row (Dq/2,) int8
    bytes.  Replaces ``repro/kernels/safl_agg.py:658 safl_fold_q4``.
    ``out`` may be ``acc``; a row may start at any lane or byte.  4 lanes
    a thread over an exact grid from the first lane where acc, out and
    q_row are all vector-aligned, the lanes around those vectors (every
    lane where the three disagree) one a thread in the same launch.
    Bound: 8.5*Dq + 4*Dq/qblock bytes."""
    return _fold_q(safl_fold_q4, safl_fold_q4_plain, True, acc, q_row,
                   s_row, w, beta, qblock, out)


safl_fold_q4.launches = 0


# ---------------------------------------------------------------------------
# buffered K-way aggregate with the server step fused
# ---------------------------------------------------------------------------


def _weighted_sum_plain(u: torch.Tensor, w: torch.Tensor, alpha: float,
                        discount: str):
    """(sum_k w_k u_k, sum_k w_k) over the rows of u, one row at a time in
    the fold's order (``acc = acc + w[k]*u[k]``), weights discounted to
    (1+tau)^-alpha when ``discount="poly"``."""
    wv = w.to(torch.float32)
    if discount == "poly":
        wv = torch.pow(1.0 + wv, -alpha)
    acc = torch.zeros(u.shape[1], dtype=torch.float32, device=u.device)
    wsum = torch.zeros((), dtype=torch.float32, device=u.device)
    for k in range(u.shape[0]):
        acc = acc + wv[k] * u[k]
        wsum = wsum + wv[k]
    return acc, wsum


def safl_aggregate_plain(u: torch.Tensor, w: torch.Tensor,
                         p: torch.Tensor = None, *, server_lr: float = 1.0,
                         mode: str = "fedsgd", alpha: float = 0.5,
                         discount: str = "none") -> torch.Tensor:
    """Plain version of :func:`safl_aggregate` (any device).  Reduces over
    K in the fold's order, so a chain of :func:`safl_fold_plain` calls
    equals this bitwise."""
    _check_mode(mode, discount, p)
    acc, wsum = _weighted_sum_plain(u, w, alpha, discount)
    if mode == "sum":
        return acc
    if mode == "mix":
        return (1.0 - wsum) * p + acc
    g = acc / torch.clamp(wsum, min=1e-12)
    if mode == "avg":
        return g
    return p - server_lr * g


def safl_aggregate(u: torch.Tensor, w: torch.Tensor, p: torch.Tensor = None,
                   *, server_lr: float = 1.0, mode: str = "fedsgd",
                   alpha: float = 0.5,
                   discount: str = "none") -> torch.Tensor:
    """u (K, D) f32 rows, w (K,) weights (or staleness with
    ``discount="poly"``, read as (1+tau)^-alpha), p (D,) params for
    fedsgd/mix -> (D,):

      fedsgd  p - lr * (w@u)/max(sum w, 1e-12)
      avg     (w@u)/max(sum w, 1e-12)
      mix     (1 - sum w)*p + w@u
      sum     w@u

    Replaces the TPU kernel ``repro/kernels/safl_agg.py:136
    safl_aggregate``.  Bound: (K+2)*D*4 bytes for fedsgd/mix, (K+1)*D*4
    for avg/sum."""
    _check_mode(mode, discount, p)
    if not _on_cuda(u, "safl_aggregate"):
        return safl_aggregate_plain(u, w, p, server_lr=server_lr, mode=mode,
                                    alpha=alpha, discount=discount)
    if u.dim() != 2:
        raise ValueError(f"u: expected (K, D), got {tuple(u.shape)}")
    k, d = u.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K={k} outside [1, {MAX_K}]")
    _check("u", u, (k, d), u.device)
    _check("w", w, (k,), u.device)
    if p is not None:
        _check("p", p, (d,), u.device)
    out = torch.empty(d, dtype=torch.float32, device=u.device)
    rc = _lib().safl_aggregate_f32(
        u.data_ptr(), w.data_ptr(), None if p is None else p.data_ptr(),
        out.data_ptr(), k, d, _f32(server_lr), _f32(alpha), MODES[mode],
        int(discount == "poly"), _stream(u))
    _raise_on(rc, "safl_aggregate")
    safl_aggregate.launches += 1
    return out


safl_aggregate.launches = 0


def safl_aggregate_q8_plain(q: torch.Tensor, scales: torch.Tensor,
                            w: torch.Tensor, p: torch.Tensor = None, *,
                            server_lr: float = 1.0, mode: str = "fedsgd",
                            alpha: float = 0.5, discount: str = "none",
                            qblock: int = BLOCK) -> torch.Tensor:
    """Plain version of :func:`safl_aggregate_q8` (any device): dequantize
    the rows, then :func:`safl_aggregate_plain` over the D lanes of p
    (fedsgd / mix) or all Dq lanes (avg / sum)."""
    _check_mode(mode, discount, p)
    u = ref.dequant_flat_ref(q, scales, qblock)
    if mode in ("fedsgd", "mix"):
        u = u[:, :p.shape[0]]
    return safl_aggregate_plain(u, w, p, server_lr=server_lr, mode=mode,
                                alpha=alpha, discount=discount)


def safl_aggregate_q4_plain(q: torch.Tensor, scales: torch.Tensor,
                            w: torch.Tensor, p: torch.Tensor = None,
                            **kw) -> torch.Tensor:
    """Plain version of :func:`safl_aggregate_q4` (any device): unpack,
    then :func:`safl_aggregate_q8_plain`."""
    return safl_aggregate_q8_plain(ref.unpack_q4_ref(q), scales, w, p, **kw)


def _aggregate_q(wrapper, plain, packed: bool, q, scales, w, p, server_lr,
                 mode, alpha, discount, qblock):
    """A quantized aggregate: ``plain`` on the CPU, else the kernel named
    like ``wrapper``, which counts the launch."""
    name = wrapper.__name__
    _check_mode(mode, discount, p)
    if not _on_cuda(q, name):
        return plain(q, scales, w, p, server_lr=server_lr, mode=mode,
                     alpha=alpha, discount=discount, qblock=qblock)
    qshift = _qshift(qblock)
    k, dq = _check_q(q, scales, qblock, packed)
    _check("w", w, (k,), q.device)
    n = dq
    if p is not None:
        n = p.shape[0]
        if n > dq:
            raise ValueError(f"p has {n} lanes, more than Dq={dq}")
        _check("p", p, (n,), q.device)
    if mode in ("avg", "sum"):
        n = dq
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    rc = getattr(_lib(), name)(
        q.data_ptr(), scales.data_ptr(), w.data_ptr(),
        None if p is None else p.data_ptr(), out.data_ptr(), k, dq, n,
        _f32(server_lr), _f32(alpha), MODES[mode], int(discount == "poly"),
        qshift, _stream(q))
    _raise_on(rc, name)
    wrapper.launches += 1
    return out


def safl_aggregate_q8(q: torch.Tensor, scales: torch.Tensor, w: torch.Tensor,
                      p: torch.Tensor = None, *, server_lr: float = 1.0,
                      mode: str = "fedsgd", alpha: float = 0.5,
                      discount: str = "none",
                      qblock: int = BLOCK) -> torch.Tensor:
    """q (K, Dq) int8 rows, scales (K, Dq/qblock) f32, w (K,), p (D,)
    params (D <= Dq) for fedsgd/mix -> (D,) for fedsgd/mix, (Dq,) for
    avg/sum: :func:`safl_aggregate` with each row dequantized as
    (float)q * scale before it is weighted.  Replaces
    ``repro/kernels/safl_agg.py:420 safl_aggregate_q8``.  One launch of
    ``aggregate_q8_kernel``: vectors of lanes over an exact grid where
    the rows, ``p`` and the output are vector-aligned (as in the engine),
    else lane by lane; the same bits either way.  Bound: K*Dq +
    K*Dq/qblock*4 bytes read, plus 2*D*4 (fedsgd/mix) or Dq*4
    (avg/sum)."""
    return _aggregate_q(safl_aggregate_q8, safl_aggregate_q8_plain, False,
                        q, scales, w, p, server_lr, mode, alpha, discount,
                        qblock)


safl_aggregate_q8.launches = 0


def safl_aggregate_q4(q: torch.Tensor, scales: torch.Tensor, w: torch.Tensor,
                      p: torch.Tensor = None, *, server_lr: float = 1.0,
                      mode: str = "fedsgd", alpha: float = 0.5,
                      discount: str = "none",
                      qblock: int = BLOCK) -> torch.Tensor:
    """:func:`safl_aggregate_q8` over packed int4 rows, q (K, Dq/2) int8
    bytes.  Replaces ``repro/kernels/safl_agg.py:599 safl_aggregate_q4``.
    One launch of ``aggregate_q4_kernel``: vectors of lanes over an exact
    grid where the rows, ``p`` and the output are vector-aligned (as in
    the engine), else lane by lane; the same bits either way.  Bound:
    K*Dq/2 + K*Dq/qblock*4 bytes read, plus 2*D*4 (fedsgd/mix) or Dq*4
    (avg/sum)."""
    return _aggregate_q(safl_aggregate_q4, safl_aggregate_q4_plain, True,
                        q, scales, w, p, server_lr, mode, alpha, discount,
                        qblock)


safl_aggregate_q4.launches = 0


# ---------------------------------------------------------------------------
# SDGA: weighted mean + momentum + SGD step + EMA anchor, one pass
# ---------------------------------------------------------------------------


def sdga_aggregate_plain(u: torch.Tensor, w: torch.Tensor, p: torch.Tensor,
                         m: torch.Tensor, e: torch.Tensor, *,
                         server_lr: float, alpha: float = 0.5,
                         momentum: float = 0.8, ema_anchor: float = 0.05,
                         ema_decay: float = 0.95, discount: str = "poly"):
    """Plain version of :func:`sdga_aggregate` (any device): the weighted
    mean in the fold's order, then :func:`ref.sdga_step_from_mean`."""
    _check_discount(discount)
    acc, wsum = _weighted_sum_plain(u, w, alpha, discount)
    g = acc / torch.clamp(wsum, min=1e-12)
    return ref.sdga_step_from_mean(g, p, m, e, server_lr=server_lr,
                                   momentum=momentum, ema_anchor=ema_anchor,
                                   ema_decay=ema_decay)


def _sdga_scalars(server_lr, alpha, momentum, ema_anchor, ema_decay):
    """The kernel's f32 scalars, each rounded from the Python float the
    way JAX rounds a weakly typed constant (1 - decay in double first)."""
    return (_f32(server_lr), _f32(alpha), _f32(momentum), _f32(ema_anchor),
            _f32(ema_decay), _f32(1.0 - ema_decay))


def sdga_aggregate(u: torch.Tensor, w: torch.Tensor, p: torch.Tensor,
                   m: torch.Tensor, e: torch.Tensor, *, server_lr: float,
                   alpha: float = 0.5, momentum: float = 0.8,
                   ema_anchor: float = 0.05, ema_decay: float = 0.95,
                   discount: str = "poly"):
    """u (K, D) f32 rows, w (K,) weights (staleness with
    ``discount="poly"``), p / m / e (D,) params, server momentum, EMA ->
    (p', m', e'), all new (D,) tensors:

      g  = (w@u)/max(sum w, 1e-12)
      m' = momentum*m + g
      p' = p - lr*m' + ema_anchor*(e - p)
      e' = ema_decay*e + (1 - ema_decay)*p'

    Replaces ``repro/kernels/safl_agg.py:323 sdga_aggregate``.  Bound:
    (K+6)*D*4 bytes."""
    _check_discount(discount)
    if not _on_cuda(u, "sdga_aggregate"):
        return sdga_aggregate_plain(
            u, w, p, m, e, server_lr=server_lr, alpha=alpha,
            momentum=momentum, ema_anchor=ema_anchor, ema_decay=ema_decay,
            discount=discount)
    if u.dim() != 2:
        raise ValueError(f"u: expected (K, D), got {tuple(u.shape)}")
    k, d = u.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K={k} outside [1, {MAX_K}]")
    _check("u", u, (k, d), u.device)
    _check("w", w, (k,), u.device)
    for name, t in (("p", p), ("m", m), ("e", e)):
        _check(name, t, (d,), u.device)
    outs = [torch.empty(d, dtype=torch.float32, device=u.device)
            for _ in range(3)]
    rc = _lib().sdga_aggregate_f32(
        u.data_ptr(), w.data_ptr(), p.data_ptr(), m.data_ptr(), e.data_ptr(),
        *(o.data_ptr() for o in outs), k, d,
        *_sdga_scalars(server_lr, alpha, momentum, ema_anchor, ema_decay),
        int(discount == "poly"), _stream(u))
    _raise_on(rc, "sdga_aggregate")
    sdga_aggregate.launches += 1
    return tuple(outs)


sdga_aggregate.launches = 0


def sdga_aggregate_q8_plain(q: torch.Tensor, scales: torch.Tensor,
                            w: torch.Tensor, p: torch.Tensor,
                            m: torch.Tensor, e: torch.Tensor, *,
                            server_lr: float, alpha: float = 0.5,
                            momentum: float = 0.8, ema_anchor: float = 0.05,
                            ema_decay: float = 0.95, discount: str = "poly",
                            qblock: int = BLOCK):
    """Plain version of :func:`sdga_aggregate_q8` (any device)."""
    u = ref.dequant_flat_ref(q, scales, qblock)[:, :p.shape[0]]
    return sdga_aggregate_plain(
        u, w, p, m, e, server_lr=server_lr, alpha=alpha, momentum=momentum,
        ema_anchor=ema_anchor, ema_decay=ema_decay, discount=discount)


def sdga_aggregate_q4_plain(q: torch.Tensor, scales: torch.Tensor,
                            w: torch.Tensor, p: torch.Tensor,
                            m: torch.Tensor, e: torch.Tensor, **kw):
    """Plain version of :func:`sdga_aggregate_q4` (any device): unpack,
    then :func:`sdga_aggregate_q8_plain`."""
    return sdga_aggregate_q8_plain(ref.unpack_q4_ref(q), scales, w, p, m, e,
                                   **kw)


def _sdga_q(wrapper, plain, packed: bool, q, scales, w, p, m, e, server_lr,
            alpha, momentum, ema_anchor, ema_decay, discount, qblock):
    """A quantized SDGA round: ``plain`` on the CPU, else the kernel named
    like ``wrapper``, which counts the launch."""
    name = wrapper.__name__
    _check_discount(discount)
    if not _on_cuda(q, name):
        return plain(q, scales, w, p, m, e, server_lr=server_lr, alpha=alpha,
                     momentum=momentum, ema_anchor=ema_anchor,
                     ema_decay=ema_decay, discount=discount, qblock=qblock)
    qshift = _qshift(qblock)
    k, dq = _check_q(q, scales, qblock, packed)
    _check("w", w, (k,), q.device)
    d = p.shape[0]
    if d > dq:
        raise ValueError(f"p has {d} lanes, more than Dq={dq}")
    for label, t in (("p", p), ("m", m), ("e", e)):
        _check(label, t, (d,), q.device)
    outs = [torch.empty(d, dtype=torch.float32, device=q.device)
            for _ in range(3)]
    rc = getattr(_lib(), name)(
        q.data_ptr(), scales.data_ptr(), w.data_ptr(), p.data_ptr(),
        m.data_ptr(), e.data_ptr(), *(o.data_ptr() for o in outs), k, dq, d,
        *_sdga_scalars(server_lr, alpha, momentum, ema_anchor, ema_decay),
        int(discount == "poly"), qshift, _stream(q))
    _raise_on(rc, name)
    wrapper.launches += 1
    return tuple(outs)


def sdga_aggregate_q8(q: torch.Tensor, scales: torch.Tensor, w: torch.Tensor,
                      p: torch.Tensor, m: torch.Tensor, e: torch.Tensor, *,
                      server_lr: float, alpha: float = 0.5,
                      momentum: float = 0.8, ema_anchor: float = 0.05,
                      ema_decay: float = 0.95, discount: str = "poly",
                      qblock: int = BLOCK):
    """:func:`sdga_aggregate` over q (K, Dq) int8 rows with scales
    (K, Dq/qblock), each row dequantized as (float)q * scale; p / m / e
    are (D,) with D <= Dq.  Replaces ``repro/kernels/safl_agg.py:488
    sdga_aggregate_q8``.  Bound: K*Dq + K*Dq/qblock*4 + 6*D*4 bytes."""
    return _sdga_q(sdga_aggregate_q8, sdga_aggregate_q8_plain, False, q,
                   scales, w, p, m, e, server_lr, alpha, momentum,
                   ema_anchor, ema_decay, discount, qblock)


sdga_aggregate_q8.launches = 0


def sdga_aggregate_q4(q: torch.Tensor, scales: torch.Tensor, w: torch.Tensor,
                      p: torch.Tensor, m: torch.Tensor, e: torch.Tensor, *,
                      server_lr: float, alpha: float = 0.5,
                      momentum: float = 0.8, ema_anchor: float = 0.05,
                      ema_decay: float = 0.95, discount: str = "poly",
                      qblock: int = BLOCK):
    """:func:`sdga_aggregate_q8` over packed int4 rows, q (K, Dq/2) int8
    bytes.  Replaces ``repro/kernels/safl_agg.py:709 sdga_aggregate_q4``.
    Bound: K*Dq/2 + K*Dq/qblock*4 + 6*D*4 bytes."""
    return _sdga_q(sdga_aggregate_q4, sdga_aggregate_q4_plain, True, q,
                   scales, w, p, m, e, server_lr, alpha, momentum,
                   ema_anchor, ema_decay, discount, qblock)


sdga_aggregate_q4.launches = 0


# ---------------------------------------------------------------------------
# defense screening: per-row sum of squares
# ---------------------------------------------------------------------------


def _per_row(fn, *rows: torch.Tensor) -> torch.Tensor:
    """``fn`` over (1, n) slices, one row at a time: PyTorch sums a (K, n)
    tensor in another order than a (1, n) one once n is large, and a
    row's sum must not depend on the stack."""
    return torch.cat([fn(*(r[i:i + 1] for r in rows))
                      for i in range(rows[0].shape[0])])


def screen_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`screen_rows` (any device), the reference
    oracle's op order: ``(u*u).sum(1)``, row by row."""
    def sumsq(r):
        r = r.to(torch.float32)
        return (r * r).sum(dim=1)
    return _per_row(sumsq, rows)


def screen_chunks(d: int) -> int:
    """Chunks (blocks of threads) per row of ``d`` lanes in the f32
    screen: a function of the row's length only."""
    return -(-d // SCREEN_CHUNK)


def screen_rows(rows: torch.Tensor) -> torch.Tensor:
    """rows (K, D) f32 -> (K,) f32 sums of squares.  NaN/Inf lanes make a
    row's sum non-finite.  Replaces ``repro/kernels/safl_agg.py:887
    screen_rows``.  One launch, as the quantized screens
    (:func:`_screen_q`): each block of a (chunks, K) grid sums its chunk
    of :data:`SCREEN_CHUNK` lanes into ``part`` and bumps its row's
    counter (:func:`_screen_counts`), the row's last block sums the
    partials.  float4 loads where every row starts 16-byte aligned, else
    lane by lane, in one partition of groups of 4 lanes (the same sums
    bitwise).  Bound: K*D*4
    bytes read."""
    if not _on_cuda(rows, "screen_rows"):
        return screen_rows_plain(rows)
    if rows.dim() != 2:
        raise ValueError(f"rows: expected (K, D), got {tuple(rows.shape)}")
    k, d = rows.shape
    if not 1 <= k <= MAX_K or d < 1:
        raise ValueError(f"rows: shape {(k, d)} outside [1, {MAX_K}] x "
                         "[1, ...)")
    _check("rows", rows, (k, d), rows.device)
    chunks = screen_chunks(d)
    part = torch.empty((k, chunks), dtype=torch.float32, device=rows.device)
    out = torch.empty(k, dtype=torch.float32, device=rows.device)
    stream = _stream(rows)
    counts = _screen_counts(rows.device.index, stream)
    rc = _lib().screen_rows_f32(rows.data_ptr(), part.data_ptr(),
                                counts.data_ptr(), out.data_ptr(), k, d,
                                chunks, stream)
    _raise_on(rc, "screen_rows")
    screen_rows.launches += 1
    return out


screen_rows.launches = 0


def screen_rows_q8_plain(q: torch.Tensor, scales: torch.Tensor, *,
                         qblock: int = BLOCK) -> torch.Tensor:
    """Plain version of :func:`screen_rows_q8` (any device), the reference
    oracle's blockwise form (:func:`ref.screen_sumsq_q8_ref`: ``q2_b =
    sum q^2`` over each block in int32, then ``sum_b (q2_b * s_b) * s_b``
    in f32), row by row."""
    return _per_row(lambda qr, sr: ref.screen_sumsq_q8_ref(qr, sr, qblock),
                    q, scales)


def screen_rows_q4_plain(q: torch.Tensor, scales: torch.Tensor, *,
                         qblock: int = BLOCK) -> torch.Tensor:
    """Plain version of :func:`screen_rows_q4` (any device):
    :func:`ref.screen_sumsq_q4_ref` (unpack, then the q8 rule), row by
    row."""
    return _per_row(lambda qr, sr: ref.screen_sumsq_q4_ref(qr, sr, qblock),
                    q, scales)


def screen_q_blocks(bbytes: int) -> int:
    """Quantization blocks of ``bbytes`` bytes that one warp of the
    quantized screens takes (the kernel's ``screen_qpw``)."""
    return max(1, SCREEN_WARP_BYTES // bbytes)


def screen_q_chunks(nb: int, bbytes: int) -> int:
    """Chunks (blocks of threads) per row of ``nb`` quantization blocks of
    ``bbytes`` bytes in the quantized screens: a function of the row's
    length and the block size only."""
    return -(-nb // (SCREEN_QWARPS * screen_q_blocks(bbytes)))


@functools.lru_cache(maxsize=None)
def _screen_counts(device: int, stream: int) -> torch.Tensor:
    """The screens' per-row arrival counters on CUDA device
    ``device`` for launches on ``stream``: MAX_K int32, zeroed once (on
    that stream, the current one); every launch leaves them zero."""
    return torch.zeros(MAX_K, dtype=torch.int32,
                       device=torch.device("cuda", device))


def _screen_q(wrapper, plain, packed: bool, q, scales, qblock):
    """A quantized screen: ``plain`` on the CPU, else one launch of the
    kernel named like ``wrapper``.  Each block of a (chunks, K) grid
    writes its chunk's partial sum into the ``part`` scratch and bumps its
    row's integer counter; the row's last block sums the partials in index
    order and resets the counter, so the counters (allocated and zeroed
    once per device and stream, not per call: a memset would be a second
    launch) are zero between launches.  16-byte loads where the rows
    start 16-byte aligned and a block spans a multiple of 16 bytes, else
    one byte a lane in the same partition (the same sums bitwise)."""
    name = wrapper.__name__
    if not _on_cuda(q, name):
        return plain(q, scales, qblock=qblock)
    qshift = _qshift(qblock)
    if packed and qblock < 2:
        raise ValueError(f"{name}: qblock={qblock} is less than a byte")
    k, dq = _check_q(q, scales, qblock, packed)
    chunks = screen_q_chunks(dq // qblock, qblock // 2 if packed else qblock)
    part = torch.empty((k, chunks), dtype=torch.float32, device=q.device)
    out = torch.empty(k, dtype=torch.float32, device=q.device)
    stream = _stream(q)
    counts = _screen_counts(q.device.index, stream)
    rc = getattr(_lib(), name)(q.data_ptr(), scales.data_ptr(),
                               part.data_ptr(), counts.data_ptr(),
                               out.data_ptr(), k, dq, qshift, chunks, stream)
    _raise_on(rc, name)
    wrapper.launches += 1
    return out


def screen_rows_q8(q: torch.Tensor, scales: torch.Tensor, *,
                   qblock: int = BLOCK) -> torch.Tensor:
    """q (K, Dq) int8 rows with scales (K, Dq/qblock) -> (K,) f32 sums of
    squares of the dequantized rows, ``sum_b s_b^2 * sum_{j in b} q_j^2``
    without forming the f32 row.  An Inf scale makes a row's sum
    non-finite.  Replaces ``repro/kernels/safl_agg.py:918
    screen_rows_q8``.  Bound: K*Dq + K*Dq/qblock*4 bytes read."""
    return _screen_q(screen_rows_q8, screen_rows_q8_plain, False, q, scales,
                     qblock)


screen_rows_q8.launches = 0


def screen_rows_q4(q: torch.Tensor, scales: torch.Tensor, *,
                   qblock: int = BLOCK) -> torch.Tensor:
    """:func:`screen_rows_q8` over packed int4 rows, q (K, Dq/2) int8
    bytes; a corrupted byte's nibble -8 counts as 64.  Replaces
    ``repro/kernels/safl_agg.py:952 screen_rows_q4``.  Bound:
    K*Dq/2 + K*Dq/qblock*4 bytes read."""
    return _screen_q(screen_rows_q4, screen_rows_q4_plain, True, q, scales,
                     qblock)


screen_rows_q4.launches = 0


# ---------------------------------------------------------------------------
# the top-k sparse wire: scatter of compacted (idx, qv, scales) rows
# ---------------------------------------------------------------------------


def _check_topk(idx: torch.Tensor, qv: torch.Tensor, scales: torch.Tensor,
                qblock: int, device, rows: int):
    """Shapes of sparse rows on ``device``: ``rows`` = 1 for one (nk,)
    row, 2 for (K, nk) rows.  Returns (K, nk), K = 1 for one row."""
    if qv.dim() != rows:
        raise ValueError(f"qv: expected {rows} dims, got {tuple(qv.shape)}")
    lead, nk = tuple(qv.shape[:-1]), qv.shape[-1]
    if nk % qblock:
        raise ValueError(f"nk={nk} is not a multiple of qblock={qblock}")
    _check("idx", idx, lead + (nk,), device, torch.int32)
    _check("qv", qv, lead + (nk,), device, torch.int8)
    _check("scales", scales, lead + (nk // qblock,), device)
    return (lead[0] if lead else 1), nk


def safl_fold_topk_plain(acc: torch.Tensor, idx: torch.Tensor,
                         qv: torch.Tensor, s_row: torch.Tensor, w, beta=1.0,
                         *, qblock: int = BLOCK) -> torch.Tensor:
    """Plain version of :func:`safl_fold_topk` (any device)."""
    return ref.fold_topk_ref(acc, idx, qv, s_row, w, qblock, beta)


def safl_fold_topk(acc: torch.Tensor, idx: torch.Tensor, qv: torch.Tensor,
                   s_row: torch.Tensor, w, beta=1.0, *, qblock: int = BLOCK,
                   out: torch.Tensor = None) -> torch.Tensor:
    """acc (d,) f32 and one sparse row (idx (nk,) int32 coordinates, qv
    (nk,) int8 values, s_row (nk/qblock,) f32 scales) -> beta*acc + w *
    scatter(dequant(qv), idx), lanes with idx outside [0, d) dropped.
    Replaces ``repro/kernels/safl_agg.py:830 safl_fold_topk``.  ``out``
    may be ``acc``: beta == 1 then touches the kept lanes only, one
    launch (as the engine folds); any other beta, or a separate ``out``,
    first writes beta*acc over the whole row, as the TPU kernel does (two
    launches, counted as one; no engine run takes this path).  Bound at
    beta == 1 in place: 13*nk + 4*nk/qblock bytes (idx, qv, scales, and
    a read and a write of each kept coordinate); the dense pass adds
    8*d."""
    if not _on_cuda(acc, "safl_fold_topk"):
        res = safl_fold_topk_plain(acc, idx, qv, s_row, w, beta,
                                   qblock=qblock)
        if out is None:
            return res
        out.copy_(res)
        return out
    qshift = _qshift(qblock)
    d = acc.shape[0]
    _check("acc", acc, (d,), acc.device)
    _, nk = _check_topk(idx, qv, s_row, qblock, acc.device, 1)
    if out is None:
        out = torch.empty_like(acc)
    _check("out", out, (d,), acc.device)
    rc = _lib().safl_fold_topk(
        acc.data_ptr(), idx.data_ptr(), qv.data_ptr(), s_row.data_ptr(),
        out.data_ptr(), _f32(w), _f32(beta), d, nk, qshift, _stream(acc))
    _raise_on(rc, "safl_fold_topk")
    safl_fold_topk.launches += 1
    return out


safl_fold_topk.launches = 0


def safl_aggregate_topk_plain(idx: torch.Tensor, qv: torch.Tensor,
                              scales: torch.Tensor, w: torch.Tensor, d: int,
                              *, qblock: int = BLOCK) -> torch.Tensor:
    """Plain version of :func:`safl_aggregate_topk` (any device): K row
    scatters in order from zeros (:func:`ref.topk_weighted_sum_ref`)."""
    return ref.topk_weighted_sum_ref(idx, qv, scales,
                                     w.to(torch.float32).cpu().numpy(), d,
                                     qblock)


def safl_aggregate_topk(idx: torch.Tensor, qv: torch.Tensor,
                        scales: torch.Tensor, w: torch.Tensor, d: int, *,
                        qblock: int = BLOCK) -> torch.Tensor:
    """idx (K, nk) int32 coordinates (an empty row holds d everywhere),
    qv (K, nk) int8 values, scales (K, nk/qblock) f32, w (K,) final
    weights -> sum_k w_k * scatter(dequant(qv_k), idx_k), unnormalized,
    as a (d,) f32 row: bitwise the chain of K :func:`safl_fold_topk`
    calls from zeros.  Replaces ``repro/kernels/safl_agg.py:779
    safl_aggregate_topk``; the caller takes the server step from the sum.
    One cooperative launch (zeros, then the rows in order; a refused
    launch raises).  Bound: 4*d bytes written + K*(5*nk + 4*nk/qblock)
    read."""
    if not _on_cuda(qv, "safl_aggregate_topk"):
        return safl_aggregate_topk_plain(idx, qv, scales, w, d,
                                         qblock=qblock)
    qshift = _qshift(qblock)
    k, nk = _check_topk(idx, qv, scales, qblock, qv.device, 2)
    _check("w", w, (k,), qv.device)
    out = torch.empty(d, dtype=torch.float32, device=qv.device)
    rc = _lib().safl_aggregate_topk(
        idx.data_ptr(), qv.data_ptr(), scales.data_ptr(), w.data_ptr(),
        out.data_ptr(), k, nk, d, qshift, _stream(qv))
    _raise_on(rc, "safl_aggregate_topk")
    safl_aggregate_topk.launches += 1
    return out


safl_aggregate_topk.launches = 0

#: every kernel wrapper of this module, by name (each has ``.launches``)
KERNELS = {f.__name__: f for f in (
    safl_fold, safl_fold_q8, safl_aggregate, safl_aggregate_q8,
    sdga_aggregate, sdga_aggregate_q8, screen_rows, screen_rows_q8,
    safl_fold_q4, safl_aggregate_q4, sdga_aggregate_q4, screen_rows_q4,
    safl_fold_topk, safl_aggregate_topk)}
