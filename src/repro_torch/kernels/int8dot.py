"""The q8 server round's large-K int8-dot reduction: a hand-written CUDA
kernel for Hopper beside its plain PyTorch version.

:func:`weighted_sum_q8_int8dot` is the port of the reference's
``repro/kernels/ref.py:224 weighted_sum_q8_int8dot_ref``, the XLA int8
einsum that the reference's ``FlatServer`` runs in the large-K regime of
the q8 round (``ref.int8dot_auto``; the port's gate is
:func:`repro_torch.kernels.ref.int8dot_auto`).  It is not a TPU kernel:
the reference's Pallas backend runs the q8 aggregate kernel at every K.
Each block's reduction coefficients c_kb = w_k * s_kb are quantized on
one f32 scale per block (the coefficients' absmax / 127, or the mesh's
given scale), and the block's sum over K rows becomes an int8 x int8
product accumulated in int32, scaled back once.

Routing: CPU tensors run the plain version; CUDA tensors launch the
kernel (``csrc/int8dot.cu``, built at first use by
:mod:`repro_torch.kernels.build`) or raise.  The wrapper counts its
launches in ``weighted_sum_q8_int8dot.launches``.  Integer sums are exact
in any order, so the kernel equals the plain version bitwise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.kernels.checks import check, on_cuda, raise_on, stream_of
from repro_torch.kernels.quantize import BLOCK

#: most rows the int32 accumulators take: 127^2 * K < 2^31 (the wire's
#: levels and the coefficients' lie in [-127, 127])
MAX_K = (2 ** 31 - 1) // (127 * 127)
#: the kernel's lane widths: a thread takes four lanes, a block at most
#: 1024 threads
MAX_QBLOCK = 4096


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built ``csrc/int8dot.cu`` with its C signature declared."""
    lib = build.load("int8dot")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn = lib.weighted_sum_q8_int8dot
    fn.argtypes = [p, p, p, p, p, i64, i64, ctypes.c_int, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return lib


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K={k} outside [1, {MAX_K}]: the int32 "
                         "accumulators hold 127^2 * K < 2^31")


def weighted_sum_q8_int8dot_plain(q: torch.Tensor, scales: torch.Tensor,
                                  w: torch.Tensor, qblock: int = BLOCK,
                                  coeff_scale: torch.Tensor = None
                                  ) -> torch.Tensor:
    """Plain version of :func:`weighted_sum_q8_int8dot` (any device), the
    reference's function in its op order: c = w[:, None] * scales, cs =
    max(coeff_scale, 1e-30), cq = clip(round(c / cs), -127, 127) as int8
    (a true division, half to even), the products widened to int32
    before they are taken (an int8 product would wrap) and summed row by
    row (exact), then float(acc) * cs."""
    k, dq = q.shape
    _check_k(k)
    nb = dq // qblock
    c = w.to(torch.float32)[:, None] * scales
    if coeff_scale is None:
        coeff_scale = ref.int8dot_coeff_scale(scales, w)
    cs = torch.clamp(coeff_scale, min=1e-30)
    cq = torch.clamp(torch.round(c / cs), -127, 127).to(torch.int8).to(
        torch.int32)
    lanes = q.view(k, nb, qblock)
    acc = torch.zeros((nb, qblock), dtype=torch.int32, device=q.device)
    for i in range(k):
        acc += cq[i][:, None] * lanes[i].to(torch.int32)
    return (acc.to(torch.float32) * cs[:, None]).reshape(dq)


def weighted_sum_q8_int8dot(q: torch.Tensor, scales: torch.Tensor,
                            w: torch.Tensor, qblock: int = BLOCK,
                            coeff_scale: torch.Tensor = None
                            ) -> torch.Tensor:
    """q (K, Dq) int8 rows, scales (K, Dq/qblock) f32, w (K,) f32 weights,
    ``coeff_scale`` (Dq/qblock,) f32 or None -> (Dq,) f32, sum_k w_k *
    dequant(q_k) on each block's int8 grid of coefficients (see the
    module's docstring).  Replaces the reference's
    ``ref.py:224 weighted_sum_q8_int8dot_ref``.  One launch, one CTA a
    block of ``qblock`` lanes.  Bound: K*Dq + K*Dq/qblock*4 + K*4 bytes
    read, Dq*4 written."""
    if q.dim() != 2:
        raise ValueError(f"q: expected (K, Dq), got {tuple(q.shape)}")
    _check_k(q.shape[0])
    if not on_cuda(q, "weighted_sum_q8_int8dot"):
        return weighted_sum_q8_int8dot_plain(q, scales, w, qblock,
                                             coeff_scale)
    k, dq = q.shape
    if qblock % 4 or not 4 <= qblock <= MAX_QBLOCK or dq % qblock or not dq:
        raise ValueError(f"Dq={dq} must be a positive multiple of qblock="
                         f"{qblock}, a multiple of 4 in [4, {MAX_QBLOCK}]")
    nb = dq // qblock
    check("q", q, (k, dq), q.device, dtype=torch.int8)
    if q.data_ptr() % 4:
        raise ValueError("q must start on a 4-byte boundary (the kernel "
                         "loads four lanes a row as one word)")
    check("scales", scales, (k, nb), q.device)
    check("w", w, (k,), q.device)
    if coeff_scale is not None:
        check("coeff_scale", coeff_scale, (nb,), q.device)
    out = torch.empty(dq, dtype=torch.float32, device=q.device)
    rc = _lib().weighted_sum_q8_int8dot(
        q.data_ptr(), scales.data_ptr(), w.data_ptr(),
        None if coeff_scale is None else coeff_scale.data_ptr(),
        out.data_ptr(), k, dq, qblock, ref.INV_127, stream_of(q))
    raise_on(rc, "weighted_sum_q8_int8dot")
    weighted_sum_q8_int8dot.launches += 1
    return out


weighted_sum_q8_int8dot.launches = 0

KERNELS = {weighted_sum_q8_int8dot.__name__: weighted_sum_q8_int8dot}
