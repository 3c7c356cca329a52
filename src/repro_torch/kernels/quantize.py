"""Wire formats of the upload channel, their byte accounting, the int8
quantize / dequantize kernels and the pytree compression helpers.

A copy of the reference's ``repro/kernels/quantize.py`` without JAX:

  * ``BLOCK`` (512), the quantization granule (one f32 absmax scale per
    ``BLOCK`` lanes of a quantized row), ``WIRES`` and
    :func:`payload_nbytes`, so both packages count the same bytes for the
    same upload;
  * :func:`quantize_int8` and :func:`dequantize_int8` replace the TPU
    kernels ``quantize.py:96 quantize_int8`` and ``:121
    dequantize_int8`` (and their jitted wrappers in ``kernels/ops.py``):
    hand-written CUDA (``csrc/quantize.cu``) beside plain PyTorch
    versions, routed like :mod:`repro_torch.kernels.safl_agg`'s wrappers
    (a CPU tensor runs the plain version, a CUDA one launches the kernel
    or raises) and counting launches in ``.launches``;
  * :func:`quantize_q4` and :func:`dequantize_q4`, the packed-int4 pair
    (``quantize.py:152``, ``:162``), thin over the oracles of
    :mod:`repro_torch.kernels.ref` as in the reference (no kernel: the
    engine's q4 codec quantizes in its own ops);
  * the pytree helpers :func:`quantize_array`, :func:`dequantize_array`,
    :func:`quantize_pytree`, :func:`dequantize_pytree` (a pytree is a
    dict of tensors, nested dicts allowed) and the top-k sparsifier
    :func:`topk_sparsify` / :func:`topk_restore` / :func:`topk_bytes`.

The scale is ``max(absmax * f32(1/127), 1e-12)``: what the reference's
Pallas kernel gives (XLA multiplies by the reciprocal of the constant
127), not its eager ``xla`` fallback's true division, which differs in
the last ulp of a few percent of the scales.  Top-k ranks by a stable
descending sort of |x|: ties keep the lower index first, as
``jax.lax.top_k`` does (``torch.topk`` does not).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.kernels.checks import check, on_cuda, raise_on, stream_of

BLOCK = 512

WIRES = ("f32", "q8", "q4", "topk")


def payload_nbytes(wire: str, *, d: int, dq: int = 0, n_qblocks: int = 0,
                   nk: int = 0, nk_qblocks: int = 0) -> int:
    """Bytes ONE upload payload puts on the wire.

    f32: 4 B/coord over the raw d.  q8: 1 B/coord over the padded dq +
    4 B per scale block.  q4: half a byte per padded coord + the same
    scales.  topk: 4 B index + 1 B value per kept coord + 4 B per scale
    block of the compacted array.
    """
    if wire not in WIRES:
        raise ValueError(f"wire {wire!r} not in {WIRES}")
    if wire == "f32":
        return d * 4
    if wire == "q8":
        return dq + n_qblocks * 4
    if wire == "q4":
        return dq // 2 + n_qblocks * 4
    return nk * 5 + nk_qblocks * 4


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built ``csrc/quantize.cu`` with its C signatures declared."""
    lib = build.load("quantize")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    for name, args in (
            ("quantize_int8", [p, p, p, i64, i64, ctypes.c_float, p]),
            ("dequantize_int8", [p, p, p, i64, i64, p])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


#: Plain version of :func:`quantize_int8` (any device).
quantize_int8_plain = ref.quantize_ref


def dequantize_int8_plain(q: torch.Tensor,
                          scales: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`dequantize_int8` (any device)."""
    return q.to(torch.float32) * scales.unsqueeze(-1)


def quantize_int8(x: torch.Tensor):
    """x (R, B) f32 -> (q int8 (R, B), scales f32 (R,)): per row
    s = max(absmax * f32(1/127), 1e-12) (NaN if the row holds a NaN),
    q = clip(round(x / s), -127, 127), rounding half to even.  Replaces
    ``repro/kernels/quantize.py:96 quantize_int8``.  One launch, one warp
    a row: at B = 512 with x's rows 16-byte aligned (as
    :func:`quantize_array` calls it) the row held in registers, read
    once; else read twice; the same bits either way.  Bound: 5*R*B + 4*R
    bytes."""
    if not on_cuda(x, "quantize_int8"):
        return quantize_int8_plain(x)
    if x.dim() != 2:
        raise ValueError(f"x: expected (R, B), got {tuple(x.shape)}")
    r, b = x.shape
    check("x", x, (r, b), x.device)
    q = torch.empty((r, b), dtype=torch.int8, device=x.device)
    s = torch.empty(r, dtype=torch.float32, device=x.device)
    if r and b:
        raise_on(_lib().quantize_int8(x.data_ptr(), q.data_ptr(),
                                      s.data_ptr(), r, b, ref.INV_127,
                                      stream_of(x)), "quantize_int8")
        quantize_int8.launches += 1
    return q, s


quantize_int8.launches = 0


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """q (R, B) int8, scales (R,) f32 -> (float)q * scale, (R, B) f32.
    Replaces ``repro/kernels/quantize.py:121 dequantize_int8``.  One
    launch: at B = 512 with q's rows 4-byte and the output's 16-byte
    aligned (as :func:`dequantize_array` calls it) one warp a row, each
    lane's packed words loaded first and their levels made without a
    conversion, stored as float4; else one block a row; the same bits
    either way.  Bound: 5*R*B + 4*R bytes."""
    if not on_cuda(q, "dequantize_int8"):
        return dequantize_int8_plain(q, scales)
    if q.dim() != 2:
        raise ValueError(f"q: expected (R, B), got {tuple(q.shape)}")
    r, b = q.shape
    check("q", q, (r, b), q.device, torch.int8)
    check("scales", scales, (r,), q.device)
    out = torch.empty((r, b), dtype=torch.float32, device=q.device)
    if r and b:
        raise_on(_lib().dequantize_int8(q.data_ptr(), scales.data_ptr(),
                                        out.data_ptr(), r, b,
                                        stream_of(q)), "dequantize_int8")
        dequantize_int8.launches += 1
    return out


dequantize_int8.launches = 0

#: the kernel wrappers of this module, by name (each has ``.launches``)
KERNELS = {f.__name__: f for f in (quantize_int8, dequantize_int8)}


def quantize_q4(x: torch.Tensor, u: torch.Tensor):
    """x (R, B) f32 and u (R, B) uniform [0, 1) draws -> (packed int8
    (R, B // 2), scales f32 (R,)): the blockwise absmax / 7 grid with
    stochastic rounding, two nibbles per byte."""
    q, s = ref.quantize_q4_ref(x, u)
    return ref.pack_q4_ref(q), s


def dequantize_q4(p: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_q4`: (R, B // 2) packed and (R,) scales
    -> (R, B) f32."""
    return ref.unpack_q4_ref(p).to(torch.float32) * scales.unsqueeze(-1)


# ---------------------------------------------------------------------------
# pytree compression + top-k sparsification (transmission-load studies;
# the engine quantizes inside core.flatbuf.PytreeCodec)
# ---------------------------------------------------------------------------


def quantize_array(x: torch.Tensor, block: int = BLOCK):
    """x of any shape -> (q int8 (n_blocks, block), scales f32 (n_blocks,),
    its shape): flattened, zero-padded to a ``block`` multiple."""
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % block
    flat = torch.nn.functional.pad(flat, (0, pad))
    q, scales = quantize_int8(flat.view(-1, block))
    return q, scales, tuple(x.shape)


def dequantize_array(q: torch.Tensor, scale: torch.Tensor,
                     shape) -> torch.Tensor:
    """Inverse of :func:`quantize_array` up to the rounding."""
    flat = dequantize_int8(q, scale).reshape(-1)
    n = int(np.prod(shape))
    return flat[:n].reshape(shape)


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def quantize_pytree(tree):
    """Per-leaf :func:`quantize_array` of a dict of tensors; returns (the
    dict of (q, scales, shape) triples, wire bytes = 1 B per padded coord
    + 4 B per block scale)."""
    qs = _map(quantize_array, tree)
    nbytes = sum(q.numel() + s.numel() * 4 for q, s, _ in _leaves(qs))
    return qs, int(nbytes)


def dequantize_pytree(qs):
    """Inverse of :func:`quantize_pytree`: a dict of f32 tensors."""
    return _map(lambda t: dequantize_array(*t), qs)


def topk_sparsify(x: torch.Tensor, frac: float = 0.05):
    """Keep the top-|x| ``frac`` of coordinates -> (values f32, indices
    int32, shape), ties in index order as ``jax.lax.top_k`` breaks them.
    The engine's wire-format counterpart (int8 values + error feedback)
    is ``core.flatbuf.PytreeCodec.ravel_delta_topk``."""
    flat = x.reshape(-1).to(torch.float32)
    k = max(1, int(flat.numel() * frac))
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return flat[idx], idx.to(torch.int32), tuple(x.shape)


def topk_restore(vals: torch.Tensor, idx: torch.Tensor,
                 shape) -> torch.Tensor:
    """Inverse of :func:`topk_sparsify`: zeros with the kept values set."""
    n = int(np.prod(shape))
    out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    out[idx.to(torch.int64)] = vals
    return out.reshape(shape)


def topk_bytes(vals: torch.Tensor, idx: torch.Tensor) -> int:
    """Wire bytes of a :func:`topk_sparsify` payload: 4 B per value and
    per index."""
    return int(vals.numel() * 4 + idx.numel() * 4)
