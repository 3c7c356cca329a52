"""Causal or non-causal GQA attention forward with an online softmax: the
port of the reference's TPU kernel ``repro/kernels/flash_attention.py:76
flash_attention`` (its ``pallas_call`` at :91).

:func:`flash_attention` takes the reference's signature: q (B, S, H, hd),
k and v (B, S, Hkv, hd), f32 or bf16, -> (B, S, H, hd) of q's dtype, the
kv head of q head h being ``h // (H // Hkv)``.  Given CUDA tensors it
launches a hand-written kernel of ``csrc/flash_attention.cu`` (hd 32,
64, 80, 112 or 128; any S; any H / Hkv) or raises; given CPU tensors it runs the
plain version :func:`flash_attention_plain` (``ref.flash_attention_ref``:
k and v repeated, f32 softmax, a -inf mask).  Both kernels compute what
the Pallas kernel computes (f32 scores and running (m, l, acc), masked
scores -1e30, the kv loop stopping at the causal triangle,
``acc / max(l, 1e-20)`` cast to q's dtype):

- bf16 (the serving prefill's dtype): ``flash_fwd_wgmma_kernel``, both
  products on the tensor cores (``wgmma``, f32 accumulators), K / V
  tiles loaded by TMA into a two-stage ring by a producer warp and shared
  by two consumer warpgroups (two q heads of one kv head, or 128 rows of
  one head), p split into bf16 ``p_hi + p_lo`` so that P V keeps p at f32
  precision.  Within one bf16 step (the reference tests' ``2e-2``) of the
  plain version, and at the qwen3 prefill shape differing from it in
  well under 2 % of the output lanes (rounding p to bf16 alone moves
  about 40 %).
- f32: ``flash_fwd_simt_kernel`` on the CUDA cores, 64 x 64 tiles of f32
  (the tensor cores would multiply in TF32); within ``2e-5``.

The kernels have no backward (nor has the reference's Pallas kernel: its
training attention is XLA's).  Their output is written through a raw
pointer and carries no ``grad_fn``, so with grad mode on a CUDA q, k or
v that requires grad raises instead of losing its gradient; training runs
:func:`repro_torch.models.layers.full_attention` with ``train=True``.

``block_q`` and ``block_k`` are accepted for the reference's signature;
the kernels choose their own tiles and mask a ragged last tile, so they
take any S (the Pallas kernel asserts ``S % block == 0``).  The bf16
kernel reads q, k and v through TMA, which needs them to start on
16-byte boundaries.

Bound: the bytes of q, k, v and o read or written once,
``(2 B S H hd + 2 B S Hkv hd) * itemsize`` at the HBM rate, against the
FLOPs of the two products, ``4 B H hd S (S + 1) / 2`` causal or
``4 B H hd S^2`` not, at the card's dense peak for the dtype (the bf16
kernel issues half again the P V product for the p split).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.kernels.checks import check, on_cuda, raise_on, stream_of

#: the reference's tile sizes (its signature's defaults)
BLOCK_Q = 128
BLOCK_K = 128
#: head dims the CUDA kernels are built for (80: zamba2-2.7b; 112:
#: kimi-k2-1t-a32b)
HEAD_DIMS = (32, 64, 80, 112, 128)
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built ``csrc/flash_attention.cu`` with its C signatures
    declared."""
    lib = build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


#: Plain version of :func:`flash_attention` (any device).
flash_attention_plain = ref.flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = BLOCK_Q,
                    block_k: int = BLOCK_K) -> torch.Tensor:
    """q (B, S, H, hd), k / v (B, S, Hkv, hd) -> (B, S, H, hd).  Replaces
    ``repro/kernels/flash_attention.py:76 flash_attention``."""
    del block_q, block_k  # the CUDA kernels' tiles are their own
    if not on_cuda(q, "flash_attention"):
        return flash_attention_plain(q, k, v, causal=causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention: the CUDA kernel has no backward, and q, k or "
            "v requires grad; the training forward computes attention in "
            "PyTorch ops (models.layers.full_attention(..., train=True))")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q, k: expected (B, S, H, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    B, S, H, hd = q.shape
    hkv = k.shape[2]
    if q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention: dtype {q.dtype} not in "
                        f"{list(_ENTRY)}")
    if hd not in HEAD_DIMS or hkv == 0 or H % hkv:
        raise ValueError(f"flash_attention: hd {hd} (built for "
                         f"{HEAD_DIMS}), H {H}, Hkv {hkv}")
    check("q", q, (B, S, H, hd), q.device, q.dtype)
    check("k", k, (B, S, hkv, hd), q.device, q.dtype)
    check("v", v, (B, S, hkv, hd), q.device, q.dtype)
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 q, k and v must start on "
                         "16-byte boundaries (TMA)")
    out = torch.empty_like(q)
    if B and S and H:
        raise_on(getattr(_lib(), _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, hkv, hd, int(bool(causal)), float(np.float32(np.sqrt(hd))),
            stream_of(q)), "flash_attention")
        flash_attention.launches += 1
    return out


flash_attention.launches = 0

#: the kernel wrappers of this module, by name (each has ``.launches``)
KERNELS = {flash_attention.__name__: flash_attention}

