"""Public entry points over the ported kernels: the reference's
``repro/kernels/ops.py`` without JAX.

The reference jits these and picks interpret-mode Pallas or the TPU by
``REPRO_PALLAS_INTERPRET`` and the backend; here every one is a thin call
of its kernel wrapper, which routes by device like every wrapper of the
port: CPU tensors run the plain version, CUDA tensors launch the kernel
or raise.  The ``block_*`` arguments are accepted for the reference's
signatures; the CUDA kernels choose their own tiles.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import safl_agg as _agg


def safl_aggregate(updates: torch.Tensor, weights: torch.Tensor,
                   params: torch.Tensor = None, server_lr: float = 1.0,
                   mode: str = "fedsgd", block_d: int = 0) -> torch.Tensor:
    """updates (K, D), weights (K,), params (D,) for fedsgd -> (D,)."""
    del block_d
    return _agg.safl_aggregate(updates, weights, params,
                               server_lr=server_lr, mode=mode)


def quantize_int8(x: torch.Tensor):
    """x (R, B) f32 -> (q int8 (R, B), scales f32 (R,))."""
    return _q.quantize_int8(x)


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """q (R, B) int8, scales (R,) -> (R, B) f32."""
    return _q.dequantize_int8(q, scales)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = _fa.BLOCK_Q,
                    block_k: int = _fa.BLOCK_K) -> torch.Tensor:
    """q (B, S, H, hd), k / v (B, S, Hkv, hd) -> (B, S, H, hd)."""
    return _fa.flash_attention(q, k, v, causal=causal, block_q=block_q,
                               block_k=block_k)
