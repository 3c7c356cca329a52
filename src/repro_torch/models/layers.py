"""Transformer building blocks over plain dicts of tensors: the reference's
``repro/models/layers.py`` for the dense decoder, in PyTorch.

Every function keeps the reference's signature, parameter layout
((in, out) dense weights, so ``x @ w`` reads the same) and order of
operations, including where the compute dtype rounds:

  * :func:`rmsnorm` takes the variance in f32 and casts ``rsqrt`` to
    x's dtype before it multiplies;
  * :func:`apply_rope` rotates the halves ``(x[:hd/2], x[hd/2:])`` in
    f32, with the frequencies computed on the host in f32 in the
    reference's order, ``1 / theta ** (arange(half) / half)``;
  * in :func:`_qkv`, the qk-norm comes before RoPE;
  * :func:`lm_head` and :func:`decode_attention`'s scores keep f32
    (the reference's ``preferred_element_type``): a bf16 operand pair is
    upcast and multiplied in f32, since a bf16 matmul in PyTorch returns
    bf16, and greedy argmax must not see logits rounded to bf16; decode
    casts the probabilities to the cache's dtype before the PV product.

:func:`full_attention` runs its self-attention through
:func:`repro_torch.kernels.ops.flash_attention` (the CUDA kernel on the
card, its plain version on the CPU).  That kernel has no window and no
memory (cross-attention), so both raise here, as do a decode window and
the ring-buffer cache; the reference's ``constrain_*`` sharding hints are
no-ops on one device and are dropped.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.kernels import ops

Params = Dict[str, object]


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (see ROADMAP.md, "
                               "queue 1)")


# ---------------------------------------------------------------------------
# initialisation helpers
# ---------------------------------------------------------------------------


def dense_init(key: prng.Key, in_dim: int, out_dim: int, dtype,
               device) -> torch.Tensor:
    scale = np.float32(1.0 / np.sqrt(in_dim))
    return (prng.normal_torch(key, (in_dim, out_dim), device)
            * float(scale)).to(dtype)


def embed_init(key: prng.Key, vocab: int, dim: int, dtype,
               device) -> torch.Tensor:
    return (prng.normal_torch(key, (vocab, dim), device)
            * float(np.float32(0.02))).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_init(dim: int, dtype, device) -> Params:
    return {"scale": torch.ones(dim, dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """Variance in f32; the normalize multiply stays in x's dtype."""
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1,
                     keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * params["scale"].to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float) -> torch.Tensor:
    """(hd/2,) f32 on the CPU: ``1 / theta ** (arange(half) / half)``."""
    half = head_dim // 2
    expo = torch.arange(half, dtype=torch.float32) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), expo)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta).to(x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention_init(key: prng.Key, cfg, dtype, device) -> Params:
    hd = cfg.hd
    kq, kk, kv, ko = prng.split(key, 4)
    p = {
        "wq": dense_init(kq, cfg.d_model, cfg.n_heads * hd, dtype, device),
        "wk": dense_init(kk, cfg.d_model, cfg.n_kv_heads * hd, dtype,
                         device),
        "wv": dense_init(kv, cfg.d_model, cfg.n_kv_heads * hd, dtype,
                         device),
        "wo": dense_init(ko, cfg.n_heads * hd, cfg.d_model, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, device)
        p["k_norm"] = rmsnorm_init(hd, dtype, device)
    return p


def _cast(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return w.to(x.dtype)


def _qkv(params: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
         rope: bool = True):
    B, S, _ = x.shape
    hd = cfg.hd
    q = (x @ _cast(params["wq"], x)).reshape(B, S, cfg.n_heads, hd)
    k = (x @ _cast(params["wk"], x)).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ _cast(params["wv"], x)).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def full_attention(params: Params, cfg, x: torch.Tensor,
                   positions: torch.Tensor, *, causal: bool = True,
                   window: Optional[int] = None,
                   memory: Optional[torch.Tensor] = None,
                   rope: bool = True, return_kv: bool = False):
    """Prefill self-attention over the full sequence, through the flash
    kernel; ``return_kv`` also returns the (roped, un-repeated) K and V
    for the serving cache."""
    if window is not None:
        raise _unported("windowed attention")
    if memory is not None:
        raise _unported("cross-attention")
    B, S, _ = x.shape
    q, k, v = _qkv(params, cfg, x, positions, rope=rope)
    out = ops.flash_attention(q.contiguous(), k.contiguous(),
                              v.contiguous(), causal=causal)
    out = out.reshape(B, S, -1) @ _cast(params["wo"], x)
    if return_kv:
        return out, (k, v)
    return out


def decode_attention(params: Params, cfg, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                     *, window: Optional[int] = None):
    """Single-token decode.  x: (B, 1, D); cache_[kv]: (B, C, Hkv, hd), C
    the capacity; ``pos`` the absolute position of the new token.  The
    new K and V are written into the cache in place (the reference
    returns updated copies).  Returns (out, cache_k, cache_v)."""
    if window is not None:
        raise _unported("windowed (ring-buffer) decode")
    B = x.shape[0]
    hd = cfg.hd
    n_kv = cfg.n_kv_heads
    n_rep = cfg.n_heads // n_kv
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(params, cfg, x, positions)
    C = cache_k.shape[1]
    slot = min(pos, C - 1)
    cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)
    valid = torch.arange(C, device=x.device) <= pos
    # grouped GQA: q head g * n_rep + r reads kv head g, never repeated
    qg = q.reshape(B, n_kv, n_rep, hd)
    scores = torch.einsum("bgrd,bcgd->bgrc", qg.to(torch.float32),
                          cache_k.to(torch.float32)) / float(np.sqrt(hd))
    scores = scores.masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrc,bcgd->bgrd", probs.to(cache_v.dtype), cache_v)
    out = out.reshape(B, 1, -1) @ _cast(params["wo"], x)
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_init(key: prng.Key, cfg, dtype, device,
             d_ff: Optional[int] = None) -> Params:
    d_ff = d_ff or cfg.d_ff
    k1, k2, k3 = prng.split(key, 3)
    if cfg.act == "swiglu":
        return {
            "w1": dense_init(k1, cfg.d_model, d_ff, dtype, device),
            "w3": dense_init(k3, cfg.d_model, d_ff, dtype, device),
            "w2": dense_init(k2, d_ff, cfg.d_model, dtype, device),
        }
    return {
        "w1": dense_init(k1, cfg.d_model, d_ff, dtype, device),
        "w2": dense_init(k2, d_ff, cfg.d_model, dtype, device),
    }


def mlp(params: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        return (F.silu(x @ _cast(params["w1"], x))
                * (x @ _cast(params["w3"], x))) @ _cast(params["w2"], x)
    return F.gelu(x @ _cast(params["w1"], x), approximate="tanh") \
        @ _cast(params["w2"], x)


# ---------------------------------------------------------------------------
# LM head
# ---------------------------------------------------------------------------


def lm_head(embed: torch.Tensor, head: Optional[torch.Tensor],
            x: torch.Tensor, tie: bool) -> torch.Tensor:
    """(B, S, D) -> (B, S, V) f32 logits: the weight rounded to x's dtype,
    the product in f32."""
    w = embed.t() if tie else head
    return x.to(torch.float32) @ w.to(x.dtype).to(torch.float32)
