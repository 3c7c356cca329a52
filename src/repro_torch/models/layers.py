"""Transformer building blocks over plain dicts of tensors: the reference's
``repro/models/layers.py`` in PyTorch.

Every function keeps the reference's signature, parameter layout
((in, out) dense weights, so ``x @ w`` reads the same) and order of
operations, including where the compute dtype rounds:

  * :func:`rmsnorm` takes the variance in f32 and casts ``rsqrt`` to
    x's dtype before it multiplies;
  * :func:`apply_rope` rotates the halves ``(x[:hd/2], x[hd/2:])`` in
    f32, with the frequencies computed on the host in f32 in the
    reference's order, ``1 / theta ** (arange(half) / half)``;
  * in :func:`_qkv`, the qk-norm comes before RoPE;
  * :func:`lm_head`, :func:`_sdpa` and the decode attentions keep their
    scores f32 (the reference's ``preferred_element_type``): a bf16
    operand pair is upcast and multiplied in f32, since a bf16 matmul in
    PyTorch returns bf16, and greedy argmax must not see logits rounded
    to bf16; the probabilities are cast to v's dtype before the PV
    product;
  * a division by ``sqrt(hd)`` divides by an f32 tensor on the
    operand's device (:func:`div_f32`): PyTorch on CUDA turns a division
    by a host scalar into a multiply by its reciprocal.

:func:`full_attention` has two forms, picked by its ``train`` argument,
which the training forwards of :mod:`.transformer` pass down:

  * serving (``train=False``, prefill): causal and non-causal
    self-attention through :func:`repro_torch.kernels.ops.flash_attention`
    (the CUDA kernel on the card, its plain version on the CPU), and a
    sliding window too while the sequence fits in it (S <= window: the
    window mask is then the causal mask).  A longer windowed sequence
    runs :func:`_sdpa` in PyTorch ops, q-chunked as the reference's
    ``_chunked_attention`` when ``attn_chunk`` is set.
  * training (``train=True``): the reference's XLA forms in PyTorch ops
    under autograd, chosen by the reference's rules: the online softmax
    (:func:`_online_attention`) for ``attn_impl="online"`` when S splits
    into its chunks, the q-chunked form beyond ``attn_chunk``, else one
    :func:`_sdpa` under the causal / window mask.  The CUDA flash kernel
    has no backward (neither has the reference's Pallas kernel), and its
    wrapper refuses a differentiable input.

Cross-attention runs :func:`_sdpa` in both forms: the reference computes
it in XLA (its Pallas kernel has no window and no memory).  Beyond
``attn_chunk`` the reference masks causally even where ``causal=False``
(its chunked and online paths know no other mask); so does this port.
The reference's ``constrain_*`` sharding hints are no-ops on one device
and are dropped.  :func:`cross_entropy` is the training loss.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.kernels import ops

Params = Dict[str, object]


def div_f32(x: torch.Tensor, v: float) -> torch.Tensor:
    """``x / f32(v)``, a true division on every device (the divisor an f32
    tensor on x's device, never a host scalar)."""
    return x / torch.tensor(np.float32(v), device=x.device)


def sqrt_f32(v: int) -> float:
    """``np.sqrt(v)`` rounded to f32 (the reference divides f32 arrays by
    it)."""
    return float(np.float32(np.sqrt(v)))


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


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, Hkv * n_rep, hd), kv head g read by q
    heads g * n_rep .. g * n_rep + n_rep - 1."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=2)


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: Optional[int],
          causal: bool) -> torch.Tensor:
    """Boolean (len_q, len_k) mask; True = attend."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    diff = q_pos[:, None].to(torch.int64) - k_pos[None, :].to(torch.int64)
    if causal:
        m &= diff >= 0
    if window is not None:
        m &= diff < window
    return m


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q (B, Sq, H, hd), k / v (B, Sk, H, hd), mask (Sq, Sk) or None (all
    attend) -> (B, Sq, H, hd) of v's dtype: f32 scores over f32
    ``sqrt(hd)``, masked to -1e30, an f32 softmax, p cast to v's dtype."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32))
    scores = div_f32(scores, sqrt_f32(hd))
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _chunked_attention(q, k, v, positions, window, chunk):
    """The reference's q-chunked attention: each chunk of ``chunk`` query
    rows against every key under the causal (and window) mask; the
    largest score tensor is (B, H, chunk, S)."""
    S = q.shape[1]
    if S % chunk:
        raise ValueError(f"S {S} is not a multiple of attn_chunk {chunk}")
    return torch.cat([
        _sdpa(q[:, c0:c0 + chunk], k, v,
              _mask(positions[c0:c0 + chunk], positions, window,
                    causal=True))
        for c0 in range(0, S, chunk)], dim=1)


def _online_attention(q, k, v, positions, window, q_chunk: int,
                      kv_chunk: int) -> torch.Tensor:
    """The reference's flash-style online softmax in plain ops: for each
    chunk of ``q_chunk`` query rows, a loop over every chunk of
    ``kv_chunk`` keys carrying the running max m (from -1e30), denominator
    l and f32 accumulator; f32 scores times the f32 ``1 / sqrt(hd)``,
    masked to -1e30 (causal, and the window), p cast to v's dtype before
    P V, ``acc / max(l, 1e-20)`` cast to q's dtype.  Every kv chunk is
    visited, masked or not, as the reference's scan visits them."""
    B, S, H, hd = q.shape
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    f32 = torch.float32
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, S, hd)
    outs = []
    for q0 in range(0, S, q_chunk):
        q_i, qpos = qh[:, :, q0:q0 + q_chunk], positions[q0:q0 + q_chunk]
        m = torch.full((B, H, q_chunk), -1e30, dtype=f32, device=q.device)
        l = torch.zeros((B, H, q_chunk), dtype=f32, device=q.device)
        acc = torch.zeros((B, H, q_chunk, hd), dtype=f32, device=q.device)
        for k0 in range(0, S, kv_chunk):
            k_j, v_j = kh[:, :, k0:k0 + kv_chunk], vh[:, :, k0:k0 + kv_chunk]
            s = torch.einsum("bhqd,bhkd->bhqk", q_i.to(f32),
                             k_j.to(f32)) * scale
            mask = _mask(qpos, positions[k0:k0 + kv_chunk], window,
                         causal=True)
            s = s.masked_fill(~mask, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(v_j.dtype), v_j).to(f32)
            m = m_new
        out = acc / torch.maximum(l, l.new_tensor(1e-20))[..., None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=2).transpose(1, 2)


def _train_attention(cfg, q, k, v, positions, window, causal):
    """Self-attention of the training forward (q, k, v roped, k and v
    repeated to q's heads): the reference's choice among its XLA forms."""
    S = q.shape[1]
    chunk, kv_chunk = cfg.attn_chunk, min(cfg.attn_kv_chunk, S)
    if (cfg.attn_impl == "online" and chunk and S > chunk
            and S % chunk == 0 and S % kv_chunk == 0):
        return _online_attention(q, k, v, positions, window, chunk,
                                 kv_chunk)
    if chunk and S > chunk:
        return _chunked_attention(q, k, v, positions, window, chunk)
    return _sdpa(q, k, v, _mask(positions, positions, window, causal))


def full_attention(params: Params, cfg, x: torch.Tensor,
                   positions: torch.Tensor, *, causal: bool = True,
                   window: Optional[int] = None,
                   memory: Optional[torch.Tensor] = None,
                   rope: bool = True, return_kv: bool = False,
                   train: bool = False):
    """Attention over the full sequence: the serving prefill's form, or
    with ``train`` the training forward's (see the module's docstring).
    ``memory`` (B, Sm, D) makes it cross-attention (keys and values from
    memory; no mask, no RoPE); ``return_kv`` also returns the (roped,
    un-repeated) K and V for the serving cache."""
    B, S, _ = x.shape
    n_rep = cfg.n_heads // cfg.n_kv_heads
    if memory is not None:
        hd = cfg.hd
        Sm = memory.shape[1]
        q = (x @ _cast(params["wq"], x)).reshape(B, S, cfg.n_heads, hd)
        k = (memory @ _cast(params["wk"], x)).reshape(B, Sm,
                                                      cfg.n_kv_heads, hd)
        v = (memory @ _cast(params["wv"], x)).reshape(B, Sm,
                                                      cfg.n_kv_heads, hd)
        out = _sdpa(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep), None)
        return out.reshape(B, S, -1) @ _cast(params["wo"], x)

    q, k, v = _qkv(params, cfg, x, positions, rope=rope)
    chunked = bool(cfg.attn_chunk) and S > cfg.attn_chunk
    if train:
        out = _train_attention(cfg, q, _repeat_kv(k, n_rep),
                               _repeat_kv(v, n_rep), positions, window,
                               causal)
    elif window is not None and S > window:
        kr, vr = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
        if chunked:
            out = _chunked_attention(q, kr, vr, positions, window,
                                     cfg.attn_chunk)
        else:
            out = _sdpa(q, kr, vr, _mask(positions, positions, window,
                                         causal))
    else:
        out = ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal or chunked)
    out = out.reshape(B, S, -1) @ _cast(params["wo"], x)
    if return_kv:
        return out, (k, v)
    return out


def decode_attention(params: Params, cfg, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                     *, window: Optional[int] = None):
    """Single-token decode.  x: (B, 1, D); cache_[kv]: (B, C, Hkv, hd), C
    the capacity (the full sequence, or a ring buffer of the window);
    ``pos`` the absolute position of the new token.  Without a window
    the new K and V go to slot min(pos, C - 1) and slots <= pos attend;
    with one, to slot pos % C, and a slot attends when the position it
    holds (pos - ((pos - i) mod C)) is >= 0 and within the window.  The
    cache is written in place (the reference returns updated copies).
    Returns (out, cache_k, cache_v)."""
    B = x.shape[0]
    hd = cfg.hd
    n_kv = cfg.n_kv_heads
    n_rep = cfg.n_heads // n_kv
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(params, cfg, x, positions)
    C = cache_k.shape[1]
    slot = min(pos, C - 1) if window is None else pos % C
    cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)
    idx = torch.arange(C, device=x.device)
    if window is None:
        valid = idx <= pos
    else:
        p_at = pos - torch.remainder(pos - idx, C)
        valid = (p_at >= 0) & (p_at > pos - window)
    # grouped GQA: q head g * n_rep + r reads kv head g, never repeated
    qg = q.reshape(B, n_kv, n_rep, hd)
    scores = torch.einsum("bgrd,bcgd->bgrc", qg.to(torch.float32),
                          cache_k.to(torch.float32))
    scores = div_f32(scores, sqrt_f32(hd)).masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrc,bcgd->bgrd", probs.to(cache_v.dtype), cache_v)
    out = out.reshape(B, 1, -1) @ _cast(params["wo"], x)
    return out, cache_k, cache_v


def cross_attention_decode(params: Params, cfg, x: torch.Tensor,
                           mem_k: torch.Tensor,
                           mem_v: torch.Tensor) -> torch.Tensor:
    """Decode-time cross-attention of x (B, 1, D) against the encoder's
    K / V (B, Sm, Hkv, hd) computed at prefill."""
    B = x.shape[0]
    hd = cfg.hd
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q = (x @ _cast(params["wq"], x)).reshape(B, 1, cfg.n_heads, hd)
    out = _sdpa(q, _repeat_kv(mem_k, n_rep), _repeat_kv(mem_v, n_rep), None)
    return out.reshape(B, 1, -1).to(x.dtype) @ _cast(params["wo"], x)


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


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B, S, V), targets (B, S) -> the mean NLL over the valid
    tokens, in f32: ``logsumexp - the target's logit``, averaged, or with
    ``mask`` summed over the masked tokens and divided by ``max(sum mask,
    1)``."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    nll = logz - torch.gather(logits, -1,
                              targets[..., None].to(torch.int64))[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
