"""Plain PyTorch copies of the reference's oracles (``repro/kernels/ref.py``)
that the server and the codec build on.

Each keeps the reference's op order as its jitted programs compute it:
``x / scale`` is a true division by a tensor (PyTorch turns a division by
a Python number on CUDA into a multiply by its reciprocal, which rounds
differently), ``torch.round`` rounds half to even like ``jnp.round``, and
the scale is ``max(absmax * f32(1/127), 1e-12)`` (``f32(1/7)`` on the
packed-int4 wire).
Host scalars (fold weights, survival factors) are np.float32 values.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def fold_ref(acc: torch.Tensor, vec: torch.Tensor, w,
             beta=1.0) -> torch.Tensor:
    """One streaming fold: beta*acc + w*vec (w, beta rounded to f32).
    beta == 1 never multiplies acc, as the reference keeps beta a
    compile-time constant outside fedasync."""
    wv = float(np.float32(w)) * vec
    if float(np.float32(beta)) == 1.0:
        return acc + wv
    return float(np.float32(beta)) * acc + wv


def dequant_flat_ref(q: torch.Tensor, scales: torch.Tensor,
                     qblock: int) -> torch.Tensor:
    """Blockwise dequantize: q (..., Dq) int8 with scales (..., Dq/qblock)
    -> (..., Dq) f32, each lane (float)q * its block's scale.  Padding
    blocks carry scale 0 and dequantize to 0."""
    shape = q.shape
    nb = shape[-1] // qblock
    return (q.to(torch.float32).reshape(*shape[:-1], nb, qblock)
            * scales.unsqueeze(-1)).reshape(shape)


def fold_q8_ref(acc: torch.Tensor, q_row: torch.Tensor, s_row: torch.Tensor,
                w, qblock: int, beta=1.0) -> torch.Tensor:
    """Streaming fold of one quantized row: dequantize, then
    :func:`fold_ref`."""
    return fold_ref(acc, dequant_flat_ref(q_row, s_row, qblock), w, beta)


def unpack_q4_ref(p: torch.Tensor) -> torch.Tensor:
    """(..., n) packed int8 -> (..., 2n) int8 lanes in [-8, 7]: lane 2j
    is the low nibble of byte j, lane 2j+1 the high one, each
    sign-extended (a nibble above 7 reads as itself minus 16)."""
    u = p.view(torch.uint8).to(torch.int16)
    lo, hi = u & 0xF, u >> 4
    lanes = torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1],
                                                  2 * p.shape[-1])
    return torch.where(lanes > 7, lanes - 16, lanes).to(torch.int8)


def pack_q4_ref(q: torch.Tensor) -> torch.Tensor:
    """(..., 2n) int8 lanes in [-8, 7] -> (..., n) int8, two per byte in
    :func:`unpack_q4_ref`'s layout (two's complement nibbles)."""
    u = q.view(torch.uint8) & 0xF
    return (u[..., 0::2] | (u[..., 1::2] << 4)).view(torch.int8)


def dequant_q4_flat_ref(p: torch.Tensor, scales: torch.Tensor,
                        qblock: int) -> torch.Tensor:
    """Unpack, then :func:`dequant_flat_ref`: p (..., Dq/2) packed int8
    with scales (..., Dq/qblock) -> (..., Dq) f32."""
    return dequant_flat_ref(unpack_q4_ref(p), scales, qblock)


def fold_q4_ref(acc: torch.Tensor, p_row: torch.Tensor, s_row: torch.Tensor,
                w, qblock: int, beta=1.0) -> torch.Tensor:
    """Streaming fold of one packed int4 row: unpack, dequantize, then
    :func:`fold_ref`."""
    return fold_ref(acc, dequant_q4_flat_ref(p_row, s_row, qblock), w, beta)


def _mix_rates(rows, rates, params: torch.Tensor):
    """The sequential fedasync mix in (S, P) form over ``rows`` (a
    sequence of (d,) f32 rows): S <- (1 - a_i)*S + a_i*u_i, P <- P*(1 -
    a_i), then P*p + S.  Returns (mixed, 1 - P)."""
    s = torch.zeros_like(params, dtype=torch.float32)
    prod = np.float32(1.0)
    for a, u in zip(np.asarray(rates, np.float32), rows):
        beta = np.float32(1.0) - a
        s = fold_ref(s, u, a, beta)
        prod = np.float32(prod * beta)
    return float(prod) * params.to(torch.float32) + s, \
        np.float32(np.float32(1.0) - prod)


def fedasync_rates_flat_ref(updates: torch.Tensor, rates,
                            params: torch.Tensor):
    """Sequential fedasync mix over a flat (K, D) buffer: K mixes
    p <- (1 - a_i) p + a_i u_i as the fold recursion with beta = 1 - a_i
    (S) and the host product P = prod(1 - a_i), final model P*p + S.
    ``rates`` are the raw np.float32 per-upload rates a_i.  Returns
    (mixed, weight_sum = 1 - P)."""
    return _mix_rates(updates.to(torch.float32), rates, params)


def fedasync_rates_flat_q8_ref(q: torch.Tensor, scales: torch.Tensor, rates,
                               params: torch.Tensor, qblock: int):
    """:func:`fedasync_rates_flat_ref` with each int8 row dequantized (and
    cut to the params' d lanes) before its fold."""
    d = params.shape[0]
    rows = (dequant_flat_ref(q[i], scales[i], qblock)[:d]
            for i in range(q.shape[0]))
    return _mix_rates(rows, rates, params)


def fedasync_rates_flat_q4_ref(p: torch.Tensor, scales: torch.Tensor, rates,
                               params: torch.Tensor, qblock: int):
    """:func:`fedasync_rates_flat_q8_ref` over packed int4 rows."""
    return fedasync_rates_flat_q8_ref(unpack_q4_ref(p), scales, rates,
                                      params, qblock)


def sdga_step_from_mean(g: torch.Tensor, params: torch.Tensor,
                        mom: torch.Tensor, ema: torch.Tensor, *,
                        server_lr: float, momentum: float,
                        ema_anchor: float, ema_decay: float):
    """The SDGA server step from the aggregated mean g (D,):
    m' = mu*m + g, p' = p - lr*m' + anchor*(e - p),
    e' = decay*e + (1 - decay)*p'.  Returns (p', m', e')."""
    m_new = momentum * mom + g
    p_new = params - server_lr * m_new + ema_anchor * (ema - params)
    e_new = ema_decay * ema + (1.0 - ema_decay) * p_new
    return p_new, m_new, e_new


#: 1/127 rounded to f32: inside a jitted program XLA turns the reference's
#: ``absmax / 127.0`` (a division by a constant) into a multiply by this
#: reciprocal, and the reference's codec runs jitted
INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_ref(x: torch.Tensor):
    """Blockwise int8 absmax quantization: x (R, B) f32 -> (q int8 (R, B),
    scales f32 (R,)), scale = max(absmax * f32(1/127), 1e-12) (the
    reference's ``absmax / 127`` as its jitted codec computes it),
    q = clip(round(x / scale), -127, 127) with a true division."""
    x = x.to(torch.float32)
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True) * INV_127,
                        min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q.to(torch.int8), scale[:, 0]


#: 1/7 rounded to f32, the q4 twin of :data:`INV_127`
INV_7 = float(np.float32(1.0) / np.float32(7.0))
#: levels of the symmetric int4 grid [-7, 7] (-8 stays unused)
Q4_LEVELS = 7


def quantize_q4_ref(x: torch.Tensor, u: torch.Tensor):
    """Blockwise int4 absmax quantization with stochastic rounding, as the
    reference's jitted codec computes it: x (R, B) f32 and u (R, B)
    uniform [0, 1) draws -> (q int8 (R, B) in [-7, 7], scales f32 (R,)),
    scale = max(absmax * f32(1/7), 1e-12), y = clip(x / scale, -7, 7)
    with a true division, q = floor(y) + (u < y - floor(y)), clipped."""
    x = x.to(torch.float32)
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True) * INV_7,
                        min=1e-12)
    y = torch.clamp(x / scale, -Q4_LEVELS, Q4_LEVELS)
    f = torch.floor(y)
    q = torch.clamp(f + (u < (y - f)).to(torch.float32), -Q4_LEVELS,
                    Q4_LEVELS)
    return q.to(torch.int8), scale[:, 0]


def screen_sumsq_q8_ref(q: torch.Tensor, scales: torch.Tensor,
                        qblock: int) -> torch.Tensor:
    """Sum of squares of each dequantized int8 row, blockwise: (K, Dq)
    int8 + (K, Dq/qblock) scales -> (K,) f32, ``q2_b = sum q^2`` over
    each block in int32 (exact), then ``sum_b (q2_b * s_b) * s_b`` in
    f32.  An Inf scale poisons the sum (``0 * Inf`` is NaN)."""
    k, dq = q.shape
    nb = scales.shape[1]
    if dq != nb * qblock:
        raise ValueError(f"Dq={dq} is not {nb} blocks of {qblock}")
    qi = q.to(torch.int32)
    q2 = (qi * qi).view(k, nb, qblock).sum(dim=2, dtype=torch.int32)
    return (q2.to(torch.float32) * scales * scales).sum(dim=1)


def screen_sumsq_q4_ref(p: torch.Tensor, scales: torch.Tensor,
                        qblock: int) -> torch.Tensor:
    """Packed int4 screening: unpack the nibbles, then the q8 rule."""
    return screen_sumsq_q8_ref(unpack_q4_ref(p), scales, qblock)


# --------------- the q8 round's large-K int8-dot regime ---------------

#: rows at which the int8-dot regime may engage (the reference's constant)
INT8_DOT_MIN_K = 32


def int8dot_auto(k: int) -> bool:
    """Whether the buffered q8 round of K rows takes the int8-dot regime
    (:func:`repro_torch.kernels.int8dot.weighted_sum_q8_int8dot`).

    ``REPRO_INT8_DOT=1`` / ``=0`` override the platform gate exactly as
    the reference's ``int8dot_auto`` reads them, and the ``K >=
    INT8_DOT_MIN_K`` threshold always holds.  The platform gate itself
    is closed on both devices: on the CPU the reference closes it (XLA
    emulates the int8 GEMM), and the port's card path is the counterpart
    of the reference's Pallas backend, which runs the q8 aggregate kernel
    at every K.  So with the variable unset every round keeps the fused
    ``safl_aggregate_q8`` / ``sdga_aggregate_q8`` path and its launches.
    """
    env = os.environ.get("REPRO_INT8_DOT", "").strip()
    if env in ("0", "1"):
        return env == "1" and k >= INT8_DOT_MIN_K
    return False


def int8dot_coeff_scale(scales: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """(nb,) per-block absmax scale of the reduction coefficients c_kb =
    w_k * s_kb, as the reference's jitted ``int8dot_coeff_scale`` computes
    it: the column absmax over K times f32(1/127) (XLA's rewrite of
    ``absmax / 127``).  The mesh takes the elementwise max of every
    shard's, so each shard quantizes on the single device's grid."""
    c = w.to(torch.float32)[:, None] * scales
    return c.abs().amax(dim=0) * INV_127


# ------------------------- top-k sparse wire -------------------------


def dequant_topk_ref(qv: torch.Tensor, scales: torch.Tensor,
                     qblock: int) -> torch.Tensor:
    """Blockwise dequantize of compacted top-k values: qv (..., nk) int8
    with scales (..., nk/qblock) -> (..., nk) f32.  The granule runs over
    the compacted value array, not the dense coordinates."""
    return dequant_flat_ref(qv, scales, qblock)


def _scatter_add_drop(acc: torch.Tensor, idx: torch.Tensor,
                      vals: torch.Tensor) -> torch.Tensor:
    """acc[idx] += vals in place for the lanes with 0 <= idx < len(acc);
    the others are dropped (JAX's ``mode="drop"``).  The indices of one
    row are distinct, so each lane gets one add."""
    keep = (idx >= 0) & (idx < acc.shape[0])
    acc.index_put_((idx[keep].to(torch.int64),), vals[keep],
                   accumulate=True)
    return acc


def fold_topk_ref(acc: torch.Tensor, idx: torch.Tensor, qv: torch.Tensor,
                  s_row: torch.Tensor, w, qblock: int,
                  beta=1.0) -> torch.Tensor:
    """One streaming fold of a sparse upload: beta*acc, then
    + w * dequant(qv) scattered to ``idx`` (lanes with idx >= d drop)."""
    wv = float(np.float32(w)) * dequant_topk_ref(qv, s_row, qblock)
    base = float(np.float32(beta)) * acc.to(torch.float32)
    return _scatter_add_drop(base, idx, wv)


def topk_weighted_sum_ref(idx: torch.Tensor, qv: torch.Tensor,
                          scales: torch.Tensor, weights, d: int,
                          qblock: int) -> torch.Tensor:
    """sum_k w_k * scatter(dequant(qv_k), idx_k) -> (d,) f32, as K row
    scatters in order from zeros: bitwise the streaming channel's chain
    of :func:`fold_topk_ref` calls on the same rows."""
    w = torch.as_tensor(np.asarray(weights, np.float32))
    acc = torch.zeros(d, dtype=torch.float32, device=qv.device)
    vals = dequant_topk_ref(qv, scales, qblock)
    for k in range(idx.shape[0]):
        _scatter_add_drop(acc, idx[k], float(w[k]) * vals[k])
    return acc


def safl_agg_topk_ref(idx: torch.Tensor, qv: torch.Tensor,
                      scales: torch.Tensor, weights, params: torch.Tensor,
                      server_lr: float, qblock: int) -> torch.Tensor:
    """The topk FedSGD step: params - lr * (gsum / max(sum w, 1e-12))."""
    w = np.asarray(weights, np.float32)
    wsafe = torch.tensor(max(np.float32(np.sum(w)), np.float32(1e-12)),
                         device=params.device)
    gsum = topk_weighted_sum_ref(idx, qv, scales, w, params.shape[0],
                                 qblock)
    return params.to(torch.float32) - server_lr * (gsum / wsafe)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q (B, S, H, hd), k / v (B, S, Hkv, hd) GQA -> out (B, S, H, hd):
    k and v repeated to H heads, f32 scores divided by sqrt(hd), a -inf
    causal mask, an f32 softmax, the output cast to q's dtype (the
    reference's ``ref.flash_attention_ref``)."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) / float(np.sqrt(hd))
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype)
