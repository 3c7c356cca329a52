"""Mixture-of-experts layer: the reference's ``repro/models/moe.py``
(GShard-style top-k routing with a per-expert capacity) in PyTorch.

Tokens are cut into groups of ``min(moe_group_size, B * S)``; in each
group the router's f32 softmax picks ``top_k`` experts per token, ranked
by a stable descending sort (``lax.top_k``'s order: of equal
probabilities the lower expert first; ``torch.topk`` does not promise
it), a subnormal probability counted as 0 as XLA flushes it.  A token's choices are queued in k-major priority (every token's
first choice before any second choice) by an f32 cumsum, and a choice
whose place in its expert's queue is at or past the capacity
``max(4, int(capacity_factor * group * top_k / n_experts))`` is dropped,
its gate zeroed.  The kept tokens are gathered into each expert's slots,
the experts' SwiGLU products run as batched matmuls over (G, E, C, D),
and each token sums its kept experts' outputs weighted by its gates, in
k order.

Both of the reference's dispatches (``moe_dispatch_impl`` ``einsum``:
one-hot dispatch / combine tensors; ``scatter``: segment sums) compute
this function; with exact 0 / 1 dispatch weights they differ only in the
order their sums add.  One gather serves both here.  With
``moe_dispatch_dtype="bfloat16"`` the einsum path rounds the gate
weights to bf16 in its combine tensor; so does this port (the scatter
path keeps them in the compute dtype, as the reference's).  The reference
has no Pallas kernel here: the routing and products are XLA ops there
and PyTorch ops (cuBLAS matmuls on the card) here.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.models import layers

Params = Dict[str, object]

_F32_TINY = float(np.finfo(np.float32).tiny)

#: experts drawn at once by :func:`moe_init` (a slice of the (E, D, F)
#: draw; kimi-k2's full draw is 21 GiB of f32)
INIT_EXPERTS = 16


def _expert_weights(key: prng.Key, shape, fan_in: int, dtype,
                    device) -> torch.Tensor:
    """``(normal(key, shape) / jnp.sqrt(fan_in)).astype(dtype)``, drawn in
    slices of :data:`INIT_EXPERTS` experts (the lanes of the one draw),
    each divided by the f32 root on the device and rounded to ``dtype``."""
    E = shape[0]
    per = int(np.prod(shape[1:]))
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    for e0 in range(0, E, INIT_EXPERTS):
        e1 = min(E, e0 + INIT_EXPERTS)
        w = prng.normal_torch(key, (e1 - e0, *shape[1:]), device,
                              start=e0 * per)
        out[e0:e1] = layers.div_f32(w, layers.sqrt_f32(fan_in)).to(dtype)
    return out


def moe_init(key: prng.Key, cfg, dtype, device) -> Params:
    kg, k1, k2, k3, ks = prng.split(key, 5)
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": layers.dense_init(kg, D, E, torch.float32, device),
        "w1": _expert_weights(k1, (E, D, Fd), D, dtype, device),
        "w3": _expert_weights(k3, (E, D, Fd), D, dtype, device),
        "w2": _expert_weights(k2, (E, Fd, D), Fd, dtype, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = layers.mlp_init(ks, cfg, dtype, device,
                                      d_ff=cfg.d_ff * cfg.n_shared_experts)
    return p


def _capacity(cfg, group_size: int) -> int:
    c = int(cfg.capacity_factor * group_size * cfg.top_k / cfg.n_experts)
    return max(4, c)


def route(params: Params, cfg, xt: torch.Tensor):
    """The router of groups ``xt`` (G, gs, D): (probs (G, gs, E) f32,
    gate values (G, gs, K) f32 normalised and zeroed where dropped,
    expert index (G, gs, K), slot in the expert's queue (G, gs, K),
    kept (G, gs, K) bool)."""
    G, gs, _ = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = xt.to(torch.float32) @ params["router"]
    # subnormal probabilities flushed to 0, as XLA's softmax on the CPU
    # flushes them: a tie at 0 then ranks the lower expert first
    probs = torch.softmax(logits, dim=-1)
    probs = probs.masked_fill(probs < _F32_TINY, 0.0)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[..., :K], gate_idx[..., :K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    C = _capacity(cfg, gs)
    onehot = F.one_hot(gate_idx, E).to(torch.float32)  # (G, gs, K, E)
    # choices in priority order: all k = 0 first, then k = 1, ...
    oh_k_major = onehot.transpose(1, 2).reshape(G, K * gs, E)
    pos_in_e = torch.cumsum(oh_k_major, dim=1) - oh_k_major
    pos = (pos_in_e * oh_k_major).sum(-1)  # (G, K * gs), exact integers
    keep = pos < C
    pos = pos.reshape(G, K, gs).transpose(1, 2).to(torch.int64)
    keep = keep.reshape(G, K, gs).transpose(1, 2)
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    return probs, gate_vals, gate_idx, pos, keep, onehot


def moe_apply(params: Params, cfg, x: torch.Tensor):
    """x (B, S, D) -> (y (B, S, D), the Switch aux loss)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    gs = min(cfg.moe_group_size, T)
    if T % gs:
        raise ValueError(f"tokens {T} not divisible by group {gs}")
    G = T // gs
    C = _capacity(cfg, gs)
    cdt = getattr(torch, cfg.compute_dtype)
    xt = x.reshape(G, gs, D)
    probs, gate_vals, gate_idx, pos, keep, onehot = route(params, cfg, xt)
    if cfg.moe_dispatch_impl != "scatter":
        # the einsum path's combine tensor holds the gates in the
        # dispatch dtype
        gate_vals = gate_vals.to(getattr(torch, cfg.moe_dispatch_dtype))

    # flat slot of (g, s, k): g*E*C + e*C + pos; a dropped choice -> the
    # overflow slot G*E*C (zeros)
    gidx = torch.arange(G, device=x.device)[:, None, None]
    flat_slot = torch.where(keep, gidx * E * C + gate_idx * C + pos,
                            G * E * C).reshape(-1)
    expert_in = torch.zeros((G * E * C + 1, D), dtype=cdt, device=x.device)
    tok = torch.arange(G * gs, device=x.device).repeat_interleave(K)
    # each kept slot holds exactly one token: a plain indexed write
    expert_in[flat_slot] = xt.reshape(G * gs, D).to(cdt)[tok]
    expert_in = expert_in[:-1].reshape(G, E, C, D)

    h1 = torch.einsum("gecd,edf->gecf", expert_in, params["w1"].to(cdt))
    h3 = torch.einsum("gecd,edf->gecf", expert_in, params["w3"].to(cdt))
    h = F.silu(h1) * h3
    expert_out = torch.einsum("gecf,efd->gecd", h, params["w2"].to(cdt))

    out_flat = torch.cat([expert_out.reshape(G * E * C, D),
                          torch.zeros((1, D), dtype=cdt, device=x.device)])
    y_k = out_flat[flat_slot].reshape(G, gs, K, D)
    gw = gate_vals.to(cdt)
    y = y_k[:, :, 0] * gw[..., 0, None]
    for k in range(1, K):
        y = y + y_k[:, :, k] * gw[..., k, None]
    y = y.reshape(B, S, D).to(x.dtype)

    if cfg.n_shared_experts:
        y = y + layers.mlp(params["shared"], cfg, x)

    # Switch aux loss: E * sum_e f_e * p_e (f_e: the top-1 fraction)
    frac_tokens = onehot[:, :, 0, :].mean(dim=(0, 1))
    mean_probs = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * mean_probs)
    return y, aux
