"""Mamba2 (SSD, state-space duality) block: the reference's
``repro/models/ssm.py`` in PyTorch.

Prefill runs the chunked form: quadratic within a chunk of ``Q`` steps
(``Q = min(ssm_chunk, S)``, lowered to the largest divisor of S when S is
not a multiple, as the reference does), recurrent across chunks.
Decode is the O(1) recurrent update of the per-head state (B, H, P, N)
and the conv ring of the last k - 1 pre-conv inputs.  The compute dtype
rounds where the reference's does: the intra-chunk product takes its
decay-weighted M and x * dt in the compute dtype, the incoming state's
contribution is cast to it, the states and decays stay f32.

``A_log = log(linspace(1, 16, H))`` is made on the host as the
reference's XLA computes it: the linspace reassociated by XLA's
simplifier, ``(1 - i * r) + i * f32(16 r)`` with ``r = f32(1 / (H - 1))``
and the last add one FMA, then XLA's f32 log (:func:`repro_torch.prng._log`).
``torch.linspace`` and ``torch.log`` differ from it in a few lanes.

The reference has no Pallas kernel here (its scan and einsums are XLA
ops); the port's are PyTorch ops.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.models import layers

Params = Dict[str, object]


def a_log(H: int) -> np.ndarray:
    """(H,) f32: ``jnp.log(jnp.linspace(1.0, 16.0, H))`` as XLA computes
    it on the CPU."""
    f32 = np.float32
    if H == 1:
        lin = np.ones(1, f32)
    else:
        i = np.arange(H - 1, dtype=f32)
        r = f32(f32(1.0) / f32(H - 1))
        head = prng._fma(i, float(f32(f32(16.0) * r)),
                         (f32(1.0) - i * r).astype(f32), prng._np_to)
        lin = np.append(head, f32(16.0)).astype(f32)
    return prng._log(lin, np, prng._np_to, prng._np_view).astype(f32)


def ssm_init(key: prng.Key, cfg, dtype, device) -> Params:
    D, DI, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    keys = prng.split(key, 6)
    in_dim = 2 * DI + 2 * N + H  # z, x, B, C, dt
    return {
        "in_proj": layers.dense_init(keys[0], D, in_dim, dtype, device),
        "out_proj": layers.dense_init(keys[1], DI, D, dtype, device),
        "conv_w": (prng.normal_torch(keys[2], (cfg.ssm_conv, DI + 2 * N),
                                     device)
                   * float(np.float32(0.1))).to(dtype),
        "conv_b": torch.zeros(DI + 2 * N, dtype=dtype, device=device),
        "A_log": torch.from_numpy(a_log(H)).to(device),
        "dt_bias": torch.zeros(H, dtype=torch.float32, device=device),
        "D_skip": torch.ones(H, dtype=dtype, device=device),
        "norm": layers.rmsnorm_init(DI, dtype, device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|))."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _split_proj(cfg, proj: torch.Tensor):
    DI, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return torch.split(proj, [DI, DI + 2 * N, H], dim=-1)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time.  xBC (B, S, Ch), w (k, Ch)."""
    k, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, k - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + S] * w[i]
    return F.silu(out + b)


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA (..., L) -> (..., L, L): M[i, j] = sum_{j < t <= i} dA[t] below
    the diagonal (log space), -inf above it."""
    L = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=dA.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_forward(params: Params, cfg, u: torch.Tensor, state=None,
                return_state: bool = False):
    """u (B, S, d_model) -> y (B, S, d_model); with ``return_state`` also
    ``{"ssm": (B, H, P, N) f32, "conv": (B, k - 1, Ch)}`` for decode.
    ``state``: an optional (B, H, P, N) initial state (or such a dict)."""
    B, S, _ = u.shape
    DI, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    Q = min(cfg.ssm_chunk, S)
    while S % Q:  # the largest divisor (odd prompts)
        Q -= 1
    nc = S // Q
    f32 = torch.float32

    proj = u @ params["in_proj"].to(u.dtype)
    z, xBC_in, dt = _split_proj(cfg, proj)
    xBC = _causal_conv(xBC_in, params["conv_w"].to(u.dtype),
                       params["conv_b"].to(u.dtype))
    x, Bmat, Cmat = torch.split(xBC, [DI, N, N], dim=-1)
    x = x.reshape(B, S, H, P)
    dt = softplus(dt.to(f32) + params["dt_bias"])  # (B, S, H)
    A = -torch.exp(params["A_log"])
    dA = dt * A

    xc = x.reshape(B, nc, Q, H, P)
    Bc = Bmat.reshape(B, nc, Q, N).to(f32)
    Cc = Cmat.reshape(B, nc, Q, N).to(f32)
    dAc = dA.reshape(B, nc, Q, H).permute(0, 1, 3, 2)  # (B, nc, H, Q)
    dtc = dt.reshape(B, nc, Q, H)

    # intra-chunk
    L = torch.exp(_segsum(dAc))  # (B, nc, H, Q, Q)
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    M = CB[:, :, None] * L
    xdt = xc * dtc[..., None]  # (B, nc, Q, H, P), f32
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", M.to(u.dtype),
                          xdt.to(u.dtype))

    # chunk states: decay from each step to the chunk's end
    cum = torch.cumsum(dAc, dim=-1)
    total = torch.sum(dAc, dim=-1, keepdim=True)  # (B, nc, H, 1)
    decay_states = torch.exp(total - cum)
    chunk_states = torch.einsum("bckn,bchk,bckhp->bchpn", Bc, decay_states,
                                xdt.to(f32))
    chunk_decay = torch.exp(total[..., 0])  # (B, nc, H)

    if state is None:
        s = torch.zeros((B, H, P, N), dtype=f32, device=u.device)
    else:
        s = state["ssm"] if isinstance(state, dict) else state
    states_in = torch.empty((B, nc, H, P, N), dtype=f32, device=u.device)
    for c in range(nc):  # the state entering each chunk
        states_in[:, c] = s
        s = s * chunk_decay[:, c, :, None, None] + chunk_states[:, c]

    decay_from_start = torch.exp(cum)  # (B, nc, H, Q)
    y_off = torch.einsum("bcqn,bchq,bchpn->bcqhp", Cc, decay_from_start,
                         states_in).to(u.dtype)

    y = (y_diag + y_off).reshape(B, S, H, P)
    y = y + x * params["D_skip"][None, None, :, None].to(u.dtype)
    y = y.reshape(B, S, DI)
    y = layers.rmsnorm(params["norm"], y, cfg.norm_eps)
    y = y * F.silu(z)
    out = y @ params["out_proj"].to(u.dtype)
    if return_state:
        # the conv ring: the last k - 1 pre-conv inputs, zero-padded on
        # the left for prompts shorter than the kernel
        kc = params["conv_w"].shape[0]
        padded = F.pad(xBC_in, (0, 0, max(0, kc - 1 - S), 0))
        conv_state = padded[:, padded.shape[1] - (kc - 1):]
        return out, {"ssm": s, "conv": conv_state}
    return out


def ssd_decode_step(params: Params, cfg, u: torch.Tensor, state):
    """u (B, 1, d_model); state ``{"ssm": (B, H, P, N), "conv": (B, k-1,
    Ch)}`` -> (y (B, 1, d_model), the new state)."""
    B = u.shape[0]
    DI, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    f32 = torch.float32
    sstate, cstate = state["ssm"], state["conv"]
    proj = u @ params["in_proj"].to(u.dtype)
    z, xBC_in, dt = _split_proj(cfg, proj)
    w = params["conv_w"].to(u.dtype)  # (k, Ch)
    window = torch.cat([cstate.to(u.dtype), xBC_in], dim=1)
    xBC = F.silu(torch.einsum("bkc,kc->bc", window, w)[:, None, :]
                 + params["conv_b"].to(u.dtype))
    new_cstate = window[:, 1:]
    x, Bmat, Cmat = torch.split(xBC, [DI, N, N], dim=-1)
    x = x.reshape(B, H, P)
    Bv = Bmat[:, 0].to(f32)
    Cv = Cmat[:, 0].to(f32)
    dt = softplus(dt[:, 0].to(f32) + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    da = torch.exp(dt * A)  # (B, H)
    upd = torch.einsum("bhp,bn,bh->bhpn", x.to(f32), Bv, dt)
    sstate = sstate * da[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", sstate, Cv).to(u.dtype)
    y = y + x * params["D_skip"][None, :, None].to(u.dtype)
    y = y.reshape(B, 1, DI)
    y = layers.rmsnorm(params["norm"], y, cfg.norm_eps)
    y = y * F.silu(z)
    return (y @ params["out_proj"].to(u.dtype),
            {"ssm": sstate, "conv": new_cstate})
