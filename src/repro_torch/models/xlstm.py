"""xLSTM blocks (arXiv:2405.04517): the reference's
``repro/models/xlstm.py`` in PyTorch.  mLSTM (matrix memory) runs its
parallel, attention-like form at prefill, whose closed-form final state
(:func:`mlstm_final_state`) hands over to the recurrent form at decode;
sLSTM (scalar memory) is a recurrent scan in both.  The stabilisers keep
the reference's order: log-sigmoid forget gates, the running max ``m``
started at -1e30, ``exp`` of the differences, the normaliser's floor
``exp(-m)`` (mLSTM) or 1 (sLSTM).  Divisions by ``sqrt(hd)`` divide by
the f32 root on the operand's device (:func:`layers.div_f32`).  The
training forward differentiates both blocks as they are: the sLSTM's
time loop writes each step's h into a fresh buffer that nothing has
saved, and its normaliser's floor ``max(n, 1)`` is ``torch.maximum``,
whose gradient at a tie is ``jnp.maximum``'s.

Blocks (xlstm-125m, d_ff = 0: the projections live in the blocks): mLSTM
block = norm, up-projection to 2 x 2D, mLSTM * silu(gate),
down-projection, residual; sLSTM block = norm, sLSTM with 4 heads (the
paper's, hard-coded as in the reference), residual, norm, GeGLU FFN of
width 4D/3, residual.  The reference has no Pallas kernel here.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.kernels.checks import trips
from repro_torch.models import layers

Params = Dict[str, object]

#: the sLSTM's heads (the paper's 4, whatever cfg.n_heads is)
SLSTM_HEADS = 4
_F32 = torch.float32


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid`` = -softplus(-x) = min(x, 0) -
    log1p(exp(-|x|))."""
    return torch.clamp(x, max=0.0) - torch.log1p(torch.exp(-x.abs()))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(key: prng.Key, d_in: int, n_heads: int, dtype,
               device) -> Params:
    ks = prng.split(key, 6)
    return {
        "wq": layers.dense_init(ks[0], d_in, d_in, dtype, device),
        "wk": layers.dense_init(ks[1], d_in, d_in, dtype, device),
        "wv": layers.dense_init(ks[2], d_in, d_in, dtype, device),
        "wi": layers.dense_init(ks[3], d_in, n_heads, _F32, device),
        "wf": layers.dense_init(ks[4], d_in, n_heads, _F32, device),
        "bi": torch.zeros(n_heads, dtype=_F32, device=device),
        "bf": torch.full((n_heads,), 3.0, dtype=_F32, device=device),
        "norm": layers.rmsnorm_init(d_in, dtype, device),
    }


def _mlstm_gates(p: Params, x: torch.Tensor):
    i_pre = x.to(_F32) @ p["wi"] + p["bi"]  # (B, S, H)
    f_pre = x.to(_F32) @ p["wf"] + p["bf"]
    return i_pre, log_sigmoid(f_pre)


def _heads(x: torch.Tensor, w: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, D) @ w -> (B, H, S, hd)."""
    B, S, D = x.shape
    return (x @ w.to(x.dtype)).reshape(B, S, n_heads,
                                       D // n_heads).transpose(1, 2)


def mlstm_parallel(p: Params, x: torch.Tensor, n_heads: int
                   ) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D): the stabilised parallel form."""
    B, S, D = x.shape
    hd = D // n_heads
    q, k, v = (_heads(x, p[w], n_heads) for w in ("wq", "wk", "wv"))
    i_pre, logf = _mlstm_gates(p, x)
    i_pre = i_pre.transpose(1, 2)  # (B, H, S)
    Fc = torch.cumsum(logf.transpose(1, 2), dim=-1)
    # D~[t, s] = F[t] - F[s] + i[s] for s <= t
    Dtil = Fc[..., :, None] - Fc[..., None, :] + i_pre[..., None, :]
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                   device=x.device))
    Dtil = Dtil.masked_fill(~causal, float("-inf"))
    m = torch.clamp(Dtil.amax(dim=-1, keepdim=True), min=-1e30)
    Dmat = torch.exp(Dtil - m)
    scores = layers.div_f32(torch.einsum("bhsd,bhtd->bhst", q.to(_F32),
                                         k.to(_F32)), layers.sqrt_f32(hd))
    C = scores * Dmat
    norm = torch.maximum(C.sum(dim=-1, keepdim=True).abs(), torch.exp(-m))
    h = torch.einsum("bhst,bhtd->bhsd", (C / norm).to(v.dtype), v)
    h = h.transpose(1, 2).reshape(B, S, D)
    return layers.rmsnorm(p["norm"], h)


def mlstm_final_state(p: Params, x: torch.Tensor, n_heads: int):
    """The recurrent state after consuming x (B, S, D), in closed form:
    (C (B, H, hd, hd), n (B, H, hd), m (B, H)), what :func:`mlstm_decode`
    over every position would leave."""
    B, S, D = x.shape
    hd = D // n_heads
    k, v = (_heads(x, p[w], n_heads) for w in ("wk", "wv"))
    i_pre, logf = _mlstm_gates(p, x)
    i_pre = i_pre.transpose(1, 2)
    Fc = torch.cumsum(logf.transpose(1, 2), dim=-1)
    a = Fc[..., -1:] - Fc + i_pre  # (B, H, S) log-weights
    m = a.amax(dim=-1, keepdim=True)
    w = torch.exp(a - m)
    kf = layers.div_f32(k.to(_F32), layers.sqrt_f32(hd))
    Cm = torch.einsum("bhs,bhsd,bhse->bhde", w, v.to(_F32), kf)
    n = torch.einsum("bhs,bhse->bhe", w, kf)
    return Cm, n, m[..., 0]


def mlstm_decode(p: Params, x: torch.Tensor, state, n_heads: int):
    """x (B, 1, D); state (C, n, m) -> (h (B, 1, D), the new state)."""
    B, _, D = x.shape
    hd = D // n_heads
    Cm, n, m = state
    q, k, v = ((x @ p[w].to(x.dtype)).reshape(B, n_heads, hd)
               for w in ("wq", "wk", "wv"))
    i_pre, logf = _mlstm_gates(p, x)
    i_pre, logf = i_pre[:, 0], logf[:, 0]  # (B, H)
    m_new = torch.maximum(logf + m, i_pre)
    f_s = torch.exp(logf + m - m_new)[..., None, None]
    i_s = torch.exp(i_pre - m_new)[..., None, None]
    kf = layers.div_f32(k.to(_F32), layers.sqrt_f32(hd))
    Cm = f_s * Cm + i_s * torch.einsum("bhd,bhe->bhde", v.to(_F32), kf)
    n = f_s[..., 0] * n + i_s[..., 0] * kf
    qf = q.to(_F32)
    hnum = torch.einsum("bhde,bhe->bhd", Cm, qf)
    hden = torch.maximum(torch.einsum("bhd,bhd->bh", n, qf).abs(),
                         torch.exp(-m_new))[..., None]
    h = (hnum / hden).reshape(B, 1, D).to(x.dtype)
    return layers.rmsnorm(p["norm"], h), (Cm, n, m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_init(key: prng.Key, d: int, n_heads: int, dtype,
               device) -> Params:
    hd = d // n_heads
    ks = prng.split(key, 3)
    r = layers.div_f32(prng.normal_torch(ks[1], (4, n_heads, hd, hd),
                                         device), layers.sqrt_f32(hd))
    return {
        # input weights of z, i, f, o stacked: (D, 4D)
        "w": layers.dense_init(ks[0], d, 4 * d, dtype, device),
        # block-diagonal recurrent weights per head: (4, H, hd, hd)
        "r": r.to(_F32),
        "b": torch.cat([torch.zeros(2 * d), torch.full((d,), 3.0),
                        torch.zeros(d)]).to(device=device, dtype=_F32),
        "norm": layers.rmsnorm_init(d, dtype, device),
    }


def slstm_state_init(B: int, D: int, n_heads: int, device):
    hd = D // n_heads
    z = torch.zeros((B, n_heads, hd), dtype=_F32, device=device)
    return (z, z, z, torch.full((B, n_heads, hd), -1e30, dtype=_F32,
                                device=device))


def slstm_scan(p: Params, x: torch.Tensor, n_heads: int, state=None):
    """x (B, S, D) -> ((B, S, D), the carry (c, n, h, m)): the recurrent
    scan over time (every step; five under the dry run's counter, which
    counts a middle one ``S - 4`` times:
    :func:`repro_torch.kernels.checks.trips`)."""
    B, S, D = x.shape
    hd = D // n_heads
    pre_all = (x @ p["w"].to(x.dtype)).to(_F32) + p["b"]  # (B, S, 4D)
    if state is None:
        state = slstm_state_init(B, D, n_heads, x.device)
    c, n, h, m = state
    one = torch.ones((), dtype=_F32, device=x.device)
    pre_seq = pre_all.reshape(B, S, 4, n_heads, hd)
    hs = torch.empty((B, S, n_heads, hd), dtype=_F32, device=x.device)
    for t in trips(S):
        rec = torch.einsum("ghde,bhe->bghd", p["r"], h)  # (B, 4, H, hd)
        pre = pre_seq[:, t] + rec
        zt = torch.tanh(pre[:, 0])
        i_pre = pre[:, 1]
        o = torch.sigmoid(pre[:, 3])
        logf = log_sigmoid(pre[:, 2])
        m_new = torch.maximum(logf + m, i_pre)
        i_s = torch.exp(i_pre - m_new)
        f_s = torch.exp(logf + m - m_new)
        c = f_s * c + i_s * zt
        n = f_s * n + i_s
        # max(n, 1), not clamp: at the tie (n is exactly 1 after the
        # first step) the reference's gradient goes half to each side
        h = o * c / torch.maximum(n, one)
        m = m_new
        hs[:, t] = h
    out = hs.reshape(B, S, D).to(x.dtype)
    return layers.rmsnorm(p["norm"], out), (c, n, h, m)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def mlstm_block_init(key: prng.Key, cfg, dtype, device) -> Params:
    d, di = cfg.d_model, 2 * cfg.d_model
    ks = prng.split(key, 4)
    return {
        "ln": layers.rmsnorm_init(d, dtype, device),
        "up": layers.dense_init(ks[0], d, 2 * di, dtype, device),
        "cell": mlstm_init(ks[1], di, cfg.n_heads, dtype, device),
        "down": layers.dense_init(ks[2], di, d, dtype, device),
    }


def mlstm_block(p: Params, cfg, x: torch.Tensor, state=None,
                decode: bool = False, return_state: bool = False):
    h = layers.rmsnorm(p["ln"], x, cfg.norm_eps)
    u, gate = torch.chunk(h @ p["up"].to(h.dtype), 2, dim=-1)
    if decode:
        y, state = mlstm_decode(p["cell"], u, state, cfg.n_heads)
    else:
        y = mlstm_parallel(p["cell"], u, cfg.n_heads)
        if return_state:
            state = mlstm_final_state(p["cell"], u, cfg.n_heads)
    y = y * F.silu(gate)
    return x + y @ p["down"].to(y.dtype), state


def slstm_block_init(key: prng.Key, cfg, dtype, device) -> Params:
    d = cfg.d_model
    dff = max(1, (4 * d) // 3)
    ks = prng.split(key, 4)
    return {
        "ln": layers.rmsnorm_init(d, dtype, device),
        "cell": slstm_init(ks[0], d, SLSTM_HEADS, dtype, device),
        "ln2": layers.rmsnorm_init(d, dtype, device),
        "ff1": layers.dense_init(ks[1], d, 2 * dff, dtype, device),
        "ff2": layers.dense_init(ks[2], dff, d, dtype, device),
    }


def slstm_block(p: Params, cfg, x: torch.Tensor, state=None):
    h = layers.rmsnorm(p["ln"], x, cfg.norm_eps)
    y, state = slstm_scan(p["cell"], h, SLSTM_HEADS, state)
    x = x + y
    h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
    a, b = torch.chunk(h @ p["ff1"].to(h.dtype), 2, dim=-1)
    x = x + (F.gelu(a, approximate="tanh") * b) @ p["ff2"].to(h.dtype)
    return x, state
