"""The paper's LSTM model (§4.3.4): embedding + LSTM + fully connected.

Two task heads, as the reference's ``models/lstm.py``:

  * ``char``: next-character prediction (Shakespeare, 80-symbol vocab),
    logits at every position;
  * ``sentiment``: sequence classification (Sentiment140, 2 classes), the
    head on the last hidden state.

The gates are ``i, f, g, o`` in that order with the forget gate at
``sigmoid(f + 1.0)``; the reference's ``lax.scan`` over time is a Python
loop here.  The embedding lookup is ``F.embedding``, whose backward sums
each row's gradient in a fixed order on both devices, so a run repeats
bit for bit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.device import resolve_device


def _scaled_normal(key: prng.Key, shape, fan: int) -> torch.Tensor:
    """``normal(key, shape) / sqrt(fan)`` as a true f32 division (the
    reference divides; a multiply by the reciprocal rounds otherwise)."""
    x = prng.normal_torch(key, shape, "cpu")
    return x / torch.full_like(x, np.float32(np.sqrt(fan)))


def lstm_init(key: prng.Key, *, vocab=80, embed=64, hidden=128, n_out=80,
              device="cuda"):
    """Weights from a reference key, consumed as the reference's
    ``lstm_init`` consumes it (``split(key, 4)``), drawn on the CPU and
    moved to ``device`` -> (params, {})."""
    device = resolve_device(device)
    ks = prng.split(key, 4)
    params = {
        "embed": prng.normal_torch(ks[0], (vocab, embed), "cpu") * 0.1,
        "wx": _scaled_normal(ks[1], (embed, 4 * hidden), embed),
        "wh": _scaled_normal(ks[2], (hidden, 4 * hidden), hidden),
        "b": torch.zeros(4 * hidden),
        "fc": _scaled_normal(ks[3], (hidden, n_out), hidden),
        "fcb": torch.zeros(n_out),
    }
    return {k: v.to(device) for k, v in params.items()}, {}


def lstm_apply(params, state, tokens: torch.Tensor, train: bool,
               task: str = "char"):
    """tokens (B, S) int64 -> (logits, state): (B, S, n_out) for
    ``char``, (B, n_out) from the last hidden state for ``sentiment``."""
    del train
    # F.embedding, not params["embed"][tokens]: the same rows, and a
    # backward that sums each row's gradient in a fixed order (the
    # indexing backward's scatter-add runs with atomics on the CPU: two
    # runs' sums differed in their last bits)
    x = F.embedding(tokens, params["embed"])  # (B, S, E)
    batch, seq = tokens.shape
    hidden = params["wh"].shape[0]
    h = x.new_zeros((batch, hidden))
    c = x.new_zeros((batch, hidden))
    hs = []
    for t in range(seq):
        gates = x[:, t] @ params["wx"] + h @ params["wh"] + params["b"]
        i, f, g, o = torch.split(gates, hidden, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    if task == "char":
        return torch.stack(hs, dim=1) @ params["fc"] + params["fcb"], state
    return h @ params["fc"] + params["fcb"], state


def build_lstm(key: prng.Key, task: str = "char", *, device="cuda", **kw):
    """(params, state, apply_fn) of the ``task`` head with the
    reference's defaults (``sentiment``: vocab 1000, 2 outputs)."""
    if task == "sentiment":
        kw.setdefault("n_out", 2)
        kw.setdefault("vocab", 1000)
    p, s = lstm_init(key, device=device, **kw)
    return p, s, functools.partial(lstm_apply, task=task)
