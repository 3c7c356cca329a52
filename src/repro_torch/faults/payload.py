"""Wire-level payload faults on K-stacked rows (torch copies of the
reference's ``repro/faults/payload.py``, whose appliers are jnp, not
Pallas).

Corruption models a bit storm on the wire after the client serialized
(its error-feedback residual was already updated against the clean row):

  * f32 row: a 16-lane span starting at ``int32(f32(loc) * f32(max(D -
    16, 1)))`` turns NaN, its first lane +Inf.
  * q8 row: a 64-byte span of the int8 payload is XOR-flipped with 0x55
    (survivable: the screen is norm-based, not a checksum) and the scale
    block ``int32(f32(loc) * f32(n_blocks))`` is blown to +Inf.

Byzantine rows are multiplied by ``-rescale`` in f32 (the f32 row, or the
q8 scales).  Every op is elementwise and ``torch.where`` returns the
untouched lanes bitwise, so a faulted row is the same whether it was
faulted alone or in a stack.
"""
from __future__ import annotations

import numpy as np
import torch

_NAN_SPAN = 16   # f32 lanes poisoned per corrupt row
_FLIP_SPAN = 64  # int8 bytes XOR-flipped per corrupt row


def _masks(corrupt, byz, loc, device):
    """Per-row (K, 1) bool masks and the (K, 1) f32 placement."""
    c = torch.as_tensor(np.asarray(corrupt, bool), device=device)[:, None]
    b = torch.as_tensor(np.asarray(byz, bool), device=device)[:, None]
    lc = torch.as_tensor(np.asarray(loc, np.float32), device=device)[:, None]
    return c, b, lc


def _start(loc: torch.Tensor, n: int) -> torch.Tensor:
    """int32(f32(loc) * f32(n)): one f32 multiply, then truncation."""
    return (loc * torch.tensor(float(np.float32(n)), dtype=torch.float32,
                               device=loc.device)).to(torch.int32)


def _negated(x: torch.Tensor, rescale) -> torch.Tensor:
    return x * torch.tensor(float(-np.float32(rescale)), dtype=torch.float32,
                            device=x.device)


def apply_faults_flat(rows: torch.Tensor, corrupt, byz, loc,
                      rescale) -> torch.Tensor:
    """(K, D) f32 rows under per-row corrupt / byzantine masks (host
    sequences of K bools) and placements ``loc`` -> new (K, D) rows."""
    k, d = rows.shape
    c, b, lc = _masks(corrupt, byz, loc, rows.device)
    span = min(_NAN_SPAN, d)
    start = _start(lc, max(d - span, 1))
    lane = torch.arange(d, dtype=torch.int32, device=rows.device)[None, :]
    in_span = (lane >= start) & (lane < start + span)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=rows.device)
    nan = torch.tensor(float("nan"), dtype=torch.float32, device=rows.device)
    poison = torch.where(lane == start, inf, nan)
    rows = torch.where(c & in_span, poison, rows)
    return torch.where(b, _negated(rows, rescale), rows)


def apply_faults_q(q: torch.Tensor, scales: torch.Tensor, corrupt, byz, loc,
                   rescale):
    """(K, nq) int8 payload + (K, nb) f32 scales under per-row masks ->
    new (q, scales)."""
    nq, nb = q.shape[1], scales.shape[1]
    c, b, lc = _masks(corrupt, byz, loc, q.device)
    span = min(_FLIP_SPAN, nq)
    qs = _start(lc, max(nq - span, 1))
    qcol = torch.arange(nq, dtype=torch.int32, device=q.device)[None, :]
    qmask = c & (qcol >= qs) & (qcol < qs + span)
    flip = torch.tensor(0x55, dtype=torch.int8, device=q.device)
    q = torch.where(qmask, torch.bitwise_xor(q, flip), q)
    blk = _start(lc, nb)
    col = torch.arange(nb, dtype=torch.int32, device=q.device)[None, :]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=q.device)
    scales = torch.where(c & (col == blk), inf, scales)
    return q, torch.where(b, _negated(scales, rescale), scales)
