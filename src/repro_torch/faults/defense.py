"""Host-side composition of the server's screening verdicts (a copy of
the reference's ``repro/faults/defense.py``).

``FlatServer.screen`` returns one f32 sum of squares per row; NaN/Inf
payload lanes make it non-finite, so ``isfinite`` is the integrity check
and ``sqrt`` the L2 norm.  This module turns the sums into per-row weight
factors:

  ``screen``  non-finite rows (and rows over ``norm_cap``, if set) get
              factor 0: zero weight, payload zeroed on the buffered
              channel, fold skipped on the streaming channel.
  ``clip``    non-finite rows are still dropped; finite rows over the cap
              get factor cap / norm.

Factors are np.float32 and every op is elementwise, so one row screened
alone (K = 1) and the same row in a stack get the same factor bitwise.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def defense_factors(sumsq, mode: str,
                    norm_cap: float) -> Tuple[np.ndarray, int, int]:
    """(K,) row sums of squares -> ((K,) f32 weight factors, n_screened,
    n_clipped)."""
    sumsq = np.asarray(sumsq, np.float32)
    fac = np.ones_like(sumsq)
    bad = ~np.isfinite(sumsq)
    fac[bad] = np.float32(0.0)
    clipped = 0
    if norm_cap > 0.0:
        norm = np.sqrt(sumsq)
        over = np.isfinite(sumsq) & (norm > np.float32(norm_cap))
        if mode == "screen":
            fac[over] = np.float32(0.0)
            bad |= over
        else:  # clip
            fac[over] = np.float32(norm_cap) / norm[over]
            clipped = int(over.sum())
    return fac, int(bad.sum()), clipped
