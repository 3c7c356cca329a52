"""Flat-buffer server round for the f32 wire (paper §3, Eq. 4-6).

:class:`FlatServer` runs the server side of both channels over flat (D,)
rows in the :class:`repro_torch.core.flatbuf.PytreeCodec` layout:

  * buffered (``step``): one :func:`repro_torch.kernels.safl_agg.
    safl_aggregate` over the resident (K, D) rows, with the server step
    fused (``fedsgd``: p - lr * mean; ``fedavg``: the weighted mean);
  * streaming (``fold_program`` + ``finalize``): each upload folded into
    a running sum bank the moment it lands (``safl_fold``), then one
    finalize from the bank's sum and the host's ingest weights.

The engine always hands over the FINAL per-upload weights
(discount-at-ingest, ``external_discount=True`` in the reference), so the
kernels run with ``discount="none"``.  Only ``fedsgd`` and ``fedavg`` are
ported; the other modes, the lossy wires and the meshes come later.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels.safl_agg import safl_aggregate, safl_fold


def staleness_poly(tau: torch.Tensor, alpha: float) -> torch.Tensor:
    """(1 + tau)^(-alpha), FedAsync's polynomial discount."""
    return torch.pow(1.0 + tau.to(torch.float32), -alpha)


def sum_in_order(w: np.ndarray) -> np.float32:
    """np.float32 sum of ``w`` taken k = 0..K-1, the order the aggregate
    kernel and its plain version sum their weights in (numpy's own sum
    is pairwise above 8 elements)."""
    s = np.float32(0.0)
    for x in np.asarray(w, np.float32):
        s = np.float32(s + x)
    return s


def edge_traffic(partial_nbytes: int) -> Dict:
    """The reference's cross-edge traffic record for a server without a
    mesh: one partial of ``partial_nbytes`` plus its f32 weight mass."""
    per_partial = int(partial_nbytes) + 4
    return {"mesh_shape": (1, 1), "cross_edge_partials": 1,
            "cross_edge_bytes": per_partial,
            "flat_cross_bytes": per_partial,
            "cross_edge_reduction": 1.0}


class FlatServer:
    """Server round over flat f32 rows on one device."""

    MODES = ("fedsgd", "fedavg")

    def __init__(self, mode: str, d: int, *, server_lr: float,
                 device="cpu"):
        if mode not in self.MODES:
            raise NotImplementedError(
                f"aggregation {mode!r} is not ported yet "
                f"(ported: {self.MODES})")
        self.mode = mode
        self.d = int(d)
        self.server_lr = float(server_lr)
        self.device = torch.device(device)
        self.traffic = edge_traffic(4 * self.d)

    def init_opt(self, params_flat: torch.Tensor) -> Dict:
        """Slow server state: none for fedsgd / fedavg."""
        return {}

    def _metrics(self, new, p0, wsum) -> Dict:
        upd = new - p0
        return {"update_norm": torch.sqrt(torch.sum(upd * upd)),
                "weight_sum": wsum}

    def step(self, params_flat: torch.Tensor, buf: torch.Tensor,
             wvec: np.ndarray, opt: Dict):
        """Buffered round: (D,) params, (K, D) rows, (K,) np.float32 final
        weights -> (new params, opt, {update_norm, weight_sum})."""
        w = torch.from_numpy(np.asarray(wvec, np.float32)).to(self.device)
        if self.mode == "fedavg":
            new = safl_aggregate(buf, w, mode="avg", discount="none")
        else:
            new = safl_aggregate(buf, w, params_flat,
                                 server_lr=self.server_lr, mode="fedsgd",
                                 discount="none")
        return new, opt, self._metrics(new, params_flat, sum_in_order(wvec))

    def fold_program(self, bank: torch.Tensor, vec: torch.Tensor, ridx: int,
                     w) -> torch.Tensor:
        """bank[ridx] <- bank[ridx] + w*vec, in place (beta fixed at 1.0:
        only fedasync folds with a live beta)."""
        row = bank[ridx]
        safl_fold(row, vec, w, 1.0, out=row)
        return bank

    def finalize(self, params_flat: torch.Tensor, bank: torch.Tensor,
                 wvec: np.ndarray, opt: Dict):
        """Streaming round from a sealed bank: the reference's
        ``_from_sums`` in its op order, ``p0 - lr * (gsum / wsafe)``, so
        the result equals the buffered ``step`` bitwise.  Returns (new
        params, opt, metrics, the bank zeroed for reuse)."""
        wsum = sum_in_order(wvec)
        wsafe = torch.tensor(max(wsum, np.float32(1e-12)),
                             dtype=torch.float32, device=self.device)
        gsum = bank[0]
        # divide by a device tensor: a Python-number divisor may become a
        # multiply by its reciprocal, which rounds differently
        g = gsum / wsafe
        if self.mode == "fedavg":
            new = g
        else:
            new = params_flat - self.server_lr * g
        return new, opt, self._metrics(new, params_flat, wsum), bank.zero_()
