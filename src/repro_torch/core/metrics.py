"""FL experiment metrics (paper §4.4), host-side.

Tracks per-round accuracy/loss/time/bytes and derives:
  * convergence: T_f (first round reaching Acc_t), T_s (round after which
    accuracy stays >= Acc_t), stability T_s - T_f  (§4.4.3, Table 3);
  * oscillation: O_ots, rounds where accuracy drops vs the previous round
    by more than a threshold (§4.4.4, Fig. 3);
  * resource utilization: cumulative transmission bytes per direction,
    simulated training duration (§4.4.2).

:class:`DeviceMetricsRing` is the device-resident half of the batched
engine's metric path: per-round eval / update-norm scalars stay on the
device, and cross to the host once when the run flushes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs.profile import record_transfer


@dataclasses.dataclass
class RoundRecord:
    round: int
    sim_time: float
    accuracy: float
    loss: float
    tx_bytes: int  # cumulative client->server
    rx_bytes: int  # cumulative server->client (broadcast)
    mean_staleness: float
    max_staleness: int
    nan_event: bool
    # L2 norm of the applied global-model delta (computed inside the fused
    # server program; 0.0 for paths that don't report it)
    update_norm: float = 0.0
    # CUMULATIVE defense-layer counts at this round (like tx/rx bytes):
    # uploads dropped by the screen and influence-clipped by the norm cap
    screened_uploads: int = 0
    clipped_uploads: int = 0


class MetricsLog:
    def __init__(self, target_accuracy: float,
                 oscillation_thresholds: Sequence[float]):
        self.records: List[RoundRecord] = []
        self.target = target_accuracy
        self.ots = tuple(oscillation_thresholds)

    def record(self, **kw) -> None:
        self.records.append(RoundRecord(**kw))

    # ----- §4.4.3 convergence -----
    def t_f(self) -> Optional[int]:
        for r in self.records:
            if r.accuracy >= self.target:
                return r.round
        return None

    def t_s(self) -> Optional[int]:
        """Last round after which accuracy never falls below target."""
        below = [r.round for r in self.records if r.accuracy < self.target]
        if not self.records or self.records[-1].accuracy < self.target:
            return None
        if not below:
            return self.t_f()
        last_below = max(below)
        after = [r.round for r in self.records if r.round > last_below]
        return min(after) if after else None

    def stability(self) -> Optional[int]:
        tf, ts = self.t_f(), self.t_s()
        if tf is None or ts is None:
            return None
        return ts - tf

    # ----- §4.4.4 oscillation -----
    def oscillations(self) -> Dict[float, int]:
        acc = np.array([r.accuracy for r in self.records])
        out = {}
        for th in self.ots:
            drops = acc[:-1] - acc[1:]
            out[th] = int(np.sum(drops > th))
        return out

    # ----- §4.4.1 / §4.4.2 summaries -----
    def best_accuracy(self) -> float:
        return max((r.accuracy for r in self.records), default=0.0)

    def final_accuracy(self) -> float:
        return self.records[-1].accuracy if self.records else 0.0

    def total_tx_bytes(self) -> int:
        return self.records[-1].tx_bytes if self.records else 0

    def total_rx_bytes(self) -> int:
        return self.records[-1].rx_bytes if self.records else 0

    def duration(self) -> float:
        return self.records[-1].sim_time if self.records else 0.0

    def nan_rounds(self) -> int:
        return sum(1 for r in self.records if r.nan_event)

    def first_nan_round(self) -> Optional[int]:
        for r in self.records:
            if r.nan_event:
                return r.round
        return None

    def screened_uploads(self) -> int:
        return self.records[-1].screened_uploads if self.records else 0

    def clipped_uploads(self) -> int:
        return self.records[-1].clipped_uploads if self.records else 0

    def accuracy_curve(self) -> np.ndarray:
        return np.array([(r.round, r.accuracy) for r in self.records])

    def summary(self) -> Dict:
        return {
            "rounds": len(self.records),
            "best_accuracy": self.best_accuracy(),
            "final_accuracy": self.final_accuracy(),
            "T_f": self.t_f(),
            "T_s": self.t_s(),
            "stability": self.stability(),
            "oscillations": self.oscillations(),
            "nan_rounds": self.nan_rounds(),
            "screened_uploads": self.screened_uploads(),
            "clipped_uploads": self.clipped_uploads(),
            "duration_s": self.duration(),
            "tx_GB": self.total_tx_bytes() / 1e9,
            "rx_GB": self.total_rx_bytes() / 1e9,
            "mean_staleness": float(np.mean(
                [r.mean_staleness for r in self.records])) if self.records
            else 0.0,
        }


class DeviceMetricsRing:
    """Per-round scalar metrics kept on the device: the batched engine's
    metric path, so its loop never waits on a metric.

    A (capacity, channels) f32 buffer on ``device``; ``append`` writes the
    next row from device scalars (eval accuracy and loss, the server
    round's update norm) or host numbers, with no host transfer, and
    ``flush`` makes the one device-to-host copy at run end.  ``capacity``
    is a hint: appending past it doubles the buffer (the rows written stay
    as they were).  The staleness and participation counts the
    reference's ring also keeps are host numbers here (the engine's
    ``staleness_bins`` and the scheduler's participation): nothing on the
    device computes them, so the port's ring has no ``flush_sched``.
    """

    def __init__(self, capacity: int, channels: int = 3, *, device):
        self.capacity = max(int(capacity), 1)
        self.channels = int(channels)
        self.device = device
        self._buf = torch.zeros((self.capacity, self.channels),
                                dtype=torch.float32, device=device)
        self._n = 0

    def append(self, *scalars) -> None:
        if len(scalars) != self.channels:
            raise ValueError(f"{len(scalars)} scalars for a ring of "
                             f"{self.channels} channels")
        if self._n >= self._buf.shape[0]:
            self._buf = torch.cat([self._buf, torch.zeros_like(self._buf)])
            self.capacity = self._buf.shape[0]
        self._buf[self._n] = torch.stack([
            torch.as_tensor(s, dtype=torch.float32).to(self.device)
            .reshape(()) for s in scalars])
        self._n += 1

    def __len__(self) -> int:
        return self._n

    def flush(self) -> np.ndarray:
        """One host transfer: the (n, channels) rows appended so far
        (counted as ``metrics_ring.flush`` by
        :func:`repro_torch.obs.profile.record_transfer`)."""
        record_transfer("metrics_ring.flush")
        return self._buf[:self._n].cpu().numpy()
