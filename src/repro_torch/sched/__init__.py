"""Client scheduling: simulated device time + participation.

:class:`Scheduler` is the facade the engine consumes, over a timing model
(:mod:`repro_torch.sched.timing`), a participation policy
(:mod:`repro_torch.sched.policy`) and the persistent event heap
(:mod:`repro_torch.sched.events`).  ``pop(round)`` surfaces the next
upload decision with its staleness, scheduling the client's next event
itself, and mirrors the engine's client-version refresh rule in a
projected-version map, as the reference's scheduler does.

Ported: static timing, the ``full`` policy, and no fault plan (the
reference builds none when every fault probability is zero).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.sched.events import UPLOAD, WAKE, EventQueue
from repro_torch.sched.policy import POLICIES, Policy, make_policy
from repro_torch.sched.timing import TIMING_MODELS, make_timing

__all__ = ["Scheduler", "SchedEvent", "build_scheduler", "EventQueue",
           "POLICIES", "Policy", "TIMING_MODELS", "UPLOAD", "WAKE"]


@dataclasses.dataclass(frozen=True)
class SchedEvent:
    """One upload decision surfaced to the engine (always an admission
    under the ``full`` policy)."""
    time: float
    cid: int
    staleness: int  # projected staleness at pop time (== engine's value)
    compute_s: float = 0.0  # compute seconds of the producing period


class Scheduler:
    """Facade over (timing model, participation policy, event queue)."""

    def __init__(self, cfg, clients, base_compute):
        self.cfg = cfg
        self.clients = clients
        self.timing = make_timing(cfg, base_compute)
        self.policy = make_policy(cfg, len(clients))
        self.queue = EventQueue()
        self._version: Dict[int, int] = {}
        self.participation = np.zeros(len(clients), np.int64)

    def resume(self) -> None:
        self.queue.resume(self.clients, self.timing)

    def pop(self, rnd: int) -> Optional[SchedEvent]:
        """Next upload at aggregation round ``rnd``.  Returns None only if
        the heap is empty, which the engine never lets happen (every pop
        schedules the client's next event)."""
        if not len(self.queue):
            return None
        t, cid, _kind, comp = self.queue.pop()  # static timing: UPLOADs only
        c = self.clients[cid]
        # schedule the client's next event first: the heap evolves on
        # schedule data only
        nt, nkind, ncomp = self.timing.after_upload(c, t)
        self.queue.push(nt, cid, nkind, ncomp)
        stal = rnd - self._version.get(cid, 0)
        # the projected version mirrors the engine's refresh rule: every
        # admitted client ends the event at version ``rnd``
        self._version[cid] = rnd
        self.participation[cid] += 1
        return SchedEvent(t, cid, stal, compute_s=float(comp))

    def stats(self) -> Dict:
        """Host-side scheduling summary for the run report (the reference's
        keys; rejections, idles, no-shows and crashes cannot occur under
        static timing, the full policy and no faults)."""
        return {
            "policy": self.policy.name,
            "timing": self.timing.name,
            "participation": self.participation.tolist(),
            "rejected_uploads": 0,
            "idle_requests": 0,
            "no_shows": 0,
            "crashed_uploads": 0,
        }


def build_scheduler(cfg, clients, base_compute) -> Scheduler:
    """Engine entry point: a Scheduler from the ``FLConfig.sched_*``
    knobs.  ``base_compute(client) -> seconds`` is the deterministic
    compute time of one upload period."""
    return Scheduler(cfg, clients, base_compute)
