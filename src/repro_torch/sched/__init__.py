"""Client scheduling: simulated device time + participation.

:class:`Scheduler` is the facade the engine consumes, over a timing model
(:mod:`repro_torch.sched.timing`), a participation policy
(:mod:`repro_torch.sched.policy`) and the persistent event heap
(:mod:`repro_torch.sched.events`).  ``pop(round)`` surfaces the next
upload decision with its staleness, scheduling the client's next event
itself, and mirrors the engine's client-version refresh rule in a
projected-version map, as the reference's scheduler does.

Ported: static timing, the ``full`` policy, and the fault plan
(:mod:`repro_torch.faults`): one counter-keyed draw per popped UPLOAD;
a crash loses the upload and re-enqueues the client as a WAKE after a
capped exponential backoff, a straggler spike stretches the client's
next period, and corrupt / byzantine draws ride the admitted event into
the engine.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.faults import FaultDraw, FaultPlan
from repro_torch.sched.events import UPLOAD, WAKE, EventQueue
from repro_torch.sched.policy import POLICIES, Policy, make_policy
from repro_torch.sched.timing import TIMING_MODELS, make_timing

__all__ = ["Scheduler", "SchedEvent", "build_scheduler", "EventQueue",
           "POLICIES", "Policy", "TIMING_MODELS", "UPLOAD", "WAKE"]


@dataclasses.dataclass(frozen=True)
class SchedEvent:
    """One upload decision surfaced to the engine."""
    time: float
    cid: int
    staleness: int  # projected staleness at pop time (== engine's value)
    admitted: bool  # False: the upload never reached the server
    #: "admit" or "crash" (the ported verdicts): a crash loses the upload,
    #: the client reboots (discard + resync) and re-enqueues after backoff
    verdict: str = "admit"
    #: payload fault riding an ADMITTED upload ("corrupt" or "byzantine");
    #: the engine applies it to the serialized row
    fault: Optional[FaultDraw] = None
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
        # one counter-keyed draw per popped UPLOAD; None when every fault
        # probability is zero
        self.faults = FaultPlan.from_config(cfg)
        self._crash_streak: Dict[int, int] = {}
        self.participation = np.zeros(len(clients), np.int64)
        self.crashed = np.zeros(len(clients), np.int64)

    def resume(self) -> None:
        self.queue.resume(self.clients, self.timing)

    def pop(self, rnd: int) -> Optional[SchedEvent]:
        """Next upload decision at aggregation round ``rnd`` (WAKE events
        are consumed here).  Returns None only if the heap is empty, which
        the engine never lets happen (every pop schedules the client's
        next event)."""
        while len(self.queue):
            t, cid, kind, comp = self.queue.pop()
            c = self.clients[cid]
            if kind == WAKE:
                nt, nkind, ncomp = self.timing.after_wake(c, t)
                self.queue.push(nt, cid, nkind, ncomp)
                continue
            # one draw per popped UPLOAD, before the verdict: a crash
            # preempts it (the upload never reaches the server)
            fault = self.faults.draw(cid) if self.faults else None
            stal = rnd - self._version.get(cid, 0)
            # the projected version mirrors the engine's refresh rule:
            # every client ends the event at version ``rnd`` (adopt or
            # continue when admitted, resync after a crash)
            self._version[cid] = rnd
            if fault is not None and fault.kind == "crash":
                # the client reboots and re-enqueues a WAKE after a capped
                # exponential backoff, in place of its successor period
                streak = self._crash_streak.get(cid, 0) + 1
                self._crash_streak[cid] = streak
                backoff = (self.cfg.fault_retry_backoff_s
                           * 2.0 ** (min(streak, self.cfg.fault_retry_cap)
                                     - 1))
                self.queue.push(t + backoff, cid, WAKE, 0.0)
                self.crashed[cid] += 1
                return SchedEvent(t, cid, stal, False, "crash")
            self._crash_streak.pop(cid, None)  # the streak ends on delivery
            # schedule the client's next event first: the heap evolves on
            # schedule data only
            nt, nkind, ncomp = self.timing.after_upload(c, t)
            if fault is not None and fault.kind == "straggler":
                # the NEXT period's compute stretches; comm stays put
                nt += ncomp * (fault.mult - 1.0)
                ncomp *= fault.mult
            self.queue.push(nt, cid, nkind, ncomp)
            self.participation[cid] += 1
            payload_fault = (fault if fault is not None and fault.kind
                             in ("corrupt", "byzantine") else None)
            return SchedEvent(t, cid, stal, True, fault=payload_fault,
                              compute_s=float(comp))
        return None

    def stats(self) -> Dict:
        """Host-side scheduling summary for the run report (the reference's
        keys; rejections, idles and no-shows cannot occur under static
        timing and the full policy)."""
        return {
            "policy": self.policy.name,
            "timing": self.timing.name,
            "participation": self.participation.tolist(),
            "rejected_uploads": 0,
            "idle_requests": 0,
            "no_shows": 0,
            "crashed_uploads": int(self.crashed.sum()),
        }


def build_scheduler(cfg, clients, base_compute) -> Scheduler:
    """Engine entry point: a Scheduler from the ``FLConfig.sched_*``
    knobs.  ``base_compute(client) -> seconds`` is the deterministic
    compute time of one upload period."""
    return Scheduler(cfg, clients, base_compute)
