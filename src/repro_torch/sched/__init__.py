"""Client scheduling: simulated device time + participation.

:class:`Scheduler` is the facade the engine consumes, over a timing model
(:mod:`repro_torch.sched.timing`: static, lognormal, Markov), a
participation policy (:mod:`repro_torch.sched.policy`: full, uniform,
seafl, fedqs, ratelimit) and the persistent event heap
(:mod:`repro_torch.sched.events`).  ``pop(round)`` surfaces the next
upload decision with its staleness and verdict (admit, reject, idle or
crash), consumes WAKE events (Markov no-shows, crash reboots) and
schedules the client's next event itself, and mirrors the engine's
client-version refresh rule in a projected-version map, as the
reference's scheduler does, so the sequential and horizon-batched
engines see the same schedule.

The fault plan (:mod:`repro_torch.faults`) draws once per popped UPLOAD,
before the policy: a crash loses the upload and re-enqueues the client as
a WAKE after a capped exponential backoff, a straggler spike stretches
the client's next period, and corrupt / byzantine draws ride the
admitted event into the engine.  :meth:`Scheduler.state` /
:meth:`Scheduler.load_state` carry all of it (heap, versions, counters,
the timing stream's and the fault plan's PRNG counters, rate control's
round count) through an engine snapshot.

With tracing on, the engine sets :attr:`Scheduler.tracer` and ``pop``
records the reference's instants on it: ``wake``, ``crash`` (staleness,
backoff), ``offline`` (until) and each refused verdict (``reject`` /
``idle``, staleness).  Both engines pop the same events, so they record
the same instants.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.faults import FaultDraw, FaultPlan
from repro_torch.sched.events import UPLOAD, WAKE, EventQueue
from repro_torch.sched.policy import (POLICIES, Policy, RateControl,
                                      make_policy)
from repro_torch.sched.timing import TIMING_MODELS, make_timing

__all__ = ["Scheduler", "SchedEvent", "build_scheduler", "EventQueue",
           "POLICIES", "Policy", "TIMING_MODELS", "UPLOAD", "WAKE"]


@dataclasses.dataclass(frozen=True)
class SchedEvent:
    """One upload decision surfaced to the engine."""
    time: float
    cid: int
    staleness: int  # projected staleness at pop time (== engine's value)
    admitted: bool  # False: the upload was refused (see ``verdict``)
    #: "admit" | "reject" | "idle" | "crash".  A rejection discards the
    #: client's local progress and resyncs it (selective training); idle
    #: is rate-control back-pressure: the client keeps its local chain
    #: and retries later; a crash loses the upload, the client reboots
    #: (discard + resync, like reject) and re-enqueues after a backoff
    verdict: str = "admit"
    #: payload fault riding an ADMITTED upload ("corrupt" or "byzantine");
    #: the engine applies it to the serialized row
    fault: Optional[FaultDraw] = None
    compute_s: float = 0.0  # compute seconds of the producing period


class Scheduler:
    """Facade over (timing model, participation policy, event queue).

    The projected-version map mirrors the engine's refresh rule: a
    client's version becomes the current round at every upload boundary,
    admitted (adopt or continue), rejected or crashed (discard and
    resync).  An IDLED upload is the one exception: the client's chain is
    untouched, so its version stays and its staleness keeps growing until
    it is admitted."""

    def __init__(self, cfg, clients, base_compute):
        self.cfg = cfg
        self.clients = clients
        self.timing = make_timing(cfg, base_compute)
        self.policy = make_policy(cfg, len(clients))
        # foldable policies fix their normalization constants from the
        # population (fedqs's mean sample count)
        self.policy.bind(clients)
        self.queue = EventQueue()
        self._version: Dict[int, int] = {}
        # one counter-keyed draw per popped UPLOAD; None when every fault
        # probability is zero
        self.faults = FaultPlan.from_config(cfg)
        self._crash_streak: Dict[int, int] = {}
        self.participation = np.zeros(len(clients), np.int64)
        self.rejected = np.zeros(len(clients), np.int64)
        self.idle = np.zeros(len(clients), np.int64)
        self.crashed = np.zeros(len(clients), np.int64)
        self.no_shows = 0
        # a repro_torch.obs.trace.SpanTracer when tracing is on
        self.tracer = None

    def resume(self) -> None:
        self.queue.resume(self.clients, self.timing)

    def pop(self, rnd: int) -> Optional[SchedEvent]:
        """Next upload decision at aggregation round ``rnd`` (WAKE events
        are consumed here).  Returns None only if the heap is empty, which
        the engine never lets happen (every pop schedules the client's
        next event)."""
        tr = self.tracer
        while len(self.queue):
            t, cid, kind, comp = self.queue.pop()
            c = self.clients[cid]
            if kind == WAKE:
                if tr is not None:
                    tr.sched("wake", t, cid)
                nt, nkind, ncomp = self.timing.after_wake(c, t)
                self.queue.push(nt, cid, nkind, ncomp)
                continue
            # one draw per popped UPLOAD, before the verdict: a crash
            # preempts it (the upload never reaches the server)
            fault = self.faults.draw(cid) if self.faults else None
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
                stal = rnd - self._version.get(cid, 0)
                self._version[cid] = rnd  # mirrors the engine's resync
                if tr is not None:
                    tr.sched("crash", t, cid, staleness=int(stal),
                             backoff=float(backoff))
                return SchedEvent(t, cid, stal, False, "crash")
            self._crash_streak.pop(cid, None)  # the streak ends on delivery
            # schedule the client's next event first: the heap evolves on
            # schedule data only
            nt, nkind, ncomp = self.timing.after_upload(c, t)
            if fault is not None and fault.kind == "straggler" \
                    and nkind == UPLOAD:
                # the NEXT period's compute stretches; comm stays put
                nt += ncomp * (fault.mult - 1.0)
                ncomp *= fault.mult
            if nkind == WAKE:
                self.no_shows += 1  # the client goes offline (Markov)
                if tr is not None:
                    tr.sched("offline", t, cid, until=float(nt))
            self.queue.push(nt, cid, nkind, ncomp)
            stal = rnd - self._version.get(cid, 0)
            v = self.policy.verdict(cid, stal, c.n_samples, rnd)
            # admitted and rejected clients end the event at version
            # ``rnd``; an idled client's chain, and so its version, stays
            if v != "idle":
                self._version[cid] = rnd
            if v == "admit":
                self.participation[cid] += 1
                payload_fault = (fault if fault is not None and fault.kind
                                 in ("corrupt", "byzantine") else None)
                return SchedEvent(t, cid, stal, True, fault=payload_fault,
                                  compute_s=float(comp))
            if v == "idle":
                self.idle[cid] += 1
            else:
                self.rejected[cid] += 1
            if tr is not None:
                tr.sched(v, t, cid, staleness=int(stal))
            return SchedEvent(t, cid, stal, False, v)
        return None

    def stats(self) -> Dict:
        """Host-side scheduling summary for the run report (the
        reference's keys)."""
        return {
            "policy": self.policy.name,
            "timing": self.timing.name,
            "participation": self.participation.tolist(),
            "rejected_uploads": int(self.rejected.sum()),
            "idle_requests": int(self.idle.sum()),
            "no_shows": int(self.no_shows),
            "crashed_uploads": int(self.crashed.sum()),
        }

    # -------------------- crash-consistent snapshots --------------------

    def state(self) -> Dict:
        """JSON-serializable scheduler state, the reference's keys: the
        event heap, the projected-version map, the counters, and every
        PRNG counter (fault plan, timing stream) and rate control's round
        count, so a resumed run replays the same schedule.  Python's json
        round-trips floats exactly; the heap list keeps its order."""
        st: Dict = {
            "version": {str(k): int(v) for k, v in self._version.items()},
            "participation": self.participation.tolist(),
            "rejected": self.rejected.tolist(),
            "idle": self.idle.tolist(),
            "crashed": self.crashed.tolist(),
            "no_shows": int(self.no_shows),
            "crash_streak": {str(k): int(v)
                             for k, v in self._crash_streak.items()},
            "heap": ([list(e) for e in self.queue._heap]
                     if self.queue.started else None),
            "speeds": self.queue._speeds,
        }
        if self.faults is not None:
            st["faults"] = self.faults.state()
        stream = getattr(self.timing, "_stream", None)
        if stream is not None:
            st["timing_counters"] = {
                str(k): int(v) for k, v in stream._counters.items()}
        # rate control is the one policy with per-round state; the
        # sampling policies remake their sets from (seed, round)
        if isinstance(self.policy, RateControl):
            st["policy_state"] = {"rnd": int(self.policy._rnd),
                                  "admitted": int(self.policy._admitted)}
        return st

    def load_state(self, st: Dict) -> None:
        self._version = {int(k): int(v) for k, v in st["version"].items()}
        self.participation = np.asarray(st["participation"], np.int64)
        self.rejected = np.asarray(st["rejected"], np.int64)
        self.idle = np.asarray(st["idle"], np.int64)
        self.crashed = np.asarray(st["crashed"], np.int64)
        self.no_shows = int(st["no_shows"])
        self._crash_streak = {int(k): int(v)
                              for k, v in st["crash_streak"].items()}
        if st["heap"] is not None:
            self.queue._heap = [
                (float(t), int(cid), int(kind), float(comp))
                for (t, cid, kind, comp) in st["heap"]]
            self.queue._speeds = [float(s) for s in st["speeds"]]
        if self.faults is not None and "faults" in st:
            self.faults.load_state(st["faults"])
        stream = getattr(self.timing, "_stream", None)
        if stream is not None and "timing_counters" in st:
            stream._counters = {int(k): int(v)
                                for k, v in st["timing_counters"].items()}
            stream._blocks = {}
        if isinstance(self.policy, RateControl) and "policy_state" in st:
            self.policy._rnd = int(st["policy_state"]["rnd"])
            self.policy._admitted = int(st["policy_state"]["admitted"])


def build_scheduler(cfg, clients, base_compute) -> Scheduler:
    """Engine entry point: a Scheduler from the ``FLConfig.sched_*``
    knobs.  ``base_compute(client) -> seconds`` is the deterministic
    compute time of one upload period."""
    return Scheduler(cfg, clients, base_compute)
