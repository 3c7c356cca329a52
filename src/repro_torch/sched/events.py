"""Event core of the scheduling subsystem: the persistent client-event heap
(a copy of the reference's host-only ``sched/events.py``).

Entries are ``(time, cid, kind, compute_s)``:

  * ``kind`` distinguishes UPLOAD events (a client finishes an upload
    period and contacts the server) from WAKE events (a client that went
    offline under the Markov availability model, or crashed under the
    fault plan, rejoins and restarts training) — the heap itself stays
    policy- and timing-agnostic;
  * ``compute_s`` records the *compute* portion of the interval that
    produced the event (the part proportional to ``1 / ClientState.speed``),
    so a heap persisted across ``run()`` calls stays correct when client
    speeds are mutated between runs (see :meth:`EventQueue.resume`).

Ordering: entries compare as tuples, so events order by ``(time, cid)``
(each client has exactly one pending event, so
``(time, cid)`` is always a unique key and ``kind``/``compute_s`` never
participate in a comparison).  The heap persists across ``run()`` calls —
incremental runs continue ONE simulated schedule.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

# event kinds
UPLOAD = 0  # the client finished an upload period and contacts the server
WAKE = 1  # an offline or crashed client rejoins and restarts training

Entry = Tuple[float, int, int, float]  # (time, cid, kind, compute_s)


class EventQueue:
    """Persistent min-heap of per-client events with speed-safe resume.

    One pending event per client at all times (each pop schedules the
    client's next event).  ``resume`` carries the heap across ``run()``
    calls; if any ``ClientState.speed`` was mutated in between, pending
    event times silently embed the OLD speed's compute duration — the
    original ``_epoch_time`` bug — so resume validates a speed snapshot
    and rescales the compute portion of every pending entry:

        t_new = t_old - compute_s + compute_s * (speed_old / speed_new)

    (compute time is proportional to ``1 / speed``; the communication and
    jitter portions of the interval are speed-independent and stay put).
    """

    def __init__(self):
        self._heap: Optional[List[Entry]] = None
        self._speeds: Optional[List[float]] = None

    @property
    def started(self) -> bool:
        return self._heap is not None

    def __len__(self) -> int:
        return len(self._heap) if self._heap else 0

    def resume(self, clients, timing) -> None:
        """Build the initial schedule on first use; on later calls,
        validate the speed snapshot and rescale pending compute times if
        any client speed changed since the events were scheduled."""
        if self._heap is None:
            heap: List[Entry] = []
            for c in clients:
                t, kind, comp = timing.initial(c)
                heapq.heappush(heap, (t, c.cid, kind, comp))
            self._heap = heap
            self._speeds = [float(c.speed) for c in clients]
            return
        cur = [float(c.speed) for c in clients]
        assert len(cur) == len(self._speeds), \
            "client count changed across run() calls"
        if cur != self._speeds:
            scale = [old / new for old, new in zip(self._speeds, cur)]
            self._heap = [
                (t - comp + comp * scale[cid], cid, kind,
                 comp * scale[cid])
                for (t, cid, kind, comp) in self._heap]
            heapq.heapify(self._heap)
            self._speeds = cur

    def push(self, time: float, cid: int, kind: int,
             compute_s: float) -> None:
        heapq.heappush(self._heap, (time, cid, kind, compute_s))

    def pop(self) -> Entry:
        return heapq.heappop(self._heap)
