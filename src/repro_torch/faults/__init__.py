"""Deterministic fault injection for the SAFL engine (a copy of the
reference's ``repro/faults``).

A :class:`FaultPlan` draws one :class:`FaultDraw` per (client, upload
attempt) from the counter-keyed PRNG (:mod:`repro_torch.prng`)::

    key = fold_in(fold_in(prng_key(fault_seed*1_000_003 + seed), cid),
                  upload_counter)

The counter is the client's upload-attempt index (every UPLOAD event the
scheduler pops advances it, admitted or not), so the draw depends only on
(seed, cid, counter), never on event interleaving.

Fault kinds, a priority ladder (the first that fires wins the draw):

  ``crash``      the upload is lost and the client process dies: it
                 resyncs to the global model and re-enqueues a WAKE after
                 an exponential backoff (``Scheduler.pop``).
  ``straggler``  the client's next training period is
                 ``fault_straggler_mult`` x slower.
  ``corrupt``    wire corruption of the payload (:mod:`.payload`).
  ``byzantine``  the f32 row (the q8 scales) times ``-rescale``.

Crash and straggler faults live in the scheduler; corrupt and byzantine
draws ride the :class:`repro_torch.sched.SchedEvent` into the engine,
which applies them to the serialized payload after the error-feedback
residual update.  Server-side defenses live in :mod:`.defense`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch import prng
from repro_torch.faults.defense import defense_factors  # noqa: F401
from repro_torch.faults.payload import (apply_faults_flat,  # noqa: F401
                                        apply_faults_q)

KINDS = ("crash", "straggler", "corrupt", "byzantine")


@dataclasses.dataclass(frozen=True)
class FaultDraw:
    """One per-(client, upload) fault decision.  ``mult`` is the compute
    multiplier of the client's next training period (straggler spikes);
    ``loc`` is a uniform in [0, 1) placing the corruption in the row."""

    kind: Optional[str] = None
    mult: float = 1.0
    loc: float = 0.0


_NO_FAULT = FaultDraw()


class FaultPlan:
    """Counter-keyed per-(client, upload) fault schedule: one uniform
    5-vector per upload attempt; lanes 0-3 gate crash / straggler /
    corrupt / byzantine against their probabilities in that order, lane 4
    places the corruption.  The per-client counters are the plan's whole
    state (:meth:`state` / :meth:`load_state`)."""

    def __init__(self, seed: int, *, crash_p: float, straggler_p: float,
                 straggler_mult: float, corrupt_p: float,
                 byzantine_p: float):
        self.seed = int(seed)
        self.crash_p = float(crash_p)
        self.straggler_p = float(straggler_p)
        self.straggler_mult = float(straggler_mult)
        self.corrupt_p = float(corrupt_p)
        self.byzantine_p = float(byzantine_p)
        self._key = prng.prng_key(self.seed)
        self._counters: Dict[int, int] = {}

    @staticmethod
    def from_config(cfg) -> Optional["FaultPlan"]:
        """None when every fault probability is zero: the scheduler then
        draws nothing."""
        if not (cfg.fault_crash_p or cfg.fault_straggler_p
                or cfg.fault_corrupt_p or cfg.fault_byzantine_p):
            return None
        return FaultPlan(
            cfg.fault_seed * 1_000_003 + cfg.seed,
            crash_p=cfg.fault_crash_p,
            straggler_p=cfg.fault_straggler_p,
            straggler_mult=cfg.fault_straggler_mult,
            corrupt_p=cfg.fault_corrupt_p,
            byzantine_p=cfg.fault_byzantine_p)

    def draw(self, cid: int) -> FaultDraw:
        n = self._counters.get(cid, 0)
        self._counters[cid] = n + 1
        u = prng.uniform(prng.fold_in(prng.fold_in(self._key, cid), n), (5,))
        if u[0] < self.crash_p:
            return FaultDraw("crash")
        if u[1] < self.straggler_p:
            return FaultDraw("straggler", mult=self.straggler_mult)
        if u[2] < self.corrupt_p:
            return FaultDraw("corrupt", loc=float(u[4]))
        if u[3] < self.byzantine_p:
            return FaultDraw("byzantine")
        return _NO_FAULT

    def state(self) -> Dict[str, int]:
        return {str(k): int(v) for k, v in self._counters.items()}

    def load_state(self, state: Dict[str, int]) -> None:
        self._counters = {int(k): int(v) for k, v in state.items()}
