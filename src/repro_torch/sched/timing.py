"""Device-time models: how long a client's upload period takes.

Only :class:`StaticTiming` is ported: the reference's deterministic model
(and its parity oracle), one duration per client,
``n_samples * local_epochs / (rate * speed) + comm_time``, with the small
``ClientState.rng`` uniform jitter on the very first event so clients do
not all fire at t=0.  It needs no counter-keyed PRNG.  The lognormal and
Markov models draw normals from ``jax.random`` in the reference and wait
for ``normal`` in :mod:`repro_torch.prng`.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.sched.events import UPLOAD

Entry = Tuple[float, int, float]  # (absolute time, kind, compute_s)

TIMING_MODELS = ("static",)


class StaticTiming:
    """The deterministic model (the engine's parity oracle)."""

    name = "static"

    def __init__(self, base_compute):
        self._base = base_compute  # callable(ClientState) -> seconds

    def _compute(self, c) -> float:
        return self._base(c)

    def initial(self, c) -> Entry:
        # first event at compute + comm + a small ClientState.rng jitter
        # (consumed from the client's own generator, as the reference does)
        comp = self._compute(c)
        return (comp + c.comm_time + float(c.rng.uniform(0, 0.1)),
                UPLOAD, comp)

    def after_upload(self, c, now: float) -> Entry:
        comp = self._compute(c)
        return (now + comp + c.comm_time, UPLOAD, comp)

    def after_wake(self, c, now: float) -> Entry:
        """The next training period of a client back from a WAKE (a crash
        reboot): the same as after an upload."""
        return self.after_upload(c, now)

    def sync_duration(self, c) -> float:
        """One SFL round's duration contribution for an active client."""
        return self._compute(c) + c.comm_time


def make_timing(cfg, base_compute):
    """Build the ``FLConfig.sched_timing`` model."""
    if cfg.sched_timing != "static":
        raise NotImplementedError(
            f"sched_timing={cfg.sched_timing!r} is not ported yet "
            "(ported: static)")
    return StaticTiming(base_compute)
