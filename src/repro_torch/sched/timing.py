"""Device-time models: how long a client's upload period takes.

Three models, all producing ``(absolute_time, event_kind, compute_s)``
entries for the :class:`repro_torch.sched.events.EventQueue`, as the
reference's:

  * :class:`StaticTiming` — the deterministic model (the parity oracle):
    one duration per client, ``n_samples * local_epochs / (rate * speed)
    + comm_time``, with the small ``ClientState.rng`` uniform jitter on
    the very first event so clients do not all fire at t=0.
  * :class:`LognormalTiming` — heavy-tailed per-epoch compute: each
    upload period's compute time is the static duration times
    ``exp(sigma * z)`` (median 1, heavy right tail: the straggler regime
    of the paper's Fig. 3 oscillations).
  * :class:`MarkovTiming` — two-state availability on top of the
    lognormal jitter: after each upload a client drops offline with
    probability ``drop_p`` for an Exponential(``off_mean_s``) holding
    time, emitting a WAKE (no-show) event instead of an upload.

The stochastic draws come from :class:`PRNGStream`, keyed per ``(seed,
cid, block)`` with :mod:`repro_torch.prng`'s threefry (the bits of
``jax.random``), so a draw never depends on the order of events.  The
uniform and normal lanes (:func:`repro_torch.prng.normal`, XLA's f32
erfinv and log1p) are the reference's bit for bit, so every event time
equals the reference's.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

from repro_torch import prng
from repro_torch.sched.events import UPLOAD, WAKE

Entry = Tuple[float, int, float]  # (absolute time, kind, compute_s)

_BLOCK = 64  # draws per client block


def _block(seed: int, cid: int, block: int) -> np.ndarray:
    """(BLOCK, 3) f32 draws ``[z, u1, u2]`` of ``(seed, cid, block)``: the
    reference's ``fold_in`` twice, ``split``, ``normal (BLOCK, 1)`` and
    ``uniform (BLOCK, 2)``."""
    key = prng.fold_in(prng.fold_in(prng.prng_key(seed), cid), block)
    kn, ku = prng.split(key, 2)
    z = prng.normal(kn, (_BLOCK, 1))
    u = prng.uniform(ku, (_BLOCK, 2))
    return np.concatenate([z, u], axis=1)


class PRNGStream:
    """Counter-based per-client draw stream.

    ``draw(cid)`` returns the client's next ``[z ~ N(0,1), u1, u2 ~
    U[0,1)]`` triple.  Values depend only on ``(seed, cid, counter)``,
    never on the interleaving of clients, which is what keeps the
    sequential and batched engines' schedules identical.  Counters
    persist across ``run()`` calls (one stochastic schedule per engine).
    """

    def __init__(self, seed: int):
        self._seed = int(seed)
        self._counters: Dict[int, int] = {}
        # one cached block per client: counters only grow, so an older
        # block is never read again
        self._blocks: Dict[int, Tuple[int, np.ndarray]] = {}

    def draw(self, cid: int) -> np.ndarray:
        n = self._counters.get(cid, 0)
        self._counters[cid] = n + 1
        b, i = divmod(n, _BLOCK)
        cached = self._blocks.get(cid)
        if cached is None or cached[0] != b:
            blk = _block(self._seed, cid, b)
            self._blocks[cid] = (b, blk)
        else:
            blk = cached[1]
        return blk[i]


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
        reboot, or a Markov no-show): the same as after an upload."""
        return self.after_upload(c, now)

    def sync_duration(self, c) -> float:
        """One SFL round's duration contribution for an active client."""
        return self._compute(c) + c.comm_time


class LognormalTiming(StaticTiming):
    """Heavy-tailed stochastic compute: static * exp(sigma * z)."""

    name = "lognormal"

    def __init__(self, base_compute, sigma: float, stream: PRNGStream):
        super().__init__(base_compute)
        self.sigma = float(sigma)
        self._stream = stream

    def _compute(self, c) -> float:
        z = float(self._stream.draw(c.cid)[0])
        return self._base(c) * math.exp(self.sigma * z)


class MarkovTiming(LognormalTiming):
    """Two-state (online / offline) availability + lognormal jitter.

    Each post-upload transition draws one ``(z, u1, u2)`` triple: with
    ``u1 < drop_p`` the client goes offline for ``-off_mean_s *
    log(1 - u2)`` seconds (a WAKE event, which the scheduler counts as a
    no-show); otherwise the next upload lands after the jittered compute
    + comm interval.  Wake-ups and the initial event always schedule an
    upload (clients start online)."""

    name = "markov"

    def __init__(self, base_compute, sigma: float, drop_p: float,
                 off_mean_s: float, stream: PRNGStream):
        super().__init__(base_compute, sigma, stream)
        self.drop_p = float(drop_p)
        self.off_mean_s = float(off_mean_s)

    def after_upload(self, c, now: float) -> Entry:
        z, u1, u2 = (float(v) for v in self._stream.draw(c.cid))
        if u1 < self.drop_p:
            off = -self.off_mean_s * math.log1p(-min(u2, 1.0 - 1e-7))
            return (now + off, WAKE, 0.0)
        comp = self._base(c) * math.exp(self.sigma * z)
        return (now + comp + c.comm_time, UPLOAD, comp)

    def after_wake(self, c, now: float) -> Entry:
        comp = self._compute(c)
        return (now + comp + c.comm_time, UPLOAD, comp)

    def sync_duration(self, c) -> float:
        # SFL waits for every activated client (the straggler effect), so
        # availability is not modeled there (an offline activated client
        # would stall the round forever); only the compute jitter applies
        return LognormalTiming._compute(self, c) + c.comm_time


TIMING_MODELS = ("static", "lognormal", "markov")


def make_timing(cfg, base_compute):
    """Build the ``FLConfig.sched_timing`` model.  The stochastic models
    share one stream seeded by ``sched_seed * 1_000_003 + seed`` (two
    experiments differing only in ``seed`` get distinct schedules)."""
    name = cfg.sched_timing
    if name not in TIMING_MODELS:
        raise ValueError(f"sched_timing={name!r} (one of {TIMING_MODELS})")
    if name == "static":
        return StaticTiming(base_compute)
    stream = PRNGStream(cfg.sched_seed * 1_000_003 + cfg.seed)
    if name == "lognormal":
        return LognormalTiming(base_compute, cfg.sched_jitter_sigma, stream)
    return MarkovTiming(base_compute, cfg.sched_jitter_sigma,
                        cfg.sched_drop_p, cfg.sched_off_mean_s, stream)
