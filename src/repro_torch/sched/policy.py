"""Participation policies: which client uploads the server accepts, and
with what aggregation weight (the reference's five, host numpy).

A policy sees every UPLOAD event the scheduler pops and answers
:meth:`Policy.verdict`: ``"admit"``, ``"reject"`` or ``"idle"``.

  * A rejected client's local progress is discarded and it resyncs to
    the current global model (SEAFL's selective training): a rejected
    upload takes no buffer slot, no bytes and no staleness entry.
  * ``idle`` is rate control's "the server is full, come back later":
    the client keeps its local chain (params, version) and retries at its
    next upload event, its staleness growing meanwhile.

Admission reads the scheduler's projected client versions, which mirror
the engine's refresh rule, so the sequential and horizon-batched engines
see the same verdicts.  A reweighting policy (``fedqs``) must be
foldable: its score depends only on the upload's ``(staleness,
n_samples)`` and constants fixed at :meth:`Policy.bind`, because the
streaming channel folds each upload's final weight when it lands.

Policies: ``full`` (everyone, the parity oracle), ``uniform`` (C of N per
round), ``seafl`` (staleness-capped selective training), ``fedqs``
(staleness x sample-count reweighting), ``ratelimit`` (FedBuff-style
back-pressure past a per-round admission budget).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Set

import numpy as np


class Policy:
    """Full participation: every upload is admitted, none is reweighted
    (the parity oracle and the paper's implicit policy)."""

    name = "full"
    #: True for policies that rescale the aggregation coefficients; the
    #: engine composes the per-mode base weights with :meth:`score`
    reweights = False

    def __init__(self, cfg, n_clients: int):
        self.cfg = cfg
        self.n_clients = n_clients

    def bind(self, clients) -> None:
        """One-time hook with the engine's client population (called from
        ``Scheduler.__init__``): foldable policies fix their normalization
        constants here."""

    def admit(self, cid: int, staleness: int, n_samples: int,
              rnd: int) -> bool:
        return True

    def verdict(self, cid: int, staleness: int, n_samples: int,
                rnd: int) -> str:
        """``"admit" | "reject" | "idle"``; the default wraps
        :meth:`admit` (only rate control answers ``idle``)."""
        return "admit" if self.admit(cid, staleness, n_samples, rnd) \
            else "reject"

    def score_one(self, staleness: int, n_samples: int) -> np.float32:
        """Per-upload weight multiplier; ``score([t], [n])[0] ==
        score_one(t, n)`` bitwise."""
        return np.float32(1.0)

    def score(self, staleness: Sequence[int],
              sizes: Sequence[int]) -> Optional[np.ndarray]:
        """(K,) multiplier on the mode's base weights, or None for
        policies that keep the paper's weighting."""
        return None


class UniformSampling(Policy):
    """Uniform C-of-N sampling per aggregation round: round ``r`` admits
    ``sched_c`` clients drawn without replacement by a numpy generator
    seeded ``(sched_seed, seed, r)``, whatever the order of events.  With
    C = N it is full participation."""

    name = "uniform"

    def __init__(self, cfg, n_clients: int):
        super().__init__(cfg, n_clients)
        self.c = cfg.sched_c or n_clients
        if not 1 <= self.c <= n_clients:
            raise ValueError(f"sched_c={self.c} outside [1, {n_clients}]")
        self._sets: Dict[int, Set[int]] = {}

    def _round_set(self, rnd: int) -> Set[int]:
        s = self._sets.get(rnd)
        if s is None:
            rng = np.random.default_rng(
                [self.cfg.sched_seed, self.cfg.seed, rnd])
            s = set(rng.choice(self.n_clients, self.c,
                               replace=False).tolist())
            # rounds are visited in order; drop the older sets
            self._sets = {rnd: s}
        return s

    def admit(self, cid, staleness, n_samples, rnd) -> bool:
        return self.c >= self.n_clients or cid in self._round_set(rnd)


class SEAFLSelective(Policy):
    """SEAFL's selective training (arXiv:2503.05755): reject a client
    whose projected staleness exceeds ``sched_stale_cap``.  It resyncs, so
    its next upload has staleness 0: the cap bounds the staleness that
    reaches the buffer without starving slow clients."""

    name = "seafl"

    def __init__(self, cfg, n_clients: int):
        super().__init__(cfg, n_clients)
        self.cap = int(cfg.sched_stale_cap)
        if self.cap < 0:
            raise ValueError(f"sched_stale_cap={self.cap} < 0")

    def admit(self, cid, staleness, n_samples, rnd) -> bool:
        return staleness <= self.cap


class FedQSAdaptive(Policy):
    """FedQS's adaptive weighting (arXiv:2510.07664): admit everyone and
    score each upload ``(n_i / n_mean) / (1 + tau_i)^beta``, multiplied
    into the mode's base coefficients.  ``n_mean`` is the bind-time mean
    sample count (a per-horizon normalizer cannot be known when the
    streaming channel folds an upload)."""

    name = "fedqs"
    reweights = True

    def __init__(self, cfg, n_clients: int):
        super().__init__(cfg, n_clients)
        self.beta = float(cfg.sched_qs_beta)
        self.n_mean = np.float32(1.0)  # rebound from the real population

    def bind(self, clients) -> None:
        self.n_mean = np.float32(max(
            float(np.mean([c.n_samples for c in clients])), 1e-12))

    def score_one(self, staleness: int, n_samples: int) -> np.float32:
        # the vector form's np.float32 ops in the same order: numpy's
        # scalar and array kernels agree bitwise
        return np.float32(
            (np.float32(n_samples) / self.n_mean)
            / np.power(1.0 + np.float32(staleness), np.float32(self.beta)))

    def score(self, staleness, sizes) -> np.ndarray:
        n = np.asarray(sizes, np.float32)
        tau = np.asarray(staleness, np.float32)
        return ((n / self.n_mean)
                / np.power(1.0 + tau, np.float32(self.beta)))


class RateControl(Policy):
    """FedBuff-style rate control (arXiv:2106.06639): admit the first
    ``sched_rate_limit`` (0 -> k) uploads of each round and IDLE the
    rest.  ``FLConfig.validate`` refuses a limit below a count horizon's
    target; the clock horizons (timeout / hybrid) are where it bites."""

    name = "ratelimit"

    def __init__(self, cfg, n_clients: int):
        super().__init__(cfg, n_clients)
        self.limit = int(cfg.sched_rate_limit) or int(cfg.k)
        if self.limit < 1:
            raise ValueError(f"rate limit {self.limit} < 1")
        self._rnd = -1
        self._admitted = 0

    def verdict(self, cid, staleness, n_samples, rnd) -> str:
        if rnd != self._rnd:  # rounds are visited in order
            self._rnd, self._admitted = rnd, 0
        if self._admitted < self.limit:
            self._admitted += 1
            return "admit"
        return "idle"


POLICIES = {p.name: p for p in
            (Policy, UniformSampling, SEAFLSelective, FedQSAdaptive,
             RateControl)}


def make_policy(cfg, n_clients: int) -> Policy:
    if cfg.sched_policy not in POLICIES:
        raise ValueError(f"sched_policy={cfg.sched_policy!r} (one of "
                         f"{tuple(POLICIES)})")
    return POLICIES[cfg.sched_policy](cfg, n_clients)
