"""Participation policies: which client uploads the server accepts, and
with what aggregation weight.

Only the base :class:`Policy` (``full``: every upload admitted, with the
paper's weighting; the reference's parity oracle) is ported.  The
``uniform``, ``seafl``, ``fedqs`` and ``ratelimit`` policies, and with
them rejected and idled uploads, come later.
"""
from __future__ import annotations


class Policy:
    """Full participation: every upload is admitted, none is reweighted."""

    name = "full"
    #: True for policies that rescale the aggregation coefficients
    reweights = False

    def __init__(self, cfg, n_clients: int):
        self.cfg = cfg
        self.n_clients = n_clients


POLICIES = {Policy.name: Policy}


def make_policy(cfg, n_clients: int) -> Policy:
    if cfg.sched_policy not in POLICIES:
        raise NotImplementedError(
            f"sched_policy={cfg.sched_policy!r} is not ported yet "
            f"(ported: {tuple(POLICIES)})")
    return POLICIES[cfg.sched_policy](cfg, n_clients)
