"""How ``correct`` is decided: the program's first rounds against the
plain reference (``bench/reference``), on the same inputs.

The timed path is the engine's ``run``; set-up drives it through the
cell's first ``warm_rounds`` rounds with a recorder on its client stage
(``bench/program.py``), and the reference judges those rounds stage by
stage from the program's own state:

  * the client stage: every upload's first SGD step, replayed from the
    weights its lane started from on the same batch (``step_gap``);
    a client's whole local epoch is not compared, since float32 runs of
    these models part at ReLU and max-pool branch points within it (any
    other summation order reads as far from the reference as TF32
    does), while one step reads about its own rounding;
  * the wire, the server, the eval and the schedule: the reference
    runs the rounds on the program's upload vectors (before the wire),
    round 1 from the initial weights and every later round ``r`` from
    the program's global model after round ``r - 1`` (``replay``).

The numbers, each against the cell's own limit
(``bench/workloads/<cell>.json``, set from readings as ``PERF.md``
records):

  * ``step_gap``: over the uploads of more than one step, the worst
    leaf's gap between the program's norm of a leaf's first update and
    the reference's, over the larger of the reference's norm of that
    leaf and of the median leaf;
  * ``loss_gap``: the largest gap between the program's eval loss and
    the reference's over the rounds, relative to the reference's;
  * ``first_update_gap``: the server's first update (the global weights'
    change in round 1), taken by the worst leaf as ``step_gap`` is;
  * ``change_gap``: the same of the weights' (and BatchNorm statistics')
    change from the start after each round, the worst round;
  * ``schedule_mismatches``: record fields (simulated time, bytes up and
    down, mean and largest staleness), admitted uploads a client, lanes
    whose start is not the model the schedule says (the global model of
    the client's version, or its own last end), lanes whose count of
    steps is not their valid batches', and uploads left over; all must
    match exactly.

Leaves whose update in the reference is under a thousandth of the
median leaf's are left out of the norm gaps (``excluded_leaves``, of
the first server update): their change is round-off.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bench.reference import fl, models

NUMBERS = ("step_gap", "loss_gap", "first_update_gap", "change_gap",
           "schedule_mismatches")
SCHEDULE_FIELDS = ("sim_time", "tx_bytes", "rx_bytes", "mean_staleness",
                   "max_staleness")
EXCLUDE_BELOW = 1e-3


def _leaves(params, state) -> Dict[str, torch.Tensor]:
    out = {f"params/{k}": v for k, v in models.flatten(params)}
    out.update({f"state/{k}": v for k, v in models.flatten(state or {})})
    return out


def _norms(a: Dict, b: Dict) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(a[k].double()
                                              - b[k].double()))
            for k in b}


def _worst_gap(prog: Dict[str, float], ref: Dict[str, float],
               keep: List[str]) -> float:
    """Inf where a norm on either side is not finite."""
    vals = [prog[k] for k in keep] + [ref[k] for k in keep]
    if not keep or not np.all(np.isfinite(vals)):
        return float("inf")
    med = float(np.median([ref[k] for k in keep]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keep)


def replay_of(start: Dict, snaps: Dict, rounds: int) -> Dict:
    """The program's global model after rounds ``0 .. rounds - 1`` as
    the reference's ``replay``: flat weights and the state."""
    out = {0: (models.ravel(start["params"]), start["state"])}
    for r in range(1, rounds):
        out[r] = (models.ravel(snaps[r]["params"]), snaps[r]["state"])
    return out


def from_reference(cfg: Dict, out: Dict, rounds: int) -> Dict:
    """A reference run's result as the program's warm-up record, so that
    it can be judged in the program's place (the control)."""
    specs, _ = models.leaf_specs(cfg)
    snaps = {r: {"params": models.views(out["snaps"][r][0], specs),
                 "state": out["snaps"][r][1],
                 "records": out["records"][:r],
                 "participation": out["participation"]}
             for r in range(1, rounds + 1)}
    return {"snaps": snaps, "uploads": out["uploads"], "miscounts": 0}


def _leaf_norms(diff: torch.Tensor, specs) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in models.flatten(models.views(diff, specs))}


def step_gap(cfg: Dict, tr: Dict, data: Dict, uploads: List[Dict]) -> float:
    """The worst first-step gap over ``uploads`` (see the module's
    docstring); 0 where no upload took two steps."""
    specs, _ = models.leaf_specs(cfg)
    worst = 0.0
    for u in uploads:
        if u["p1"] is None:
            continue
        cid = u["cid"]
        dev = data["xs"].device
        first = np.zeros_like(data["valid"][cid])
        first[np.flatnonzero(data["valid"][cid])[0]] = True
        p0 = u["start"].to(dev)
        p1_ref, _, _ = fl.local_epoch(
            cfg, specs, p0, fl.to_device(u["state"], dev), data["xs"][cid],
            data["ys"][cid], data["mask"][cid], first, tr["client_lr"])
        up_r = _leaf_norms(p1_ref - p0, specs)
        up_p = _leaf_norms(u["p1"].to(dev) - p0, specs)
        med = float(np.median(list(up_r.values())))
        keep = [k for k in up_r if not up_r[k] < EXCLUDE_BELOW * med]
        worst = max(worst, _worst_gap(up_p, up_r, keep))
    return worst


def judge(cfg: Dict, tr: Dict, data: Dict, start: Dict, prog: Dict,
          rounds: int) -> Dict:
    """The reference judges the program's ``rounds`` rounds (``prog``:
    :func:`bench.program.warm_up`'s record, or :func:`from_reference`'s)
    on the device ``data``; -> the numbers."""
    snaps = prog["snaps"]
    queues: Dict[int, List[Dict]] = {}
    for u in prog["uploads"]:
        queues.setdefault(u["cid"], []).append(u)
    try:
        ref = fl.simulate(cfg, tr, data, models.ravel(start["params"]),
                          start["state"], rounds,
                          replay=replay_of(start, snaps, rounds),
                          uploads=queues)
    except fl.ScheduleError:
        return {**dict.fromkeys(NUMBERS[:-1], float("inf")),
                "schedule_mismatches": 1 + len(prog["uploads"]),
                "excluded_leaves": 0}
    out = readings(cfg, start, snaps, ref, rounds)
    out["schedule_mismatches"] += (ref["stage_mismatches"]
                                   + prog["miscounts"]
                                   + sum(len(q) for q in queues.values()))
    out["step_gap"] = step_gap(cfg, tr, data, prog["uploads"])
    return out


def readings(cfg: Dict, start: Dict, prog: Dict, ref: Dict,
             rounds: int) -> Dict:
    """The round stage's numbers, and ``excluded_leaves``.  ``start``:
    the initial ``params`` and ``state`` both sides got; ``prog``: the
    program's snapshots after each round ``1 .. rounds`` (``params``,
    ``state``, ``records``, ``participation``); ``ref``: the reference's
    :func:`bench.reference.fl.simulate` result."""
    specs, _ = models.leaf_specs(cfg)
    x0 = _leaves(start["params"], start["state"])

    def ref_leaves(r):
        row, st = ref["snaps"][r]
        return _leaves(models.views(row, specs), st)

    p1 = _leaves(prog[1]["params"], prog[1]["state"])
    if set(p1) != set(x0):
        raise ValueError(f"the program's leaves {sorted(p1)} are not the "
                         f"configuration's {sorted(x0)}")
    up_p, up_r = _norms(p1, x0), _norms(ref_leaves(1), x0)
    med = float(np.median(list(up_r.values())))
    keep = [k for k in up_r
            if not up_r[k] < EXCLUDE_BELOW * med]  # NaN stays in
    change_gap = max(
        _worst_gap(_norms(_leaves(prog[r]["params"], prog[r]["state"]), x0),
                   _norms(ref_leaves(r), x0), keep)
        for r in range(1, rounds + 1))

    recs_p = prog[rounds]["records"][:rounds]
    recs_r = ref["records"][:rounds]
    losses = [a["loss"] for a in recs_p] + [b["loss"] for b in recs_r]
    loss_gap = (max(abs(a["loss"] - b["loss"]) / max(abs(b["loss"]), 1e-30)
                    for a, b in zip(recs_p, recs_r))
                if np.all(np.isfinite(losses)) else float("inf"))
    mism = sum(a[f] != b[f] for a, b in zip(recs_p, recs_r)
               for f in SCHEDULE_FIELDS)
    mism += abs(len(recs_p) - len(recs_r))
    mism += int(np.sum(np.asarray(prog[rounds]["participation"])
                       != np.asarray(ref["participation"])))
    return {"loss_gap": float(loss_gap),
            "first_update_gap": _worst_gap(up_p, up_r, keep),
            "change_gap": float(change_gap),
            "schedule_mismatches": int(mism),
            "excluded_leaves": len(up_r) - len(keep)}


def verdict(numbers: Dict, limits: Dict) -> Dict:
    """{name: {"value", "limit"}} of the compared numbers and whether
    every one is within its limit (a NaN never is)."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return {"checks": checks, "correct": bool(ok)}
