"""Plain reference of the SAFL study's simulation (paper sec. 2.2): the
static timing model, full participation, local SGD, the f32 / q8 / q4
wires and the FedSGD / FedAvg server rounds of the synchronous (SS, SA)
and semi-asynchronous (AS, AA) modes, and the per-round eval.

One upload at a time, in the order the event clock gives them; nothing
of the measured program is imported or reused: the schedule, the client
steps, the codec's levels and draws, the server's sums and the eval are
all worked out again here from the benchmark's own inputs (the client
shards, the test set, the initial weights).  Floating-point operations
follow the study's reference arithmetic: a fold is ``acc + w * x`` with
the product rounded, the weights sum in upload order in float32, a mean
is a true division by the float32 weight sum, ``x / scale`` is a true
division, and the quantizers' scale is ``max(absmax * f32(1/127),
1e-12)`` (``f32(1/7)`` on q4).
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bench.reference import models, prng

#: simulated samples a second at speed 1, and the serialization
#: envelopes of a model upload and of a gradient upload (paper sec. 5.1.2)
BASE_RATE = 500.0
MODEL_ENVELOPE = 0.010
GRAD_ENVELOPE = 0.002
INV_127 = float(np.float32(1.0) / np.float32(127.0))
INV_7 = float(np.float32(1.0) / np.float32(7.0))


def f32sum(w) -> np.float32:
    s = np.float32(0.0)
    for x in np.asarray(w, np.float32):
        s = np.float32(s + x)
    return s


# ------------------------------------------------------------- the wire
def quantize(row: torch.Tensor, qblock: int, levels: int, u=None):
    """(D,) f32 -> (levels (Dq,) f32, scales (Dq / qblock,) f32): absmax
    blocks, round half to even (``levels`` 127) or stochastic rounding by
    the draws ``u`` (``levels`` 7)."""
    d = row.shape[0]
    dq = -(-d // qblock) * qblock
    x = F.pad(row, (0, dq - d)).view(-1, qblock)
    inv = INV_127 if levels == 127 else INV_7
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True) * inv,
                        min=1e-12)
    if u is None:
        q = torch.clamp(torch.round(x / scale), -levels, levels)
    else:
        y = torch.clamp(x / scale, -levels, levels)
        f = torch.floor(y)
        q = torch.clamp(f + (u.view_as(y) < (y - f)).to(torch.float32),
                        -levels, levels)
    return q.reshape(-1), scale[:, 0]


def dequantize(q: torch.Tensor, scale: torch.Tensor, qblock: int):
    return (q.view(-1, qblock) * scale[:, None]).reshape(-1)


# ---------------------------------------------------------- the client
def local_epoch(cfg, specs, row, state, xs, ys, mask, valid, lr):
    """Plain SGD over the client's valid batches from the flat ``row``
    -> (final flat row, final state, the flat row after the first step
    or None where there was one step)."""
    pairs = models.flatten(models.views(row, specs))
    paths = [p for p, _ in pairs]
    cur = [v.detach() for _, v in pairs]
    s = state
    first = None
    for i, b in enumerate(np.flatnonzero(valid)):
        if i == 1:
            first = torch.cat([v.reshape(-1) for v in cur])
        leaves = [v.requires_grad_(True) for v in cur]
        params = models.unflatten(zip(paths, leaves))
        logits, s = models.forward(cfg, params, s, xs[b], True)
        loss = models.masked_loss(logits, ys[b], mask[b])
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            cur = [v - lr * g for v, g in zip(leaves, grads)]
        s = models.unflatten((k, v.detach()) for k, v in models.flatten(s))
    return torch.cat([v.reshape(-1) for v in cur]), s, first


def fingerprint(row: torch.Tensor) -> tuple:
    """Two float64 sums of a flat row, equal for equal rows: which model
    a client started from, without keeping the row."""
    r = row.detach().to(torch.float64)
    w = torch.arange(r.numel(), dtype=torch.float64,
                     device=r.device).remainder_(1009.0)
    return float(r.sum()), float((r * w).sum())


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


class ScheduleError(Exception):
    """The program's uploads do not follow the reference's schedule."""


@torch.no_grad()
def evaluate(cfg, specs, row, state, x, y):
    logits, _ = models.forward(cfg, models.views(row, specs), state, x,
                               False)
    hits = (torch.argmax(logits, dim=-1) == y).sum().to(torch.float32)
    acc = hits * float(np.float32(1.0) / np.float32(y.numel()))
    return float(acc), float(torch.mean(models.nll(logits, y)))


def _state_roundtrip_q8(state, qblock):
    pairs = models.flatten(state)
    if not pairs:
        return state
    row = torch.cat([v.reshape(-1) for _, v in pairs])
    q, s = quantize(row, qblock, 127)
    deq = dequantize(q, s, qblock)[:row.shape[0]]
    out, off = [], 0
    for k, v in pairs:
        out.append((k, deq[off:off + v.numel()].view(v.shape)))
        off += v.numel()
    return models.unflatten(out)


def _weighted_state(states, sizes):
    w = np.asarray(sizes, np.float32)
    denom = max(f32sum(w), np.float32(1e-12))
    flat = [dict(models.flatten(s)) for s in states]
    out = []
    for k in flat[0]:
        acc = flat[0][k] * float(w[0])
        for j in range(1, len(flat)):
            acc = acc + flat[j][k] * float(w[j])
        out.append((k, acc / torch.tensor(denom, dtype=torch.float32,
                                          device=acc.device)))
    return models.unflatten(out)


# ------------------------------------------------------------ the study
def simulate(cfg: Dict, tr: Dict, data: Dict, p0: torch.Tensor, s0,
             rounds: int, replay: Optional[Dict] = None,
             uploads: Optional[Dict] = None) -> Dict:
    """``rounds`` aggregation rounds of the cell's study from the flat
    initial weights ``p0`` and state ``s0``.  ``data``: device tensors
    ``xs`` (C, NB, B, H, W, Ch), ``ys`` (C, NB, B), ``mask`` (C, NB, B),
    ``test_x``, ``test_y``, host ``valid`` (C, NB) and ``n`` (C,).

    ``replay``, when given, maps a round ``r`` to the flat global weights
    and state another run held after ``r`` rounds: each round then starts
    from that run's global model in place of this one's.  ``uploads``,
    when given, maps a client to that run's uploads in order (as
    :func:`bench.correct.from_reference` and ``bench/program.py``'s
    recorder list them): each upload's vector before the wire and its
    end state are then that run's, in place of a local epoch here, and
    its start's fingerprint has to be the model the schedule says it
    starts from (``stage_mismatches`` counts those that are not; a
    client with no upload left raises :class:`ScheduleError`).  So the
    wire, the server, the eval and the schedule are judged from that
    run's own state, round by round.

    Returns the per-round records, the admitted uploads per client, the
    flat weights and states after every round (``snaps[0]`` the start),
    ``stage_mismatches`` and ``uploads``: each upload as the recorder
    lists it (none where ``uploads`` was given)."""
    specs, sspecs = models.leaf_specs(cfg)
    dev = p0.device
    n_cl, k = tr["clients"], tr["k"]
    lr, slr = tr["client_lr"], tr["server_lr"]
    agg, wire, qb = tr["aggregation"], tr["wire"], tr["quant_block"]
    model_target = agg == "fedavg"
    sync = tr["mode"] == "sync"
    d = p0.numel()
    dq = -(-d // qb) * qb
    d_state = sum(int(np.prod(sh)) for _, sh, *_ in sspecs)
    n = [max(int(x), 1) for x in data["n"]]

    rng = np.random.default_rng(tr["schedule_seed"])
    speed, comm = [], []
    for _ in range(n_cl):
        speed.append(float(np.exp(rng.normal(0.0, tr["speed_sigma"]))))
        comm.append(float(tr["comm_mean_s"] * np.exp(rng.normal(0.0, 0.3))))
    comp = [n[c] / (BASE_RATE * speed[c]) * tr["local_epochs"]
            for c in range(n_cl)]

    # bytes of one upload and of one broadcast
    if wire == "f32":
        payload = d * 4
    elif wire == "q8":
        payload = dq + (dq // qb) * 4
    else:
        payload = dq // 2 + (dq // qb) * 4
    if model_target:
        if wire != "f32" and d_state:
            dsq = -(-d_state // qb) * qb
            st_bytes = dsq + (dsq // qb) * 4
        else:
            st_bytes = d_state * 4
        up_bytes = int((payload + st_bytes) * (1 + MODEL_ENVELOPE))
    else:
        up_bytes = int(payload * (1 + GRAD_ENVELOPE))
    bcast = int((d * 4 + d_state * 4) * n_cl)
    overhead = 0.05 * k if agg != "fedsgd" else 0.01

    lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
    counters: Dict[int, int] = {}

    def upload(cid, vec):
        """The server's f32 view of one upload (dequantized on a lossy
        wire)."""
        if wire == "f32":
            return vec
        if wire == "q8":
            q, s = quantize(vec, qb, 127)
        else:
            c = counters.get(cid, 0)
            counters[cid] = c + 1
            key = prng.fold_in(prng.fold_in(prng.key(tr["schedule_seed"]),
                                            cid), c)
            q, s = quantize(vec, qb, 7, prng.uniform(key, dq, dev))
        return dequantize(q, s, qb)

    recorded: List[Dict] = []
    mism = 0

    def client(cid, start, state):
        """One upload of ``cid`` from ``start`` (a row, or under
        ``uploads`` the fingerprint it must have) -> (vector before the
        wire, end state, the end: a row, or its fingerprint)."""
        nonlocal mism
        if uploads is not None:
            if not uploads.get(cid):
                raise ScheduleError(f"client {cid} has no upload left")
            u = uploads[cid].pop(0)
            want = start if isinstance(start, tuple) else fingerprint(start)
            mism += int(tuple(u["start_fp"]) != tuple(want))
            return (u["vec"].to(dev), to_device(u["state_end"], dev),
                    u["end_fp"])
        end, st, first = local_epoch(
            cfg, specs, start, state, data["xs"][cid], data["ys"][cid],
            data["mask"][cid], data["valid"][cid], lr)
        vec = end if model_target else (start - end) / lr_t
        recorded.append(dict(cid=cid, start=start, state=state, p1=first,
                             vec=vec, state_end=st,
                             start_fp=fingerprint(start),
                             end_fp=fingerprint(end)))
        return vec, st, end

    g_row, g_state = p0, s0
    rows: Dict[int, torch.Tensor] = {}
    cstate: Dict[int, object] = {}
    cver = [0] * n_cl
    vproj: Dict[int, int] = {}
    part = np.zeros(n_cl, np.int64)
    heap = []
    if not sync:
        for c in range(n_cl):
            crng = np.random.default_rng(tr["schedule_seed"] * 7919 + c)
            heap.append((comp[c] + comm[c] + float(crng.uniform(0, 0.1)), c))
        heapq.heapify(heap)
    now, tx, rx = 0.0, 0, 0
    records: List[Dict] = []
    snaps = {0: (p0, s0)}
    for r in range(rounds):
        if replay is not None and r in replay:
            g_row, g_state = replay[r]
        acc = torch.zeros(dq if wire != "f32" else d, dtype=torch.float32,
                          device=dev)
        w_host: List[np.float32] = []
        stal: List[int] = []
        up_states, sizes = [], []
        if sync:
            active = rng.choice(n_cl, k, replace=False)
            durs = []
            for cid in (int(c) for c in active):
                vec, st, _ = client(cid, g_row, g_state)
                w = np.float32(n[cid]) if model_target else np.float32(1.0)
                acc = acc + float(w) * upload(cid, vec)
                w_host.append(w)
                stal.append(0)
                up_states.append(st)
                sizes.append(n[cid])
                tx += up_bytes
                part[cid] += 1
                durs.append(comp[cid] + comm[cid])
            now += max(durs) + overhead
            t_rec = now
        else:
            t = 0.0
            while len(stal) < k:
                t, cid = heapq.heappop(heap)
                heapq.heappush(heap, (t + comp[cid] + comm[cid], cid))
                s_up = r - vproj.get(cid, 0)
                vproj[cid] = r
                vec, st, end = client(cid, rows.get(cid, p0),
                                      cstate.get(cid, s0))
                w = np.float32(n[cid]) if model_target else np.float32(1.0)
                acc = acc + float(w) * upload(cid, vec)
                w_host.append(w)
                stal.append(s_up)
                up_states.append(st)
                sizes.append(n[cid])
                tx += up_bytes
                part[cid] += 1
                # refresh rule: adopt the newest global model if one came
                # since the client's version, else go on from its own
                if cver[cid] < r:
                    rows[cid], cstate[cid], cver[cid] = g_row, g_state, r
                else:
                    rows[cid], cstate[cid] = end, st
            t_rec = t + overhead
        wsum = torch.full((), float(max(f32sum(w_host), np.float32(1e-12))),
                          dtype=torch.float32, device=dev)
        mean = acc[:d] / wsum
        g_row = mean if model_target else g_row - slr * mean
        if model_target:
            if wire != "f32":
                up_states = [_state_roundtrip_q8(s, qb) for s in up_states]
            if d_state:
                g_state = _weighted_state(up_states, sizes)
        else:
            g_state = up_states[-1]
        rx += bcast
        a, loss = evaluate(cfg, specs, g_row, g_state, data["test_x"],
                           data["test_y"])
        records.append(dict(round=r + 1, sim_time=t_rec, accuracy=a,
                            loss=loss, tx_bytes=tx, rx_bytes=rx,
                            mean_staleness=float(np.mean(stal)),
                            max_staleness=int(max(stal))))
        snaps[r + 1] = (g_row, g_state)
    return {"records": records, "participation": part, "snaps": snaps,
            "stage_mismatches": mism, "uploads": recorded}
