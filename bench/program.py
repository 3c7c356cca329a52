"""The system under test: the port's FL engine built as its launcher
(``repro_torch.launch.fl_sim``) builds it, on the benchmark's inputs.

This is the only module of the benchmark that imports the port.  It
takes from it the engine and the paper's model functions; every number
the benchmark judges the engine by is worked out elsewhere under
``bench/``.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch


def set_precision(cfg: Dict) -> None:
    """The configuration's float32 flags, as the launcher sets them:
    TF32 off in cuDNN and cuBLAS, deterministic convolution algorithms
    picked by heuristics, not by timing."""
    p = cfg["precision"]
    torch.backends.cudnn.allow_tf32 = p["cudnn.allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = p["cuda.matmul.allow_tf32"]
    torch.backends.cudnn.deterministic = p["cudnn.deterministic"]
    torch.backends.cudnn.benchmark = p["cudnn.benchmark"]


def apply_fn(cfg: Dict):
    from repro_torch.models import vision_cnn
    if cfg["family"] == "resnet18":
        return functools.partial(vision_cnn.resnet18_apply,
                                 width=cfg["width"])
    return vision_cnn.vgg16_apply


def build_engine(cfg: Dict, tr: Dict, data: Dict, params, state, device):
    """An ``FLEngine`` of the cell: the port's horizon-batched engine on
    ``device`` with the launcher's settings and the mix's knobs."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import FLEngine
    fl = FLConfig(
        n_clients=tr["clients"], k=tr["k"], mode=tr["mode"],
        aggregation=tr["aggregation"], client_lr=tr["client_lr"],
        server_lr=tr["server_lr"], seed=tr["schedule_seed"],
        speed_sigma=tr["speed_sigma"], comm_mean_s=tr["comm_mean_s"],
        local_epochs=tr["local_epochs"], local_batch_size=tr["batch"],
        wire=tr["wire"], quant_block=tr["quant_block"],
        eval_every=tr["eval_every"], batch_clients=True,
        wave_impl=tr["wave_impl"], server_channel=tr["server_channel"],
        sched_timing=tr["timing"], sched_policy=tr["policy"])
    shards = [{"xs": data["xs"][c], "ys": data["ys"][c],
               "mask": data["mask"][c], "n": int(data["n"][c])}
              for c in range(tr["clients"])]
    return FLEngine(fl, apply_fn(cfg), "image", params, state, shards,
                    data["test_x"], data["test_y"], device=device)


def run_rounds(eng, n: int = 1) -> None:
    """``n`` more aggregation rounds, each with its eval, in one call of
    the engine's own ``run`` (the sync engine's takes a count of rounds,
    the semi-async engine's the round to reach).  Both fetch the rounds'
    evals from the card before they return."""
    if eng.cfg.mode == "sync":
        eng.run(n)
    else:
        eng.run(eng.t_global + n)


#: the engine's eval calls, one after each round's aggregation
EVAL_METHODS = ("_eval_and_record", "_eval_round")


def after_eval(eng, fn) -> None:
    """Call ``fn(eng)`` after each of the engine's round evals, until
    :func:`clear_after_eval`."""
    for name in EVAL_METHODS:
        inner = getattr(eng, name)

        def wrapper(*a, _inner=inner, **kw):
            out = _inner(*a, **kw)
            fn(eng)
            return out

        setattr(eng, name, wrapper)


def clear_after_eval(eng) -> None:
    for name in EVAL_METHODS:
        eng.__dict__.pop(name, None)


def clone(t):
    """A copy of a nested dict of tensors."""
    if isinstance(t, dict):
        return {k: clone(v) for k, v in t.items()}
    return t.detach().clone()


def warm_up(eng, n: int, valid) -> Dict:
    """The engine's first ``n`` rounds in one ``run`` call, as a user's
    run starts, with its client stage recorded (``valid``: the clients'
    (C, NB) valid batches) -> ``snaps`` (its snapshots after each round
    ``1 .. n``), ``uploads`` and ``miscounts`` (:class:`UploadRecorder`)."""
    snaps: Dict[int, Dict] = {}

    def keep(e):
        if 1 <= e.t_global < n and e.t_global not in snaps:
            snaps[e.t_global] = snapshot(e)

    rec = UploadRecorder(eng, valid)
    after_eval(eng, keep)
    rec.install()
    try:
        run_rounds(eng, n)
    finally:
        rec.remove()
        clear_after_eval(eng)
    snaps[n] = snapshot(eng)
    return {"snaps": snaps, "uploads": rec.uploads,
            "miscounts": rec.miscounts}


def _lane(tree, i):
    if isinstance(tree, dict):
        return {k: _lane(v, i) for k, v in tree.items()}
    return tree[i]


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu()


class UploadRecorder:
    """The client stage of the rounds an engine runs while this is
    installed, as ``bench/correct.py`` judges it: for every upload, in
    order, its client, the row and state its lane started from, its
    weights after the first SGD step (the parameters the loss sees at
    the lane's second step; None for a lane of one step), its vector
    before the wire, its end state, and fingerprints of the start and
    (semi-async) end rows.  Rows are in the reference's flattening
    order, on the host.

    It sees the steps through the model function the engine calls, and
    relies on the engine running a wave's lanes one after another, each
    over its valid batches in order (``wave_impl`` ``map``, a conv
    model's): ``miscounts`` counts the lanes whose steps break that
    count."""

    def __init__(self, eng, valid):
        self.eng, self.valid = eng, valid
        self.apply = eng.apply_fn
        self.uploads, self.miscounts = [], 0
        self._lanes = None
        self._starts = {}  # fingerprint -> host row: lanes share starts

    def install(self) -> None:
        eng, inner = self.eng, self.eng._train_wave

        def train_wave(*args):
            return self._wave(inner, *args)

        eng.apply_fn = self._apply
        eng._train_wave = train_wave

    def remove(self) -> None:
        self.eng.apply_fn = self.apply
        self.eng.__dict__.pop("_train_wave", None)

    def _row(self, flat):
        """A flat row of the program's codec in the reference's order."""
        from bench.reference import models
        return models.ravel(self.eng.codec.unravel(flat)).detach()

    def _apply(self, params, state, x, train):
        lanes = self._lanes
        if train and lanes is not None:
            i = lanes["lane"]
            if i >= len(lanes["n"]):
                lanes["extra"] += 1
            else:
                if lanes["step"] == 1:
                    from bench.reference import models
                    with torch.no_grad():
                        lanes["p1"][i] = models.ravel(
                            params).detach().cpu()
                lanes["step"] += 1
                if lanes["step"] == lanes["n"][i]:
                    lanes["lane"], lanes["step"] = i + 1, 0
        return self.apply(params, state, x, train)

    def _wave(self, inner, wave_fn, starts, states, cids, slots):
        from bench.reference.fl import fingerprint
        epochs = self.eng.cfg.local_epochs
        n = [epochs * int(self.valid[c].sum()) for c in cids]
        self._lanes = {"n": n, "lane": 0, "step": 0, "extra": 0,
                       "p1": [None] * len(cids)}
        try:
            out = inner(wave_fn, starts, states, cids, slots)
        finally:
            lanes, self._lanes = self._lanes, None
        self.miscounts += lanes["extra"] + len(cids) - lanes["lane"]
        shared = starts.dim() == 1  # the sync round: one global row
        with torch.no_grad():
            for i, cid in enumerate(cids):
                if i == 0 or not shared:
                    row0 = self._row(starts if shared else starts[i])
                    fp0 = fingerprint(row0)
                    host0 = self._starts.setdefault(fp0, row0.cpu())
                end_fp = (fingerprint(self._row(out[1][i]))
                          if len(out) == 4 else None)
                self.uploads.append(dict(
                    cid=int(cid), start=host0,
                    state=_host(states if shared else _lane(states, i)),
                    p1=lanes["p1"][i], vec=self._row(out[0][i]).cpu(),
                    state_end=_host(_lane(out[-2], i)), start_fp=fp0,
                    end_fp=end_fp))
        return out


def snapshot(eng) -> Dict:
    """What the rounds so far left, from the engine's public state: the
    global weights and model state as nested dicts (clones), the eval
    records, the admitted uploads a client."""
    return {
        "params": clone(eng.global_params),
        "state": clone(eng.global_state),
        "records": [dict(vars(r)) for r in eng.metrics.records],
        "participation": eng.sched.participation.copy(),
    }
