"""The benchmark's inputs, made from ``--seed``: the traffic mix's data
set and client shards, and the model's initial weights.

One general generator reads a traffic file of parameters
(``bench/traffic/<name>.json`` over its shared mix, as
``harness.load_traffic`` merges them).  What fixes a run's work is
drawn from the mix's ``schedule_seed`` and is the same under every
``--seed``: the labels, the per-class Dirichlet split over the clients
(so every client's sample count), the batch order and padding.
``--seed`` draws what the work is done on: the class templates, the
pixel noise and colour shift of every image (on the card, with a
``torch.Generator``, in a few large calls) and the initial weights.  So
two seeds cost the same and compute on different numbers.

The image generator and the partition are copies of the study's own
(``repro_torch.data.synthetic`` and ``.partition``), kept here so the
yardstick cannot change with the program.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bench.reference import models


def hetero_dirichlet(labels: np.ndarray, n_clients: int, alpha: float,
                     seed: int, min_per_client: int) -> List[np.ndarray]:
    """For every class, its samples split over the clients ~ Dir(alpha);
    a client left under ``min_per_client`` is topped up from the largest."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    client_idx: List[List[int]] = [[] for _ in range(n_clients)]
    for cls in range(n_classes):
        cls_idx = np.where(labels == cls)[0]
        rng.shuffle(cls_idx)
        p = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(p)[:-1] * len(cls_idx)).astype(int)
        for cid, part in enumerate(np.split(cls_idx, cuts)):
            client_idx[cid].extend(part.tolist())
    out = [np.asarray(sorted(ix), dtype=np.int64) for ix in client_idx]
    for cid in [c for c in range(n_clients) if len(out[c]) < min_per_client]:
        donor = int(np.argmax([len(a) for a in out]))
        need = min_per_client - len(out[cid])
        out[cid] = np.concatenate([out[cid], out[donor][:need]])
        out[donor] = out[donor][need:]
    return out


def _seed64(seed: int, stream: int) -> int:
    return (int(seed) * 2 + stream) % (1 << 64)


def make_data(tr: Dict, seed: int, device) -> Dict:
    """The mix's data on the host: ``xs`` (C, NB, B, H, W, Ch) f32, ``ys``
    (C, NB, B) int64, ``mask`` (C, NB, B) f32, ``valid`` (C, NB) bool,
    ``n`` (C,) samples a client, ``test_x``, ``test_y``.  Images are made
    on ``device`` and copied to the host once."""
    if tr["partition"] != "hetero_dirichlet":
        raise ValueError(f"unknown partition {tr['partition']!r}")
    h, w, ch = tr["image"]
    ncls, bsz = tr["n_classes"], tr["batch"]
    srng = np.random.default_rng(tr["schedule_seed"])
    y_tr = srng.integers(0, ncls, tr["n_train"]).astype(np.int64)
    y_te = srng.integers(0, ncls, tr["n_test"]).astype(np.int64)
    parts = hetero_dirichlet(y_tr, tr["clients"], tr["alpha"],
                             tr["schedule_seed"], tr["min_per_client"])
    nb = max(1, -(-max(len(p) for p in parts) // bsz))
    prng = np.random.default_rng(tr["schedule_seed"] + 1)
    take = np.zeros((len(parts), nb * bsz), np.int64)
    mask = np.zeros((len(parts), nb * bsz), np.float32)
    for c, p in enumerate(parts):
        p = prng.permutation(p)
        take[c, :len(p)] = p
        take[c, len(p):] = p[0] if len(p) else 0
        mask[c, :len(p)] = 1.0

    g = torch.Generator(device=device)
    g.manual_seed(_seed64(seed, 0))

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    templates = randn(ncls, h, w, ch)
    for _ in range(2):  # low-frequency structure
        templates = (templates
                     + torch.roll(templates, 1, 1)
                     + torch.roll(templates, -1, 1)
                     + torch.roll(templates, 1, 2)
                     + torch.roll(templates, -1, 2)) / 5.0

    def images(y):
        yt = torch.as_tensor(y, device=device)
        x = templates[yt] + randn(len(y), h, w, ch) * tr["noise"]
        return x + randn(len(y), 1, 1, ch) * tr["shift"]

    x_tr = images(y_tr)
    xs = x_tr[torch.as_tensor(take.reshape(-1), device=device)]
    del x_tr
    out = {
        "xs": xs.view(len(parts), nb, bsz, h, w, ch).cpu().numpy(),
        "ys": y_tr[take].reshape(len(parts), nb, bsz),
        "mask": mask.reshape(len(parts), nb, bsz),
        "n": np.asarray([max(len(p), 1) for p in parts], np.int64),
        "test_x": images(y_te).cpu().numpy(),
        "test_y": y_te,
    }
    out["valid"] = out["mask"].max(axis=2) > 0
    return out


def data_to(data: Dict, device) -> Dict:
    """The host data as device tensors (``valid`` and ``n`` stay)."""
    out = {k: torch.as_tensor(data[k], device=device)
           for k in ("xs", "ys", "mask", "test_x", "test_y")}
    out["valid"], out["n"] = data["valid"], data["n"]
    return out


def make_weights(cfg: Dict, seed: int, device):
    """(params, state) nested dicts of float32 leaves on ``device``:
    He-normal convolution and dense weights from one normal draw, unit
    BatchNorm scales, zero biases, zero means and unit variances."""
    pspecs, sspecs = models.leaf_specs(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(_seed64(seed, 1))
    he = [s for s in pspecs if s[2] == "he"]
    draw = torch.randn(sum(int(np.prod(s[1])) for s in he), generator=g,
                       device=device)

    def leaves(specs):
        pairs, off = [], 0
        for path, shape, init, fan_in in specs:
            if init == "he":
                n = int(np.prod(shape))
                v = draw[off:off + n].view(shape) * float(
                    np.float32(np.sqrt(2.0 / fan_in)))
                off += n
            elif init == "ones":
                v = torch.ones(shape, device=device)
            else:
                v = torch.zeros(shape, device=device)
            pairs.append((path, v))
        return models.unflatten(pairs)

    return leaves(pspecs), leaves(sspecs)
