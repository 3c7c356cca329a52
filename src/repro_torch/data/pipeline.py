"""Batching pipeline: turn (dataset, partition) into padded per-client shard
arrays (a numpy copy of the reference's pipeline).

Every client shard is cut into batches of ``batch_size`` and padded to the
*global* max batch count so all clients share one shape; a (n_batches,
batch) float mask marks real samples.  A held-out test split is produced
before partitioning.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.data.partition import partition
from repro_torch.data.synthetic import Dataset


def train_test_split(ds: Dataset, test_frac: float = 0.15,
                     seed: int = 0) -> Tuple[Dataset, Dataset]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds.y))
    n_test = int(len(idx) * test_frac)
    te, tr = idx[:n_test], idx[n_test:]
    mk = lambda ii: Dataset(ds.x[ii], ds.y[ii], ds.n_classes, ds.kind,
                            roles=None if ds.roles is None else ds.roles[ii])
    return mk(tr), mk(te)


def build_client_shards(ds: Dataset, scheme: str, n_clients: int,
                        batch_size: int, seed: int = 0,
                        **scheme_kw) -> List[Dict[str, np.ndarray]]:
    if scheme == "by_role":
        scheme_kw["roles"] = ds.roles
    parts = partition(scheme, ds.y, n_clients, seed=seed, **scheme_kw)
    # global max batch count so one jitted epoch program serves all clients
    max_n = max(len(p) for p in parts)
    n_batches = max(1, -(-max_n // batch_size))
    shards = []
    rng = np.random.default_rng(seed + 1)
    for p in parts:
        p = rng.permutation(p)
        n = len(p)
        pad = n_batches * batch_size - n
        take = np.concatenate([p, p[np.zeros(pad, dtype=int)]]) if n else \
            np.zeros(n_batches * batch_size, dtype=int)
        xs = ds.x[take].reshape((n_batches, batch_size) + ds.x.shape[1:])
        ys = ds.y[take].reshape((n_batches, batch_size) + ds.y.shape[1:])
        mask = (np.arange(n_batches * batch_size) < n).astype(np.float32)
        mask = mask.reshape(n_batches, batch_size)
        shards.append({"xs": xs, "ys": ys, "mask": mask, "n": max(n, 1)})
    return shards


def label_histogram(ds: Dataset, parts: List[np.ndarray]) -> np.ndarray:
    n_classes = ds.n_classes
    out = np.zeros((len(parts), n_classes), np.int64)
    for i, p in enumerate(parts):
        binc = np.bincount(ds.y[p].reshape(-1) if ds.kind != "char"
                           else ds.y[p][:, 0], minlength=n_classes)
        out[i] = binc[:n_classes]
    return out
