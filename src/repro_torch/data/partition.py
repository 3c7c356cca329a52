"""Federated partition schemes (paper §4.2).

Each function maps a dataset's label array to a list of per-client index
arrays:

  * ``iid``                  — shuffle, equal split (image & text IID)
  * ``shards``               — equal quantity, only N labels per client (§4.2.1)
  * ``unbalanced_dirichlet`` — identical label distribution, quantities
                               ~ LogNormal(0, σ²) (§4.2.2)
  * ``hetero_dirichlet``     — per-class Dirichlet(α) split across clients:
                               unequal quantities AND distributions (§4.2.3)
  * ``by_role``              — Shakespeare: clients get distinct speaker
                               roles (§4.2.4)
  * ``lognormal_text``       — Sentiment140: volumes ~ LogNormal(0, σ²)
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def iid(labels: np.ndarray, n_clients: int, seed: int = 0,
        **_) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(labels))
    return [np.sort(s) for s in np.array_split(idx, n_clients)]


def shards(labels: np.ndarray, n_clients: int, n_labels: int = 2,
           seed: int = 0, **_) -> List[np.ndarray]:
    """Each client holds an equal quantity drawn from only ``n_labels``
    classes (paper: N=2 extreme ... N=10 even)."""
    rng = np.random.default_rng(seed)
    order = np.argsort(labels, kind="stable")
    n_shards = n_clients * n_labels
    shard_list = np.array_split(order, n_shards)
    assign = rng.permutation(n_shards)
    out = []
    for c in range(n_clients):
        take = assign[c * n_labels:(c + 1) * n_labels]
        out.append(np.sort(np.concatenate([shard_list[s] for s in take])))
    return out


def unbalanced_dirichlet(labels: np.ndarray, n_clients: int,
                         sigma: float = 0.5, seed: int = 0,
                         **_) -> List[np.ndarray]:
    """Same label mix everywhere; quantity per client ~ LogNormal(0, σ²)."""
    rng = np.random.default_rng(seed)
    weights = rng.lognormal(0.0, sigma, n_clients)
    weights = weights / weights.sum()
    idx = rng.permutation(len(labels))
    counts = np.maximum(1, (weights * len(labels)).astype(int))
    # fix rounding to exactly len(labels)
    while counts.sum() > len(labels):
        counts[np.argmax(counts)] -= 1
    while counts.sum() < len(labels):
        counts[np.argmin(counts)] += 1
    bounds = np.concatenate([[0], np.cumsum(counts)])
    return [np.sort(idx[bounds[i]:bounds[i + 1]]) for i in range(n_clients)]


def hetero_dirichlet(labels: np.ndarray, n_clients: int, alpha: float = 0.5,
                     seed: int = 0, min_per_client: int = 4,
                     **_) -> List[np.ndarray]:
    """For every class, split its samples across clients ~ Dir(α)."""
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
    out = []
    spare = []
    for cid in range(n_clients):
        arr = np.asarray(sorted(client_idx[cid]), dtype=np.int64)
        out.append(arr)
        if len(arr) < min_per_client:
            spare.append(cid)
    # top up starving clients from the largest one
    for cid in spare:
        donor = int(np.argmax([len(a) for a in out]))
        need = min_per_client - len(out[cid])
        out[cid] = np.concatenate([out[cid], out[donor][:need]])
        out[donor] = out[donor][need:]
    return out


def by_role(labels: np.ndarray, n_clients: int,
            roles: Optional[np.ndarray] = None, seed: int = 0,
            **_) -> List[np.ndarray]:
    """Shakespeare non-IID: each client = dialogue lines of distinct
    speaker roles (paper §4.2.4)."""
    assert roles is not None
    rng = np.random.default_rng(seed)
    uniq = rng.permutation(np.unique(roles))
    groups = np.array_split(uniq, n_clients)
    return [np.sort(np.where(np.isin(roles, g))[0]) for g in groups]


def lognormal_text(labels: np.ndarray, n_clients: int, sigma: float = 0.5,
                   seed: int = 0, **_) -> List[np.ndarray]:
    return unbalanced_dirichlet(labels, n_clients, sigma=sigma, seed=seed)


PARTITIONERS = {
    "iid": iid,
    "shards": shards,
    "unbalanced_dirichlet": unbalanced_dirichlet,
    "hetero_dirichlet": hetero_dirichlet,
    "by_role": by_role,
    "lognormal_text": lognormal_text,
}


def partition(name: str, labels: np.ndarray, n_clients: int,
              **kw) -> List[np.ndarray]:
    parts = PARTITIONERS[name](labels, n_clients, **kw)
    assert len(parts) == n_clients
    return parts
