"""Synthetic stand-ins for the paper's five datasets (a numpy copy of the
reference's generators: equal seeds give equal arrays).  Each generator
produces a *class-structured, learnable*
dataset with the same modality/shape/label-space structure as the original;
the paper's scientifically active ingredient — the federated partition — is
applied on top by :mod:`repro_torch.data.partition`.

  cifar10     -> 32x32x3, 10 classes   (class template + noise + color jitter)
  cifar100    -> 32x32x3, 100 classes
  femnist     -> 28x28x1, 62 classes
  shakespeare -> char sequences, vocab 80 (role-conditioned Markov chains;
                 each "role" = one speaking character, the paper's non-IID unit)
  sentiment140-> token sequences, vocab 1000, 2 classes (sentiment lexicon)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Dataset:
    x: np.ndarray  # images (N,H,W,C) float32 or tokens (N,S) int32
    y: np.ndarray  # labels (N,) int32 (char task: y == x, next-char shift)
    n_classes: int
    kind: str  # image | char | sentiment
    roles: Optional[np.ndarray] = None  # shakespeare: speaker id per sample


def _image_dataset(rng, n, hw, ch, n_classes, noise=0.35) -> Dataset:
    templates = rng.normal(0, 1, (n_classes, hw, hw, ch)).astype(np.float32)
    # low-frequency structure: smooth the templates
    for _ in range(2):
        templates = (templates
                     + np.roll(templates, 1, 1) + np.roll(templates, -1, 1)
                     + np.roll(templates, 1, 2) + np.roll(templates, -1, 2)
                     ) / 5.0
    y = rng.integers(0, n_classes, n).astype(np.int32)
    x = templates[y] + rng.normal(0, noise, (n, hw, hw, ch)).astype(
        np.float32)
    shift = rng.normal(0, 0.1, (n, 1, 1, ch)).astype(np.float32)
    return Dataset(x + shift, y, n_classes, "image")


def make_cifar10(n=10_000, seed=0, hw=32) -> Dataset:
    return _image_dataset(np.random.default_rng(seed), n, hw, 3, 10)


def make_cifar100(n=10_000, seed=0, hw=32) -> Dataset:
    return _image_dataset(np.random.default_rng(seed), n, hw, 3, 100)


def make_femnist(n=10_000, seed=0, hw=28) -> Dataset:
    return _image_dataset(np.random.default_rng(seed), n, hw, 1, 62)


def make_shakespeare(n=4_000, seq=48, vocab=80, n_roles=20,
                     seed=0) -> Dataset:
    """Role-conditioned order-1 Markov chains over an 80-symbol alphabet.
    Task: next-character prediction; label array y == tokens (shift applied
    in the loss).  ``roles`` drives the paper's non-IID split (§4.2.4)."""
    rng = np.random.default_rng(seed)
    # each role has a sparse, peaky transition matrix -> learnable
    trans = rng.dirichlet(np.full(vocab, 0.05), (n_roles, vocab))
    roles = rng.integers(0, n_roles, n).astype(np.int32)
    toks = np.zeros((n, seq), np.int32)
    toks[:, 0] = rng.integers(0, vocab, n)
    for t in range(1, seq):
        p = trans[roles, toks[:, t - 1]]
        cum = np.cumsum(p, axis=-1)
        u = rng.random((n, 1))
        toks[:, t] = (u > cum).sum(axis=-1)
    return Dataset(toks, toks.copy(), vocab, "char", roles=roles)


def make_sentiment140(n=8_000, seq=24, vocab=1000, seed=0) -> Dataset:
    """Binary sentiment: positive/negative lexicon tokens mixed with neutral
    filler; label = majority lexicon polarity."""
    rng = np.random.default_rng(seed)
    pos = np.arange(0, 50)
    neg = np.arange(50, 100)
    toks = rng.integers(100, vocab, (n, seq)).astype(np.int32)
    y = rng.integers(0, 2, n).astype(np.int32)
    n_signal = rng.integers(3, 8, n)
    for i in range(n):
        lex = pos if y[i] == 1 else neg
        idx = rng.choice(seq, n_signal[i], replace=False)
        toks[i, idx] = rng.choice(lex, n_signal[i])
    return Dataset(toks, y, 2, "sentiment")


MAKERS = {
    "cifar10": make_cifar10,
    "cifar100": make_cifar100,
    "femnist": make_femnist,
    "shakespeare": make_shakespeare,
    "sentiment140": make_sentiment140,
}


def make_dataset(name: str, n: int, seed: int = 0, **kw) -> Dataset:
    return MAKERS[name](n=n, seed=seed, **kw)
