"""Counter-keyed PRNG: a numpy ``threefry2x32`` that gives the bits of
``jax.random`` under JAX's default threefry implementation with
``jax_threefry_partitionable=True`` (the default since JAX 0.5).

  * :func:`prng_key` is ``jax.random.PRNGKey(seed)``: the pair (0, seed).
  * :func:`fold_in` is ``jax.random.fold_in``: threefry2x32 of the key
    over the counter pair (0, data).
  * :func:`uniform` is ``jax.random.uniform(key, shape)`` (f32, [0, 1)):
    32 random bits per lane, lane i the xor of the two output words of
    threefry2x32 over the counter pair (0, i), the top 23 bits put under
    the exponent of 1.0, minus 1.

Draws are keyed by (seed, client, counter) only, never by the order in
which they are made.  Keys are host numpy (:func:`prng_key` and
:func:`fold_in` are one-lane threefry calls).  Two twins of the draws:

  * :func:`uniform`, host numpy, for the fault plan
    (:mod:`repro_torch.faults`), which draws a few lanes per upload;
  * :func:`uniform_torch`, the same bits made by integer PyTorch ops on
    a tensor's device, for the q4 wire's stochastic rounding, which
    draws one lane per coordinate of every upload (2.15 M at the paper
    CNN's width), so the draws never cross from the host.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = np.ndarray  # (2,) uint32


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key: Sequence[int], x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds of the key pair over the counter words
    ``x0``, ``x1`` (equal-length uint32 arrays) -> the two output words."""
    k = np.asarray(key, _U32)
    ks = (k[0], k[1], k[0] ^ k[1] ^ _U32(_PARITY))
    x = [np.array(x0, _U32, ndmin=1) + ks[0],
         np.array(x1, _U32, ndmin=1) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in the int32 / uint32 range
    (the range JAX takes without 64-bit mode)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} outside the 32-bit range")
    return np.array([0, seed & 0xFFFFFFFF], _U32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: a new key from a key and a
    non-negative 32-bit integer."""
    data = int(data)
    if not 0 <= data < 2 ** 32:
        raise ValueError(f"fold_in data {data} outside [0, 2**32)")
    a, b = threefry2x32(key, [0], [data])
    return np.array([a[0], b[0]], _U32)


def _random_bits(key: Key, n: int) -> np.ndarray:
    """n uint32 words, lane i = xor of the two words of threefry2x32 over
    (0, i)."""
    if n >= 2 ** 32:
        raise ValueError(f"{n} lanes exceed the 32-bit counter")
    a, b = threefry2x32(key, np.zeros(n, _U32), np.arange(n, dtype=_U32))
    return a ^ b


def uniform(key: Key, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape)``: f32 in [0, 1)."""
    shape = tuple(int(x) for x in np.atleast_1d(shape))
    n = int(np.prod(shape, dtype=np.int64))
    bits = _random_bits(key, n)
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32)
    return np.maximum(np.float32(0.0), f - np.float32(1.0)).reshape(shape)


_MASK = 0xFFFFFFFF


def _rotl_t(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def uniform_torch(key: Key, shape, device) -> torch.Tensor:
    """:func:`uniform` made on ``device``: threefry2x32 in int64 PyTorch
    ops, every word held in [0, 2**32) by masking after each add and
    shift (integer ops are exact on every device, so the bits equal the
    numpy twin's), then the top 23 bits put under the exponent of 1.0.
    Returns f32 in [0, 1) of ``shape``."""
    shape = tuple(int(x) for x in np.atleast_1d(shape))
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 2 ** 32:
        raise ValueError(f"{n} lanes exceed the 32-bit counter")
    k0, k1 = (int(v) for v in np.asarray(key, _U32))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x1 = torch.arange(n, dtype=torch.int64, device=device)
    x0 = torch.full_like(x1, ks[0])
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl_t(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _MASK
    bits = (x0 ^ x1) >> 9 | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(f, min=0.0).reshape(shape)
