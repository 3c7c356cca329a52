"""The counter-keyed draws of the q4 wire's stochastic rounding, as
``jax.random`` makes them under its default threefry implementation
(``jax_threefry_partitionable``): Threefry-2x32 with 20 rounds
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", 2011).

  * ``key(seed)`` is the pair (0, seed);
  * ``fold_in(key, n)`` is both output words of threefry over (0, n);
  * ``uniform(key, shape)``: lane i takes the xor of the two output words
    over the counter pair (i >> 32, i & 0xFFFFFFFF), puts its top 23 bits
    under the exponent of 1.0 and subtracts 1.

Keys are made on the host with Python integers; the lanes of a draw in
int64 PyTorch ops on the draw's device, every word masked to 32 bits.
"""
from __future__ import annotations

import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M


def _threefry(k0: int, k1: int, x0, x1):
    """Threefry-2x32 of the key (k0, k1) over the words (x0, x1), which
    are Python ints or int64 tensors holding 32-bit values."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M
    x1 = (x1 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, x1


def key(seed: int) -> tuple:
    return (0, int(seed) & _M)


def fold_in(k: tuple, n: int) -> tuple:
    return _threefry(k[0], k[1], 0, int(n) & _M)


def uniform(k: tuple, n: int, device) -> torch.Tensor:
    """(n,) float32 in [0, 1)."""
    lane = torch.arange(n, dtype=torch.int64, device=device)
    a, b = _threefry(k[0], k[1], lane >> 32, lane & _M)
    bits = a ^ b
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp(f - 1.0, min=0.0)
