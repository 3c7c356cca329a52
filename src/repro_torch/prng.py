"""Counter-keyed PRNG: a numpy ``threefry2x32`` that gives the bits of
``jax.random`` under JAX's default threefry implementation with
``jax_threefry_partitionable=True`` (the default since JAX 0.5).

  * :func:`prng_key` is ``jax.random.PRNGKey(seed)``: the pair (0, seed).
  * :func:`fold_in` is ``jax.random.fold_in``: threefry2x32 of the key
    over the counter pair (0, data).
  * :func:`split` is ``jax.random.split(key, n)``: key i is both output
    words of threefry2x32 over the counter pair (0, i).
  * :func:`uniform` is ``jax.random.uniform(key, shape)`` (f32, [0, 1)):
    32 random bits per lane, lane i the xor of the two output words of
    threefry2x32 over the counter pair (0, i), the top 23 bits put under
    the exponent of 1.0, minus 1.
  * :func:`normal` is ``jax.random.normal(key, shape)`` (f32) to a few
    ulp: ``f32(sqrt 2) * erfinv(u)`` with u uniform on
    (nextafter(-1, 0), 1) from the same bits, erfinv being XLA's f32
    polynomial (Giles), its steps single-rounded as XLA's FMA.  The
    log1p inside is the platform's, not XLA's, so about 1 % of lanes
    differ from ``jax.random.normal`` by 1-3 ulp.

Draws are keyed by (seed, client, counter) only, never by the order in
which they are made.  Keys are host numpy (:func:`prng_key`,
:func:`fold_in` and :func:`split` are threefry calls of a few lanes).
Two twins of the draws:

  * :func:`uniform` and :func:`normal`, host numpy: the fault plan
    (:mod:`repro_torch.faults`) draws a few uniform lanes per upload;
    :func:`normal` is the host twin the torch one is checked against;
  * :func:`uniform_torch` and :func:`normal_torch`, the same bits made
    by integer PyTorch ops on a tensor's device: for the q4 wire's
    stochastic rounding, which draws one lane per coordinate of every
    upload (2.15 M at the paper CNN's width), so the draws never cross
    from the host, and for the model inits (the paper CNN's drawn on the
    CPU, the transformer's 2.04 G lanes at qwen3-1.7b's full width on
    its device).
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


def split(key: Key, n: int) -> np.ndarray:
    """``jax.random.split(key, n)``: (n, 2) uint32, one key per row."""
    n = int(n)
    a, b = threefry2x32(key, np.zeros(n, _U32), np.arange(n, dtype=_U32))
    return np.stack([a, b], axis=1)


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


#: XLA's f32 erfinv (Giles): coefficients of the w < 5 and w >= 5
#: branches, highest degree first
_ERFINV_LT5 = np.float32([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                          -4.39150654e-06, 0.00021858087, -0.00125372503,
                          -0.00417768164, 0.246640727, 1.50140941])
_ERFINV_GE5 = np.float32([-0.000200214257, 0.000100950558, 0.00134934322,
                          -0.00367342844, 0.00573950773, -0.0076224613,
                          0.00943887047, 1.00167406, 2.83297682])
#: the lower end of ``normal``'s uniform: nextafter(-1, 0) in f32
_NORMAL_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))
_SQRT2 = np.float32(np.sqrt(2.0))
_F32_MAX = float(np.finfo(np.float32).max)


def _erfinv(x, xp, to):
    """XLA's f32 erfinv of the f32 array ``x`` in the array module ``xp``
    (numpy or torch; ``to(a, "float64")`` casts): w = -log1p(-x*x);
    below 5, p(w - 2.5), else p(sqrt(w) - 3); the result p * x, and +-inf
    at +-1.  Each Horner step ``c + p*w`` is one FMA in XLA: here the
    product of two f32 is exact in f64 and the sum is rounded from f64 to
    f32 (twice rounded, which parts from one FMA in far fewer lanes than
    the platform's log1p parts from XLA's)."""
    w = -xp.log1p(-(x * x))
    lt = w < 5.0
    w = to(xp.where(lt, w - 2.5, xp.sqrt(w) - 3.0), "float64")
    p = None
    for lo, hi in zip(_ERFINV_LT5.tolist(), _ERFINV_GE5.tolist()):
        c = to(xp.where(lt, lo, hi), "float64")
        p = c if p is None else to(to(p * w + c, "float32"), "float64")
    r = to(p, "float32") * x
    return xp.where(xp.abs(x) == 1.0, x * _F32_MAX, r)


def _np_to(a, dtype):
    return a.astype(dtype)


def _torch_to(a, dtype):
    return a.to(getattr(torch, dtype))


def normal(key: Key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)``: standard normal f32, to a few
    ulp (see the module docstring)."""
    shape = tuple(int(x) for x in np.atleast_1d(shape))
    n = int(np.prod(shape, dtype=np.int64))
    bits = _random_bits(key, n)
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) \
        - np.float32(1.0)
    u = np.maximum(_NORMAL_LO, f * np.float32(2.0) + _NORMAL_LO)
    return (_SQRT2 * _erfinv(u, np, _np_to)).reshape(shape)


_MASK = 0xFFFFFFFF


def _rotl_t(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def _bits_torch(key: Key, start: int, n: int, device) -> torch.Tensor:
    """Lanes ``start .. start + n`` of :func:`_random_bits`, as int64 in
    [0, 2**32) on ``device``: threefry2x32 in int64 PyTorch ops, every
    word held in [0, 2**32) by masking after each add and shift (integer
    ops are exact on every device, so the bits equal the numpy twin's)."""
    k0, k1 = (int(v) for v in np.asarray(key, _U32))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x1 = torch.arange(start, start + n, dtype=torch.int64, device=device)
    x0 = torch.full_like(x1, ks[0])
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl_t(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _MASK
    return x0 ^ x1


def _unit_torch(bits: torch.Tensor) -> torch.Tensor:
    """The top 23 bits under the exponent of 1.0, minus 1: f32 in
    [0, 1)."""
    return (bits >> 9 | 0x3F800000).to(torch.int32).view(torch.float32) \
        - 1.0


def _lanes(shape) -> Tuple[tuple, int]:
    shape = tuple(int(x) for x in np.atleast_1d(shape))
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 2 ** 32:
        raise ValueError(f"{n} lanes exceed the 32-bit counter")
    return shape, n


def uniform_torch(key: Key, shape, device) -> torch.Tensor:
    """:func:`uniform` made on ``device``, bit for bit.  Returns f32 in
    [0, 1) of ``shape``."""
    shape, n = _lanes(shape)
    f = _unit_torch(_bits_torch(key, 0, n, device))
    return torch.clamp(f, min=0.0).reshape(shape)


#: lanes per pass of :func:`normal_torch`: its int64 and f64 temporaries
#: stay at 128 MB each
NORMAL_CHUNK = 1 << 24


def normal_torch(key: Key, shape, device) -> torch.Tensor:
    """:func:`normal` made on ``device``: the same bits and the same
    erfinv steps in PyTorch ops, in passes of :data:`NORMAL_CHUNK` lanes
    (the bits of lane i depend on i alone).  Equal to the numpy twin
    except where the two platforms' f32 log1p differ (a few ulp)."""
    shape, n = _lanes(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    lo = float(_NORMAL_LO)
    for start in range(0, n, NORMAL_CHUNK):
        m = min(NORMAL_CHUNK, n - start)
        u = torch.clamp(_unit_torch(_bits_torch(key, start, m, device))
                        * 2.0 + lo, min=lo)
        out[start:start + m] = float(_SQRT2) * _erfinv(u, torch, _torch_to)
    return out.reshape(shape)
