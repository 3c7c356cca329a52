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
  * :func:`normal` is ``jax.random.normal(key, shape)`` (f32) bit for
    bit: ``f32(sqrt 2) * erfinv(u)`` with u uniform on
    (nextafter(-1, 0), 1) from the same bits, erfinv being XLA's f32
    polynomial (Giles) over XLA's f32 log1p (:func:`_log1p`), every
    multiply-add rounded once as XLA's FMA.

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
    CPU, the zoo's on its device: 2.04 G lanes at qwen3-1.7b's full
    width); :func:`normal_torch` counts on past 2**32 lanes into the
    counter's high word, as ``jax.random`` does (kimi-k2's expert draws
    hold 5.6 G lanes each);
  * :func:`gumbel_torch` and :func:`categorical_torch`, serving's
    sampling: ``jax.random.gumbel`` over :func:`uniform_range_torch`
    (``jax.random.uniform`` with ``minval`` / ``maxval``) and the Gumbel
    max of ``jax.random.categorical``, bitwise on the CPU;
  * :func:`randint`, ``jax.random.randint`` (int32) bit for bit, in
    integer PyTorch ops: the quickstart's token batch.
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


#: XLA's f32 log: Cephes' logf polynomial, highest degree first, and
#: ln 2 split in two
_LOG_P = [float(np.float32(v)) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)]
_LN2_LO = float(np.float32(-2.12194440e-4))
_LN2_HI = 0.693359375
#: XLA's f32 log1p below sqrt(2) - 1: x - x^2/2 + x^3 * num(x) / den(x)
#: (Cephes), the coefficients highest degree first
_LOG1P_NUM = [float(np.float32(v)) for v in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1)]
_LOG1P_DEN = [float(np.float32(v)) for v in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1)]
_LOG1P_SMALL = float(np.float32(0.41421356237309504880))
_SQRT_HALF = float(np.float32(0.707106781186547524))
_F32_TINY = float(np.finfo(np.float32).tiny)


def _fma(a, b, c, to):
    """``a * b + c`` of f32 operands rounded once, as XLA's FMA: the
    product is exact in f64, the sum is rounded from f64 to f32 (twice
    rounded, which parts from one FMA in about 2^-29 of the sums)."""
    if not isinstance(c, float):
        c = to(c, "float64")
    return to(to(a, "float64") * b + c, "float32")


def _log(v, xp, to, view):
    """XLA's f32 log on the CPU (Eigen's Cephes ``plog``, as XLA's
    optimizer leaves it): frexp of the bits, the fold of the mantissa
    into [sqrt(1/2), sqrt(2)), the degree-9 polynomial in three
    interleaved Horner chains joined by x^3, ln 2 added in two parts;
    each ``a*b + c`` whose product has no other use is one FMA, the rest
    rounded per operation.  0 -> -inf, +inf -> +inf, below 0 or NaN ->
    NaN."""
    t = xp.where(v > _F32_TINY, v, _F32_TINY)
    bits = view(t, "int32")
    m = view((bits & 0x7FFFFF) | 0x3F000000, "float32")
    e = to((bits >> 23) - 127, "float32") + 1.0
    fold = m < _SQRT_HALF
    e = e - to(fold, "float32")
    u = (m - 1.0) + xp.where(fold, m, 0.0)
    x2 = u * u
    x3 = x2 * u
    p = _LOG_P
    y = _fma(_fma(u, p[0], p[1], to), u, p[2], to)
    y1 = _fma(_fma(u, p[3], p[4], to), u, p[5], to)
    y2 = _fma(_fma(u, p[6], p[7], to), u, p[8], to)
    y = _fma(_fma(y, x3, y1, to), x3, y2, to)
    y = _fma(y, x3, e * _LN2_LO, to)
    r = _fma(e, _LN2_HI, (u - x2 * 0.5) + y, to)
    r = xp.where(v > 0.0, r, float("nan"))
    r = xp.where(v == 0.0, float("-inf"), r)
    return xp.where(v == float("inf"), float("inf"), r)


def _log1p(x, xp, to, view):
    """XLA's f32 log1p on the CPU (``EmitLog1p``): ``log(1 + x)`` for
    |x| >= sqrt(2) - 1, below it the rational form, its Horner steps and
    the ``-x^2/2`` term one FMA each."""
    x2 = x * x
    num = den = None
    for cn, cd in zip(_LOG1P_NUM, _LOG1P_DEN):
        # the first step is 0 * x + c: exactly c
        num = cn + 0.0 * x if num is None else _fma(num, x, cn, to)
        den = cd + 0.0 * x if den is None else _fma(den, x, cd, to)
    small = x + _fma(x2, -0.5, (x * x2) * (num / den), to)
    return xp.where(xp.abs(x) < _LOG1P_SMALL, small,
                    _log(x + 1.0, xp, to, view))


def _erfinv(x, xp, to, view):
    """XLA's f32 erfinv of the f32 array ``x`` in the array module ``xp``
    (numpy or torch; ``to(a, "float64")`` casts, ``view(a, "int32")``
    reinterprets): w = -log1p(-x*x) (:func:`_log1p`); below 5,
    p(w - 2.5), else p(sqrt(w) - 3); the result p * x, and +-inf at +-1.
    Each Horner step ``c + p*w`` is one FMA in XLA (:func:`_fma`)."""
    w = -_log1p(-(x * x), xp, to, view)
    lt = w < 5.0
    # the f32 sqrt correctly rounded, from f64 (torch's vectorized f32
    # sqrt on the CPU is not)
    w = xp.where(lt, w - 2.5,
                 to(xp.sqrt(to(w, "float64")), "float32") - 3.0)
    p = None
    for lo, hi in zip(_ERFINV_LT5.tolist(), _ERFINV_GE5.tolist()):
        c = xp.where(lt, lo, hi)
        p = c if p is None else _fma(p, w, c, to)
    r = p * x
    return xp.where(xp.abs(x) == 1.0, x * _F32_MAX, r)


def _np_to(a, dtype):
    return a.astype(dtype)


def _np_view(a, dtype):
    return a.view(dtype)


def _torch_to(a, dtype):
    return a.to(getattr(torch, dtype))


def _torch_view(a, dtype):
    return a.view(getattr(torch, dtype))


def normal(key: Key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)``: standard normal f32, bit for
    bit (see the module docstring)."""
    shape = tuple(int(x) for x in np.atleast_1d(shape))
    n = int(np.prod(shape, dtype=np.int64))
    bits = _random_bits(key, n)
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) \
        - np.float32(1.0)
    u = np.maximum(_NORMAL_LO, f * np.float32(2.0) + _NORMAL_LO)
    return (_SQRT2 * _erfinv(u, np, _np_to, _np_view)).reshape(shape)


_MASK = 0xFFFFFFFF


def _rotl_t(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def _bits_torch(key: Key, start: int, n: int, device) -> torch.Tensor:
    """Lanes ``start .. start + n`` of :func:`_random_bits`, as int64 in
    [0, 2**32) on ``device``: threefry2x32 in int64 PyTorch ops over the
    counter pair (lane >> 32, lane & 0xFFFFFFFF), as ``jax.random`` counts
    past 2**32 lanes; every word held in [0, 2**32) by masking after each
    add and shift (integer ops are exact on every device, so the bits
    equal the numpy twin's)."""
    k0, k1 = (int(v) for v in np.asarray(key, _U32))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    lane = torch.arange(start, start + n, dtype=torch.int64, device=device)
    # the counter pair is the lane's 64-bit index, high word first
    x0 = ((lane >> 32) + ks[0]) & _MASK
    x1 = ((lane & _MASK) + ks[1]) & _MASK
    del lane
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


def _lanes(shape, start: int = 0, limit: int = 2 ** 32) -> Tuple[tuple, int]:
    """(shape, lane count); lanes ``start .. start + n`` must lie below
    ``limit``: 2**32 for a draw made in one pass, which would otherwise
    hold 2**32 int64 words at once (:func:`normal_torch` draws in chunks
    and counts on into the counter's high word)."""
    shape = tuple(int(x) for x in np.atleast_1d(shape))
    n = int(np.prod(shape, dtype=np.int64))
    if start < 0 or start + n >= limit:
        raise ValueError(f"lanes {start} + {n} reach {limit}")
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


def normal_torch(key: Key, shape, device, start: int = 0) -> torch.Tensor:
    """:func:`normal` made on ``device``: the same bits and the same
    erfinv steps in PyTorch ops, in passes of :data:`NORMAL_CHUNK` lanes
    (the bits of lane i depend on i alone).  Equal to the numpy twin
    bit for bit on every device.  ``start`` > 0 gives lanes ``start ..``
    of a larger draw of the same key: a slice along the leading axis of
    a draw too large to make at once."""
    shape, n = _lanes(shape, start, limit=2 ** 62)
    out = torch.empty(n, dtype=torch.float32, device=device)
    if out.device.type == "meta":  # shapes only
        return out.reshape(shape)
    lo = float(_NORMAL_LO)
    for i in range(0, n, NORMAL_CHUNK):
        m = min(NORMAL_CHUNK, n - i)
        u = torch.clamp(_unit_torch(_bits_torch(key, start + i, m, device))
                        * 2.0 + lo, min=lo)
        out[i:i + m] = float(_SQRT2) * _erfinv(u, torch, _torch_to,
                                                _torch_view)
    return out.reshape(shape)


def uniform_range_torch(key: Key, shape, device, minval: float,
                        maxval: float) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=minval, maxval=maxval)``
    (f32) on ``device``: the unit draw ``f`` of :func:`uniform_torch`,
    then ``max(minval, f * (maxval - minval) + minval)`` with the bounds
    and their difference rounded to f32, as ``jax.random`` scales and
    clamps it (the multiply-add rounded once, XLA's FMA)."""
    shape, n = _lanes(shape)
    lo, hi = np.float32(minval), np.float32(maxval)
    span = float(np.float32(hi - lo))
    f = _unit_torch(_bits_torch(key, 0, n, device))
    u = _fma(f, span, float(lo), _torch_to)
    return torch.clamp(u, min=float(lo)).reshape(shape)


_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def _rem_u32(x, span: int):
    """XLA's unsigned remainder: ``x % span``, and ``x`` where ``span`` is
    0."""
    return x if span == 0 else x % span


def _mul_u32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x * m`` wrapped to 32 bits, for ``x`` and ``m`` in [0, 2**32):
    ``m`` in two 16-bit halves, so no int64 product overflows."""
    return (x * (m & 0xFFFF) + (((x * (m >> 16)) & 0xFFFF) << 16)) & _MASK


def randint(key: Key, shape, minval: int, maxval: int,
            device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32, JAX's
    default without 64-bit mode) on ``device``, bit for bit: JAX's
    ``_randint`` in int64 PyTorch ops masked to 32 bits (PyTorch has no
    uint32 remainder on every device).  The key is split in two, each half
    draws a row of 32-bit words (:func:`_bits_torch`); with ``span =
    maxval - minval`` (1 where ``maxval <= minval``, one more where
    ``maxval`` lies past the int32 range) and ``multiplier = (2**16 %
    span)**2 % span``, the draw is ``minval + ((hi % span) * multiplier +
    lo % span) % span``, every product and sum wrapped to 32 bits as
    uint32 arithmetic wraps; the bounds are clipped to int32 first."""
    shape, n = _lanes(shape)
    minval, maxval = int(minval), int(maxval)
    beyond = maxval > _I32_MAX
    lo = min(max(minval, _I32_MIN), _I32_MAX)
    hi = min(max(maxval, _I32_MIN), _I32_MAX)
    if hi <= lo:
        span = 1
    else:
        span = (hi - lo + int(beyond)) & _MASK
    mult = _rem_u32(2 ** 16, span)
    mult = _rem_u32((mult * mult) & _MASK, span)
    k1, k2 = split(key, 2)
    higher = _rem_u32(_bits_torch(k1, 0, n, device), span)
    lower = _rem_u32(_bits_torch(k2, 0, n, device), span)
    offset = _rem_u32((_mul_u32(higher, mult) + lower) & _MASK, span)
    out = (offset + lo) & _MASK
    return (out - ((out >> 31) << 32)).to(torch.int32).reshape(shape)


def gumbel_torch(key: Key, shape, device) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (f32, the default "low" mode):
    ``-log(-log(u))`` with u uniform on [tiny, 1), the logs XLA's f32
    log (:func:`_log`).  Bitwise ``jax.random.gumbel`` on the CPU."""
    u = uniform_range_torch(key, shape, device, _F32_TINY, 1.0)
    inner = -_log(u, torch, _torch_to, _torch_view)
    return -_log(inner, torch, _torch_to, _torch_view)


def categorical_torch(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: the Gumbel-max
    trick, ``argmax(gumbel(key, logits.shape) + logits)`` over the last
    axis (the first index of a tie, as ``jnp.argmax``); f32 logits."""
    g = gumbel_torch(key, logits.shape, logits.device)
    return torch.argmax(g + logits, dim=-1)
