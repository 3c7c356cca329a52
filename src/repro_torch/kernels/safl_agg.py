"""SAFL server-channel kernels: hand-written CUDA for Hopper, each beside
its plain PyTorch version.

  * :func:`safl_fold` replaces ``repro/kernels/safl_agg.py:221 safl_fold``
    (the streaming accumulate-on-arrival fold, once per semi-async upload).
  * :func:`safl_aggregate` replaces ``repro/kernels/safl_agg.py:136
    safl_aggregate`` (the buffered K-way reduction with the server step
    fused, once per sync round).

Routing: a wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel (``csrc/safl_agg.cu``, built at first use
by :mod:`repro_torch.kernels.build`) or raises.  There is no other switch.
Each wrapper counts its kernel launches in ``<wrapper>.launches``.

Both kernels are bound by memory bandwidth: fold moves 3*D*4 bytes, the
aggregate (K+2)*D*4 (fedsgd/mix) or (K+1)*D*4 (avg/sum), against a few
flops per element.  The design is a simple coalesced streaming pass with
a grid-stride loop; ``float4`` loads, TMA and ``wgmma`` buy nothing a
bandwidth-bound pass needs first.  Every product and sum in the kernels
uses round-to-nearest intrinsics that are never contracted into an FMA,
and the plain versions below do the same operations in the same order,
so kernel and plain version agree bitwise (the polynomial discount's
``powf`` excepted), and a chain of folds equals one aggregate bitwise.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build

DISCOUNTS = ("none", "poly")
MODES = {"fedsgd": 0, "avg": 1, "mix": 2, "sum": 3}
#: most rows the aggregate kernel takes: its K weights live in one block's
#: shared memory (48 KB without an opt-in)
MAX_K = 4096


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with every function's C signature declared
    (pointers and the stream as void*, D and K as int64)."""
    lib = build.load("safl_agg")
    p, f, i64 = ctypes.c_void_p, ctypes.c_float, ctypes.c_int64
    lib.safl_fold_f32.argtypes = [p, p, p, f, f, i64, p]
    lib.safl_fold_f32.restype = ctypes.c_int
    lib.safl_aggregate_f32.argtypes = [p, p, p, p, i64, i64, f, f,
                                       ctypes.c_int, ctypes.c_int, p]
    lib.safl_aggregate_f32.restype = ctypes.c_int
    return lib


def _check_f32(name: str, t: torch.Tensor, shape, device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")


# ---------------------------------------------------------------------------
# streaming fold: o = beta*acc + w*vec
# ---------------------------------------------------------------------------


def safl_fold_plain(acc: torch.Tensor, vec: torch.Tensor, w,
                    beta=1.0) -> torch.Tensor:
    """Plain version of :func:`safl_fold` (any device)."""
    wv = float(np.float32(w)) * vec
    if float(np.float32(beta)) == 1.0:
        return acc + wv
    return float(np.float32(beta)) * acc + wv


def safl_fold(acc: torch.Tensor, vec: torch.Tensor, w, beta=1.0, *,
              out: torch.Tensor = None) -> torch.Tensor:
    """acc (D,) f32 running sum, vec (D,) one arriving upload, w its final
    ingest weight, beta the decay on acc -> beta*acc + w*vec.  Replaces
    the TPU kernel ``repro/kernels/safl_agg.py:221 safl_fold``.

    ``out`` may be ``acc`` itself (the in-place fold into a bank row).
    beta == 1 runs a separate kernel instantiation that never multiplies
    acc, as the reference keeps beta a compile-time constant outside
    fedasync.  Bound: 3*D*4 bytes."""
    if acc.device.type == "cpu":
        res = safl_fold_plain(acc, vec, w, beta)
        if out is None:
            return res
        out.copy_(res)
        return out
    if acc.device.type != "cuda":
        raise ValueError(f"safl_fold: unsupported device {acc.device}")
    d = acc.shape[0]
    _check_f32("acc", acc, (d,), acc.device)
    _check_f32("vec", vec, (d,), acc.device)
    if out is None:
        out = torch.empty_like(acc)
    _check_f32("out", out, (d,), acc.device)
    rc = _lib().safl_fold_f32(
        acc.data_ptr(), vec.data_ptr(), out.data_ptr(),
        float(np.float32(w)), float(np.float32(beta)), d,
        torch.cuda.current_stream(acc.device).cuda_stream)
    _raise_on(rc, "safl_fold")
    safl_fold.launches += 1
    return out


safl_fold.launches = 0


# ---------------------------------------------------------------------------
# buffered K-way aggregate with the server step fused
# ---------------------------------------------------------------------------


def _check_mode(mode: str, discount: str, p) -> None:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {tuple(MODES)}")
    if discount not in DISCOUNTS:
        raise ValueError(f"discount {discount!r} not in {DISCOUNTS}")
    if mode in ("fedsgd", "mix") and p is None:
        raise ValueError(f"mode={mode!r} needs params p")


def safl_aggregate_plain(u: torch.Tensor, w: torch.Tensor,
                         p: torch.Tensor = None, *, server_lr: float = 1.0,
                         mode: str = "fedsgd", alpha: float = 0.5,
                         discount: str = "none") -> torch.Tensor:
    """Plain version of :func:`safl_aggregate` (any device).  Reduces over
    K in the fold's order, ``acc = acc + w[k]*u[k]`` for k = 0..K-1, and
    sums the weights in the same order, so a chain of
    :func:`safl_fold_plain` calls equals this bitwise."""
    _check_mode(mode, discount, p)
    wv = w.to(torch.float32)
    if discount == "poly":
        wv = torch.pow(1.0 + wv, -alpha)
    acc = torch.zeros(u.shape[1], dtype=torch.float32, device=u.device)
    wsum = torch.zeros((), dtype=torch.float32, device=u.device)
    for k in range(u.shape[0]):
        acc = acc + wv[k] * u[k]
        wsum = wsum + wv[k]
    if mode == "sum":
        return acc
    if mode == "mix":
        return (1.0 - wsum) * p + acc
    g = acc / torch.clamp(wsum, min=1e-12)
    if mode == "avg":
        return g
    return p - server_lr * g


def safl_aggregate(u: torch.Tensor, w: torch.Tensor, p: torch.Tensor = None,
                   *, server_lr: float = 1.0, mode: str = "fedsgd",
                   alpha: float = 0.5,
                   discount: str = "none") -> torch.Tensor:
    """u (K, D) f32 rows, w (K,) weights (or staleness with
    ``discount="poly"``, read as (1+tau)^-alpha), p (D,) params for
    fedsgd/mix -> (D,):

      fedsgd  p - lr * (w@u)/max(sum w, 1e-12)
      avg     (w@u)/max(sum w, 1e-12)
      mix     (1 - sum w)*p + w@u
      sum     w@u

    Replaces the TPU kernel ``repro/kernels/safl_agg.py:136
    safl_aggregate``.  Bound: (K+2)*D*4 bytes for fedsgd/mix, (K+1)*D*4
    for avg/sum."""
    _check_mode(mode, discount, p)
    if u.device.type == "cpu":
        return safl_aggregate_plain(u, w, p, server_lr=server_lr, mode=mode,
                                    alpha=alpha, discount=discount)
    if u.device.type != "cuda":
        raise ValueError(f"safl_aggregate: unsupported device {u.device}")
    if u.dim() != 2:
        raise ValueError(f"u: expected (K, D), got {tuple(u.shape)}")
    k, d = u.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K={k} outside [1, {MAX_K}]")
    _check_f32("u", u, (k, d), u.device)
    _check_f32("w", w, (k,), u.device)
    if p is not None:
        _check_f32("p", p, (d,), u.device)
    out = torch.empty(d, dtype=torch.float32, device=u.device)
    rc = _lib().safl_aggregate_f32(
        u.data_ptr(), w.data_ptr(), None if p is None else p.data_ptr(),
        out.data_ptr(), k, d, float(np.float32(server_lr)),
        float(np.float32(alpha)), MODES[mode], int(discount == "poly"),
        torch.cuda.current_stream(u.device).cuda_stream)
    _raise_on(rc, "safl_aggregate")
    safl_aggregate.launches += 1
    return out


safl_aggregate.launches = 0
