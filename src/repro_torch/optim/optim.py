"""Pytree optimizers (SGD, SGD-momentum, AdamW) and the warmup / cosine
schedules: the reference's ``repro/optim/optim.py`` over the port's
nested-dict trees.

    opt = make_optimizer(cfg.optimizer, lr=...)
    state = opt.init(params)
    params, state = opt.update(params, grads, state, step)

Each computes what the reference's jitted train step computes, bit for
bit on the CPU (``tests/test_torch_train.py``), which is not what its
source reads op by op: XLA rewrites the arithmetic and LLVM contracts a
multiply feeding an add into one FMA.

* The schedules run on the host in f32 (numpy scalars; a 0-dim f32 CPU
  tensor out) from an int32 step, as XLA compiles them: a division by a
  constant becomes a multiply by its f32 reciprocal, ``(1 - final_frac)
  * 0.5`` folds into one constant, the ``+ final_frac`` after it is an
  FMA, and ``cos`` is the C library's ``cosf``.
* AdamW's bias corrections ``1 - b ** t`` are the C library's f32
  ``powf`` (XLA's f32 power on the CPU), a subnormal power flushed to 0.
  ``(m / bc1) / (sqrt(v / bc2) + eps)`` is computed as XLA rewrites it,
  ``m / (bc1 * (sqrt(v / bc2) + eps))``; the square root is correctly
  rounded (:func:`_sqrt_`).
* Every ``a * b + c`` that XLA fuses is one FMA here too (:func:`_fma`):
  the moments' ``b * m + (1 - b) * g``, the weight decay ``q + wd * p``
  and each ``p - lr * u``.  Its multiplier is an f64 tensor, so the op
  computes in f64, where the product of two f32 values is exact, and
  rounds to f32 as it stores: one pass on the card, no f64 temporaries.

A coefficient (``b1``, ``1 - b1``, ``wd``, ``eps``) is its f32 rounding,
as the reference's weak types are.  The scalars of an update are moved
to the parameters' device in one copy (:func:`_scalars`), so every
device runs the update on the same f32 values; a division is by such a
device tensor (PyTorch on CUDA turns a division by a host scalar into a
multiply by its reciprocal).

``update`` writes the new parameters and moments into the tensors it was
given and returns those trees, as the reference's launcher donates its
step's buffers (``donate_argnums=(0, 1)``): no second copy of params and
state beside the first.  A leaf's temporaries are at most two tensors of
its size.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch import tree as treemod

Tree = Any
_F32, _F64 = torch.float32, torch.float64
_TINY = np.finfo(np.float32).tiny


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Tree], Tree]
    #: (params, grads, state, step) -> (params, state), written in place
    update: Callable


@functools.lru_cache(maxsize=None)
def _libm(name: str):
    fn = getattr(ctypes.CDLL(ctypes.util.find_library("m")), name)
    fn.argtypes = [ctypes.c_float] * (2 if name == "powf" else 1)
    fn.restype = ctypes.c_float
    return fn


def _step(step) -> int:
    """The step as an int (an int, or a 0-dim tensor on any device)."""
    if isinstance(step, torch.Tensor):
        return int(step.detach().reshape(()).cpu())
    return int(step)


def _tensor(x) -> torch.Tensor:
    return torch.tensor(np.float32(x), dtype=_F32)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    """``lr * (final_frac + (1 - final_frac) * 0.5 * (1 + cos(pi *
    clip(step / total, 0, 1))))`` in f32, as XLA compiles it; ``step`` an
    int or an int tensor -> a 0-dim f32 CPU tensor."""
    f32 = np.float32
    inv = f32(1) / f32(max(total_steps, 1))
    half = f32(f32(1 - final_frac) * f32(0.5))
    floor, lr32, pi = f32(final_frac), f32(lr), f32(np.pi)

    def sched(step):
        frac = min(f32(1), max(f32(0), f32(f32(_step(step)) * inv)))
        u = f32(_libm("cosf")(float(f32(frac * pi)))) + f32(1)
        w = f32(np.float64(u) * np.float64(half) + np.float64(floor))
        return _tensor(w * lr32)
    return sched


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup to ``lr`` over ``warmup`` steps (``min(step / max(warmup,
    1), 1)``, the division a multiply by the f32 reciprocal), then
    :func:`cosine_schedule` over the remaining ``total_steps - warmup``."""
    f32 = np.float32
    cos = cosine_schedule(lr, total_steps - warmup, final_frac)
    inv, lr32 = f32(1) / f32(max(warmup, 1)), f32(lr)

    def sched(step):
        s = _step(step)
        if s < warmup:
            return _tensor(min(f32(f32(s) * inv), f32(1)) * lr32)
        return cos(s - warmup)
    return sched


def _lr_at(lr, step) -> torch.Tensor:
    return lr(step) if callable(lr) else _tensor(lr)


def _bias_correction(b: float, t: int) -> torch.Tensor:
    """f32 ``1 - b ** t``, the power the C library's ``powf`` flushed to 0
    below the smallest normal, as XLA computes it on the CPU."""
    r = np.float32(_libm("powf")(float(np.float32(b)), float(t)))
    return _tensor(np.float32(1) - (np.float32(0) if abs(r) < _TINY else r))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
         out: torch.Tensor) -> torch.Tensor:
    """``out = a * b + c`` rounded once to f32, as XLA's fused multiply-add:
    ``a`` a (1,) f64 tensor (:func:`_scalars`), so the op computes in f64,
    where the product of two f32 values is exact; ``out`` (f32) may be
    ``b`` or ``c``."""
    return torch.addcmul(c, b, a, out=out)


def _sqrt_(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (XLA's and CUDA's), in place:
    on the CPU through f64, since PyTorch's vectorized f32 sqrt there is
    not correctly rounded."""
    if x.device.type == "cpu":
        return x.copy_(torch.sqrt(x.to(_F64)))
    return x.sqrt_()


def _scalars(values, device) -> list:
    """f32 values (numbers or 0-dim f32 CPU tensors) -> (1,) f64 tensors on
    ``device`` holding them exactly (one copy)."""
    x = torch.tensor([float(v) for v in values], dtype=_F64).to(device)
    return [x[i:i + 1] for i in range(len(values))]


def _as_f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == _F32 else t.to(_F32)


def _store(dst: torch.Tensor, t32: torch.Tensor) -> None:
    if t32 is not dst:
        dst.copy_(t32)


def _apply(leaf_fn, params: Tree, grads: Tree, slots: Dict[str, Tree]):
    """``leaf_fn(g, p, *slots)`` writes each leaf's new values into ``p``
    and its slots -> (params, {name: slot tree}), the trees given."""
    names = sorted(slots)
    with torch.no_grad():
        for g, p, *s in zip(treemod.tree_leaves(grads),
                            treemod.tree_leaves(params),
                            *(treemod.tree_leaves(slots[n]) for n in names)):
            leaf_fn(g, p, *s)
    return params, slots


def _device(params: Tree) -> torch.device:
    leaves = treemod.tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def sgd(lr=1e-2) -> Optimizer:
    def init(params):
        return {}

    def update(params, grads, state, step):
        (neg_eta,) = _scalars([-_lr_at(lr, step)], _device(params))

        def leaf(g, p):
            p32 = _as_f32(p)
            _store(p, _fma(neg_eta, g.to(p.dtype), p32, out=p32))
        params, _ = _apply(leaf, params, grads, {})
        return params, state

    return Optimizer("sgd", init, update)


def sgdm(lr=1e-2, momentum=0.9) -> Optimizer:
    def init(params):
        return {"m": treemod.tree_map(torch.zeros_like, params)}

    def update(params, grads, state, step):
        neg_eta, mu = _scalars([-_lr_at(lr, step), np.float32(momentum)],
                               _device(params))

        def leaf(g, p, m):
            m32 = _as_f32(m)
            _store(m, _fma(mu, m32, g.to(m.dtype), out=m32))
            p32 = _as_f32(p)
            _store(p, _fma(neg_eta, m.to(p.dtype), p32, out=p32))
        return _apply(leaf, params, grads, {"m": state["m"]})

    return Optimizer("sgdm", init, update)


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.01) -> Optimizer:
    k1, k2 = float(np.float32(1 - b1)), float(np.float32(1 - b2))
    eps32 = float(np.float32(eps))

    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=_F32)  # noqa: E731
        return {"m": treemod.tree_map(z, params),
                "v": treemod.tree_map(z, params)}

    def update(params, grads, state, step):
        t = _step(step) + 1
        f32 = np.float32
        neg_eta, c1, c2, cwd, bc1, bc2 = _scalars(
            [-_lr_at(lr, step), f32(b1), f32(b2), f32(wd),
             _bias_correction(b1, t), _bias_correction(b2, t)],
            _device(params))
        bc1, bc2 = bc1[0].to(_F32), bc2[0].to(_F32)

        def leaf(g, p, m, v):
            g32 = g.to(_F32)
            x = g32 * k1
            _fma(c1, m, x, out=m)  # b1 * m + (1 - b1) * g
            torch.mul(g32, g32, out=x).mul_(k2)
            _fma(c2, v, x, out=v)  # b2 * v + (1 - b2) * g^2
            # m / (bc1 * (sqrt(v / bc2) + eps)), as XLA rewrites it
            _sqrt_(torch.div(v, bc2, out=x)).add_(eps32).mul_(bc1)
            torch.div(m, x, out=x)
            p32 = _as_f32(p)
            _fma(cwd, p32, x, out=x)  # + wd * p
            _store(p, _fma(neg_eta, x, p32, out=p32))
        return _apply(leaf, params, grads, {"m": state["m"],
                                            "v": state["v"]})

    return Optimizer("adamw", init, update)


def make_optimizer(name: str, lr=1e-2, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "sgdm":
        return sgdm(lr, kw.get("momentum", 0.9))
    if name == "adamw":
        return adamw(lr, **{k: v for k, v in kw.items()
                            if k in ("b1", "b2", "eps", "wd")})
    raise ValueError(name)
