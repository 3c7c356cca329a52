"""What every kernel wrapper of the port checks before a launch: the
route by device, argument types and shapes, the stream, the launch's
return code; and the dry run's route through the models on the meta
device (:func:`meta_trace`, :func:`trips`)."""
from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

#: set inside :func:`meta_trace`
_META_TRACE = contextvars.ContextVar("meta_trace", default=False)
#: the dry run's counter inside ``meta_trace(trip_counter=...)``
_TRIP_COUNTER = contextvars.ContextVar("trip_counter", default=None)


@contextlib.contextmanager
def meta_trace(trip_counter=None):
    """Within this context a wrapper given a meta tensor runs its plain
    version, which propagates shapes and dispatches the operations that
    the dry run counts (:mod:`repro_torch.launch.cost`), with no data.
    Outside it a meta tensor raises, as any device but the CPU and CUDA
    does.  ``trip_counter`` (the dry run's
    :class:`repro_torch.launch.cost.Counter`) makes :func:`trips` run a
    loop's middle step once for many."""
    token = _META_TRACE.set(True)
    trip_token = _TRIP_COUNTER.set(trip_counter)
    try:
        yield
    finally:
        _TRIP_COUNTER.reset(trip_token)
        _META_TRACE.reset(token)


def trips(n: int):
    """``range(n)`` for a Python loop of ``n`` steps alike; inside
    ``meta_trace(trip_counter=...)``, steps 0, 1, 2, ``n - 2`` and
    ``n - 1`` with step 2 counted ``n - 4`` times
    (:mod:`repro_torch.launch.cost` says how that stays exact)."""
    counter = _TRIP_COUNTER.get()
    if counter is None or n < 6:
        yield from range(n)
        return
    yield from range(2)
    with counter.repeat(n - 4) as r:
        yield 2
    with counter.settle(r):
        yield n - 2
    yield n - 1


def on_cuda(t: torch.Tensor, kernel: str) -> bool:
    """False for a CPU tensor (run the plain version), True for a CUDA one
    (launch); a meta tensor inside :func:`meta_trace` runs the plain
    version too; any other device raises."""
    if t.device.type == "cpu" or (t.device.type == "meta"
                                  and _META_TRACE.get()):
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {t.device}")
    return True


def check(name: str, t: torch.Tensor, shape, device,
          dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def raise_on(rc: int, kernel: str) -> None:
    """Raise on a C entry point's nonzero return (a refused launch)."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the C side takes
    it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def f32(x) -> float:
    """A host scalar rounded to f32, as the kernels take it."""
    return float(np.float32(x))
