"""What every kernel wrapper of the port checks before a launch: the
route by device, argument types and shapes, the stream, the launch's
return code."""
from __future__ import annotations

import numpy as np
import torch


def on_cuda(t: torch.Tensor, kernel: str) -> bool:
    """False for a CPU tensor (run the plain version), True for a CUDA one
    (launch); any other device raises."""
    if t.device.type == "cpu":
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
