"""Carry parameters and model state across from the JAX reference as numpy
arrays."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_jax(tree: Dict[str, object], device) -> Dict[str, object]:
    """The reference's params dict or its non-trainable model state (the
    leaves already numpy arrays; nested dicts allowed, as the decoder's
    params and ResNet-18's params and BatchNorm state ``{"bn0": {"mean",
    "var"}, "s0b0": {"bn1": ...}}`` nest them) -> the same dict of
    float32 tensors on ``device``, layouts kept as they are (HWIO conv
    weights, (in, out) dense weights, the decoder's layers stacked on
    axis 0), which is what this package's models take."""
    return {k: params_from_jax(v, device) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in tree.items()}
