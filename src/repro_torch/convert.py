"""Carry parameters, model state and optimizer state across from the JAX
reference as numpy arrays."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    """One leaf, its dtype kept: a bf16 array (``ml_dtypes.bfloat16``,
    which ``torch.from_numpy`` does not take) through a ``uint16`` view of
    its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree: Dict[str, object], device) -> Dict[str, object]:
    """The reference's params dict, its non-trainable model state or its
    optimizer state (the leaves numpy arrays; nested dicts allowed, as the
    decoder's params, ResNet-18's params and BatchNorm state ``{"bn0":
    {"mean", "var"}, "s0b0": {"bn1": ...}}`` and the optimizers' ``{}``
    (sgd), ``{"m": params-like}`` (sgdm) and ``{"m", "v": params-like,
    f32}`` (adamw) nest them; a leading pod axis, as the FL step's, kept)
    -> the same dict of tensors on
    ``device``, each of its leaf's dtype (f32 stays f32, bf16 arrives as
    bf16 bit for bit), layouts kept as they are (HWIO conv weights,
    (in, out) dense weights, the decoder's layers stacked on axis 0, the
    hybrid's Mamba2 layers on axes 0 and 1 as (group, layer)), which is
    what this package's models and optimizers take."""
    return {k: params_from_jax(v, device) if isinstance(v, dict)
            else _tensor(v, device) for k, v in tree.items()}

