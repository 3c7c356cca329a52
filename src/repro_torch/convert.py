"""Carry parameters across from the JAX reference as numpy arrays."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_jax(tree: Dict[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    """The reference's params dict (already turned into numpy) -> the same
    dict of float32 tensors on ``device``, layouts kept as they are (HWIO
    conv weights, (in, out) dense weights), which is what this package's
    models take."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in tree.items()}
