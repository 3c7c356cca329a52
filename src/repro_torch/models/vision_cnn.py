"""The paper's image-classification CNN (§4.3.1): 3 conv (3x3, stride 1) +
2x2 max-pool + 2 fully connected layers, ReLU.

Functional form over a dict of tensors, in the reference's layouts at
every public boundary: images are NHWC and conv weights HWIO, so a flat
row (:class:`repro_torch.core.flatbuf.PytreeCodec`) is element for
element the reference's.  The transposes to PyTorch's NCHW/OIHW happen
inside :func:`cnn_apply`.

Only ``cnn`` is ported; ``resnet18`` and ``vgg16`` raise.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.device import resolve_device

Params = Dict[str, torch.Tensor]


def _he_normal(key: prng.Key, shape, fan_in: int) -> torch.Tensor:
    return prng.normal_torch(key, shape, "cpu") * np.float32(
        np.sqrt(2.0 / fan_in))


def cnn_init(key: prng.Key, *, in_ch=3, n_classes=10, image_size=32,
             width=32, device="cuda"):
    """He-normal init from a reference key (:func:`repro_torch.prng.
    prng_key`), consumed as the reference's ``cnn_init`` consumes it
    (``split(key, 5)``, then ``normal(k, shape) * sqrt(2 / fan_in)``), so
    the weights are ``jax.random``'s to a few ulp.  Drawn on the CPU and
    moved to ``device`` (the GPU unless the caller asks for the CPU; no
    GPU raises), so a key gives the same weights on any device."""
    device = resolve_device(device)
    ks = prng.split(key, 5)
    c1, c2, c3 = width, width * 2, width * 2
    feat = (image_size // 2) ** 2 * c3
    params = {
        "c1": _he_normal(ks[0], (3, 3, in_ch, c1), 9 * in_ch),
        "c2": _he_normal(ks[1], (3, 3, c1, c2), 9 * c1),
        "c3": _he_normal(ks[2], (3, 3, c2, c3), 9 * c2),
        "f1": _he_normal(ks[3], (feat, 128), feat),
        "b1": torch.zeros(128),
        "f2": _he_normal(ks[4], (128, n_classes), 128),
        "b2": torch.zeros(n_classes),
    }
    return {k: v.to(device) for k, v in params.items()}, {}


def _conv_same(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    # "SAME" 3x3 stride-1 convolution == padding 1 on each side
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), padding=1)


def cnn_apply(params: Params, state, x: torch.Tensor, train: bool):
    """x (N, H, W, C) -> (logits (N, n_classes), state)."""
    del train  # no dropout / BatchNorm in the paper CNN
    h = x.permute(0, 3, 1, 2)
    h = F.relu(_conv_same(h, params["c1"]))
    h = F.relu(_conv_same(h, params["c2"]))
    h = F.relu(_conv_same(h, params["c3"]))
    h = F.max_pool2d(h, 2)
    # the reference flattens the NHWC tensor: f1's rows are (h, w, c)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.relu(h @ params["f1"] + params["b1"])
    return h @ params["f2"] + params["b2"], state


def build_paper_model(name: str, key: prng.Key, *, device="cuda", **kw):
    """Returns (params, state, apply_fn) for the paper's models, drawn
    from the reference key ``key``, the params on ``device`` (the GPU
    unless the caller asks for the CPU)."""
    if name == "cnn":
        p, s = cnn_init(key, device=device, **kw)
        return p, s, cnn_apply
    if name in ("resnet18", "vgg16"):
        raise NotImplementedError(f"model {name!r} is not ported yet")
    raise ValueError(name)
