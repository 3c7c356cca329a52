"""The paper's image-classification models (§4.3): the CNN (3 conv 3x3
stride 1 + 2x2 max-pool + 2 fully connected layers, ReLU), ResNet-18 (4
stages x 2 basic blocks, BatchNorm) and VGG-16 (13 conv + 3 fc).

Functional form over (nested) dicts of tensors, in the reference's
layouts at every public boundary: images are NHWC and conv weights HWIO,
so a flat row (:class:`repro_torch.core.flatbuf.PytreeCodec`) is element
for element the reference's.  The transposes to PyTorch's NCHW/OIHW
happen inside the apply functions.

ResNet-18 carries BatchNorm running statistics as non-trainable
``state``, the payload that makes FedAvg ship more bytes than FedSGD in
the paper's Table 2.  :func:`bn_apply` is the reference's BatchNorm, not
``F.batch_norm``: in training the batch's mean and *biased* variance
over (N, H, W), the zero-padded samples of a partial batch included (the
mask weights the loss only), and ``0.9 * old + 0.1 * batch`` returned as
a new state, nothing updated in place (``torch.func.vmap`` needs that).

Convolutions pad as XLA's ``"SAME"``: (k - 1) / 2 each side at stride
1, but at stride 2 the total ``max((out - 1) * s + k - in, 0)`` is split
low = total // 2, high = the rest, so a 3x3 stride-2 convolution of an
even map pads (0, 1), not PyTorch's (1, 1).
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng, tree
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
    the weights are ``jax.random``'s bit for bit.  Drawn on the CPU and
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


def _same_pads(size: int, k: int, stride: int):
    """XLA's ``"SAME"`` padding of one axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv_same(x: torch.Tensor, w_hwio: torch.Tensor,
               stride: int = 1) -> torch.Tensor:
    """``"SAME"`` convolution of an NCHW map by HWIO weights.  Even pads
    go to ``conv2d``'s own padding; uneven ones (stride 2) are made with
    ``F.pad`` first, so the convolution keeps numeric padding (the
    vmapped wave's unfold + matmul takes no string padding).  A 1x1
    convolution at stride s reads every s-th pixel, so it is that slice
    convolved at stride 1: the same sums, and on the CPU it keeps clear
    of oneDNN's weight gradient of a 1x1 stride-2 convolution of a
    channels-last batch of 17 (the NHWC input's layout), which comes out
    wrong and not the same twice (``tools/branch_points.py onednn``)."""
    kh, kw = w_hwio.shape[0], w_hwio.shape[1]
    (t, b), (lft, r) = (_same_pads(x.shape[2], kh, stride),
                        _same_pads(x.shape[3], kw, stride))
    w = w_hwio.permute(3, 2, 0, 1)
    if kh == kw == 1 and t == b == lft == r == 0:
        return F.conv2d(x[:, :, ::stride, ::stride].contiguous(), w)
    if t == b and lft == r:
        return F.conv2d(x, w, stride=stride, padding=(t, lft))
    return F.conv2d(F.pad(x, (lft, r, t, b)), w, stride=stride)


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


# ---------------------------------------------------------------------------
# BatchNorm with running statistics
# ---------------------------------------------------------------------------


def bn_init(c: int):
    return ({"scale": torch.ones(c), "bias": torch.zeros(c)},
            {"mean": torch.zeros(c), "var": torch.ones(c)})


def bn_apply(params, state, x: torch.Tensor, train: bool, momentum=0.9,
             eps=1e-5):
    """The reference's ``bn_apply`` on an NCHW map -> (y, new state)."""
    if train:
        mean = torch.mean(x, dim=(0, 2, 3))
        var = torch.mean(torch.square(x - mean[:, None, None]),
                         dim=(0, 2, 3))
        new_state = {"mean": momentum * state["mean"]
                     + (1 - momentum) * mean,
                     "var": momentum * state["var"] + (1 - momentum) * var}
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    inv = torch.rsqrt(var + eps)
    y = ((x - mean[:, None, None]) * inv[:, None, None]
         * params["scale"][:, None, None] + params["bias"][:, None, None])
    return y, new_state


# ---------------------------------------------------------------------------
# ResNet-18 (§4.3.2)
# ---------------------------------------------------------------------------


def _stages(width: int):
    return [(width, 1), (width * 2, 2), (width * 4, 2), (width * 8, 2)]


def _basic_block_init(key: prng.Key, cin: int, cout: int, stride: int):
    ks = prng.split(key, 3)
    p1, s1 = bn_init(cout)
    p2, s2 = bn_init(cout)
    p = {"c1": _he_normal(ks[0], (3, 3, cin, cout), 9 * cin), "bn1": p1,
         "c2": _he_normal(ks[1], (3, 3, cout, cout), 9 * cout), "bn2": p2}
    s = {"bn1": s1, "bn2": s2}
    if stride != 1 or cin != cout:
        pd, sd = bn_init(cout)
        p["down"] = _he_normal(ks[2], (1, 1, cin, cout), cin)
        p["bnd"] = pd
        s["bnd"] = sd
    return p, s


def _basic_block_apply(p, s, x, stride: int, train: bool):
    h, s1 = bn_apply(p["bn1"], s["bn1"], _conv_same(x, p["c1"], stride),
                     train)
    h = F.relu(h)
    h, s2 = bn_apply(p["bn2"], s["bn2"], _conv_same(h, p["c2"]), train)
    news = {"bn1": s1, "bn2": s2}
    if "down" in p:
        x, sd = bn_apply(p["bnd"], s["bnd"],
                         _conv_same(x, p["down"], stride), train)
        news["bnd"] = sd
    return F.relu(h + x), news


def resnet18_init(key: prng.Key, *, in_ch=3, n_classes=10, width=64,
                  device="cuda"):
    """ResNet-18 from a reference key, consumed as the reference's
    ``resnet18_init`` consumes it (``split(key, 10)``: the stem, 8
    blocks of ``split(k, 3)``, the classifier) -> (params, BatchNorm
    state), both on ``device``."""
    device = resolve_device(device)
    ks = prng.split(key, 2 + 8)
    p_stem, s_stem = bn_init(width)
    params = {"stem": _he_normal(ks[0], (3, 3, in_ch, width), 9 * in_ch),
              "bn0": p_stem}
    state = {"bn0": s_stem}
    cin, i = width, 1
    for si, (cout, stride) in enumerate(_stages(width)):
        for bi in range(2):
            p, s = _basic_block_init(ks[i], cin, cout,
                                     stride if bi == 0 else 1)
            params[f"s{si}b{bi}"] = p
            state[f"s{si}b{bi}"] = s
            cin = cout
            i += 1
    params["fc"] = _he_normal(ks[i], (cin, n_classes), cin)
    params["fcb"] = torch.zeros(n_classes)
    to = functools.partial(tree.tree_map, lambda v: v.to(device))
    return to(params), to(state)


def resnet18_apply(params, state, x: torch.Tensor, train: bool,
                   width: int = 64):
    """x (N, H, W, C) -> (logits (N, n_classes), new BatchNorm state)."""
    h = x.permute(0, 3, 1, 2)
    h, s0 = bn_apply(params["bn0"], state["bn0"],
                     _conv_same(h, params["stem"]), train)
    h = F.relu(h)
    news = {"bn0": s0}
    for si, (_, stride) in enumerate(_stages(width)):
        for bi in range(2):
            name = f"s{si}b{bi}"
            h, news[name] = _basic_block_apply(params[name], state[name], h,
                                               stride if bi == 0 else 1,
                                               train)
    h = torch.mean(h, dim=(2, 3))
    return h @ params["fc"] + params["fcb"], news


# ---------------------------------------------------------------------------
# VGG-16 (§4.3.3): 13 conv + 3 fc
# ---------------------------------------------------------------------------

_VGG_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]


def vgg16_init(key: prng.Key, *, in_ch=3, n_classes=10, image_size=32,
               width_mult=1.0, device="cuda"):
    """VGG-16 from a reference key, consumed as the reference's
    ``vgg16_init`` consumes it (``split(key, 16)``: 13 convolutions, 3
    dense layers) -> (params, {}), on ``device``."""
    device = resolve_device(device)
    ks = prng.split(key, 16)
    params = {}
    cin, i = in_ch, 0
    for item in _VGG_PLAN:
        if item == "M":
            continue
        cout = max(8, int(item * width_mult))
        params[f"c{i}"] = _he_normal(ks[i], (3, 3, cin, cout), 9 * cin)
        cin = cout
        i += 1
    feat = (image_size // 32) ** 2 * cin if image_size >= 32 else cin
    params["f1"] = _he_normal(ks[13], (feat, 512), feat)
    params["fb1"] = torch.zeros(512)
    params["f2"] = _he_normal(ks[14], (512, 512), 512)
    params["fb2"] = torch.zeros(512)
    params["f3"] = _he_normal(ks[15], (512, n_classes), 512)
    params["fb3"] = torch.zeros(n_classes)
    return {k: v.to(device) for k, v in params.items()}, {}


def vgg16_apply(params, state, x: torch.Tensor, train: bool):
    """x (N, H, W, C) -> (logits, state).  Five 2x2 pools: an input
    under 32x32 (the reference launcher's 16x16 images) leaves the last
    pool no pixel, where the reference's ``f1`` matmul raises; here a
    ``ValueError`` names the cause."""
    del train
    h = x.permute(0, 3, 1, 2)
    i = 0
    for item in _VGG_PLAN:
        if item == "M":
            if min(h.shape[2], h.shape[3]) < 2:
                raise ValueError(
                    f"vgg16: a 2x2 max-pool of a {h.shape[2]}x{h.shape[3]} "
                    f"map leaves no pixel (input {x.shape[1]}x"
                    f"{x.shape[2]}; the five pools need at least 32x32)")
            h = F.max_pool2d(h, 2)
        else:
            h = F.relu(_conv_same(h, params[f"c{i}"]))
            i += 1
    # the reference flattens the NHWC tensor: f1's rows are (h, w, c)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.relu(h @ params["f1"] + params["fb1"])
    h = F.relu(h @ params["f2"] + params["fb2"])
    return h @ params["f3"] + params["fb3"], state


# ---------------------------------------------------------------------------
# registry for the FL engine
# ---------------------------------------------------------------------------


def build_paper_model(name: str, key: prng.Key, *, device="cuda", **kw):
    """Returns (params, state, apply_fn) for the paper's image models,
    drawn from the reference key ``key``, on ``device`` (the GPU unless
    the caller asks for the CPU)."""
    if name == "cnn":
        p, s = cnn_init(key, device=device, **kw)
        return p, s, cnn_apply
    if name == "resnet18":
        width = kw.pop("width", 64)
        p, s = resnet18_init(key, width=width, device=device, **kw)
        return p, s, functools.partial(resnet18_apply, width=width)
    if name == "vgg16":
        p, s = vgg16_init(key, device=device, **kw)
        return p, s, vgg16_apply
    raise ValueError(name)
