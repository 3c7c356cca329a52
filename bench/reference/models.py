"""Plain PyTorch reference of the paper's two image models (sec. 4.3).

Written from the published descriptions (He et al. 2015, ResNet-18 in
its CIFAR form; Simonyan & Zisserman 2014, VGG-16 configuration D, its
convolutions without bias) and the SAFL paper's reference
implementation, in float32, with no kernel, cache or batching of the
measured program.  Imports nothing of it.

Layouts are the SAFL reference's: images NHWC, convolution weights HWIO,
dense weights (in, out), so the parameters flatten (keys sorted at every
level, as ``jax.tree_util`` orders a dict) into one row per model whose
element order is the reference's.  Convolutions pad as XLA's ``SAME``:
``(k - 1) / 2`` a side at stride 1; at stride 2 the total
``max((out - 1) * s + k - in, 0)`` splits low = total // 2, so a 3x3
stride-2 convolution of an even map pads (0, 1).  A 1x1 stride-s
convolution reads every s-th pixel, so it is that slice convolved at
stride 1.  BatchNorm in training takes the batch mean and the biased
variance over (N, H, W), zero-padded samples of a partial batch
included (the mask weights only the loss), and returns
``0.9 * old + 0.1 * batch`` as the new running statistics.

:func:`leaf_specs` lists every leaf with its shape and initializer;
:func:`forward` runs either model on a (nested) dict of leaves.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Tree = Dict


# ---------------------------------------------------------------- layout
def leaf_specs(cfg: Dict) -> Tuple[List[tuple], List[tuple]]:
    """(params, state) leaf lists of ``cfg``: ``(path, shape, init,
    fan_in)`` with ``init`` one of ``he`` (normal times sqrt(2 / fan_in)),
    ``zeros``, ``ones``.  Paths are ``/``-joined keys."""
    h, w, cin = cfg["image"]
    n_out = cfg["n_classes"]
    params: List[tuple] = []
    state: List[tuple] = []

    def bn(name):
        params.append((f"{name}/scale", (cout_of[name],), "ones", 0))
        params.append((f"{name}/bias", (cout_of[name],), "zeros", 0))
        state.append((f"{name}/mean", (cout_of[name],), "zeros", 0))
        state.append((f"{name}/var", (cout_of[name],), "ones", 0))

    cout_of: Dict[str, int] = {}
    if cfg["family"] == "resnet18":
        width = cfg["width"]
        params.append(("stem", (3, 3, cin, width), "he", 9 * cin))
        cout_of["bn0"] = width
        bn("bn0")
        c = width
        for si, (cout, stride) in enumerate(cfg["stages"]):
            for bi in range(cfg["blocks_per_stage"]):
                s = stride if bi == 0 else 1
                blk = f"s{si}b{bi}"
                params.append((f"{blk}/c1", (3, 3, c, cout), "he", 9 * c))
                cout_of[f"{blk}/bn1"] = cout
                bn(f"{blk}/bn1")
                params.append((f"{blk}/c2", (3, 3, cout, cout), "he",
                               9 * cout))
                cout_of[f"{blk}/bn2"] = cout
                bn(f"{blk}/bn2")
                if s != 1 or c != cout:
                    params.append((f"{blk}/down", (1, 1, c, cout), "he", c))
                    cout_of[f"{blk}/bnd"] = cout
                    bn(f"{blk}/bnd")
                c = cout
        params.append(("fc", (c, n_out), "he", c))
        params.append(("fcb", (n_out,), "zeros", 0))
    elif cfg["family"] == "vgg16":
        c, i, side = cin, 0, h
        for item in cfg["plan"]:
            if item == "M":
                side //= 2
                continue
            cout = max(8, int(item * cfg["width_mult"]))
            params.append((f"c{i}", (3, 3, c, cout), "he", 9 * c))
            c, i = cout, i + 1
        feat = side * side * c
        widths = [feat] + list(cfg["dense"]) + [n_out]
        for j in range(len(widths) - 1):
            params.append((f"f{j + 1}", (widths[j], widths[j + 1]), "he",
                           widths[j]))
            params.append((f"fb{j + 1}", (widths[j + 1],), "zeros", 0))
    else:
        raise ValueError(f"unknown family {cfg['family']!r}")
    return params, state


def sorted_specs(specs: List[tuple]) -> List[tuple]:
    """The leaves in flattening order: keys sorted at every level (a
    path's keys compared level by level as strings)."""
    return sorted(specs, key=lambda s: s[0].split("/"))


def unflatten(pairs) -> Tree:
    """(path, tensor) pairs -> nested dict."""
    out: Tree = {}
    for path, v in pairs:
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out


def flatten(tree: Tree, prefix: str = "") -> List[tuple]:
    """Nested dict -> (path, leaf) pairs, keys sorted at every level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(flatten(v, f"{prefix}{k}/"))
        else:
            out.append((f"{prefix}{k}", v))
    return out


def views(flat: torch.Tensor, specs: List[tuple]) -> Tree:
    """A flat row in flattening order -> nested dict of views into it."""
    pairs, off = [], 0
    for path, shape, *_ in sorted_specs(specs):
        n = 1
        for s in shape:
            n *= s
        pairs.append((path, flat[off:off + n].view(shape)))
        off += n
    return unflatten(pairs)


def ravel(tree: Tree) -> torch.Tensor:
    return torch.cat([v.reshape(-1) for _, v in flatten(tree)])


# --------------------------------------------------------------- layers
def _same(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME convolution of an NCHW map by HWIO weights."""
    kh, kw = int(w.shape[0]), int(w.shape[1])
    top, bottom = _same(x.shape[2], kh, stride)
    left, right = _same(x.shape[3], kw, stride)
    oihw = w.permute(3, 2, 0, 1)
    if kh == 1 and kw == 1 and top == bottom == left == right == 0:
        return F.conv2d(x[:, :, ::stride, ::stride].contiguous(), oihw)
    if top == bottom and left == right:
        return F.conv2d(x, oihw, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), oihw,
                    stride=stride)


def batch_norm(p: Tree, s: Tree, x: torch.Tensor, train: bool,
               momentum: float, eps: float):
    """-> (normalized map, running statistics after this batch)."""
    if train:
        mean = torch.mean(x, dim=(0, 2, 3))
        var = torch.mean(torch.square(x - mean[:, None, None]),
                         dim=(0, 2, 3))
        new = {"mean": momentum * s["mean"] + (1 - momentum) * mean,
               "var": momentum * s["var"] + (1 - momentum) * var}
    else:
        mean, var, new = s["mean"], s["var"], s
    inv = torch.rsqrt(var + eps)
    y = ((x - mean[:, None, None]) * inv[:, None, None]
         * p["scale"][:, None, None] + p["bias"][:, None, None])
    return y, new


# --------------------------------------------------------------- models
def _resnet18(cfg, p, s, x, train):
    mom, eps = cfg["bn_momentum"], cfg["bn_eps"]
    h = x.permute(0, 3, 1, 2)
    h, s0 = batch_norm(p["bn0"], s["bn0"], conv(h, p["stem"]), train, mom,
                       eps)
    h = F.relu(h)
    new = {"bn0": s0}
    for si, (_, stride) in enumerate(cfg["stages"]):
        for bi in range(cfg["blocks_per_stage"]):
            name = f"s{si}b{bi}"
            bp, bs = p[name], s[name]
            st = stride if bi == 0 else 1
            y, s1 = batch_norm(bp["bn1"], bs["bn1"], conv(h, bp["c1"], st),
                               train, mom, eps)
            y = F.relu(y)
            y, s2 = batch_norm(bp["bn2"], bs["bn2"], conv(y, bp["c2"]),
                               train, mom, eps)
            ns = {"bn1": s1, "bn2": s2}
            if "down" in bp:
                h, sd = batch_norm(bp["bnd"], bs["bnd"],
                                   conv(h, bp["down"], st), train, mom, eps)
                ns["bnd"] = sd
            h = F.relu(y + h)
            new[name] = ns
    h = torch.mean(h, dim=(2, 3))
    return h @ p["fc"] + p["fcb"], new


def _vgg16(cfg, p, s, x, train):
    h = x.permute(0, 3, 1, 2)
    i = 0
    for item in cfg["plan"]:
        if item == "M":
            h = F.max_pool2d(h, 2)
        else:
            h = F.relu(conv(h, p[f"c{i}"]))
            i += 1
    # dense rows are (h, w, c): the NHWC map flattened
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    n = len(cfg["dense"]) + 1
    for j in range(1, n + 1):
        h = h @ p[f"f{j}"] + p[f"fb{j}"]
        if j < n:
            h = F.relu(h)
    return h, s


def forward(cfg: Dict, params: Tree, state: Tree, x: torch.Tensor,
            train: bool):
    """x (N, H, W, C) -> (logits (N, n_classes), new state)."""
    if cfg["family"] == "resnet18":
        return _resnet18(cfg, params, state, x, train)
    return _vgg16(cfg, params, state, x, train)


def nll(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample cross entropy."""
    logz = torch.logsumexp(logits, dim=-1)
    return logz - torch.gather(logits, -1, y[..., None])[..., 0]


def masked_loss(logits, y, mask) -> torch.Tensor:
    """Mean cross entropy over the real samples of a padded batch."""
    return torch.sum(nll(logits, y) * mask) / torch.clamp(torch.sum(mask),
                                                          min=1.0)
