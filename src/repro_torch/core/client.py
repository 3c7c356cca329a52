"""Client-side local training for the FL engine (paper §2.1, Eq. 1-3).

Clients run mini-batch SGD for ``local_epochs`` over their shard.  FedAvg
uploads the final local weights; FedSGD uploads the cumulative gradient of
the epoch, (w_start - w_end) / lr (:meth:`repro_torch.core.flatbuf.
PytreeCodec.ravel_delta`).

An epoch is a Python loop over the shard's stacked batches.  Shards are
padded to a common batch count with a validity mask; a batch whose mask
is all zero changes neither params nor state, as in the reference.  Which
batches are valid is decided on the host (``valid``) so the loop never
waits on the device to find out.

The horizon-batched engine trains a *wave* of K clients in one call
(:func:`make_batched_hetero_train`; :func:`make_batched_local_train` for
the sync round, whose K lanes start from one global model), on flat (K, D)
parameter rows in the codec's layout, the wave's shards gathered from the
engine's (n_clients, ...) shard bank by client index.  Two ways to run
the lanes:

  * ``vmap``: ``torch.func.vmap`` over ``torch.func.grad_and_value`` of
    the loss on dict params, one batched step for all K lanes (the
    CNN's convolutions as unfold + matmul over the lanes); a lane whose
    batch holds no valid sample keeps its params through
    ``torch.where``, the shared epoch body of the reference
    (``_make_epoch_body``);
  * ``map``: the lanes one after another through :func:`local_epoch`, the
    sequential engine's own step, so a wave equals K sequential uploads
    bit for bit.

``auto`` (:func:`resolve_wave_impl`) is ``map`` for a conv model on
either device and ``vmap`` for a model without one.  The reference picks
``vmap`` on its accelerator; on one H100 the vmapped wave's client
training measured slower than the serial lanes in all four of the
paper's settings (medians of three runs, ``PERF.md`` §5), so the port's
card default is ``map``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from repro_torch import tree

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class ClientState:
    """Host-side record for one simulated client."""
    cid: int
    params: Params  # current local weights
    model_state: Any  # non-trainables (ResNet-18's BatchNorm statistics)
    version: int  # global round the local model derives from
    n_samples: int
    speed: float  # relative compute speed (samples/sec multiplier)
    comm_time: float  # upload latency (simulated seconds)
    rng: np.random.Generator = None


def sequence_loss(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor = None) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    nll = logz - torch.gather(logits, -1, targets[..., None])[..., 0]
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def make_loss_fn(apply_fn: Callable, kind: str):
    """kind: image | char | sentiment -> ``loss(params, state, x, y,
    mask) -> (loss, new state)``.  ``char`` (next-character prediction)
    scores ``logits[:, :-1]`` against ``y[:, 1:]``, the (B,) mask
    broadcast over the positions."""
    if kind not in ("image", "char", "sentiment"):
        raise ValueError(f"kind={kind!r} not in (image, char, sentiment)")

    def loss(params, model_state, x, y, mask):
        logits, new_state = apply_fn(params, model_state, x, True)
        if kind == "char":
            m = mask[:, None] * torch.ones_like(y[:, 1:],
                                                dtype=torch.float32)
            return sequence_loss(logits[:, :-1], y[:, 1:], m), new_state
        return sequence_loss(logits, y, mask), new_state

    return loss


def local_epoch(loss_fn: Callable, params, model_state, xs, ys,
                mask, valid: np.ndarray, lr: float):
    """One epoch of plain SGD.  xs (n_batches, B, ...), ys (n_batches, B,
    ...), mask (n_batches, B) on the device; ``valid`` (n_batches,) host
    bools, True where the batch has any real sample (a batch without one
    keeps params and state, as the reference's ``where(any_valid, ...)``).
    Returns (params', state', mean loss over valid batches) with the loss
    as a device scalar."""
    leaves0, treedef = tree.tree_flatten(params)
    p = [v.detach() for v in leaves0]
    s = model_state
    loss_sum = torch.zeros((), device=xs.device)
    for b in np.flatnonzero(valid):
        leaves = [v.requires_grad_(True) for v in p]
        loss, s = loss_fn(tree.tree_unflatten(treedef, leaves), s, xs[b],
                          ys[b], mask[b])
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            p = [leaf - lr * g for leaf, g in zip(leaves, grads)]
        s = tree.tree_map(torch.Tensor.detach, s)
        loss_sum = loss_sum + loss.detach()
    return (tree.tree_unflatten(treedef, p), s,
            loss_sum / max(int(valid.sum()), 1))


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv2d_gemm(x, w, bias=None, stride=1, padding=0, dilation=1,
                 groups=1):
    """``conv2d`` of one group as unfold + matmul: the columns of each
    window times the flattened weights, a full-f32 GEMM with a
    deterministic backward (col2im, GEMMs)."""
    if groups != 1 or isinstance(padding, str):
        raise NotImplementedError("the vmapped wave's convolution takes "
                                  "one group and numeric padding")
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), \
        _pair(dilation)
    n, _, h, wd = x.shape
    o, _, kh, kw = w.shape
    cols = F.unfold(x, (kh, kw), dilation=(dh, dw), padding=(ph, pw),
                    stride=(sh, sw))
    out = torch.matmul(w.reshape(o, -1), cols).reshape(
        n, o, (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1,
        (wd + 2 * pw - dw * (kw - 1) - 1) // sw + 1)
    return out if bias is None else out + bias.view(1, -1, 1, 1)


class _GemmConvs(TorchFunctionMode):
    """Runs every ``conv2d`` under it as :func:`_conv2d_gemm`.  The
    vmapped step needs it on the card: vmap lowers a convolution of K
    lanes to one grouped convolution, and under ``cudnn.deterministic``
    cuDNN computes the grouped ones with algorithms whose f32 results
    leave the per-lane convolutions' (on one H100 the sync round of a
    width-4 CNN drifted 9.1e-4 from the serial lanes in 3 rounds, against
    6e-8 without ``deterministic`` or without cuDNN); unfold + matmul
    keeps f32 precision and repeats bit for bit."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is F.conv2d:
            return _conv2d_gemm(*args, **(kwargs or {}))
        return func(*args, **(kwargs or {}))


def _vmap_epoch(loss_fn: Callable, params, model_state, xs, ys,
                mask, valid: np.ndarray, lr: float):
    """One epoch of plain SGD for K lanes at once: params and state (K,
    ...) each, xs (K, n_batches, B, ...), ys and mask likewise, ``valid``
    (K, n_batches) host bools.  Each step is one ``vmap`` of
    ``grad_and_value(..., has_aux=True)`` over the lanes, the new state
    the aux, convolutions as unfold + matmul (:class:`_GemmConvs`); a
    lane whose batch holds no valid sample keeps its params and state
    (``torch.where``), so its epoch is its sequential one up to the
    reduction order of the batched ops.  A batch that no lane holds is
    skipped on the host.  Returns (params', state', (K,) mean loss over
    each lane's valid batches)."""
    from torch.func import grad_and_value, vmap

    step = vmap(grad_and_value(loss_fn, has_aux=True))
    ok_all = torch.as_tensor(valid, device=xs.device)
    p, s = params, model_state
    loss_sum = torch.zeros(valid.shape[0], device=xs.device)

    def keep(ok):
        return lambda new, old: torch.where(
            ok.view((-1,) + (1,) * (old.dim() - 1)), new, old)

    for b in np.flatnonzero(valid.any(axis=0)):
        with _GemmConvs():
            grads, (losses, s_new) = step(p, s, xs[:, b], ys[:, b],
                                          mask[:, b])
        ok = ok_all[:, b]
        p = tree.tree_map(lambda v, g: keep(ok)(v - lr * g, v), p, grads)
        s = tree.tree_map(keep(ok), s_new, s)
        loss_sum = loss_sum + torch.where(ok, losses.detach(), 0.0)
    n_valid = torch.as_tensor(np.maximum(valid.sum(axis=1), 1),
                              dtype=torch.float32, device=xs.device)
    return p, s, loss_sum / n_valid


class _ConvSeen(TorchFunctionMode):
    """Notes whether a convolution runs under it."""

    def __init__(self):
        super().__init__()
        self.seen = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if "conv" in getattr(func, "__name__", ""):
            self.seen = True
        return func(*args, **(kwargs or {}))


_HAS_CONV: Dict[Callable, bool] = {}


def model_has_conv(apply_fn: Callable, params: Params, model_state,
                   sample_x: torch.Tensor) -> bool:
    """True iff ``apply_fn``'s forward pass runs a convolution (one
    forward of ``sample_x``, cached per ``apply_fn``): the signal
    ``wave_impl="auto"`` uses to pick the serial wave."""
    if apply_fn not in _HAS_CONV:
        with torch.no_grad(), _ConvSeen() as mode:
            apply_fn(params, model_state, sample_x, True)
        _HAS_CONV[apply_fn] = mode.seen
    return _HAS_CONV[apply_fn]


def resolve_wave_impl(impl: str, apply_fn: Callable, params: Params,
                      model_state, sample_x: torch.Tensor) -> str:
    """Resolve ``FLConfig.wave_impl``: ``vmap`` / ``map`` pass through;
    ``auto`` is ``map`` for a conv model and ``vmap`` for a model without
    a convolution, on either device.  On the CPU this is the reference's
    rule (a vmapped wave's convolutions lose to one lane at a time); on
    the card the reference picks ``vmap``, which on one H100 trained the
    paper CNN's waves slower than ``map`` in all four of the paper's
    settings."""
    if impl not in ("vmap", "map", "auto"):
        raise ValueError(f"wave_impl={impl!r} not in (vmap, map, auto)")
    if impl != "auto":
        return impl
    return ("map" if model_has_conv(apply_fn, params, model_state, sample_x)
            else "vmap")


def make_batched_hetero_train(apply_fn: Callable, kind: str, target: str,
                              local_epochs: int, codec, impl: str = "vmap"):
    """One wave of K clients with heterogeneous parameters, carried as
    flat (K, D) f32 rows in ``codec``'s layout.  Returns
    ``round_fn(flat_k, states_k, bank, idx, lr) -> (vecs, new_flat,
    states, losses)``:

      * ``bank`` the engine's shard bank, a dict of (n_clients, n_batches,
        B, ...) device tensors ``xs``, ``ys``, ``mask`` and the host bools
        ``valid`` (n_clients, n_batches); the wave's shards are gathered
        from it by the client indices ``idx`` (K ints);
      * ``vecs`` (K, D) the upload rows: the cumulative gradient (row_start
        - row_end) / lr for ``target="grad"`` (Eq. 3, divided by an f32
        tensor on the rows' device, as ``PytreeCodec.ravel_delta``
        divides), the final local weights for ``target="params"``;
      * ``new_flat`` (K, D) the final local weights; ``states`` the K
        lanes' final model states, K-stacked (``states_k`` is the lanes'
        K-stacked start states; ``{}`` for a model without state);
        ``losses`` (K,) mean losses as device values, never fetched.

    ``impl`` ``map`` runs the lanes one after another through
    :func:`local_epoch`, bitwise the sequential engine's uploads;
    ``vmap`` runs all K lanes in one batched step (:func:`_vmap_epoch`)."""
    if impl not in ("vmap", "map"):
        raise ValueError(f"impl={impl!r} not in (vmap, map)")
    if target not in ("grad", "params"):
        raise ValueError(f"target={target!r} not in (grad, params)")
    loss_fn = make_loss_fn(apply_fn, kind)

    def round_fn(flat_k: torch.Tensor, states_k, bank: Dict,
                 idx: Sequence[int], lr: float):
        idx = [int(i) for i in idx]
        lr_t = torch.tensor(lr, dtype=torch.float32, device=flat_k.device)
        if impl == "map":
            new_rows, new_states, losses = [], [], []
            for i, cid in enumerate(idx):
                p = codec.unravel(flat_k[i])
                s = tree.tree_map(lambda leaf, i=i: leaf[i], states_k)
                loss = torch.zeros((), device=flat_k.device)
                for _ in range(local_epochs):
                    p, s, loss = local_epoch(
                        loss_fn, p, s, bank["xs"][cid], bank["ys"][cid],
                        bank["mask"][cid], bank["valid"][cid], lr)
                new_rows.append(codec.ravel(p))
                new_states.append(s)
                losses.append(loss)
            new_flat = torch.stack(new_rows)
            states = tree.tree_stack(new_states)
            losses = torch.stack(losses)
        else:
            gather = torch.as_tensor(idx, device=flat_k.device)
            xs, ys, mask = (bank[f].index_select(0, gather)
                            for f in ("xs", "ys", "mask"))
            # contiguous rows: the sync round's rows are one broadcast
            # (D,) row, and a vmapped step on CUDA must not see its leaves
            # with a stride-0 lane dimension
            p = codec.unravel_rows(flat_k.contiguous())
            s = tree.tree_map(torch.Tensor.contiguous, states_k)
            losses = None
            for _ in range(local_epochs):
                p, s, losses = _vmap_epoch(loss_fn, p, s, xs, ys, mask,
                                           bank["valid"][idx], lr)
            new_flat = codec.ravel_rows(p)
            states = s
        vecs = (flat_k - new_flat) / lr_t if target == "grad" else new_flat
        return vecs, new_flat, states, losses

    return round_fn


def make_batched_local_train(apply_fn: Callable, kind: str, target: str,
                             local_epochs: int, codec, impl: str = "vmap"):
    """The sync (SFL) round of K clients, all starting from the one
    broadcast global model: ``round_fn(flat, state, bank, idx, lr) ->
    (vecs, states, losses)``, the wave of
    :func:`make_batched_hetero_train` with every lane's row the global
    (D,) row ``flat`` and its state the global ``state``; ``states`` the
    K lanes' final states, K-stacked."""
    wave = make_batched_hetero_train(apply_fn, kind, target, local_epochs,
                                     codec, impl)

    def round_fn(flat: torch.Tensor, state, bank: Dict,
                 idx: Sequence[int], lr: float):
        k = len(idx)
        states_k = tree.tree_map(
            lambda leaf: leaf.expand((k,) + tuple(leaf.shape)), state)
        vecs, _, states, losses = wave(flat.expand(k, flat.numel()),
                                       states_k, bank, idx, lr)
        return vecs, states, losses

    return round_fn


def make_flat_eval_fn(apply_fn: Callable, kind: str, codec):
    """``evaluate(flat, state, x, y)`` on the flat (D,) global row: the
    batched engine keeps the global model flat and unravels it (to views)
    only to evaluate."""
    def evaluate_flat(flat: torch.Tensor, state, x, y):
        return evaluate(apply_fn, kind, codec.unravel(flat), state, x, y)
    return evaluate_flat


@torch.no_grad()
def evaluate(apply_fn: Callable, kind: str, params: Params, model_state,
             x: torch.Tensor, y: torch.Tensor):
    """(accuracy, loss) over the test set, as device scalars; for
    ``char`` the next-character accuracy and loss, averaged over the
    positions."""
    logits, _ = apply_fn(params, model_state, x, False)
    if kind == "char":
        logits, y = logits[:, :-1], y[:, 1:]
    pred = torch.argmax(logits, dim=-1)
    acc = torch.mean((pred == y).to(torch.float32))
    return acc, sequence_loss(logits, y)


def pytree_bytes(tree_) -> int:
    """Bytes of the leaves of a (nested) dict of tensors."""
    return sum(t.numel() * t.element_size() for t in tree.tree_leaves(tree_))
