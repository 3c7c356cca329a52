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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class ClientState:
    """Host-side record for one simulated client."""
    cid: int
    params: Params  # current local weights
    model_state: Any  # non-trainables (none for the paper CNN)
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
    """kind: image | sentiment.  ``char`` (next-character prediction)
    belongs with the LSTM, which is not ported yet."""
    if kind == "char":
        raise NotImplementedError("kind='char' (LSTM) is not ported yet")

    def loss(params, model_state, x, y, mask):
        logits, new_state = apply_fn(params, model_state, x, True)
        return sequence_loss(logits, y, mask), new_state

    return loss


def local_epoch(loss_fn: Callable, params: Params, model_state, xs, ys,
                mask, valid: np.ndarray, lr: float):
    """One epoch of plain SGD.  xs (n_batches, B, ...), ys (n_batches, B),
    mask (n_batches, B) on the device; ``valid`` (n_batches,) host bools,
    True where the batch has any real sample.  Returns (params', state',
    mean loss over valid batches) with the loss as a device scalar."""
    names = list(params)
    p = {k: v.detach() for k, v in params.items()}
    s = model_state
    loss_sum = torch.zeros((), device=xs.device)
    for b in np.flatnonzero(valid):
        leaves = [p[k].requires_grad_(True) for k in names]
        loss, s = loss_fn(dict(zip(names, leaves)), s, xs[b], ys[b],
                          mask[b])
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            p = {k: leaf - lr * g for k, leaf, g in zip(names, leaves,
                                                        grads)}
        loss_sum = loss_sum + loss.detach()
    return p, s, loss_sum / max(int(valid.sum()), 1)


@torch.no_grad()
def evaluate(apply_fn: Callable, kind: str, params: Params, model_state,
             x: torch.Tensor, y: torch.Tensor):
    """(accuracy, loss) over the test set, as device scalars."""
    if kind == "char":
        raise NotImplementedError("kind='char' (LSTM) is not ported yet")
    logits, _ = apply_fn(params, model_state, x, False)
    pred = torch.argmax(logits, dim=-1)
    acc = torch.mean((pred == y).to(torch.float32))
    return acc, sequence_loss(logits, y)


def pytree_bytes(tree: Dict[str, torch.Tensor]) -> int:
    """Bytes of a dict of tensors."""
    return sum(t.numel() * t.element_size() for t in tree.values())
