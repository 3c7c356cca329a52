"""Step builders: train, the cross-pod FL train step, prefill and decode
(the reference's ``repro/launch/steps.py``).

``make_train_step``     -- one optimizer step on the gradient of
    ``model.train_loss`` (the reference's pjit step; on one device its
    psum over shards is the identity).
``make_fl_train_step``  -- the paper's FL round across pods: params and
    optimizer state carry a leading pod axis; each pod takes its
    ``inner_steps`` microbatches of the global batch, then the round
    closes per the paper's target:

      fedsgd: each pod's gradients summed over its microbatches, the
              weighted mean over pods (Eq. 4-5), one optimizer step per
              pod on that mean;
      fedavg: each pod takes ``inner_steps`` local optimizer steps, then
              the weighted parameter mean over pods (Eq. 6).

    The weighted mean over pods (the reference's ``_tmean_over_leading``,
    ``sum_i w_i x_i / max(sum w, 1e-12)`` in f32) is one launch of the
    ``safl_aggregate`` kernel in mode ``avg``
    (:func:`repro_torch.kernels.ops.safl_aggregate`, the port of the TPU
    kernel ``repro/kernels/safl_agg.py:136``) over the pods' (n_pods, D)
    f32 rows, each pod's tree flattened in the codec's leaf order
    (:class:`repro_torch.core.flatbuf.PytreeCodec`).  The mean is cut
    back into leaves, cast to each leaf's dtype and given to every pod,
    so the pods leave the round in sync.  A weight of 0 (a straggler pod)
    takes that pod out of the mean.
``make_prefill_step`` / ``make_decode_step`` -- serving, on the serving
    module of a params tree.

Pods run one after another on the one device (the reference vmaps them
over its "pod" mesh axis).  Gradients come from autograd
(:func:`value_and_grad`).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import tree as treemod
from repro_torch.core.flatbuf import PytreeCodec
from repro_torch.kernels import ops
from repro_torch.models.transformer import STACKS
from repro_torch.optim import make_optimizer


def value_and_grad(loss_fn: Callable) -> Callable:
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ``(params, batch) ->
    ((loss, metrics), grads)``, ``grads`` a tree like ``params`` (zeros
    for a leaf the loss does not read); everything returned detached."""
    def vg(params, batch):
        leaves, treedef = treemod.tree_flatten(params)
        live = [leaf.detach().requires_grad_() for leaf in leaves]
        with torch.enable_grad():
            loss, metrics = loss_fn(treemod.tree_unflatten(treedef, live),
                                    batch)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(leaf) if g is None else g
                 for leaf, g in zip(leaves, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return ((loss.detach(), metrics),
                treemod.tree_unflatten(treedef, grads))
    return vg


def make_train_step(model, cfg, lr=1e-3):
    """-> (``train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics)``, the optimizer); the update is written into
    ``params`` and ``opt_state`` (the reference's launcher donates them to
    its jitted step)."""
    opt = make_optimizer(cfg.optimizer, lr=lr)
    vg = value_and_grad(model.train_loss)

    def train_step(params, opt_state, batch, step):
        (_, metrics), grads = vg(params, batch)
        params, opt_state = opt.update(params, grads, opt_state, step)
        return params, opt_state, metrics

    return train_step, opt


def _pod(tree_, i: int):
    return treemod.tree_map(lambda leaf: leaf[i], tree_)


def make_fl_train_step(model, cfg, *, aggregation: str = "fedsgd",
                       lr=1e-3, server_lr: float = 1.0,
                       inner_steps: int = 1):
    """FL across pods.  ``params_stacked`` / ``opt_stacked`` leaves have a
    leading n_pods axis; ``batch`` is the global batch (pod i takes rows
    ``i * B / n_pods`` on, in ``inner_steps`` microbatches); ``weights``
    (n_pods,) the round's participation / staleness weights (0: a
    straggler pod left out).  ``server_lr`` is accepted as the
    reference's (which does not read it either).  Every update is written
    into ``params_stacked`` and ``opt_stacked`` (each pod's slice in
    place), so the round holds the stacked trees, one pod's gradients and
    the (n_pods, D) rows, not a second copy of the trees.  -> (
    ``fl_train_step(params_stacked, opt_stacked, batch, step, weights) ->
    (params, opt_state, {"loss"})``, the optimizer)."""
    del server_lr
    if aggregation not in ("fedsgd", "fedavg"):
        raise ValueError(f"aggregation {aggregation!r} not in "
                         "('fedsgd', 'fedavg')")
    opt = make_optimizer(cfg.optimizer, lr=lr)
    vg = value_and_grad(model.train_loss)

    def local_round(params, opt_state, batch, step):
        """One pod's local work -> (params, opt state, summed grads, mean
        loss)."""
        n = next(iter(batch.values())).shape[0] // inner_steps
        losses, gsum = [], None
        for j in range(inner_steps):
            mb = {k: v[j * n:(j + 1) * n] for k, v in batch.items()}
            (loss, _), g = vg(params, mb)
            if aggregation == "fedavg":  # local optimizer steps
                params, opt_state = opt.update(params, g, opt_state, step + j)
            else:
                gsum = g if gsum is None else treemod.tree_map(
                    torch.add, gsum, g)
            losses.append(loss)
        return params, opt_state, gsum, torch.stack(losses).mean()

    def fl_train_step(params_stacked, opt_stacked, batch, step, weights):
        n_pods = len(weights)
        codec = PytreeCodec(_pod(params_stacked, 0))
        device = treemod.tree_leaves(params_stacked)[0].device
        weights = torch.as_tensor(weights, dtype=torch.float32).to(device)
        b = next(iter(batch.values())).shape[0] // n_pods
        # each pod's row (its params under fedavg, its summed gradients
        # under fedsgd), flattened as soon as its local round ends
        rows = torch.empty((n_pods, codec.d), dtype=torch.float32,
                           device=device)
        losses = []
        for i in range(n_pods):
            p, _, gsum, loss = local_round(
                _pod(params_stacked, i), _pod(opt_stacked, i),
                {k: v[i * b:(i + 1) * b] for k, v in batch.items()}, step)
            rows[i] = codec.ravel(p if aggregation == "fedavg" else gsum)
            losses.append(loss)
            del p, gsum
        # the weighted mean over the pods: one safl_aggregate launch
        mean = codec.unravel(ops.safl_aggregate(rows, weights, mode="avg"))
        del rows
        if aggregation == "fedavg":
            # Eq. (6): the parameter mean, given to every pod (each pod
            # keeps its own optimizer state)
            with torch.no_grad():
                treemod.tree_map(lambda leaf, m: leaf.copy_(
                    m.to(leaf.dtype).expand_as(leaf)), params_stacked, mean)
        else:
            # Eq. (4)-(5): the gradient mean, one optimizer step on every
            # pod
            for i in range(n_pods):
                opt.update(_pod(params_stacked, i), mean,
                           _pod(opt_stacked, i), step)
        return params_stacked, opt_stacked, {
            "loss": torch.stack(losses).mean()}

    return fl_train_step, opt


def _module(model, params):
    """The serving module of ``params``: a module as it is, or a params
    tree as views (:meth:`from_tree`)."""
    if isinstance(params, torch.nn.Module):
        return params
    return STACKS[model.cfg.family].from_tree(model.cfg, params)


def make_prefill_step(model, window: Optional[int] = None):
    """-> ``prefill_step(params, batch) -> (last logits, cache)``; batch
    ``{"tokens", and the VLM's "prefix_embeds" or the enc-dec's
    "enc_frames"}``."""
    del window  # prefill keeps cfg.sliding_window, as the reference's

    @torch.no_grad()
    def prefill_step(params, batch):
        extra = {k: v for k, v in batch.items() if k != "tokens"}
        return _module(model, params).prefill(batch["tokens"], **extra)

    return prefill_step


def make_decode_step(model, window: Optional[int] = None):
    """-> ``decode_step(params, cache, tokens, pos) -> (logits, cache)``,
    ``window`` passed to every attention layer."""
    @torch.no_grad()
    def decode_step(params, cache, tokens, pos):
        return _module(model, params).decode_step(cache, tokens, pos,
                                                  window=window)

    return decode_step
