"""Activation-sharding constraints (the reference's
``repro/sharding/ctx.py``), kept for its API: ``enable``, ``disable``,
``activation_sharding``, ``constrain_batch`` and ``constrain_scores``.

In the reference these pin activations to batch-sharded layouts with
``jax.lax.with_sharding_constraint`` while a step is lowered under a
mesh, to steer GSPMD's partitioner.  The port runs on one controller
and PyTorch has no GSPMD to steer: a tensor lives where its op put it.
So each constraint returns its input unchanged, and ``enable`` /
``disable`` have nothing to switch; the port's layers already leave the
hints out (:mod:`repro_torch.models.layers`).
"""
from __future__ import annotations

from typing import Tuple

import torch


def enable(batch_axes: Tuple[str, ...], model_size: int = 0,
           batch_total: int = 1) -> None:
    """Nothing to switch on (see the module's docstring)."""
    del batch_axes, model_size, batch_total


def disable() -> None:
    """Nothing to switch off."""


class activation_sharding:
    """Context: ``with activation_sharding(("data",), 16, 16): ...``
    (enters and leaves with nothing to do)."""

    def __init__(self, batch_axes, model_size: int = 0,
                 batch_total: int = 1):
        self.axes = tuple(batch_axes)
        self.model_size = model_size
        self.batch_total = batch_total

    def __enter__(self):
        enable(self.axes, self.model_size, self.batch_total)

    def __exit__(self, *exc):
        disable()


def constrain_batch(x: torch.Tensor, batch_dim: int = 0) -> torch.Tensor:
    """``x`` unchanged (the reference pins its batch dim to the
    data-parallel axes)."""
    del batch_dim
    return x


def constrain_scores(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """``x`` unchanged (the reference pins score slabs (B, H, q, k) to
    batch on data and heads or keys on model)."""
    del n_heads
    return x
