"""The branch points of a training run, recorded in one run and taken by
another.

``relu`` and ``max_pool2d`` are continuous, but their gradients are not:
through a unit whose pre-activation is just above 0 a weight's gradient
takes that unit's upstream gradient times its input, just below 0 it
takes nothing, and a pool passes its gradient to whichever input is the
largest.  ``round`` (the q8 wire's quantizer) jumps a whole level where
its argument crosses a half-integer.  Two f32 runs of one training step
(another device, another summation order) compute every value to
rounding, yet a unit whose input lies within rounding of its branch
point lands on one side in one run and on the other in the other, and
the step then parts by that unit's whole term.  For ResNet-18 at width 4
on the CPU one such unit moved a step's gradient by 2.7e-3 of 0.72; the
f64 gradient taken with the f32 run's masks came back to 6.8e-6 of it
(``tools/branch_points.py steps``).  The parted runs do not come back
together over an epoch and FL rounds, so two correct f32 engines of a
conv model cannot be held to each other to a float bound unless they
take the same branches.

:class:`Record` notes a run's choices in call order: each ``relu``'s
``x > 0``, each ``max_pool2d``'s argmax and each ``round``'s integers.
:class:`Replay` makes another run take them: ``relu(x)`` becomes ``x *
mask``, a pool gathers its input at the recorded argmax (both
differentiable) and ``round`` returns the recorded integers, so the
replaying run follows the recorded run's branches and what is left
between the two is rounding.  It counts the units where its own choice
differs (``flips``) and keeps the largest distance of such a unit's
input from the branch point, over the largest |input| of its call
(``margin``): a flip within rounding has a margin of a few ulp, a run
that computes other values flips with a margin of order 1.  A call whose
kind or shape is not the recorded one raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode


def _strip(kwargs):
    return {k: v for k, v in (kwargs or {}).items() if k != "return_indices"}


class Record(TorchFunctionMode):
    """Under it, every ``F.relu``, ``F.max_pool2d`` and ``torch.round``
    call runs as usual and notes its choice in ``choices`` (on the call's
    device)."""

    def __init__(self):
        super().__init__()
        self.choices = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = _strip(kwargs)
        if func is F.relu:
            self.choices.append(("relu", args[0].detach() > 0))
        elif func is F.max_pool2d:
            out, idx = F.max_pool2d(*args, **kwargs, return_indices=True)
            self.choices.append(("pool", idx))
            return out
        elif func is torch.round:
            out = func(*args, **kwargs)
            self.choices.append(("round", out))
            return out
        return func(*args, **kwargs)


class Replay(TorchFunctionMode):
    """Under it, the i-th ``F.relu`` / ``F.max_pool2d`` / ``torch.round``
    call takes the i-th recorded choice (moved to the call's device)."""

    def __init__(self, choices):
        super().__init__()
        self.choices = choices
        self.used = 0
        self.flips = 0
        self.margin = 0.0

    def _next(self, kind, shape, device):
        if self.used == len(self.choices):
            raise RuntimeError(f"replay: a {kind} call past the "
                               f"{len(self.choices)} recorded")
        got, choice = self.choices[self.used]
        if got != kind or tuple(choice.shape) != tuple(shape):
            raise RuntimeError(
                f"replay: call {self.used} is a {kind} of {tuple(shape)}, "
                f"the recorded one a {got} of {tuple(choice.shape)}")
        self.used += 1
        return choice.to(device)

    def _note(self, flipped, distance, x):
        n = int(flipped.sum())
        if n:
            self.flips += n
            scale = float(x.abs().max())
            self.margin = max(self.margin,
                              float(distance[flipped].max()) / scale)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = _strip(kwargs)
        if func is F.relu:
            x = args[0]
            mask = self._next("relu", x.shape, x.device)
            xd = x.detach()
            self._note(mask != (xd > 0), xd.abs(), xd)
            return x * mask.to(x.dtype)
        if func is F.max_pool2d:
            x = args[0]
            own, own_idx = F.max_pool2d(x.detach(), *args[1:], **kwargs,
                                        return_indices=True)
            idx = self._next("pool", own_idx.shape, x.device)
            n, c = x.shape[:2]
            out = torch.gather(x.reshape(n, c, -1), 2,
                               idx.reshape(n, c, -1)).reshape(idx.shape)
            self._note(own > out.detach(), own - out.detach(), x.detach())
            return out
        if func is torch.round:
            x = args[0]
            own = func(*args, **kwargs)
            rec = self._next("round", own.shape, own.device)
            self._note(own != rec, (x - (own + rec) / 2).abs()
                       + (own - rec).abs() - 1, x)
            return rec
        return func(*args, **kwargs)

    @property
    def done(self) -> bool:
        """Every recorded choice was taken."""
        return self.used == len(self.choices)
