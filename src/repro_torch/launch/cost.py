"""The dry run's cost counter: the port's counterpart of the reference's
``repro/launch/hlo_cost.py``.

The reference compiles a step for the TPU and walks the optimised HLO:
dot and convolution FLOPs, the operand and result bytes of each fused
op, collective bytes, each ``while`` body times its
``known_trip_count``.  The port has no compiler between its Python and
the device, so there is no HLO to parse: ``parse_hlo``,
``collective_bytes`` and ``profile_bytes`` have nothing to read.
Instead :func:`analyze` runs the step itself on tensors of the meta
device (shapes and dtypes, no data) inside
:func:`repro_torch.kernels.checks.meta_trace`, so each kernel wrapper
runs its plain version, and counts what is dispatched:

  * ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s total, the
    matmul and convolution FLOPs that ``hlo_cost`` counts for dot and
    convolution (elementwise work is not counted on either side);
  * ``bytes``: the operand and result bytes of every aten op that is
    not a pure view.  This is the eager, unfused traffic the port moves
    op by op, not the reference's count over XLA's fused ops, which is
    smaller;
  * ``peak_live_B``: the largest sum of the bytes of live storages
    during the call, the arguments' included: a storage is added when
    an op makes it and removed when it is freed.

A Python loop over time steps would dispatch every step.  The sLSTM's
scan (:func:`repro_torch.models.xlstm.slstm_scan`), 32,768 steps at
``prefill_32k``, loops through :func:`repro_torch.kernels.checks.trips`
instead, which under the counter runs five of its ``n`` steps: the first
two, one middle step counted ``n - 4`` times, and the last two
(``hlo_cost``'s ``known_trip_count`` rule).  The first and last steps
run as they are because they differ from the rest in what needs a
gradient: the initial carry needs none, and the last step's carry is
used by no gradient.  What the middle step dispatches in the forward,
and what its autograd nodes dispatch in the backward (gradient
accumulation included), is counted ``n - 4`` times.  The storages that
the middle step leaves alive past the step after it are held ``n - 4``
times until the last of them is freed, as the full loop holds one set a
step until its backward; storages that the next step frees stand for
one at a time.  So FLOPs, bytes and the peak are the full loop's.  The
skipped steps never run, so trip counting takes meta tensors only.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import checks

def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Repeat:
    """One middle step counted ``mult`` times
    (:func:`repro_torch.kernels.checks.trips`)."""

    def __init__(self, mult: int):
        self.mult = mult
        self.seq = [0, 0]  # its autograd nodes' sequence numbers [lo, hi)
        self.made: Dict[int, int] = {}  # its storages alive: key -> bytes
        self.peak = 0  # the highest live bytes within it
        self.settle_peak = 0  # ... within the step after it


class Counter(TorchDispatchMode):
    """Counts the operand and result bytes and the live storages of every
    aten op dispatched while it is entered, and the FLOPs of a repeated
    step that ``flops`` (a ``FlopCounterMode`` entered before it) counts
    only once."""

    def __init__(self, flops: FlopCounterMode):
        super().__init__()
        self.fc = flops
        self.extra_flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._bytes_of: Dict[int, int] = {}  # live storage key -> bytes
        self._on_free: Dict[int, List[Callable]] = {}
        self._finalizers: List[weakref.finalize] = []
        self._repeat: Optional[_Repeat] = None  # the middle step running
        self._settling: Optional[_Repeat] = None  # the step after it
        self._ranges: List[_Repeat] = []  # repeats that ran

    # -- live storages ----------------------------------------------------

    def _change(self, n: int) -> None:
        self.live += n
        self.peak = max(self.peak, self.live)
        if self._repeat is not None:
            self._repeat.peak = max(self._repeat.peak, self.live)
        if self._settling is not None:
            self._settling.settle_peak = max(self._settling.settle_peak,
                                             self.live)

    def _add(self, t: torch.Tensor) -> None:
        key = _key(t)
        if key in self._bytes_of:
            return
        storage = t.untyped_storage()
        n = self._bytes_of[key] = storage.nbytes()
        self._change(n)
        if self._repeat is not None:
            self._repeat.made[key] = n
        self._finalizers.append(weakref.finalize(storage, self._free, key))

    def _free(self, key: int) -> None:
        self._change(-self._bytes_of.pop(key, 0))
        for r in (self._repeat, self._settling):
            if r is not None:
                r.made.pop(key, None)
        for callback in self._on_free.pop(key, ()):
            callback(key)

    def hold(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live (the call's
        arguments)."""
        for t in _tensors(tree):
            self._add(t)

    # -- trip counting ----------------------------------------------------

    @staticmethod
    def _seq() -> int:
        """The next autograd sequence number (read from a probe node,
        uncounted)."""
        with _disable_current_modes(), torch.enable_grad():
            probe = torch.zeros((), requires_grad=True).view(())
            return probe.grad_fn._sequence_nr() + 1

    def _mult(self) -> int:
        """How many times the op being dispatched counts: the middle
        step's forward, or the backward of one of its autograd nodes."""
        mult = self._repeat.mult if self._repeat is not None else 1
        node = (torch._C._current_autograd_node() if self._ranges
                else None)
        if node is not None:
            seq = node._sequence_nr()
            for r in self._ranges:
                if r.seq[0] <= seq < r.seq[1]:
                    return mult * r.mult
        return mult

    @contextlib.contextmanager
    def repeat(self, mult: int):
        """The step run within counts ``mult`` times; yields its
        :class:`_Repeat`."""
        r = _Repeat(mult)
        r.seq[0] = self._seq()
        r.peak = self.live
        outer, self._repeat = self._repeat, r
        try:
            yield r
        finally:
            self._repeat = outer
            r.seq[1] = self._seq()
            self._ranges.append(r)

    @contextlib.contextmanager
    def settle(self, r: _Repeat):
        """The step after ``r``: what ``r`` made and this step leaves alive
        is held ``r.mult - 1`` more times until the last of it is freed;
        the peaks within ``r`` and this step rise by as much."""
        r.settle_peak = self.live
        self._settling = r
        try:
            yield
        finally:
            self._settling = None
            kept = set(r.made)
            lump = (r.mult - 1) * sum(r.made.values())
            if lump:
                self.peak = max(self.peak, r.peak + lump,
                                r.settle_peak + lump)
                self._change(lump)

                def gone(key):
                    kept.discard(key)
                    if not kept:
                        self._change(-lump)

                for key in kept:
                    self._on_free.setdefault(key, []).append(gone)

    # -- dispatch ---------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        mult = self._mult()
        flops = self.fc.flop_counts["Global"]
        before = sum(flops.values()) if mult != 1 else 0
        out = func(*args, **kwargs)
        if mult != 1:
            self.extra_flops += (mult - 1) * (sum(flops.values()) - before)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        in_keys = {_key(t) for t in ins}
        if func._schema.is_mutable or any(_key(t) not in in_keys
                                          for t in outs):
            self.bytes += mult * (sum(map(tensor_bytes, ins))
                                  + sum(map(tensor_bytes, outs)))
        for t in outs:
            self._add(t)
        return out

    def __exit__(self, *exc):
        for f in self._finalizers:
            f.detach()
        return super().__exit__(*exc)


def analyze(fn: Callable, *args, trip_count: bool = True) -> Dict:
    """Run ``fn(*args)`` under the counter -> ``{"flops", "bytes",
    "peak_live_B", "out"}``.  With ``trip_count`` a
    :func:`~repro_torch.kernels.checks.trips` loop runs five steps for
    all, so the tensor arguments must be on meta (a real one raises: the
    skipped steps would leave its results unwritten);
    ``trip_count=False`` runs every step, on any device."""
    if trip_count:
        real = [t.device for t in _tensors(args) if t.device.type != "meta"]
        if real:
            raise ValueError(f"analyze: trip counting takes meta tensors, "
                             f"not {real[0]} (pass trip_count=False)")
    with FlopCounterMode(display=False) as fc, Counter(fc) as counter, \
            checks.meta_trace(counter if trip_count else None):
        counter.hold(args)
        out = fn(*args)
    return {"flops": fc.get_total_flops() + counter.extra_flops,
            "bytes": counter.bytes, "peak_live_B": counter.peak, "out": out}
