"""Profiling hooks: build counts, host-transfer counts and a
``torch.profiler`` toggle.

:class:`CompileLog` keeps the reference's contract (``repro.obs.profile``):
register named targets, read their counts, assert bounds; a count of -1
means "unknown" and passes every assertion.  What the port builds is not
a jit cache but, once per engine or process, the engine's wave program
(the lane execution ``wave_impl`` resolves to) and the CUDA kernel
libraries that :mod:`repro_torch.kernels.build` compiles and loads;
:func:`engine_compile_log` registers those, each a real count >= 0.

The module-level transfer counter backs the batched engine's "one
device-to-host copy of the metrics a run" rule:
:meth:`repro_torch.core.metrics.DeviceMetricsRing.flush` records itself
here and :class:`TransferScope` measures the change across a region.

:func:`torch_profile` wraps a region in ``torch.profiler`` (``fl_sim
--trace-jax``, the reference's flag name) and writes its Chrome trace to
the trace directory.
"""
from __future__ import annotations

import collections
import contextlib
import os
from typing import Any, Dict, Optional

from repro_torch.kernels import build

#: the kernel libraries of the package's wrappers (``csrc/<name>.cu``)
KERNEL_LIBRARIES = ("safl_agg", "quantize", "flash_attention")

# ---------------------------------------------------------------------
# build counts
# ---------------------------------------------------------------------


class CompileLog:
    """Named registry of build-count targets.

    A target is an object with a ``compile_count`` attribute or property,
    or, with ``attr=``, any object whose named attribute holds the count.
    A target without one counts -1 (unknown).
    """

    def __init__(self):
        self._targets: Dict[str, Any] = {}

    def track(self, name: str, target, attr: Optional[str] = None
              ) -> "CompileLog":
        self._targets[name] = (target, attr)
        return self

    def count(self, name: str) -> int:
        target, attr = self._targets[name]
        try:
            return int(getattr(target, attr or "compile_count"))
        except Exception:
            return -1

    def counts(self) -> Dict[str, int]:
        return {name: self.count(name) for name in self._targets}

    def assert_at_most(self, name: str, bound: int) -> int:
        c = self.count(name)
        assert c == -1 or 0 <= c <= bound, (
            f"{name}: {c} compiled programs > bound {bound}")
        return c

    def assert_exactly(self, name: str, n: int) -> int:
        c = self.count(name)
        assert c in (n, -1), f"{name}: {c} compiled programs != {n}"
        return c


class _WaveProgram:
    """The engine's wave program: 1 once ``wave_impl`` is resolved (the
    first batched run), 0 before."""

    def __init__(self, eng):
        self._eng = eng

    @property
    def compile_count(self) -> int:
        return int(self._eng.wave_impl_resolved is not None)


class _LibraryLoads:
    """How many times this process loaded ``csrc/<name>.cu``'s library
    (each wrapper module loads it once, at its first CUDA launch)."""

    def __init__(self, name: str):
        self._name = name

    @property
    def compile_count(self) -> int:
        return build.load_counts().get(self._name, 0)


def engine_compile_log(eng) -> CompileLog:
    """CompileLog wired for an ``FLEngine``: ``wave`` (the engine's wave
    program, resolved once) and ``kernels.<name>`` for each kernel
    library of :data:`KERNEL_LIBRARIES` (0 on the CPU, where no wrapper
    launches a kernel)."""
    log = CompileLog().track("wave", _WaveProgram(eng))
    for name in KERNEL_LIBRARIES:
        log.track(f"kernels.{name}", _LibraryLoads(name))
    return log


# ---------------------------------------------------------------------
# host-transfer counting
# ---------------------------------------------------------------------

_TRANSFERS: "collections.Counter[str]" = collections.Counter()


def record_transfer(tag: str) -> None:
    """Record one device-to-host transfer under ``tag`` (called by the
    transfer sites themselves, e.g. ``DeviceMetricsRing.flush``)."""
    _TRANSFERS[str(tag)] += 1


def transfer_counts() -> Dict[str, int]:
    return dict(_TRANSFERS)


class TransferScope:
    """Context manager measuring host transfers inside the scope::

        with TransferScope() as ts:
            eng.run(rounds)
        assert ts.count("metrics_ring.flush") == 1
    """

    def __enter__(self) -> "TransferScope":
        self._t0 = collections.Counter(_TRANSFERS)
        self._t1: Optional[collections.Counter] = None
        return self

    def __exit__(self, *exc) -> bool:
        self._t1 = collections.Counter(_TRANSFERS)
        return False

    def delta(self) -> Dict[str, int]:
        end = self._t1 if self._t1 is not None \
            else collections.Counter(_TRANSFERS)
        return {k: v for k, v in (end - self._t0).items() if v}

    def count(self, tag: str) -> int:
        return self.delta().get(str(tag), 0)


# ---------------------------------------------------------------------
# torch.profiler toggle
# ---------------------------------------------------------------------

#: the Chrome trace :func:`torch_profile` writes into its directory
PROFILE_TRACE = "torch_profile.json"


@contextlib.contextmanager
def torch_profile(trace_dir: str, enabled: bool = True):
    """Wrap a region in ``torch.profiler`` (the host's ops, and the
    card's kernels and copies when CUDA is available) when enabled, and
    write its Chrome trace to ``trace_dir/torch_profile.json``.  Yields
    the profiler, whose events a caller may read after the region; a
    no-op yielding None when disabled, when ``trace_dir`` is empty, or
    when the profiler cannot start here."""
    if not (enabled and trace_dir):
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    try:
        prof.__enter__()
    except Exception:
        yield None
        return
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, PROFILE_TRACE))
