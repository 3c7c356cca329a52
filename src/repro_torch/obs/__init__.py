"""Observability of the FL engines: tracing, metrics, profiling.

- :mod:`repro_torch.obs.trace`: each upload's life and each horizon's
  spans on the simulated clock (JSONL; equal streams on both engines).
- :mod:`repro_torch.obs.export`: Chrome-trace / Perfetto export, its
  schema check, and JSON-native values (``to_native``).
- :mod:`repro_torch.obs.metrics`: a counter / gauge / histogram registry
  with Prometheus-text and JSON exposition; ``from_engine`` snapshots.
- :mod:`repro_torch.obs.profile`: build counts (``CompileLog``),
  device-to-host copy counts (``TransferScope``) and a ``torch.profiler``
  toggle.
- :mod:`repro_torch.obs.report`: the ``python -m repro_torch.obs.report``
  text timeline.

Turn it on with ``FLConfig.trace_level`` / ``trace_dir`` or ``fl_sim
--trace-dir``.
"""
# repro_torch.obs.report is not imported here: it is the ``python -m``
# entry point, and importing it from the package would trip runpy's
# double-import warning.
from repro_torch.obs import export, metrics, profile, trace  # noqa: F401
from repro_torch.obs.export import export_chrome_trace, to_native  # noqa: F401
from repro_torch.obs.metrics import MetricsRegistry, from_engine  # noqa: F401
from repro_torch.obs.profile import (CompileLog, TransferScope,  # noqa: F401
                                     engine_compile_log, record_transfer,
                                     torch_profile)
from repro_torch.obs.trace import SpanTracer, canonical  # noqa: F401
