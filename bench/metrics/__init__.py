"""One reader a per-layer metric: ``read(rec) -> float | None`` over the
traced run's records (``bench.harness.run_cell``'s ``rec``).  A reader
that finds nothing to read returns None and the metric is left out of
the line."""
