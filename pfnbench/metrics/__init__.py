"""Per-layer metric readers, one file a metric (``spec.metric_reader``).

Each has ``read(t) -> float | None``: ``t`` is a traced run's record (the
traffic's ``trace``: the kind, the window's host spans and required
operations, the profiled stretch, the attention launches it held). A reader
that finds nothing to read returns None, and the metric is left out of the
line."""
