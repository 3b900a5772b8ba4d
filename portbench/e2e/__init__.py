"""End-to-end metrics, one file a metric: ``read(window) -> float | None``,
on the benchmark's host clock over the whole window."""
