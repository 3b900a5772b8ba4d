"""Per-layer metrics: one reader a metric, ``<metric name>.py``, each with
``read(trace) -> float | None`` (None: nothing to read in this run).
``_yardstick.py`` holds the arithmetic they share."""
