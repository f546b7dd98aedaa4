"""One reader per per-layer metric, ``<name>.py``, found by the metric's
name in ``BENCHMARK.json``: ``read(summary)`` returns the value, or None
where the traced window holds nothing to read."""
