"""One reader a metric, found by the metric's name in ``BENCHMARK.json``:
``<metric>.py`` with ``read(run) -> float or None`` (``run`` is
``harness.Run``).  A reader that finds nothing to read returns None and
the harness leaves the metric out of the line."""
