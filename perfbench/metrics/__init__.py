"""One reader per per-layer metric, found by the metric's name in
BENCHMARK.json: ``read(run)`` takes the run's record (``harness/window.py``:
spans, counts, shapes and, in a traced run, the device trace's summary) and
returns the metric's value, or None where it finds nothing to read."""
