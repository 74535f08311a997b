"""``wrapper_host_us``: the median microseconds of host time a kernel
wrapper call takes in the traced window (``ops/*``: from the wrapper's entry
to the launch's return, its ``ops.<launches key>`` span)."""

import statistics

from perfbench.metrics._spans import named, program_spans


def read(run):
    spans = program_spans(run)
    if spans is None:
        return None
    calls = named(spans, "ops.")
    if not calls:
        return None
    return statistics.median(s.end_ns - s.start_ns for s in calls) / 1e3
