"""``kmin2_roofline_pct``: the coverage pass's top-2 minimum (``ops/kmin2.py``
+ ``csrc/kmin2.cu``, row #8) against its roofline: the least time of each
``kmin2`` launch in the trace at the shape of the program's ``psr.coverage``
span that launched it (the last one to start before it), summed, over the
device time of those launches.  None where the trace holds no coverage span
(a program without the span, a cell without a coverage pass)."""

from bisect import bisect_right

from perfbench.metrics._spans import named, program_spans
from perfbench.roofline import kmin2


def read(run):
    spans = program_spans(run)
    if spans is None:
        return None
    cover = sorted(named(spans, "psr.coverage"), key=lambda s: s.start_ns)
    if not cover:
        return None
    starts = [s.start_ns for s in cover]
    bounds = [kmin2.launch_bounds(s.attrs)["kmin2"] for s in cover]
    bound_ms = device_ms = 0.0
    for name, start, dur in run["trace"]["events"]:
        i = bisect_right(starts, start) - 1
        if i < 0:
            continue
        symbol, least = bounds[i]
        if symbol in name:
            bound_ms += least
            device_ms += dur / 1e6
    return 100.0 * bound_ms / device_ms if device_ms > 0 else None
