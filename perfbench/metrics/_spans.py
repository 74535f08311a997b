"""The program's spans of a traced run (``difficp_torch/utils/profiling.py``:
recorded in memory while the harness's profiler runs, so exactly those of
the traced window) and the device's idle time inside them.

A program without the recorder (an older commit) has no spans to give:
``program_spans`` returns None there, and so does every reader built on it.
Spans are stamped in nanoseconds since the epoch, the time base of the
trace's device events, so the two compare directly."""

from __future__ import annotations

from bisect import bisect_right


def program_spans(run):
    """The traced window's spans (``profiling.Span``), or None where the run
    was not traced or the program recorded none."""
    if not run.get("trace"):
        return None
    try:
        from difficp_torch.utils import profiling

        recorded = profiling.spans()
    except (ImportError, AttributeError):
        return None
    return recorded or None


def named(spans, name, under=None):
    """The spans called ``name`` (a prefix when it ends in "."), only those
    inside a span called ``under`` where given."""
    prefix = name.endswith(".")
    out = []
    for s in spans:
        if not (s.name.startswith(name) if prefix else s.name == name):
            continue
        if under is not None:
            j = s.parent
            while j >= 0 and spans[j].name != under:
                j = spans[j].parent
            if j < 0:
                continue
        out.append(s)
    return out


def busy_union(events):
    """The device's busy intervals: the union of the events' (start, end),
    sorted and disjoint, as two lists (starts, ends)."""
    starts, ends = [], []
    for _, s, dur in sorted(events, key=lambda e: e[1]):
        e = s + dur
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return starts, ends


def idle_ns(union, a, b):
    """Nanoseconds of [a, b] in which the device ran nothing."""
    starts, ends = union
    busy = 0
    i = max(bisect_right(starts, a) - 1, 0)
    while i < len(starts) and starts[i] < b:
        busy += max(0, min(ends[i], b) - max(starts[i], a))
        i += 1
    return (b - a) - busy
