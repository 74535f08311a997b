"""Tracing and per-phase timing (counterpart of
``difficp_tpu/utils/profiling.py``; the reference has none, SURVEY §5).

- ``span``: the program's own spans at its layer boundaries
  (``psr.*``, ``gmm.em_step``, ``lddmm.row_order``, ``lbfgs.*``, ``ops.*``;
  README names them).  A span is recorded in memory only while a
  ``torch.profiler`` is running (``trace`` below, or any other profiler);
  otherwise ``span`` returns one shared no-op object after one flag
  check.  Each profiler start begins a new region: ``spans()`` holds
  exactly the spans recorded since the last start.  A span is stamped with
  ``time.time_ns()``, nanoseconds since the epoch, the time base of the
  profiler's own events, so that spans and device intervals compare
  directly.  Every span carries ``psr``, the serial number of the
  registration (``MultiPSR.serial``) whose work it is, taken from its
  parent where not given.
- ``phase_timer``: wall-clock accounting per named phase (GMM_opt / Reg_opt
  / Template_opt ...) on ``perf_counter``, aggregated in a global registry
  that ``timings_summary`` reads; each phase is also a span, recorded with
  the profiler running or not.
- ``trace``: a ``torch.profiler`` trace of a code region, CPU activity and,
  where CUDA is available, the card's kernels; it writes a Chrome / Perfetto
  trace file (``*.pt.trace.json``) under ``logdir``, the program's spans
  among its events.
- ``span_table``: count, total and self seconds of the spans per name (a
  span's self time is its duration less what its child spans cover).
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from collections import defaultdict
from typing import NamedTuple, Optional

import torch.autograd.profiler as _profiler

_TIMINGS: dict[str, list[float]] = defaultdict(list)


class Span(NamedTuple):
    name: str
    start_ns: int         # time.time_ns() at the start
    end_ns: Optional[int]  # and at the end (None while it is open)
    parent: int           # index of the enclosing span in spans(), -1 for none
    psr: Optional[int]    # serial of the registration whose work it is
    attrs: dict


class _Recorder:
    """The spans of the current region: records [name, start, end, parent,
    psr, attrs, index] in the order they opened, and the stack of open
    ones."""

    def __init__(self):
        self.records: list[list] = []
        self.stack: list[list] = []

    def restart(self):
        self.records = []
        self.stack = []


_REC = _Recorder()


def _on_profiler_start(_start=_profiler._run_on_profiler_start):
    _start()
    _REC.restart()


# a profiler's start begins a region of its own (torch calls this hook from
# every profiler's start, whatever its activities)
if not hasattr(_profiler._run_on_profiler_start, "__wrapped__"):
    _on_profiler_start.__wrapped__ = _profiler._run_on_profiler_start
    _profiler._run_on_profiler_start = _on_profiler_start


class _Off:
    """The span that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self, **attrs):
        pass


OFF = _Off()


class _Span:
    __slots__ = ("rec",)

    def __init__(self, name, attrs):
        stack = _REC.stack
        parent = stack[-1] if stack else None
        psr = attrs.pop("psr", None)
        if psr is None and parent is not None:
            psr = parent[4]
        self.rec = [name, time.time_ns(), None, -1 if parent is None else parent[6],
                    psr, attrs, len(_REC.records)]
        _REC.records.append(self.rec)
        stack.append(self.rec)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def end(self, **attrs):
        """Close the span (again: nothing), and any span opened inside it
        and left open by an exception, at this time."""
        rec = self.rec
        if rec[2] is not None:
            return
        t = time.time_ns()
        stack = _REC.stack
        if any(r is rec for r in stack):
            while stack:
                top = stack.pop()
                if top[2] is None:
                    top[2] = t
                if top is rec:
                    break
        rec[2] = t
        rec[5].update(attrs)


def span(name: str, **attrs):
    """A span opened now, recorded while a profiler runs, else the shared
    no-op ``OFF``: used as a ``with`` block, or closed by its
    ``end(**attrs)`` where it ends at a point a block cannot reach (a host
    read in the next pass of a loop).  ``psr=``: the registration's serial.
    Spans nest by the order they open and close, on one thread."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _Span(name, attrs)


def spans() -> list[Span]:
    """The spans of the current region (since the last profiler start), in
    the order they opened."""
    return [Span(r[0], r[1], r[2], r[3], r[4], dict(r[5])) for r in _REC.records]


def span_table(recorded=None) -> dict:
    """Per span name: ``n``, ``total_s`` and ``self_s`` (the duration less
    what the span's children cover), over ``recorded`` (default ``spans()``)."""
    recorded = spans() if recorded is None else recorded
    child_ns = defaultdict(int)
    for s in recorded:
        if s.parent >= 0:
            child_ns[s.parent] += s.end_ns - s.start_ns
    out: dict[str, dict] = {}
    for i, s in enumerate(recorded):
        dur = s.end_ns - s.start_ns
        row = out.setdefault(s.name, {"n": 0, "total_s": 0.0, "self_s": 0.0})
        row["n"] += 1
        row["total_s"] += dur / 1e9
        row["self_s"] += (dur - child_ns[i]) / 1e9
    return out


@contextlib.contextmanager
def phase_timer(name: str, sync=None):
    """Time a phase on ``perf_counter``; ``sync`` may be a callable that
    waits for the device (e.g. ``torch.cuda.synchronize``, or ``lambda:
    float(psr.FE)``), called before the phase ends.  The phase is a span of
    its own, recorded whether a profiler runs or not; a phase that raises
    is not timed."""
    s = _Span(name, {})
    try:
        t0 = time.perf_counter()
        yield
        if sync is not None:
            sync()
        _TIMINGS[name].append(time.perf_counter() - t0)
    finally:
        s.end()


def timings_summary(reset: bool = False) -> dict:
    out = {
        k: {"n": len(v), "total_s": sum(v), "mean_s": sum(v) / len(v)}
        for k, v in _TIMINGS.items()
        if v
    }
    if reset:
        _TIMINGS.clear()
    return out


def _add_spans(path: str, recorded) -> None:
    """The spans as complete events of the Chrome trace at ``path``, on a
    track of their own (pid "difficp spans"), in the trace's time base."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    events = doc.setdefault("traceEvents", [])
    for s in recorded:
        args = dict(s.attrs, psr=s.psr, parent=s.parent)
        events.append({"ph": "X", "cat": "difficp_span", "name": s.name,
                       "pid": "difficp spans", "tid": 0,
                       "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir: str = "traces"):
    """torch.profiler trace around a code region; yields the profiler.  On
    exit the trace is written to ``logdir/<host>_<pid>.<ms>.pt.trace.json``
    (``logdir`` relative to the working directory; open the file in Perfetto
    or chrome://tracing), the region's spans added to it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)

    def write(prof):
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                                    f"{time.time_ns() // 1_000_000}.pt.trace.json")
        prof.export_chrome_trace(path)
        _add_spans(path, spans())

    with profile(activities=activities, on_trace_ready=write) as prof:
        yield prof
