"""Tracing and per-phase timing (counterpart of
``difficp_tpu/utils/profiling.py``; the reference has none, SURVEY §5).

- ``phase_timer``: wall-clock accounting per named phase (GMM_opt / Reg_opt
  / Template_opt ...), aggregated in a global registry that
  ``timings_summary`` reads.
- ``trace``: a ``torch.profiler`` trace of a code region, CPU activity and,
  where CUDA is available, the card's kernels; it writes a Chrome / Perfetto
  trace file (``*.pt.trace.json``) under ``logdir``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

_TIMINGS: dict[str, list[float]] = defaultdict(list)


@contextlib.contextmanager
def phase_timer(name: str, sync=None):
    """Time a phase; ``sync`` may be a callable that waits for the device
    (e.g. ``torch.cuda.synchronize``, or ``lambda: float(psr.FE)``)."""
    t0 = time.time()
    yield
    if sync is not None:
        sync()
    _TIMINGS[name].append(time.time() - t0)


def timings_summary(reset: bool = False) -> dict:
    out = {
        k: {"n": len(v), "total_s": sum(v), "mean_s": sum(v) / len(v)}
        for k, v in _TIMINGS.items()
        if v
    }
    if reset:
        _TIMINGS.clear()
    return out


@contextlib.contextmanager
def trace(logdir: str = "/tmp/difficp_trace"):
    """torch.profiler trace around a code region; yields the profiler.  On
    exit the trace is written to ``logdir/<host>_<pid>.<timestamp>.pt.trace.json``
    (open it in Perfetto or chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) \
            as prof:
        yield prof
