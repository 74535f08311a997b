"""The device trace of a ``--trace 1`` run: ``torch.profiler`` with CUDA
activity only (the kernels, copies and sets that ran on the card), over
whole outer iterations from the window's start, read back into device
intervals, the busy time (the union of those intervals, as
``chip_smoke.py``'s ``phase_profile`` takes it), and a breakdown: the device
operations that took most time and the longest idle gaps, each gap named by
the harness span the host was in.

Only device activity is recorded: the host operators of a traced outer
iteration number in the millions on the grid paths, which the profiler
could not hand back within a run's time.  Nothing is written to disk.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


class DeviceTrace:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0 = self.t1 = None
        self.active = False
        self.evals = 0
        self.iterations = 0

    def start(self):
        torch.cuda.synchronize()
        self._prof.start()
        torch.cuda.synchronize()
        # the host clock against the trace's (kineto stamps in ns since the epoch)
        self.t0 = time.perf_counter()
        self._epoch0 = time.time_ns()
        self.active = True

    def stop(self):
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.stop()
        self.active = False

    def to_epoch_ns(self, t: float) -> float:
        return self._epoch0 + (t - self.t0) * 1e9

    def summary(self, spans) -> dict:
        """Device intervals and the numbers read from them: ``events`` (name,
        start ns, duration ns), ``window_s`` (host clock, synchronised at both
        ends), ``busy_s``, ``breakdown``."""
        from torch.autograd import DeviceType

        events = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                events.append((e.name(), e.start_ns(), e.duration_ns()))
        events.sort(key=lambda t: t[1])
        busy, end, gaps = 0, None, []
        for name, s, dur in events:
            e = s + dur
            if end is None or s >= end:
                if end is not None:
                    gaps.append((end, s))
                busy += dur
                end = e
            elif e > end:
                busy += e - end
                end = e
        by_name = defaultdict(float)
        for name, _, dur in events:
            by_name[name] += dur / 1e9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        host = [(name, self.to_epoch_ns(a), self.to_epoch_ns(b)) for name, a, b in spans
                if b >= self.t0 and a <= self.t1]

        def host_doing(a, b):
            mid = (a + b) / 2
            inside = [name for name, s, e in host if s <= mid <= e]
            return inside[-1] if inside else "harness"

        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        return {"events": events, "window_s": self.t1 - self.t0, "busy_s": busy / 1e9,
                "evals": self.evals, "iterations": self.iterations, "stopped_at": self.t1,
                "breakdown": {"device_ops": [[n[:160], s] for n, s in top],
                              "idle_gaps": [[host_doing(a, b), (b - a) / 1e9]
                                            for a, b in longest]}}
