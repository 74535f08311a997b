"""The six readers of the program's spans (``metrics/_spans.py`` and the
metrics on it), exactly, on a synthetic run with known spans and device
events; then a traced run of each cell on the CPU at a small size, CPU
operators standing in for the card's, which reports them."""

import sys
import time
from types import SimpleNamespace

import pytest
import torch

from conftest import SEED, TINY
from difficp_torch.utils import profiling
from perfbench.harness import manifest as man
from perfbench.harness import trace as trace_mod
from perfbench.metrics import (em_idle_pct, em_step_ms, em_steps_per_call,
                               lbfgs_idle_ms_per_eval, trials_per_linesearch, wrapper_host_us)

sys.path.insert(0, str(man.BENCH))
import run  # noqa: E402

pytestmark = pytest.mark.usefixtures("pending_cells")

MS = 1_000_000
US = 1_000
READERS = {"em_steps_per_call": em_steps_per_call, "em_step_ms": em_step_ms,
           "em_idle_pct": em_idle_pct, "trials_per_linesearch": trials_per_linesearch,
           "lbfgs_idle_ms_per_eval": lbfgs_idle_ms_per_eval,
           "wrapper_host_us": wrapper_host_us}


def _synthetic():
    """Two GMM_opt calls of 3 and 5 EM steps (3 of 10, 20, 30 ms, then 5 of
    20 ms); one Reg_opt with an entry and two searches of 2 and 3 trials, and
    three wrapper calls of 10, 30 and 50 us; device busy 40 of the first
    call's 100 ms, all of the second call's, and 180 of Reg_opt's 200 ms."""
    S = profiling.Span
    t = 1_700_000_000 * 10 ** 9  # ns since the epoch
    spans = [S("psr.GMM_opt", t, t + 100 * MS, -1, 3, {})]
    spans += [S("gmm.em_step", t + a * MS, t + b * MS, 0, 3, {"step": i})
              for i, (a, b) in enumerate([(0, 10), (10, 30), (30, 60)])]
    spans.append(S("psr.GMM_opt", t + 200 * MS, t + 300 * MS, -1, 3, {}))
    spans += [S("gmm.em_step", t + (200 + 20 * i) * MS, t + (220 + 20 * i) * MS, 4, 3,
                {"step": i}) for i in range(5)]
    r = t + 400 * MS
    reg = len(spans)
    spans += [S("psr.Reg_opt", r, r + 200 * MS, -1, 3, {}),
              S("lbfgs.optimize", r + 1 * MS, r + 199 * MS, reg, 3, {}),
              S("lbfgs.entry", r + 2 * MS, r + 30 * MS, reg + 1, 3, {}),
              S("ops.rhs_self_fwd", r + 3 * MS, r + 3 * MS + 10 * US, reg + 2, 3, {}),
              S("lbfgs.linesearch", r + 40 * MS, r + 100 * MS, reg + 1, 3, {"trials": 2})]
    ls = len(spans) - 1
    spans += [S("lbfgs.eval", r + (41 + 25 * i) * MS, r + (65 + 25 * i) * MS, ls, 3, {})
              for i in range(2)]
    spans.append(S("ops.rhs_self_bwd", r + 42 * MS, r + 42 * MS + 50 * US, ls + 1, 3, {}))
    spans.append(S("lbfgs.linesearch", r + 110 * MS, r + 190 * MS, reg + 1, 3, {"trials": 3}))
    ls = len(spans) - 1
    spans += [S("lbfgs.eval", r + (111 + 25 * i) * MS, r + (135 + 25 * i) * MS, ls, 3, {})
              for i in range(3)]
    spans.append(S("ops.rhs_self_fwd", r + 112 * MS, r + 112 * MS + 30 * US, ls + 1, 3, {}))
    events = [("k1", t + 5 * MS, 30 * MS), ("k2", t + 20 * MS, 25 * MS),  # union 5-45: 40 ms
              ("k3", t + 190 * MS, 120 * MS),                               # covers call 2
              ("k4", r - 10 * MS, 100 * MS), ("k5", r + 100 * MS, 90 * MS)]  # 90 + 90 ms
    return spans, {"trace": {"events": events, "evals": 6}, "spans": []}


def test_readers_on_known_spans(monkeypatch):
    spans, run = _synthetic()
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    got = {name: r.read(run) for name, r in READERS.items()}
    assert got == {"em_steps_per_call": 4.0, "em_step_ms": 20.0,
                   "em_idle_pct": 100.0 * 60 / 200, "trials_per_linesearch": 2.5,
                   "lbfgs_idle_ms_per_eval": 20.0 / 6, "wrapper_host_us": 30.0}


@pytest.mark.parametrize("case", ["untraced", "no_spans", "older_program"])
def test_readers_find_nothing(monkeypatch, case):
    """None, and no error: an untraced run, a window with no span, and a
    program without the recorder (no ``profiling.spans``)."""
    spans, run = _synthetic()
    if case == "untraced":
        monkeypatch.setattr(profiling, "spans", lambda: spans)
        run = dict(run, trace=None)
    elif case == "no_spans":
        monkeypatch.setattr(profiling, "spans", lambda: [])
    else:
        monkeypatch.delattr(profiling, "spans")
    assert all(r.read(run) is None for r in READERS.values())


class _AsDevice:
    """A CPU operator of the profiler, passed off as a device operation."""

    def __init__(self, e):
        self.e = e

    def name(self):
        return self.e.name()

    def start_ns(self):
        return self.e.start_ns()

    def duration_ns(self):
        return self.e.duration_ns()

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA


class CPUTrace(trace_mod.DeviceTrace):
    """The harness's trace on the CPU: the profiler records CPU activity, and
    its operators stand in for the card's."""

    def __init__(self):
        super().__init__()
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU])

    def summary(self, spans):
        ops = [_AsDevice(e) for e in self._prof.profiler.kineto_results.events()
               if e.name().startswith("aten::")]
        real = self._prof
        self._prof = SimpleNamespace(profiler=SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: ops)))
        try:
            return super().summary(spans)
        finally:
            self._prof = real


@pytest.mark.parametrize("workload", sorted(TINY))
def test_traced_rehearsal_reports_the_span_metrics(monkeypatch, workload):
    """``--trace 1`` on the CPU at a small size, the device trace CPU
    operators, the kernel wrappers' route forced (their plain versions)
    where the cell reads their spans: the result reports the span metrics
    the cell lists; the EM steps a call lie in [2, the EM's limit]."""
    from difficp_torch.ops import backend

    listed = {m["name"] for m in man.metrics_for(man.load(), workload, True)}
    readers = set(READERS) & listed
    monkeypatch.setattr(trace_mod, "DeviceTrace", CPUTrace)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    backend.set_backend("kernel" if "wrapper_host_us" in listed else None)
    try:
        res = run.run(workload, SEED, 2.0, True, "cpu", time.perf_counter(), TINY[workload])
    finally:
        backend.set_backend(None)
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert {"trials_per_linesearch", "lbfgs_idle_ms_per_eval"} <= readers <= set(res["metrics"])
    for name in readers:
        assert res["metrics"][name]["value"] >= 0, name
    spans = profiling.spans()
    if "em_steps_per_call" in readers:
        em_limit = man.cell(man.load(), workload)["config"]["loop"]["em"]["max_iterations"]
        assert 2 <= res["metrics"]["em_steps_per_call"]["value"] <= em_limit
        assert 0 <= res["metrics"]["em_idle_pct"]["value"] <= 100
        assert sum(s.name == "psr.GMM_opt" for s in spans) >= 1
    assert sum(s.name in ("lbfgs.entry", "lbfgs.eval") for s in spans) >= 3
