"""The program's spans (utils/profiling.py) on the CPU: the tree of a
dense DiffPSR's GMM_opt and Reg_opt, the counts of EM steps and loss+grads
against the program's own, nothing recorded and nothing changed without a
profiler, the cost of a span that records nothing, the clock against the
profiler's, and regions that do not mix.  Imports no JAX."""

import glob
import json
import os
import time
import timeit

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from difficp_torch.models import gmm as gmm_mod
from difficp_torch.models import lddmm
from difficp_torch.models.psr import DiffPSR
from difficp_torch.ops import backend
from difficp_torch.utils import profiling

torch.set_num_threads(1)

# the parent each span name takes in a DiffPSR's GMM_opt and Reg_opt
PARENTS = {
    "psr.GMM_opt": {None}, "psr.Reg_opt": {None}, "psr.init": {None},
    "gmm.em_step": {"psr.GMM_opt"},
    "psr.fe_sync": {"psr.GMM_opt", "psr.Reg_opt", "psr.init"},
    "lddmm.row_order": {"psr.Reg_opt"}, "lbfgs.optimize": {"psr.Reg_opt"},
    "lbfgs.entry": {"lbfgs.optimize"}, "lbfgs.linesearch": {"lbfgs.optimize"},
    "lbfgs.eval": {"lbfgs.linesearch"},
    "ops.rhs_self_fwd": {"lbfgs.entry", "lbfgs.eval"},
    "ops.rhs_self_bwd": {"lbfgs.entry", "lbfgs.eval"},
}


def _psr(frames=1, n=48):
    rng = np.random.default_rng(3)
    x = [rng.normal(size=(n, 2)).astype(np.float32) for _ in range(frames)]
    state, cfg = gmm_mod.create(x[0][:6], device="cpu")
    lcfg = lddmm.make_config(sigma=0.5, lambd=100.0, version="hybrid", nt=3, scheme="Euler")
    psr = DiffPSR(x if frames > 1 else x[0], state, cfg, lcfg, device="cpu")
    psr.printstuff = False
    return psr


def _iteration(psr):
    """GMM_opt, then a Reg_opt with an entry evaluation and one that
    carries the value (no entry)."""
    psr.GMM_opt(max_iterations=6, tol=1e-4)
    psr.Reg_opt(nmax=1, inner=2, carry_value=True, carry_memory=True)
    first = int(psr.last_reg_evals.sum())
    psr.Reg_opt(nmax=1, inner=2, carry_value=True, carry_memory=True)
    return first, int(psr.last_reg_evals.sum())


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=False) as prof:
        out = fn()
    return out, profiling.spans(), prof


@pytest.fixture
def kernel_route():
    """The kernel wrappers' route (their plain versions on the CPU) at the
    tests' small size, so that the ops spans show."""
    backend.set_backend("kernel")
    yield
    backend.set_backend(None)


def test_span_tree_of_gmm_and_reg_opt(kernel_route):
    psr, spans, _ = _traced(lambda: (lambda p: (_iteration(p), p)[1])(_psr()))
    names = {s.name for s in spans}
    assert names == set(PARENTS), names ^ set(PARENTS)
    for s in spans:
        parent = spans[s.parent] if s.parent >= 0 else None
        assert (parent.name if parent else None) in PARENTS[s.name], s
        assert s.psr == psr.serial
        assert s.start_ns <= s.end_ns
        if parent is not None:
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns, (s, parent)
    for i, s in enumerate(spans):
        if s.name == "lbfgs.linesearch":
            trials = [c for c in spans if c.parent == i and c.name == "lbfgs.eval"]
            assert s.attrs["trials"] == len(trials) >= 1
    assert [s.attrs["step"] for s in spans if s.name == "gmm.em_step"] == list(
        range(sum(s.name == "gmm.em_step" for s in spans)))
    # psr.init ends at its own free-energy read
    init = next(i for i, s in enumerate(spans) if s.name == "psr.init")
    assert spans[init + 1].name == "psr.fe_sync" and spans[init + 1].end_ns <= spans[init].end_ns


def test_em_steps_equal_the_em_count(monkeypatch):
    counts = []
    em = gmm_mod.em_optimization

    def counted(*args, **kwargs):
        out = em(*args, **kwargs)
        counts.append(out.n_iters)
        return out

    monkeypatch.setattr(gmm_mod, "em_optimization", counted)

    def run():
        psr = _psr(frames=2)
        for cap in (1, 2, 6, 40):
            psr.GMM_opt(max_iterations=cap, tol=1e-4)

    _, spans, _ = _traced(run)
    calls = [i for i, s in enumerate(spans) if s.name == "psr.GMM_opt"]
    steps = [sum(s.name == "gmm.em_step" and s.parent == i for s in spans) for i in calls]
    assert steps == counts and counts[:2] == [1, 2] and len(counts) == 4


def test_entry_and_trials_equal_the_lbfgs_count():
    """On one frame, the lbfgs.entry and lbfgs.eval spans of each Reg_opt
    are its L-BFGS's evaluations (n_evals) plus the entry where one ran."""
    (first, second), spans, _ = _traced(lambda: _iteration(_psr()))
    calls = [i for i, s in enumerate(spans) if s.name == "psr.Reg_opt"]

    def under(i, name):
        out = 0
        for s in spans:
            j = s.parent
            while j >= 0 and j != i:
                j = spans[j].parent
            out += j == i and s.name == name
        return out

    assert [under(i, "lbfgs.entry") for i in calls] == [1, 0]
    assert [under(i, "lbfgs.eval") for i in calls] == [first, second]
    assert first >= 1 and second >= 1


def test_without_a_profiler_nothing_is_recorded_and_nothing_changes(kernel_route):
    (_, traced), _, _ = _traced(lambda: (lambda p: (_iteration(p), p))(_psr()))
    before = profiling.spans()
    plain = _psr()
    _iteration(plain)
    assert profiling.spans() == before and not profiling._REC.stack
    assert plain.FE == traced.FE
    assert torch.equal(plain.a0, traced.a0) and torch.equal(plain.x1, traced.x1)


def test_a_span_off_costs_under_a_microsecond():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("x", step=1) is profiling.OFF is profiling.span("x")

    def block():
        with profiling.span("ops.x"):
            pass

    n = 20000
    per = min(timeit.repeat(lambda: profiling.span("ops.x"), number=n, repeat=5)) / n
    per_end = min(timeit.repeat(lambda: profiling.span("ops.x").end(), number=n,
                                repeat=5)) / n
    per_block = min(timeit.repeat(block, number=n, repeat=5)) / n
    assert per < 1e-6 and per_end < 1e-6 and per_block < 1e-6, (per, per_end, per_block)


def test_a_span_agrees_with_record_function():
    """A span and a record_function range opened and closed at the same
    points: both ends within 100 us (the clock is the profiler's)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):
            pass
        for i in range(3):
            with profiling.span(f"probe{i}"), record_function(f"range{i}"):
                time.sleep(0.002)
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()}
    spans = [s for s in profiling.spans() if s.name.startswith("probe")]
    assert len(spans) == 3
    for s in spans:
        e = ranges["range" + s.name[-1]]
        assert abs(e.start_ns() - s.start_ns) < 100_000, (e.start_ns(), s.start_ns)
        assert abs(e.start_ns() + e.duration_ns() - s.end_ns) < 100_000


def test_two_traced_regions_do_not_mix():
    for region in ("first", "second"):
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span(f"{region}.a"):
                with profiling.span(f"{region}.b", psr=7):
                    pass
    spans = profiling.spans()
    assert [(s.name, s.parent, s.psr) for s in spans] == [("second.a", -1, None),
                                                           ("second.b", 0, 7)]


def test_an_open_span_left_by_an_error_is_closed_with_its_parent():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with profiling.span("outer"):
                profiling.span("inner")
                raise ValueError("inside")
        with profiling.span("after"):
            pass
    spans = profiling.spans()
    assert [(s.name, s.parent) for s in spans] == [("outer", -1), ("inner", 0),
                                                    ("after", -1)]
    assert spans[1].end_ns == spans[0].end_ns and not profiling._REC.stack


def test_span_table_self_time():
    S = profiling.Span
    spans = [S("a", 0, 10_000_000_000, -1, None, {}), S("b", 1_000_000_000, 4_000_000_000, 0,
                                                        None, {}),
             S("b", 5_000_000_000, 6_000_000_000, 0, None, {}),
             S("c", 2_000_000_000, 3_000_000_000, 1, None, {})]
    table = profiling.span_table(spans)
    assert table == {"a": {"n": 1, "total_s": 10.0, "self_s": 6.0},
                     "b": {"n": 2, "total_s": 4.0, "self_s": 3.0},
                     "c": {"n": 1, "total_s": 1.0, "self_s": 1.0}}


def test_phase_timer_is_a_span_and_trace_writes_the_spans(tmp_path, monkeypatch):
    """trace() writes under ./traces by default, and its Chrome file holds
    the program's spans; a phase_timer is one of them."""
    monkeypatch.chdir(tmp_path)
    with profiling.trace():
        with profiling.phase_timer("phase"):
            _psr().GMM_opt(max_iterations=3)
    files = glob.glob(os.path.join("traces", "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "difficp_span"]
    names = [e["name"] for e in spans]
    assert names[0] == "phase" and "psr.GMM_opt" in names and "gmm.em_step" in names
    assert [s.name for s in profiling.spans()] == names
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in spans)
    # a phase is recorded with no profiler running too
    profiling.timings_summary(reset=True)
    with profiling.phase_timer("alone"):
        pass
    assert profiling.timings_summary(reset=True)["alone"]["n"] == 1
    assert profiling._REC.records[-1][0] == "alone" and not profiling._REC.stack
