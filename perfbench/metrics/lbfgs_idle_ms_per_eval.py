"""``lbfgs_idle_ms_per_eval``: milliseconds in which the card ran nothing
inside the program's ``psr.Reg_opt`` spans of the traced window, per
loss+grad evaluated there (``lbfgs.entry`` and ``lbfgs.eval`` spans): the
host's share of a loss+grad in the L-BFGS (``utils/lbfgs.py``) and the
shoots (``models/lddmm.py``)."""

from perfbench.metrics._spans import busy_union, idle_ns, named, program_spans


def read(run):
    spans = program_spans(run)
    if spans is None or not run["trace"]["events"]:
        return None
    calls = named(spans, "psr.Reg_opt")
    evals = (len(named(spans, "lbfgs.entry", under="psr.Reg_opt"))
             + len(named(spans, "lbfgs.eval", under="psr.Reg_opt")))
    if not evals:
        return None
    union = busy_union(run["trace"]["events"])
    return sum(idle_ns(union, s.start_ns, s.end_ns) for s in calls) / 1e6 / evals
