"""``lossgrad_ms``: milliseconds of the registration calls (``Reg_opt``:
``utils/lbfgs.py`` over ``models/lddmm.py``) per loss+grad evaluation they
made, in the part of the window after the trace stopped.  The spans are the
harness's, around each iteration's Reg_opt calls; the evaluations are the
lockstep count, one self-RHS backward launch per Euler step
(``ops/rhs_self.launches``)."""

from perfbench.metrics._untraced import untraced_spans


def read(run):
    tr = run.get("trace")
    evals = run["evals"] - (tr["evals"] if tr else 0)
    spans = untraced_spans(run, "Reg_opt")
    return 1e3 * sum(spans) / evals if spans and evals > 0 else None
