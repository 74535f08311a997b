"""``em_ms``: mean milliseconds of a ``GMM_opt`` call (``models/gmm.py``'s
EM through ``DiffPSR.GMM_opt``), from the harness's spans around each call
(host clock, the device synchronised at both ends) in the part of the
window after the trace stopped, so that the profiler's cost is not in it."""

from perfbench.metrics._untraced import untraced_spans


def read(run):
    spans = untraced_spans(run, "GMM_opt")
    return 1e3 * sum(spans) / len(spans) if spans else None
