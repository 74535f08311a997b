"""``em_step_ms``: the median milliseconds of an EM step inside ``GMM_opt``
in the traced window, from the program's ``gmm.em_step`` spans (each ends
at the stop test's read of its free energy, or at its dispatch where no
read follows it: a call's first step, and its last at the step limit)."""

import statistics

from perfbench.metrics._spans import named, program_spans


def read(run):
    spans = program_spans(run)
    if spans is None:
        return None
    steps = named(spans, "gmm.em_step", under="psr.GMM_opt")
    if not steps:
        return None
    return statistics.median(s.end_ns - s.start_ns for s in steps) / 1e6
