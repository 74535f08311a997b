"""``em_steps_per_call``: EM steps per ``GMM_opt`` call in the traced window
(``models/gmm.py``'s ``em_optimization``): the program's ``gmm.em_step``
spans inside ``psr.GMM_opt`` spans over those calls."""

from perfbench.metrics._spans import named, program_spans


def read(run):
    spans = program_spans(run)
    if spans is None:
        return None
    calls = named(spans, "psr.GMM_opt")
    steps = named(spans, "gmm.em_step", under="psr.GMM_opt")
    return len(steps) / len(calls) if calls else None
