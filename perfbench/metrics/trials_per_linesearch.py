"""``trials_per_linesearch``: loss+grad trials per line search
(``utils/lbfgs.py``'s ``_linesearch``) in the traced window, from the
program's ``lbfgs.eval`` and ``lbfgs.linesearch`` spans."""

from perfbench.metrics._spans import named, program_spans


def read(run):
    spans = program_spans(run)
    if spans is None:
        return None
    searches = named(spans, "lbfgs.linesearch")
    return len(named(spans, "lbfgs.eval")) / len(searches) if searches else None
