"""``em_idle_pct``: the share of the program's ``psr.GMM_opt`` spans in the
traced window in which no operation ran on the card (the union of the
trace's device intervals): how far the EM's host dispatch holds the device
back."""

from perfbench.metrics._spans import busy_union, idle_ns, named, program_spans


def read(run):
    spans = program_spans(run)
    if spans is None or not run["trace"]["events"]:
        return None
    calls = named(spans, "psr.GMM_opt")
    total = sum(s.end_ns - s.start_ns for s in calls)
    if total <= 0:
        return None
    union = busy_union(run["trace"]["events"])
    return 100.0 * sum(idle_ns(union, s.start_ns, s.end_ns) for s in calls) / total
