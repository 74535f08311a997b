"""The harness's spans of one name in the untraced part of a run: all of
them in an untraced run, those that start after the trace stopped in a
traced one (the profiler slows the host's dispatch while it records)."""


def untraced_spans(run, name):
    tr = run.get("trace")
    after = tr["stopped_at"] if tr else float("-inf")
    return [b - a for n, a, b in run["spans"] if n == name and a >= after]
