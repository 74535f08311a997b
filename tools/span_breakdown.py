#!/usr/bin/env python3
"""Where a traced window of a perfbench cell goes, read from the program's
spans (``difficp_torch/utils/profiling.py``) against the device trace, on
one CUDA card.

Run from the repository root:

    python3 tools/span_breakdown.py --workload twoset_dense.n131k --seed <n> \\
        --seconds 51 [--windows on,off,on,off]

The cell is set up as ``perfbench/run.py`` sets it up, then one measured
window runs per entry of ``--windows``, each from the cell's first
registration: ``on`` with the span recorder as it is, ``off`` with
``profiling.span`` replaced by the no-op (the
recorder's cost: the traced wall time per outer iteration of each).  The
trace covers whole outer iterations from each window's start for
``min(20, 0.4 x seconds)`` s, as in a ``--trace 1`` run.  No reference check
runs.  For the first ``on`` window it prints, and writes to
``build/span_breakdown.json`` (``--out``):

- ``idle_by_span``: the device's idle time in the traced window split by the
  innermost program span the host was in (outside every program span: the
  harness span, ``GMM_opt`` / ``Reg_opt`` / ``restart``, or ``harness``);
- ``idle_in_harness_spans``: of the idle time inside the harness's
  ``GMM_opt`` and ``Reg_opt`` spans, the share inside a child span of
  ``psr.GMM_opt`` / ``psr.Reg_opt`` (not their self time);
- ``iterations``: each outer iteration of each registration, its wall time
  and its EM steps, entry evaluations, line-search trials, row orders and
  coverage passes (count and ms);
- ``coverage``: each coverage pass (``psr.coverage``), its ms and the shape
  of its min reduction;
- ``routes``: the window's route decisions by function and route
  (``ops.backend.routes``);
- ``ops_by_harness_span``: the traced device operations that start inside
  each kind of harness span (``GMM_opt``, ``Reg_opt``, ``restart``), and
  those of ``Reg_opt`` per traced loss+grad;
- ``table``: count, total and self seconds per span name;
- ``metrics``: the six span readers of ``perfbench/metrics`` on the window.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from bisect import bisect_left
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SPAN_METRICS = ("em_steps_per_call", "em_step_ms", "em_idle_pct", "trials_per_linesearch",
                "lbfgs_idle_ms_per_eval", "wrapper_host_us")


def innermost_segments(spans, lo, hi):
    """[(a, b, index of the innermost span or -1)] covering [lo, hi], from
    properly nested spans."""
    points = []
    for i, s in enumerate(spans):
        points.append((s.start_ns, 1, i))
        points.append((s.end_ns, 0, i))
    points.sort()
    out, stack, t = [], [], lo
    for when, opens, i in points:
        when = min(max(when, lo), hi)
        if when > t:
            out.append((t, when, stack[-1] if stack else -1))
            t = when
        if opens:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
    if hi > t:
        out.append((t, hi, stack[-1] if stack else -1))
    return out


def idle_gaps(union, lo, hi):
    """The device's idle intervals inside [lo, hi]."""
    starts, ends = union
    gaps, t = [], lo
    for s, e in zip(starts, ends):
        if e <= lo:
            continue
        if s >= hi:
            break
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def overlap(intervals, segments):
    """For each segment (a, b, label), the ns of it that ``intervals`` (sorted,
    disjoint) cover: [(a, b, label, ns)] where ns > 0."""
    out, j = [], 0
    for a, b, label in segments:
        while j < len(intervals) and intervals[j][1] <= a:
            j += 1
        k, ns = j, 0
        while k < len(intervals) and intervals[k][0] < b:
            ns += min(b, intervals[k][1]) - max(a, intervals[k][0])
            k += 1
        if ns:
            out.append((a, b, label, ns))
    return out


def harness_at(hspans, t):
    inside = [name for name, a, b in hspans if a <= t <= b]
    return inside[-1] if inside else "harness"


def idle_table(spans, events, hspans, lo, hi):
    """(idle ns by innermost span name, idle ns inside the harness's GMM_opt /
    Reg_opt spans, of which inside a child of psr.GMM_opt / psr.Reg_opt)."""
    from perfbench.metrics._spans import busy_union

    gaps = idle_gaps(busy_union(events), lo, hi)
    by, work, child = {}, 0, 0
    for a, b, label, ns in overlap(gaps, innermost_segments(spans, lo, hi)):
        name = spans[label].name if label >= 0 else harness_at(hspans, (a + b) / 2)
        by[name] = by.get(name, 0) + ns
        if harness_at(hspans, (a + b) / 2) in ("GMM_opt", "Reg_opt"):
            work += ns
            if name not in ("psr.GMM_opt", "psr.Reg_opt", "GMM_opt", "Reg_opt"):
                child += ns
    return by, work, child


def ops_by(hspans, events):
    """The device operations that start inside each kind of harness span."""
    starts = sorted(e[1] for e in events)
    out = {}
    for name, a, b in hspans:
        out[name] = out.get(name, 0) + bisect_left(starts, b) - bisect_left(starts, a)
    return out


def iterations(spans):
    """Each registration's outer iterations (a psr.GMM_opt and the psr.Reg_opt
    calls after it), with their wall ms and what they hold."""
    from perfbench.metrics._spans import named

    top = [s for s in spans if s.name in ("psr.GMM_opt", "psr.Reg_opt") and s.parent < 0]
    groups = []
    for s in top:
        if s.name == "psr.GMM_opt" or not groups or groups[-1][0].psr != s.psr:
            groups.append([s])
        else:
            groups[-1].append(s)
    out = []
    for g in groups:
        a, b = g[0].start_ns, g[-1].end_ns
        inside = [s for s in spans if a <= s.start_ns and s.end_ns <= b and s.psr == g[0].psr]
        row = {"psr": g[0].psr, "wall_ms": (b - a) / 1e6, "calls": [s.name for s in g]}
        for key, name in (("em_steps", "gmm.em_step"), ("entries", "lbfgs.entry"),
                          ("trials", "lbfgs.eval"), ("searches", "lbfgs.linesearch"),
                          ("row_orders", "lddmm.row_order"), ("fe_syncs", "psr.fe_sync"),
                          ("coverage", "psr.coverage")):
            ss = named(inside, name)
            row[key] = [len(ss), sum(s.end_ns - s.start_ns for s in ss) / 1e6]
        out.append(row)
    return out


def one_window(win, entry, prob, device, seconds, seed, on):
    """A window of the cell from its first registration, with the recorder
    as it is (``on``) or stubbed; its record and spans."""
    from difficp_torch.ops import backend
    from difficp_torch.utils import profiling

    span = profiling.span
    if not on:
        profiling.span = lambda *a, **k: profiling.OFF
    try:
        reg = entry.Registration(prob, device, 0)
        backend.routes.clear()
        rec = win.window(entry, prob, reg, device, seconds, seed, True)
        win.free(reg)
    finally:
        profiling.span = span
    return rec, profiling.spans(), dict(backend.routes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="twoset_dense.n131k")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--windows", default="on")
    ap.add_argument("--out", default=str(ROOT / "build" / "span_breakdown.json"))
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness import window as win

    if not torch.cuda.is_available():
        print("span_breakdown: needs a CUDA card", file=sys.stderr)
        return 3
    # host clock (perf_counter) to the trace's (ns since the epoch)
    offset_ns = time.time_ns() - time.perf_counter_ns()
    c, entry, prob, reg = win.setup(args.workload, args.seed, "cuda")
    win.free(reg)
    del reg
    result = {"workload": args.workload, "seed": args.seed, "seconds": args.seconds,
              "card": torch.cuda.get_device_name(), "windows": []}
    for kind in args.windows.split(","):
        rec, spans, routes = one_window(win, entry, prob, "cuda", args.seconds, args.seed,
                                        kind == "on")
        tr = rec["trace"]
        w = {"recorder": kind, "traced_iterations": tr["iterations"],
             "traced_window_s": tr["window_s"],
             "traced_s_per_iteration": tr["window_s"] / tr["iterations"],
             "traced_evals": tr["evals"], "spans": len(spans),
             "spans_per_iteration": len(spans) / tr["iterations"],
             "idle_share": 1.0 - tr["busy_s"] / tr["window_s"]}
        if kind == "on" and "idle_by_span" not in result:
            lo = int(round((tr["stopped_at"] - tr["window_s"]) * 1e9)) + offset_ns
            hi = int(round(tr["stopped_at"] * 1e9)) + offset_ns
            hspans = [(n, int(a * 1e9) + offset_ns, int(b * 1e9) + offset_ns)
                      for n, a, b in rec["spans"]]
            by, work, child = idle_table(spans, tr["events"], hspans, lo, hi)
            result["idle_by_span"] = {k: v / 1e9 for k, v in
                                      sorted(by.items(), key=lambda kv: -kv[1])}
            result["idle_in_harness_spans"] = {"idle_s": work / 1e9, "in_child_s": child / 1e9,
                                               "share": child / work if work else None}
            result["iterations"] = iterations(spans)
            result["coverage"] = [dict(s.attrs, ms=(s.end_ns - s.start_ns) / 1e6)
                                  for s in spans if s.name == "psr.coverage"]
            ops = ops_by(hspans, tr["events"])
            result["ops_by_harness_span"] = dict(
                ops, reg_opt_per_eval=ops.get("Reg_opt", 0) / tr["evals"] if tr["evals"] else None)
            result["routes"] = {f"{fn} {route}": n for (fn, route), n in sorted(routes.items())}
            from difficp_torch.utils import profiling

            result["table"] = profiling.span_table(spans)
            w["metrics"] = {m: __import__(f"perfbench.metrics.{m}", fromlist=["read"]).read(rec)
                            for m in SPAN_METRICS}
            w["entry_and_eval_spans"] = sum(s.name in ("lbfgs.entry", "lbfgs.eval")
                                            for s in spans)
        result["windows"].append(w)
        print(json.dumps(w), flush=True)
    for kind in ("on", "off"):
        per = [w["traced_s_per_iteration"] for w in result["windows"] if w["recorder"] == kind]
        if per:
            result[f"median_traced_s_per_iteration_{kind}"] = statistics.median(per)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k not in ("windows", "table")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
