"""One run of one cell: set-up, the measured window, the per-layer readings,
and the check against the reference.

The loop is closed, with one client: each outer iteration starts when the
one before it has ended, as a user's registration runs.  The window starts
from a fresh registration and ends at the first registration boundary past
``seconds``, so that it holds whole registrations: their first iterations
cost more than the later ones.  A registration that the source's own stop
ends is followed by the next, on the same sets in an order of its own
(set up inside the window, a ``restart`` span).  One outer iteration of the
window, drawn from the seed (a reservoir of one), is copied to the host for
the check, with the inputs of its registration.
"""

from __future__ import annotations

import gc
import importlib
import time
from contextlib import contextmanager

import numpy as np
import torch

from perfbench.harness import manifest as man

# traced outer iterations: whole ones from the window's start, until this
# much host time is traced, or this share of a shorter window (at 51 s, on
# the two-set, three registrations); the host-clock per-layer metrics read
# the untraced rest of the window
TRACE_SECONDS = 20.0
TRACE_SHARE = 0.4


class Spans:
    """(name, start, end) on the host clock around calls into the program,
    the device synchronised at both ends."""

    def __init__(self, sync):
        self.sync = sync
        self.records = []

    @contextmanager
    def __call__(self, name):
        self.sync()
        t0 = time.perf_counter()
        yield
        self.sync()
        self.records.append((name, t0, time.perf_counter()))


def _sync_for(device):
    return torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)


def setup(workload: str, seed: int, device, overrides=None):
    """Inputs from the seed, the entry's warm-up of the cell's own shapes and
    the window's first registration.  ``overrides`` ({"mix": {...},
    "config": {...}}, top-level keys replaced) shrink a cell for a rehearsal
    on the CPU."""
    c = man.cell(man.load(), workload)
    for key, new in (overrides or {}).items():
        c[key] = dict(c[key], **new)
    entry = importlib.import_module(f"perfbench.entries.{c['config']['entry']}")
    prob = entry.problem(c["config"], c["mix"], seed)
    entry.warm_up(prob, device)
    reg = entry.Registration(prob, device, 0)
    _sync_for(device)()
    return c, entry, prob, reg


def window(entry, prob, reg, device, seconds: float, seed: int, trace: bool):
    """The measured window.  Returns the run's record: iterations, failed
    iterations, evaluations, spans, wall seconds, the seconds at which each
    iteration ended, the registrations, the peak of allocated device memory,
    the shapes, the traced summary (with the host time at which the trace
    stopped and the evaluations up to it), and the sampled iteration's
    snapshot."""
    sync = _sync_for(device)
    spans = Spans(sync)
    pick = np.random.default_rng([int(seed), 0x5A3D])
    tr = None
    if trace:
        from perfbench.harness.trace import DeviceTrace

        tr = DeviceTrace()
    shapes = entry.shapes(reg)
    cuda = torch.device(device).type == "cuda"
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    if tr is not None:
        tr.start()
    n_iter = failed = n_reg = 0
    ends = []
    ev0 = entry.eval_count(prob)
    snap = None
    while True:
        chosen = pick.random() < 1.0 / (n_iter + 1)
        s = {} if chosen else None
        e_before = entry.eval_count(prob)
        failed += bool(entry.iteration(reg, spans, s))
        n_iter += 1
        ends.append(time.perf_counter() - t0)
        if s is not None:
            snap = s
        if tr is not None and tr.active:
            tr.evals += entry.eval_count(prob) - e_before
            tr.iterations += 1
            if time.perf_counter() - tr.t0 >= min(TRACE_SECONDS, TRACE_SHARE * seconds):
                tr.stop()
        if reg.done:
            n_reg += 1
            if time.perf_counter() >= deadline:
                break
            with spans("restart"):
                reg.psr = None
                reg = entry.Registration(prob, device, n_reg)
    sync()
    wall = time.perf_counter() - t0
    if tr is not None and tr.active:
        tr.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    record = {"iterations": n_iter, "failed": failed, "evals": entry.eval_count(prob) - ev0,
              "spans": spans.records, "wall_s": wall, "iteration_ends": ends,
              "registrations": n_reg, "peak_bytes": peak,
              "shapes": shapes, "snapshot": snap, "trace": None}
    if tr is not None:
        record["trace"] = tr.summary(spans.records)
    return record


def free(reg):
    """Drop the program's state before the reference runs."""
    reg.psr = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(prob: dict, snap: dict, limits: dict, failed: int, device):
    """The compared numbers of the sampled iteration, each beside its limit,
    and whether every one is within it."""
    from perfbench.reference import check as rc

    torch.backends.cuda.matmul.allow_tf32 = False
    snap = dict(snap, extent=prob["extent"])
    ref = rc.outputs(prob, snap, "float64", device)
    nums = rc.numbers(rc.program_outputs(snap), ref, prob["extent"])
    nums["fe_rises"] = float(failed)
    unknown = set(limits) - set(nums)
    if unknown:
        raise ValueError(f"limits for numbers the check does not take: {sorted(unknown)}")
    out = {name: {"value": value, "limit": limits[name]}
           for name, value in nums.items() if name in limits}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in out.values())
    return ok, out
