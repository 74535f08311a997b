"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout holding ``difficp_torch`` and ``BENCHMARK.json``.
It needs a CUDA card (as many as the cell asks for) and exits with another
code than 0, printing no result, without one.  The last line of standard
output is one JSON object: ``correct``, ``attempted`` (outer iterations in
the window), ``failed`` (those whose free energy rose or turned
non-finite), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its limit,
which also end standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout (the port's own
# nvcc build goes to build/ there, ops/_build.py)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
sys.path.insert(0, str(ROOT))

# top-level modules of the JAX package and its stack, which no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "difficp_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, whole) is
    one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run(workload: str, seed: int, seconds: float, trace: bool, device, t_start: float,
        overrides=None):
    """One run of the cell on ``device``, the result line's object (its
    ``checks`` last).  ``overrides``: see ``harness.window.setup``."""
    import torch

    from perfbench.harness import manifest as man
    from perfbench.harness import window as win

    mf = man.load()
    c, entry, prob, reg = win.setup(workload, seed, device, overrides)
    setup_s = time.perf_counter() - t_start
    rec = win.window(entry, prob, reg, device, seconds, seed, trace)
    win.free(reg)
    del reg
    ok, checks = win.check(prob, rec["snapshot"], c["limits"]["limits"], rec["failed"], device)
    metrics = {}
    for m in man.metrics_for(mf, workload, trace):
        name = m["name"]
        if name == "setup_s":
            value = setup_s
        elif name == "iter_s":
            value = rec["wall_s"] / rec["iterations"]
        elif name == "peak_mem_gib":
            value = rec["peak_bytes"] / 2 ** 30
        else:
            value = __import__(f"perfbench.metrics.{name}", fromlist=["read"]).read(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": m["unit"]}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": rec["peak_bytes"]}
    result = {"correct": bool(ok), "attempted": rec["iterations"], "failed": rec["failed"],
              "metrics": metrics, "device": dev}
    if trace and rec["trace"] is not None:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = rec["trace"]["breakdown"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness import manifest as man

    chips = man.cell(man.load(), args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {chips} CUDA card(s), found {n}", file=sys.stderr)
        return 3
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules of the JAX stack were loaded: {found}", file=sys.stderr)
        return 4
    result["device"]["power_limit"] = power_limit()
    emit(result, sys.stdout, sys.stderr)
    return 0


def emit(result: dict, out, err):
    """The card and each compared number beside its limit as the last lines of
    ``err``, then the result as the last line of ``out``, ``checks`` its last
    key."""
    result["checks"] = result.pop("checks")
    print(f"perfbench: card {result['device'].get('power_limit', 'unknown')}", file=err)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)


if __name__ == "__main__":
    sys.exit(main())
