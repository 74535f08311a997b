"""BENCHMARK.json and the files it names: a cell's configuration, traffic
mix and limits, each found by its name."""

from __future__ import annotations

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load(path=None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(manifest: dict, workload: str) -> dict:
    """The workload entry, its configuration (the file the manifest names),
    its traffic mix (``traffic/<traffic>.json``) and its limits
    (``checks/<workload>.json``)."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    with open(BENCH / "checks" / f"{workload}.json") as f:
        limits = json.load(f)
    return {"workload": w, "config": config, "mix": mix, "limits": limits}


def metrics_for(manifest: dict, workload: str, trace: bool) -> list:
    """The metrics this cell reports: its end-to-end metrics in an untraced
    run, its per-layer metrics in a traced one."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[key] if workload in m.get("workloads", [workload])]
