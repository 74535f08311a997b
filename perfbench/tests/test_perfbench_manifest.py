"""BENCHMARK.json against the benchmark's contract and the files it names."""

import importlib
import json
import re

import pytest

from perfbench.harness import manifest as man

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def mf():
    return man.load()


def test_top_level_keys_and_paths(mf):
    assert set(mf) == TOP
    assert 1 <= len(mf["paths"]) <= 16
    for p in mf["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(mf["command"]) <= 32
    assert isinstance(mf["run_seconds"], int) and 1 <= mf["run_seconds"] <= 51
    assert (man.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_and_units(mf):
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in mf[key]:
            assert NAME.match(e["name"]), e["name"]
            names.append((key, e["name"]))
    for c in mf["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in mf["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in mf["end_to_end"] + mf["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for key in ("configs", "workloads"):
        assert len({e["name"] for e in mf[key]}) == len(mf[key])
    metric_names = [m["name"] for m in mf["end_to_end"] + mf["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)


def test_entry_keys(mf):
    for c in mf["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in mf["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in mf["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in mf["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_what_it_must(mf):
    e2e = {m["name"] for m in mf["end_to_end"]}
    assert "setup_s" in e2e
    for w in mf["workloads"]:
        reported = {m["name"] for m in man.metrics_for(mf, w["name"], False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert man.metrics_for(mf, w["name"], True)


def test_moves_is_reported_by_every_listed_cell(mf):
    e2e = {m["name"]: m for m in mf["end_to_end"]}
    cells = {w["name"] for w in mf["workloads"]}
    for m in mf["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            assert m["moves"] in {x["name"] for x in man.metrics_for(mf, w, False)}


def test_files_found_by_name(mf):
    for w in mf["workloads"]:
        c = man.cell(mf, w["name"])
        assert c["config"]["name"] == w["config"]
        limits = set(c["limits"]["limits"])
        assert {"em_err", "fe_err", "grad_err", "reg_stall", "q0_diff", "fe_rises"} <= limits
        assert limits <= {"em_err", "fe_err", "x1_err", "grad_err", "reg_stall", "q0_diff",
                          "cover_diff", "fe_rises"}
        if c["config"]["support"]["scheme"] != "dense":
            assert {"x1_err", "cover_diff"} <= limits
        importlib.import_module(f"perfbench.entries.{c['config']['entry']}")
    files = [c["file"] for c in mf["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith(mf["paths"][0] + "/")
        json.loads((man.ROOT / f).read_text())
    for m in mf["per_layer"]:
        assert callable(importlib.import_module(f"perfbench.metrics.{m['name']}").read)


def test_four_chip_share(mf):
    four = sum(w["chips"] == 4 for w in mf["workloads"])
    assert four <= max(1, len(mf["workloads"]) // 4)
