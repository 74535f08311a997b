"""On the card: the command as the driver runs it, for each cell, traced
and untraced, with a short window (``python -m pytest --noconftest`` is not
needed: these tests import nothing of JAX)."""

import json
import subprocess
import sys

import pytest

from perfbench.harness import manifest as man


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [w["name"] for w in man.load()["workloads"]])
def test_a_short_run_is_correct(card, workload, trace):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", workload,
                          "--seed", str(2 ** 31 + 99), "--seconds", "5", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=man.ROOT, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    obj = json.loads(out.stdout.strip().splitlines()[-1])
    assert obj["correct"] is True, obj["checks"]
    assert obj["device"]["platform"] == "gpu" and obj["device"]["count"] == 1
    mf = man.load()
    want = {m["name"] for m in man.metrics_for(mf, workload, bool(trace))}
    assert set(obj["metrics"]) == want
    if trace:
        assert 0 < obj["device"]["busy_s"] <= obj["device"]["window_s"]
