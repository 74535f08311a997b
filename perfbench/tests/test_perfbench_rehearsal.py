"""A run of each cell on the CPU at a small size, through the port's plain
versions: the whole harness but the look for a card, printing the result
line of the contract."""

import io
import json
import sys
import time

import pytest

from conftest import SEED, TINY
from perfbench.harness import manifest as man

sys.path.insert(0, str(man.BENCH))
import run  # noqa: E402

pytestmark = pytest.mark.usefixtures("pending_cells")

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("workload", sorted(TINY))
def test_one_result_line(workload):
    res = run.run(workload, SEED, 2.0, False, "cpu", time.perf_counter(), TINY[workload])
    out, err = io.StringIO(), io.StringIO()
    run.emit(res, out, err)
    obj = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(obj) == KEYS
    assert obj["correct"] is True, obj["checks"]
    assert obj["attempted"] >= 1 and obj["failed"] == 0
    mf = man.load()
    assert set(obj["metrics"]) == {m["name"] for m in man.metrics_for(mf, workload, False)}
    assert all(set(v) == {"value", "unit"} for v in obj["metrics"].values())
    assert obj["device"]["platform"] == "cpu"
    lines = err.getvalue().strip().splitlines()
    assert len(lines) >= len(obj["checks"])
    for line, (name, c) in zip(lines[-len(obj["checks"]):], obj["checks"].items()):
        assert line.startswith(f"check {name} = ") and set(c) == {"value", "limit"}


def test_without_a_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "twoset_dense.n131k", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
