"""CPU tests of the benchmark (``python -m pytest perfbench/tests``); tests
marked ``cuda`` need the card and skip here, deciding inside a fixture."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.harness import manifest as man  # noqa: E402

# cells whose configuration, traffic mix and limits are in perfbench/ but
# which BENCHMARK.json does not hold (PERF.md §7: their iter_s spreads too
# wide): the manifest entries a change that adds them would make, so that
# the CPU tests drive them through the same harness (``pending_cells``)
PENDING = {
    "configs": [{"name": "atlas_grid", "file": "perfbench/configs/atlas_grid.json",
                 "reduced": ["max_iterations"]}],
    "workloads": [{"name": "atlas_grid.k40", "config": "atlas_grid", "traffic": "k40",
                   "chips": 1}],
    # the per-layer metrics whose readers find something in these cells (the
    # EM's span metrics do not: the traced part of a window ends in the
    # first iteration, which runs no EM)
    "per_layer": ["em_ms", "lossgrad_ms", "evals_per_iter", "launches_per_eval",
                  "device_idle_pct", "trials_per_linesearch", "lbfgs_idle_ms_per_eval"],
}

# one thread: the CPU sums come out the same in every run
torch.set_num_threads(1)

# small sizes of each cell for a rehearsal on the CPU through the port's
# plain versions
TINY = {"twoset_dense.n131k": {"mix": {"points": 600}},
        "atlas_grid.k40": {"mix": {"frames": 3, "points": 500}}}
# and shorter registrations: a few L-BFGS steps a call
for _w, _c in (("twoset_dense.n131k", "twoset_dense"), ("atlas_grid.k40", "atlas_grid")):
    _loop = json.loads((ROOT / "perfbench" / "configs" / f"{_c}.json").read_text())["loop"]
    _loop["reg_calls"] = [dict(c, nmax=min(c["nmax"], 2), inner=min(c["inner"], 3),
                               ls_steps=min(c["ls_steps"], 8)) for c in _loop["reg_calls"]]
    TINY[_w]["config"] = {"loop": _loop}
SEED = 2 ** 31 + 12345
# the seed of each cell's check at those sizes: with a window of 0 s (one
# registration) the atlas's samples its third iteration, since its first
# runs no EM
SEEDS = {"twoset_dense.n131k": SEED, "atlas_grid.k40": 2 ** 31 + 12348}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(scope="module")
def pending_cells():
    """``manifest.load`` with the PENDING cells in it, for one test module."""
    real = man.load

    def load(path=None):
        mf = real(path)
        mf["configs"] = mf["configs"] + PENDING["configs"]
        mf["workloads"] = mf["workloads"] + PENDING["workloads"]
        names = [w["name"] for w in PENDING["workloads"]]
        mf["per_layer"] = [dict(m, workloads=m["workloads"] + names)
                           if m["name"] in PENDING["per_layer"] else m
                           for m in mf["per_layer"]]
        return mf

    mp = pytest.MonkeyPatch()
    mp.setattr(man, "load", load)
    yield
    mp.undo()
