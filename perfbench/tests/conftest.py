"""CPU tests of the benchmark (``python -m pytest perfbench/tests``); tests
marked ``cuda`` need the card and skip here, deciding inside a fixture."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# small sizes of each cell for a rehearsal on the CPU through the port's
# plain versions
TINY = {"twoset_dense.n131k": {"mix": {"points": 600}}}
# and shorter registrations: a few L-BFGS steps a call
for _w, _c in (("twoset_dense.n131k", "twoset_dense"),):
    _loop = json.loads((ROOT / "perfbench" / "configs" / f"{_c}.json").read_text())["loop"]
    _loop["reg_calls"] = [dict(c, nmax=min(c["nmax"], 2), inner=min(c["inner"], 3),
                               ls_steps=min(c["ls_steps"], 8)) for c in _loop["reg_calls"]]
    TINY[_w]["config"] = {"loop": _loop}
SEED = 2 ** 31 + 12345


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
