"""The port's profiling helpers (utils/profiling.py) against the JAX
package's: phase_timer and timings_summary keep the same registry, and
trace writes a torch.profiler trace file on the CPU."""

import glob
import json
import os
import time

import numpy as np
import pytest
import torch

from difficp_tpu.utils import profiling as jprof
from difficp_torch.models import lddmm as tl
from difficp_torch.utils import profiling as tprof

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_registry():
    tprof.timings_summary(reset=True)
    yield
    tprof.timings_summary(reset=True)


def _drive(mod):
    """The same phases through either package's timer."""
    calls = []
    for name, n in (("GMM_opt", 3), ("Reg_opt", 2)):
        for _ in range(n):
            with mod.phase_timer(name, sync=lambda: calls.append(name)):
                time.sleep(0.002)
    return calls


def test_phase_timer_and_summary_as_in_jax():
    jprof.timings_summary(reset=True)
    calls = _drive(tprof)
    assert calls == _drive(jprof) == ["GMM_opt"] * 3 + ["Reg_opt"] * 2
    got, ref = tprof.timings_summary(), jprof.timings_summary(reset=True)
    assert got.keys() == ref.keys() == {"GMM_opt", "Reg_opt"}
    for name, rec in got.items():
        assert rec.keys() == ref[name].keys() == {"n", "total_s", "mean_s"}
        assert rec["n"] == ref[name]["n"]
        assert rec["total_s"] >= 0.002 * rec["n"]
        np.testing.assert_allclose(rec["mean_s"], rec["total_s"] / rec["n"])
    # a summary without reset keeps the registry; with reset it empties it
    assert tprof.timings_summary(reset=True) == got
    assert tprof.timings_summary() == {} == jprof.timings_summary()


def test_phase_timer_without_sync_and_on_error():
    with tprof.phase_timer("plain"):
        pass
    with pytest.raises(RuntimeError):
        with tprof.phase_timer("failed"):
            raise RuntimeError("inside the phase")
    assert set(tprof.timings_summary()) == {"plain"}


def test_trace_writes_a_trace_file(tmp_path):
    """One shoot traced on the CPU: a Chrome trace file under logdir, with
    the shoot's operators in it."""
    cfg = tl.make_config(sigma=0.3, lambd=100.0, version="classic", nt=3, scheme="Euler")
    q = torch.as_tensor(np.random.default_rng(0).normal(size=(40, 2)).astype(np.float32))
    logdir = str(tmp_path / "trace")
    with tprof.trace(logdir) as prof:
        with tprof.phase_timer("shoot"):
            final, _ = tl.shoot(cfg, q, 0.05 * q)
    assert prof is not None and torch.isfinite(final.q).all()
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert tprof.timings_summary()["shoot"]["n"] == 1
