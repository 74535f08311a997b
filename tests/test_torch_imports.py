"""difficp_torch imports neither JAX nor anything of the JAX package: every
module of the port is imported in a fresh interpreter, which must then hold
no ``jax`` and no ``difficp_tpu`` module, and no ``matplotlib`` either (the
card's machine has none; viz/ imports it inside its plotting functions)."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import difficp_torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(difficp_torch.__path__,
                                                        "difficp_torch."))


def test_port_modules_import_without_jax():
    mods = _port_modules()
    assert "difficp_torch.ops.rhs_self" in mods and "difficp_torch.models.psr" in mods
    assert {"difficp_torch.viz.grid", "difficp_torch.viz.visu",
            "difficp_torch.utils.checkpoint", "difficp_torch.utils.profiling",
            "difficp_torch.api.deformetrica_atlas", "difficp_torch.examples.chui"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for name in {mods!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.startswith('jaxlib') or m.startswith('difficp_tpu')\n"
        "             or m.split('.')[0] == 'matplotlib')\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_imports_without_jax():
    """chip_smoke.py, imported as a module, pulls in no JAX either."""
    code = (
        "import sys, runpy\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "import difficp_torch.examples.run_large, difficp_torch.api.icp_two_set\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.startswith('difficp_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_fails_without_cuda():
    """Without a card the smoke test exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
