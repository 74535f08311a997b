"""What the benchmark loads: nothing of the JAX stack anywhere, and nothing of
the program in the reference.  Top-level module names (before the first dot)
are compared whole: the port's name begins with the JAX package's."""

import ast
import subprocess
import sys

import pytest

from perfbench.harness import manifest as man

JAX_STACK = {"jax", "jaxlib", "flax", "difficp_tpu"}
SOURCES = sorted(man.BENCH.rglob("*.py"))


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(man.ROOT)))
def test_no_source_imports_the_jax_stack(path):
    assert not top_level_imports(path) & JAX_STACK


@pytest.mark.parametrize("path", sorted((man.BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "difficp_torch" not in top_level_imports(path)


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         capture_output=True, text=True, cwd=man.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_module_of_the_jax_stack():
    mods = _loaded_after(
        "import sys; sys.path.insert(0, '.')\n"
        "import perfbench.run, perfbench.harness.window, perfbench.harness.trace\n"
        "import perfbench.entries.diffpsr, perfbench.reference.check\n"
        "import perfbench.metrics.em_ms, perfbench.metrics.self_rhs_roofline_pct")
    assert not mods & JAX_STACK
    assert "difficp_torch" in mods


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded_after("import sys; sys.path.insert(0, '.')\n"
                         "import perfbench.reference.check")
    assert "difficp_torch" not in mods and not mods & JAX_STACK


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(man.BENCH))
    import run

    monkeypatch.setitem(sys.modules, "difficp_tpux", sys)
    assert run.forbidden_modules() == sorted(JAX_STACK & {m.split(".")[0] for m in sys.modules})
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()
