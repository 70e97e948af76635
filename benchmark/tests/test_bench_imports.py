"""Nothing the harness runs loads JAX or the JAX package, compared by whole
top-level names, and the references import nothing of the program."""

import ast
import subprocess
import sys
import types

import harness
from conftest import HOME

NOT_EVER = {"jax", "jaxlib", "flax", "zippy_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in HOME.rglob("*.py"):
        found = set(_imports(path)) & NOT_EVER
        assert not found, (path, found)


def test_the_references_import_nothing_of_the_program():
    for path in (HOME / "reference").glob("*.py"):
        assert "zippy_tpu_torch" not in set(_imports(path)), path
        assert "zippy_tpu_torch" not in path.read_text(), path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "zippy_tpu_torch_like",
                        types.ModuleType("zippy_tpu_torch_like"))
    assert harness.forbidden_modules() == [] or all(
        n.split(".")[0] in NOT_EVER for n in harness.forbidden_modules())
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "zippy_tpu.api",
                        types.ModuleType("zippy_tpu.api"))
    assert set(harness.forbidden_modules()) - before == {"zippy_tpu.api"}


REHEARSAL = """
import sys, time
sys.path[:0] = [{home!r}, {root!r}]
import harness
from conftest import SMALL
bench = harness.Bench()
for cell in bench.spec["workloads"]:
    for trace in (False, True):
        harness.run_cell(bench, cell["name"], 5, 0.2, trace,
                         t0=time.perf_counter(), device="cpu",
                         overrides=SMALL[cell["config"]])
print(harness.forbidden_modules())
"""


def test_a_whole_rehearsal_loads_no_jax(tmp_path):
    code = REHEARSAL.format(home=str(HOME), root=str(HOME.parent))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=HOME / "tests", capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
