"""Nothing the benchmark runs loads JAX or the JAX package ``repro``, and the
reference takes nothing from the port. Module names are compared whole, by
the part before the first dot: ``repro_torch`` is the port, ``repro`` is not."""
from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys
import types

from lirabench import run

HERE = pathlib.Path(__file__).resolve().parents[1]
REPO = HERE.parent


def _imports(path: pathlib.Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_of_the_benchmark_imports_jax_or_repro():
    for path in HERE.rglob("*.py"):
        found = _imports(path) & set(run.FORBIDDEN)
        assert not found, f"{path.relative_to(REPO)} imports {found}"


def test_reference_takes_nothing_from_the_port():
    assert _imports(HERE / "reference.py") <= {"__future__", "torch"}


def test_a_run_loads_no_jax(tmp_path):
    """A whole toy run in a fresh interpreter, then its loaded modules."""
    code = f"""
import json, pathlib, sys
sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]
from lirabench.tests.conftest import make_toy_root
from lirabench import run
root = make_toy_root(pathlib.Path({str(tmp_path)!r}))
res = run.run_cell(root, "toy.batch", 5, 0.3, True, device="cpu", log=lambda m: None)
print(json.dumps({{"forbidden": run.forbidden_modules(), "correct": res["correct"],
                  "torch": "repro_torch" in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "correct": True, "torch": True}


def test_the_check_names_what_it_finds(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    monkeypatch.setitem(sys.modules, "repro_torchlike", types.ModuleType("repro_torchlike"))
    assert run.forbidden_modules() == ["jax", "repro"]
