"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the library under test."""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "gpufhe_tpu", "__graft_entry__"}


def imported(path: pathlib.Path) -> set[str]:
    """Every module name a file imports, at any depth of its code."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def top(name: str) -> str:
    return name.split(".")[0]


MODULES = sorted(BENCH.rglob("*.py"))


def test_every_module_is_walked():
    assert any(p.parent.name == "reference" for p in MODULES)
    assert any(p.parent.name == "metrics" for p in MODULES)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    bad = {n for n in imported(path) if top(n) in FORBIDDEN}
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_whole_names_are_compared():
    # the port's name begins with the JAX package's: only a whole match counts
    assert top("gpufhe_tpu_torch.ops") not in FORBIDDEN
    assert top("gpufhe_tpu.ops") in FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    for name in imported(path):
        assert top(name) != "gpufhe_tpu_torch", f"{path.name} imports {name}"
        if top(name) == "fhebench":
            assert name.startswith("fhebench.reference"), f"{path.name} imports {name}"


def test_reference_loads_nothing_of_the_library():
    code = ("import sys, fhebench.reference.ckks, fhebench.reference.integer; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    assert "gpufhe_tpu_torch" not in out and "'jax'" not in out
