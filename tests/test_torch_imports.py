"""The port stands alone: no file of gpufhe_tpu_torch/, and not chip_smoke.py,
imports jax or gpufhe_tpu (gpufhe_tpu/__init__.py pulls in jax through api.py)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "gpufhe_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "gpufhe_tpu")


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_scan_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "chip_smoke.py" in names
    assert "gpufhe_tpu_torch/ops/ntt_cuda.py" in names
    assert "gpufhe_tpu_torch/ops/convert_cuda.py" in names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & set(BANNED)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
