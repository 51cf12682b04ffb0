"""The port stands alone: no file of gpufhe_tpu_torch/, and not chip_smoke.py,
imports jax or gpufhe_tpu (gpufhe_tpu/__init__.py pulls in jax through api.py);
`import gpufhe_tpu_torch` exports Session, CKKSParams and make_context and
builds nothing, needs no card, and loads neither jax nor the reference."""

import ast
import os
import pathlib
import subprocess
import sys

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
    assert "gpufhe_tpu_torch/ops/mac_cuda.py" in names
    assert "gpufhe_tpu_torch/ops/probes.py" in names
    assert "gpufhe_tpu_torch/golden/bgv.py" in names
    assert "gpufhe_tpu_torch/golden/bfv.py" in names
    assert "gpufhe_tpu_torch/keys/prng.py" in names
    assert "gpufhe_tpu_torch/keys/device_keygen.py" in names
    for module in ("backend", "linalg", "fftboot", "polyeval", "bootstrap", "bgv", "bfv",
                   "bgv_backend", "bfv_backend", "approx", "compare", "exact", "batch",
                   "threshold"):
        assert f"gpufhe_tpu_torch/ciphertext/{module}.py" in names
    for module in ("__init__", "linear", "mlp", "cnn", "logreg", "logreg_train", "pir",
                   "attention", "transformer"):
        assert f"gpufhe_tpu_torch/models/{module}.py" in names
    for module in ("api", "cli", "__init__"):
        assert f"gpufhe_tpu_torch/{module}.py" in names
    for module in ("__init__", "serialization", "security", "noise", "profiling", "benchkit"):
        assert f"gpufhe_tpu_torch/utils/{module}.py" in names
    for module in ("__init__", "mesh", "sharded", "bfv_sharded", "backend", "planner",
                   "multihost"):
        assert f"gpufhe_tpu_torch/parallel/{module}.py" in names


def test_package_import_builds_nothing_and_needs_no_card():
    build = ROOT / "gpufhe_tpu_torch" / "csrc" / "build"
    before = sorted(build.iterdir()) if build.exists() else []
    code = ("import sys, gpufhe_tpu_torch as g; "
            "assert g.Session.__module__ == 'gpufhe_tpu_torch.api'; "
            "assert g.CKKSParams.__module__ == 'gpufhe_tpu_torch.params.params'; "
            "assert g.make_context.__module__ == 'gpufhe_tpu_torch.params.params'; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gpufhe_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(ROOT)})
    assert (sorted(build.iterdir()) if build.exists() else []) == before


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & set(BANNED)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
