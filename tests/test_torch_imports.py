"""The port stands alone: no file of gpufhe_tpu_torch/, and not chip_smoke.py,
imports jax or gpufhe_tpu (gpufhe_tpu/__init__.py pulls in jax through api.py);
`import gpufhe_tpu_torch` exports Session, CKKSParams and make_context and
builds nothing, needs no card, and loads neither jax nor the reference. The
golden model (golden/*) is an oracle independent of the port's kernels: with
the port's NTT, modular ops and kernel wrappers replaced by functions that
raise, and torch itself refused, every golden op and keygen without ctx
still gives the reference's limbs, and so do the golden backends."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
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
    for module in ("arithmetic", "ntt", "native", "rns", "ckks", "bgv", "bfv", "vectors"):
        assert f"gpufhe_tpu_torch/golden/{module}.py" in names
    assert "gpufhe_tpu_torch/keys/prng.py" in names
    assert "gpufhe_tpu_torch/keys/device_keygen.py" in names
    for module in ("backend", "linalg", "fftboot", "polyeval", "bootstrap", "bgv", "bfv",
                   "bgv_backend", "bfv_backend", "approx", "compare", "exact", "batch",
                   "threshold"):
        assert f"gpufhe_tpu_torch/ciphertext/{module}.py" in names
    for module in ("__init__", "linear", "mlp", "cnn", "logreg", "logreg_train", "pir",
                   "attention", "transformer"):
        assert f"gpufhe_tpu_torch/models/{module}.py" in names
    for module in ("api", "cli", "bench", "__init__"):
        assert f"gpufhe_tpu_torch/{module}.py" in names
    for module in ("__init__", "serialization", "security", "noise", "profiling", "benchkit"):
        assert f"gpufhe_tpu_torch/utils/{module}.py" in names
    for module in ("__init__", "mesh", "sharded", "bfv_sharded", "backend", "planner",
                   "multihost"):
        assert f"gpufhe_tpu_torch/parallel/{module}.py" in names


def test_package_import_builds_nothing_and_needs_no_card():
    """In a fresh process with no card, `import gpufhe_tpu_torch` starts no
    process (so no nvcc and no cc) and loads no shared library (ctypes.CDLL:
    no kernel and no golden NTT library), and loads neither jax nor the
    reference. torch and numpy are imported before the traps are set: their
    own libraries are not the package's. Nothing here reads the build
    directory, which other test processes may be writing at the same time."""
    code = """
import ctypes, subprocess, sys
import numpy, torch

called = []


def refuse(name):
    def trap(*args, **kwargs):
        called.append(name)
        raise RuntimeError(f"import gpufhe_tpu_torch called {name}")
    return trap


subprocess.run = refuse("subprocess.run")
subprocess.Popen = refuse("subprocess.Popen")
ctypes.CDLL = refuse("ctypes.CDLL")
import gpufhe_tpu_torch as g
assert not called, called
assert g.Session.__module__ == "gpufhe_tpu_torch.api"
assert g.CKKSParams.__module__ == "gpufhe_tpu_torch.params.params"
assert g.make_context.__module__ == "gpufhe_tpu_torch.params.params"
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "gpufhe_tpu")]
assert not bad, bad
"""
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(ROOT)})


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & set(BANNED)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


# the port's NTT, modular ops and kernel wrappers: what the golden model must
# not reach
PORT_OPS = ("gpufhe_tpu_torch.ops.ntt", "gpufhe_tpu_torch.ops.modops",
            "gpufhe_tpu_torch.ops.ntt_cuda", "gpufhe_tpu_torch.ops.convert_cuda",
            "gpufhe_tpu_torch.ops.mac_cuda")


def _trap_port_ops(monkeypatch) -> int:
    """Replace every function of PORT_OPS, wherever a module of the port
    holds it (by its own name or imported by name), with one that raises."""
    import importlib

    for name in PORT_OPS:
        importlib.import_module(name)
    patched = 0
    for modname, mod in list(sys.modules.items()):
        if mod is None or not modname.startswith("gpufhe_tpu_torch"):
            continue
        for attr, value in list(vars(mod).items()):
            if (callable(value) and not isinstance(value, type)
                    and getattr(value, "__module__", None) in PORT_OPS):
                def trap(*args, _what=f"{value.__module__}.{attr}", **kwargs):
                    raise AssertionError(f"the golden model called {_what}")

                monkeypatch.setattr(mod, attr, trap)
                patched += 1
    return patched


def _same_ct(got, want):
    assert got.level == want.level and len(got.c) == len(want.c)
    assert getattr(got, "pt_factor", None) == getattr(want, "pt_factor", None)
    assert getattr(got, "scale", None) == getattr(want, "scale", None)
    for g, w in zip(got.c, want.c):
        assert isinstance(g, np.ndarray) and (g == np.asarray(w)).all()


def _golden_ops_against_reference():
    """The ops the known-answer vectors do not reach, port == reference."""
    from gpufhe_tpu.golden import bfv as rgbfv
    from gpufhe_tpu.golden import bgv as rgbgv
    from gpufhe_tpu.golden import ckks as rgckks
    from gpufhe_tpu.params.params import preset as ref_preset
    from gpufhe_tpu_torch.golden import bfv as gbfv
    from gpufhe_tpu_torch.golden import bgv as gbgv
    from gpufhe_tpu_torch.golden import ckks as gckks
    from gpufhe_tpu_torch.params.params import preset

    outs = []
    for ckks, params in ((gckks, preset("tiny2")), (rgckks, ref_preset("tiny2"))):
        rng = np.random.default_rng(3)
        sk, pk = ckks.keygen(params, rng)
        gks = {s: ckks.make_galois_key(params, s, sk, rng) for s in (1, 2)}
        ck = ckks.make_conj_key(params, sk, rng)
        z = np.random.default_rng(4).normal(size=params.slots) + 0j
        ct = ckks.encrypt(ckks.encode(z, params.scale, params.q_primes, params.n), params, pk,
                          np.random.default_rng(5), params.scale)
        qp = params.q_primes + params.p_primes
        diag = ckks.ntt_limbs(ckks.encode(z, params.scale, qp, params.n), params, qp)
        low = ckks.Ciphertext([c[:1] for c in ct.c], 1, ct.scale)
        outs.append([ckks.ct_rotate(ct, 1, params, gks[1]), ckks.ct_conjugate(ct, params, ck),
                     ckks.ct_key_switch(ct, params, gks[2]), ckks.ct_mod_raise(low, params),
                     *ckks.ct_diag_fan(ct, [{0: diag, 2: diag}], params.scale, params, gks)])
    for mods, name in (((gbgv, rgbgv), "bgv_tiny"), ((gbfv, rgbfv), "bfv_tiny")):
        for mod, params in zip(mods, (preset(name), ref_preset(name))):
            rng = np.random.default_rng(6)
            sk, pk = mod.keygen(params, rng)
            gks = {s: mod.make_galois_key(params, s, sk, rng) for s in (1, 2)}
            ct = mod.encrypt(mod.encode(np.arange(params.n), params), params, pk,
                             np.random.default_rng(7))
            outs.append(mod.ct_rotate_hoisted(ct, [1, 2], params, gks) + [mod.ct_sub(ct, ct,
                                                                                     params)])
    for got, want in zip(outs[0::2], outs[1::2]):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_ct(g, w)


def test_golden_model_reaches_no_port_op_and_no_torch(monkeypatch):
    """Every golden op and keygen without ctx, with the port's ops trapped
    and any torch call refused: the six known-answer vectors (keygen and
    every op they trace, the reference's limbs in their files) and the ops
    they do not reach against the reference's. Then the three golden
    backends, on the port's own chests (drawn first, on the CPU), run a
    matvec with the port's ops trapped."""
    import torch
    from torch.overrides import TorchFunctionMode

    from gpufhe_tpu_torch.ciphertext import bfv as pbfv
    from gpufhe_tpu_torch.ciphertext import bgv as pbgv
    from gpufhe_tpu_torch.ciphertext import linalg
    from gpufhe_tpu_torch.ciphertext.backend import GoldenBackend
    from gpufhe_tpu_torch.ciphertext.bfv_backend import BFVGoldenBackend
    from gpufhe_tpu_torch.ciphertext.bgv_backend import BGVGoldenBackend
    from gpufhe_tpu_torch.golden import bfv as gbfv
    from gpufhe_tpu_torch.golden import bgv as gbgv
    from gpufhe_tpu_torch.golden import ckks as gckks
    from gpufhe_tpu_torch.golden import vectors
    from gpufhe_tpu_torch.keys import keys as pkeys
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.params.params import preset

    class NoTorch(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            raise AssertionError(f"the golden model called torch: {func}")

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        chests = {}  # the port's chests, drawn before the trap (keygen with ctx)
        for name, keygen in (("tiny2", pkeys.keygen), ("bgv_tiny", pbgv.keygen),
                             ("bfv_tiny", pbfv.keygen)):
            params = preset(name)
            rots = tuple(linalg.bsgs_rotations(params.slots))
            chests[name] = (params, keygen(params, np.random.default_rng(8), rotations=rots,
                                           ctx=make_context(params, device="cpu")))
        assert _trap_port_ops(monkeypatch) > 20
        with NoTorch():
            for name, gen in vectors.GENERATORS.items():
                got, want = gen(), np.load(vectors.VEC_DIR / f"{name}.npz")
                for key in want.files:
                    assert (np.asarray(got[key]) == want[key]).all(), (name, key)
            _golden_ops_against_reference()
        params, chest = chests["tiny2"]
        be = GoldenBackend(params, chest)
        rng = np.random.default_rng(10)
        a = rng.normal(size=(params.slots, params.slots)) / params.slots
        z = rng.normal(size=params.slots) + 0j
        x = gckks.encrypt(gckks.encode(z, params.scale, params.q_primes, params.n), params,
                          chest.pk, np.random.default_rng(11), params.scale)
        assert np.abs(be.decrypt_decode(linalg.matmul_plain(be, x, a)) - a @ z).max() < 1e-2
        for name, backend, gold in (("bgv_tiny", BGVGoldenBackend, gbgv),
                                    ("bfv_tiny", BFVGoldenBackend, gbfv)):
            params, chest = chests[name]
            ib = backend(params, chest)
            t = params.plain_modulus
            v = rng.integers(0, t, size=(2, params.slots))
            mat = rng.integers(0, t, size=(params.slots, params.slots))
            raw = np.empty(params.n, dtype=np.int64)
            raw[ib.rings[0]], raw[ib.rings[1]] = v[0], v[1]
            x = gold.encrypt(gold.encode(raw, params), params, chest.pk, np.random.default_rng(12))
            want = (mat.astype(object) @ v.T.astype(object) % t).T.astype(np.int64)
            assert (ib.decrypt_decode(linalg.matmul_plain(ib, x, mat)) == want).all()
    finally:
        torch.set_num_threads(threads)
