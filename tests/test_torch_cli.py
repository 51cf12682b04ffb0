"""The port's CLI (python -m gpufhe_tpu_torch.cli) against the reference's.

Every ported subcommand runs once with --cpu, at its default preset (kernels
and keygen at tiny2: their defaults are full-size chains), in process. Each
line it prints is the reference CLI's line for the same arguments, key for
key and value for value, apart from times (`steady_s`, `first_s`) and the
kernels rows, whose measures are the card's (the reference's are a TPU's:
there the row names are compared). The reference runs its own subcommand
code over its golden model: its DeviceBackend, BGVDeviceBackend and
BFVDeviceBackend are the golden backends of the scheme and its three
device encrypts the golden ones (the same draws, from the canonical public
key), so no jit compile runs, and its EncryptedMLP lifts as the port's does
(tests/lifted_mlp.py); security, keygen and demo-threshold are host
code in the reference already. keygen's two files are also held equal, and
the written chest loads in the port's Session.
"""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from gpufhe_tpu import cli as rcli
from gpufhe_tpu.ciphertext import backend as rbackend
from gpufhe_tpu.ciphertext import bfv as rbfv
from gpufhe_tpu.ciphertext import bfv_backend as rbfv_backend
from gpufhe_tpu.ciphertext import bgv as rbgv
from gpufhe_tpu.ciphertext import bgv_backend as rbgv_backend
from gpufhe_tpu.ciphertext import ct as rct
from gpufhe_tpu.golden import bfv as rgbfv
from gpufhe_tpu.golden import bgv as rgbgv
from gpufhe_tpu.golden import ckks as rgckks
from gpufhe_tpu.models import mlp as rmlp
from gpufhe_tpu_torch import cli
from gpufhe_tpu_torch.api import Session
from lifted_mlp import LiftedMLP


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's PyTorch CPU work: its tensors are
    small (N <= 2^10), and tier-1 runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _canonical_pk(pk, params):
    """A device public key (Montgomery form, x 2^32 mod q) as the golden one."""
    q = np.asarray(params.q_primes, dtype=np.int64)[:, None]
    rinv = np.asarray([pow(2**32, -1, int(p)) for p in params.q_primes], np.int64)[:, None]
    canon = [np.asarray(x).astype(np.int64) * rinv % q for x in (pk.b_mont, pk.a_mont)]
    return rgckks.PublicKey(b=canon[0], a=canon[1])


@pytest.fixture
def golden_reference(monkeypatch):
    """The reference's device backends and encrypts swapped for its golden
    model (module docstring)."""
    def ckks_encrypt(pt, params, pk, ctx, rng, scale, level=None):
        return rgckks.encrypt(pt, params, _canonical_pk(pk, params), rng, scale,
                              level=level)

    def integer_encrypt(gold):
        def encrypt(pt, params, pk, ctx, rng, level=None):
            return gold.encrypt(pt, params, _canonical_pk(pk, params), rng, level=level)
        return encrypt

    monkeypatch.setattr(rbackend, "DeviceBackend",
                        lambda params, ctx, chest: rbackend.GoldenBackend(params, chest))
    monkeypatch.setattr(rbgv_backend, "BGVDeviceBackend",
                        lambda params, ctx, chest: rbgv_backend.BGVGoldenBackend(params, chest))
    monkeypatch.setattr(rbfv_backend, "BFVDeviceBackend",
                        lambda params, ctx, chest: rbfv_backend.BFVGoldenBackend(params, chest))
    monkeypatch.setattr(rct, "encrypt", ckks_encrypt)
    # the port's square networks lift their activations (models/mlp.py
    # _lift_of): the reference's model with the port's lift
    monkeypatch.setattr(rmlp, "EncryptedMLP", LiftedMLP)
    monkeypatch.setattr(rbgv, "encrypt", integer_encrypt(rgbgv))
    monkeypatch.setattr(rbfv, "encrypt", integer_encrypt(rgbfv))


def _lines(main, argv) -> list[dict]:
    out = io.StringIO()
    with redirect_stdout(out):
        main(argv)
    return [json.loads(line) for line in out.getvalue().splitlines()]


TIMES = ("steady_s", "first_s")


def _without_times(rows):
    return [{k: v for k, v in r.items() if k not in TIMES} for r in rows]


# subcommand arguments; every one at its default preset but kernels and keygen
COMMANDS = {
    "demo-mlp": [],
    "demo-deep-mlp": [],
    "demo-train": [],
    "demo-logreg": [],
    "demo-bgv": [],
    "demo-bfv": [],
    "demo-threshold": [],
    "demo-attention": [],
    "demo-matmul": [],
    "security": [],
}


# the port's trainer evaluates the reference's update in another order (lr/m
# after the SlotSum; models/logreg_train.py), so these values of demo-train
# are held to a tolerance: at ci_deep the reference's order reads 1.9e-3
# from the cleartext weights after two steps and the port's 7.7e-5, and a
# wrong step moves them by about 0.3
CLOSE = {"demo-train": {"encrypted_weights": 5e-3, "max_abs_err": 5e-3}}


@pytest.mark.parametrize("cmd", sorted(COMMANDS))
def test_subcommand_json_equals_the_reference(cmd, golden_reference):
    got = _lines(cli.main, ["--cpu", cmd, *COMMANDS[cmd]])
    want = _lines(rcli.main, ["--cpu", cmd, *COMMANDS[cmd]])
    close = CLOSE.get(cmd, {})
    assert len(got) == 1 and len(want) == 1
    for key, tol in close.items():
        assert np.abs(np.subtract(got[0][key], want[0][key])).max() < tol, key
    if "max_abs_err" in close:
        assert got[0]["max_abs_err"] <= want[0]["max_abs_err"]
    strip = [{k: v for k, v in r.items() if k not in close} for r in (got[0], want[0])]
    assert _without_times(strip[:1]) == _without_times(strip[1:])
    assert list(got[0]) == list(want[0])  # the same keys, in order


def test_bootstrap_subcommand():
    """The reference's bootstrap draws device keys (jitted threefry) and
    compiles its whole jitted bootstrap, minutes on a CPU, so its line is not
    compared here: the port's has the reference's keys, in order, and
    decodes within the reference's bootstrap tolerance
    (tests/test_api.py:129)."""
    (got,) = _lines(cli.main, ["--cpu", "bootstrap"])
    assert list(got) == ["bootstrap", "steady_s", "first_s", "out_level", "max_err"]
    assert got["bootstrap"] == "boot_ci_f" and got["out_level"] >= 2
    assert got["max_err"] < 0.02


def test_demos_report_what_the_reference_reports():
    """The decoded outputs themselves: each demo within the error its own
    data gives (exact where the reference's is)."""
    out = {cmd: _lines(cli.main, ["--cpu", cmd])[0]
           for cmd in ("demo-bgv", "demo-bfv", "demo-threshold")}
    assert out["demo-bgv"]["exact"] is True
    assert out["demo-bfv"]["matvec_exact"] is True and out["demo-bfv"]["mult_exact"] is True
    assert out["demo-threshold"]["abs_err"] < 1e-2


def test_kernels_rows_are_the_reference_rows():
    rows = _lines(cli.main, ["--cpu", "kernels", "--preset", "tiny2"])
    names = [r["kernel"] for r in rows]
    assert names == ["add_mod", "mont_mul", "mul_mod", "ntt_fwd", "ntt_inv", "mod_up",
                     "mod_down", "ks_mac", "key_switch"]
    # on the CPU no bound: the bounds are the card's
    assert all(r["ms"] > 0 and "bound_ms" not in r for r in rows)


def test_keygen_file_equals_the_reference_and_loads_in_a_session(tmp_path):
    argv = ["--cpu", "keygen", "--preset", "tiny2", "--rotations", "1,2", "--conjugation"]
    port, ref = tmp_path / "port.npz", tmp_path / "ref.npz"
    got = _lines(cli.main, [*argv, "--out", str(port)])
    want = _lines(rcli.main, [*argv, "--out", str(ref)])
    assert {**got[0], "written": None} == {**want[0], "written": None}
    assert got[0]["written"] == str(port)
    with np.load(port) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and (a[k] == b[k]).all(), k
    s = Session.load(port, device="cpu")
    assert s.scheme == "ckks" and sorted(s.chest.galois) == [1, 2] and s.chest.conj
    z = np.random.default_rng(0).uniform(-1, 1, size=s.params.slots)
    assert np.abs(s.decrypt(s.rotate(s.encrypt(z), 2)) - np.roll(z, -2)).max() < 1e-3


def test_the_port_refuses_cache():
    """--cache is XLA's compile cache and has no counterpart. (bench is
    tests/test_torch_bench.py's; scaling has come with the parallel package:
    test_scaling_subcommand_reports_the_one_distinct_device.)"""
    with pytest.raises(SystemExit):
        cli.main(["--cache", "x", "security"])


def test_scaling_subcommand_reports_the_one_distinct_device():
    """scaling over the CPU: of the reference's default mesh shapes only the
    1 x 1 row fits one distinct device (logical shards on one device are
    never reported as scaling); each row has the reference's keys."""
    rows = _lines(cli.main, ["--cpu", "scaling", "--iters", "1"])
    assert [(r["mode"], r["mesh"], r["devices"], r["batch"]) for r in rows] == [
        ("strong", "limb=1 x coeff=1", 1, 1), ("weak", "limb=1 x coeff=1", 1, 1)]
    assert all(sorted(r) == sorted(("mode", "mesh", "devices", "batch", "ms_per_mult",
                                    "ops_per_s", "scaling_eff_pct")) for r in rows)
    assert all(r["ops_per_s"] > 0 and r["scaling_eff_pct"] == 100.0 for r in rows)
