"""The check catches a broken timed path: the harness's run at CI presets
on the CPU (its look for a card skipped), with the library's operation
broken underneath, comes out not correct. Faults that these cells can
have: a step that returns its state unchanged, and an answer altered where
it is produced. A batch (one ciphertext a request) and an exchange between
chips (one chip) are not parts of these cells."""

from __future__ import annotations

import pytest
import torch

import fhebench_ci as ci


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def altered(ct):
    """The ciphertext with one residue of c0 moved by one."""
    c0 = ct.c[0].clone()
    c0[0, 0] += 1
    c0[0, 0] %= 2**29  # stays a canonical residue of the first prime's size
    ct.c = [c0] + list(ct.c[1:])
    return ct


def broken(fn, fault):
    if fault == "unchanged":
        return lambda a, *args, **kw: a
    return lambda *args, **kw: altered(fn(*args, **kw))


TARGETS = {  # workload -> (module, attribute) of the operation each request runs
    "ckks_n16_dw.mul8": ("gpufhe_tpu_torch.ciphertext.ct", "ct_mul_full"),
    "n16_int.bgv_mul5": ("gpufhe_tpu_torch.ciphertext.bgv", "ct_mul"),
    "n16_int.bfv_mul8": ("gpufhe_tpu_torch.ciphertext.bfv", "ct_mul"),
}


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
@pytest.mark.parametrize("name", sorted(TARGETS))
def test_broken_multiply_is_not_correct(name, fault, monkeypatch):
    import importlib

    mod, attr = TARGETS[name]
    module = importlib.import_module(mod)
    monkeypatch.setattr(module, attr, broken(getattr(module, attr), fault))
    line = ci.run(name)
    assert line["correct"] is False, line["checked"]


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_broken_bootstrap_is_not_correct(fault, monkeypatch):
    """At the CI preset the refresh returns at its input's level, so the
    step left unchanged is the EvalMod (the whole call unchanged is caught
    by the level at the cell's size: test_unrefreshed_output_is_not_correct)."""
    from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper
    from gpufhe_tpu_torch.ciphertext.polyeval import ChebyshevEvaluator

    if fault == "unchanged":
        monkeypatch.setattr(ChebyshevEvaluator, "__call__", lambda self, y: y)
    else:
        call = Bootstrapper.__call__
        monkeypatch.setattr(Bootstrapper, "__call__",
                            lambda self, ct, _phase=None: altered(call(self, ct, _phase)))
    line = ci.run("ckks_n16_dw.boot")
    assert line["correct"] is False, line["checked"]


def test_unrefreshed_output_is_not_correct():
    """At the cell's own size a bootstrap that hands back its input (level 2)
    misses the refreshed level the cell states (12)."""
    from fhebench import harness

    cfg, mix, cell = harness.cell_files(harness.workload(harness.manifest(), "ckks_n16_dw.boot"))
    mod = harness.load_module("circuits", mix["circuit"])
    level = mod.in_level(cfg, mix)
    assert level != cell["out_level"]
    out = {"c0": None, "c1": None, "level": level, "components": 2}
    checked = dict((n, (v, lim)) for n, v, lim in mod.judge(cfg, cell, mix, 1, [(0, out)], "cpu"))
    assert checked["bad_level"][0] > checked["bad_level"][1]
