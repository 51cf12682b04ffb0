"""The MNIST inference cell (ckks_n15_mlp.mnist) at a CI preset on the CPU:
its files with the configuration swapped for ci_deep (N = 2^10, 16 limbs)
and the network scaled to its 512 slots, 48-16-16-4, a pool of 2. The
harness runs it and prints the contract's line; a layer returning its
input, a baby rotation by a wrong step, a skipped square and an output left
one level high come out not correct; the check's partial decryption equals
the whole one; the bfloat16 control fails the cell's limits at the cell's
own size; the work count is the forward's 1303 plaintext products, 381
hoisted babies and 9 giants; the `linear` readers read the spans alone."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from fhebench import harness, inputs
from fhebench.reference import ckks as ref_ckks
from fhebench.reference import secret_key
from fhebench.tools import control_mlp
from fhebench.trace import Trace
from fhebench.work import mlp as work_mlp

import fhebench_ci as ci

NAME = "ckks_n15_mlp.mnist"
SEED = 2**31 + 11
CI_LAYERS = [48, 16, 16, 4]
# at ci_deep the forward reads 1.6e-5 over all 512 slots (both entries);
# the faults below read 1e-2 and more, or leave the level wrong
CI_LIMITS = {"max_err": 1e-4, "mean_err": 1e-4}


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def files() -> tuple[dict, dict, dict]:
    _, mix, cell = harness.cell_files(harness.workload(harness.manifest(), NAME))
    mix = dict(mix, pool=2, sample=2, layers=CI_LAYERS)
    return ci.config("ci_deep"), mix, dict(cell, limits=CI_LIMITS)


def test_cell_runs_at_ci():
    line = harness.run_cell(NAME, SEED, 0.3, False, device="cpu", files=files())
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checked"]
    assert line["correct"] is True, line["checked"]
    assert list(line["metrics"]) == ["req_per_s", "latency_p50_ms", "latency_p95_ms",
                                     "peak_mem_gib", "setup_s"]
    assert line["checked"]["bad_level"]["value"] == 0
    json.dumps(line)


def test_traced_line_at_ci(monkeypatch):
    # the CPU traces no kernel, so the span metrics pair nothing and are left out
    monkeypatch.setattr(harness, "TRACE_SLICE", (0.0, 0.0, 1, 1))
    line = harness.run_cell(NAME, SEED, 1.0, True, device="cpu", files=files())
    assert line["correct"] is True
    assert line["metrics"] == {}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.fixture(scope="module")
def circuit():
    cfg, mix, cell = files()
    mod = harness.load_module("circuits", mix["circuit"])
    return mod, cfg, mix, cell, mod.Circuit(cfg, cell, mix, SEED, "cpu")


def judged(circuit) -> dict:
    """Every pool entry's forward, judged: {name: (value, limit)}."""
    mod, cfg, mix, cell, c = circuit
    samples = [(i, c.export(c.request(entry))) for i, entry in enumerate(c.pool)]
    return {n: (v, lim) for n, v, lim in mod.judge(cfg, cell, mix, SEED, samples, "cpu")}


def test_every_entry_is_correct(circuit):
    got = judged(circuit)
    assert all(v <= lim for v, lim in got.values()), got
    assert got["max_err"][0] >= got["mean_err"][0] > 0


def _wrong_baby(baby_sums):
    """Hoisted babies whose step 1 rotates by 2 (in step 1's row of the
    stack of rotations): one diagonal a giant group meets the wrong slots."""
    def run(self, ct, steps, groups):
        return baby_sums(self, ct, [2 if s == 1 else s for s in steps], groups)
    return run


def _last_rescale_skipped(rescale, level):
    def run(self, ct):
        return ct if ct.level == level else rescale(self, ct)
    return run


FAULTS = ["layer_returns_input", "wrong_baby_step", "square_skipped", "level_high"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_faulty_forward_is_not_correct(circuit, fault, monkeypatch):
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend

    mod, cfg, mix, _, c = circuit
    model = c.model
    if fault == "layer_returns_input":
        second = model._plans[(1, model.be.level(c.pool[0]) - 2)]
        monkeypatch.setattr(second, "apply", lambda ct: ct)
    elif fault == "wrong_baby_step":
        monkeypatch.setattr(DeviceBackend, "baby_sums", _wrong_baby(DeviceBackend.baby_sums))
    elif fault == "square_skipped":
        monkeypatch.setattr(model, "act", lambda be, ct: ct)
    else:  # the last product's rescale left out: the output one level high
        last = mod.out_level(cfg, mix) + cfg["scale_words"]
        monkeypatch.setattr(DeviceBackend, "rescale",
                            _last_rescale_skipped(DeviceBackend.rescale, last))
    got = judged(circuit)
    assert any(v > lim for v, lim in got.values()), got
    if fault == "wrong_baby_step":  # the level holds; the values do not
        assert got["bad_level"][0] == 0 and got["max_err"][0] > 1e-2
    if fault == "level_high":
        assert got["bad_level"][0] == len(circuit[4].pool)


def test_partial_decryption_is_the_whole_one(circuit):
    """The check reads the leading limbs_needed limbs of the output: there
    the centred residues are the message's coefficients, as over all."""
    mod, cfg, mix, _, c = circuit
    out = c.model(c.pool[1])
    primes, s = cfg["q_primes"], secret_key(inputs.stream(SEED, "keys"), cfg["n"])
    full = ref_ckks.decrypt_decode(out.c[0].numpy(), out.c[1].numpy(), s, primes[:out.level],
                                   out.scale)
    k = mod.ref_limbs.limbs_needed(primes, out.scale, float(np.abs(full).max()))
    assert k < mod.KEEP_LIMBS < out.level
    part = ref_ckks.decrypt_decode(out.c[0][:k].numpy(), out.c[1][:k].numpy(), s, primes[:k],
                                   out.scale)
    assert np.abs(part - full).max() < 1e-12


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 98765])
def test_control_fails_the_limit(seed):
    cfg, mix, cell = harness.cell_files(harness.workload(harness.manifest(), NAME))
    rows = control_mlp.reading(cfg, mix, cell, seed)
    assert [n for n, _, _ in rows] == ["max_err", "mean_err"]
    assert any(value > limit for _, value, limit in rows), rows


def test_control_tool_reads_above_the_limit(capsys):
    assert control_mlp.main(["--workload", NAME, "--seeds", "1,2"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["seed"] for x in lines] == [1, 2] and all(x["fails"] for x in lines)


def test_work_is_the_forwards_products():
    cfg, mix, cell = harness.cell_files(harness.workload(harness.manifest(), NAME))
    ps = work_mlp.products(mix["layers"], cfg["n"] // 2)
    assert [p.diagonals for p in ps] == [911, 255, 137]
    assert sum(len(p.babies) for p in ps) == 381 and sum(len(p.giants) for p in ps) == 9
    w = harness.load_module("circuits", mix["circuit"]).work(cfg, cell, mix)
    # per layer a hoist and 127 babies, per giant a key switch; 2 squarings
    assert len(w.macs) == 381 + 9 + 2 and len(w.linear.macs) == 381 + 9
    assert len(w.plain) == 2 * 1303 - 3
    least = w.least_s()
    assert set(least) == {"K1", "K3", "K4", "linear"}
    kernels = w.linear.least_s()
    assert least["linear"][0] > sum(s for s, _ in kernels.values())
    assert least["linear"][1] == "bytes"


def test_linear_metrics_on_a_hand_built_trace():
    """A forward's first product: its hoist, two babies' K4 and a plaintext
    product inside the `linear` span, a square's launches outside it."""
    host = [("linear", 1.000, 0.050), ("ks.mod_up", 1.001, 0.005),
            ("cudaLaunchKernel", 1.002, 0.0004), ("galois", 1.010, 0.005),
            ("cudaLaunchKernel", 1.011, 0.0004), ("galois", 1.020, 0.005),
            ("cudaLaunchKernel", 1.021, 0.0004), ("cudaMemcpyAsync", 1.030, 0.0004),
            ("cudaLaunchKernel", 1.040, 0.0004),
            ("ckks.mul", 1.060, 0.010), ("cudaLaunchKernel", 1.061, 0.0004)]
    device = [("k1_pass", 1.005, 0.002), ("mac_kernel", 1.013, 0.003),
              ("mac_kernel", 1.023, 0.003), ("Memcpy DtoD (Device -> Device)", 1.031, 0.0005),
              ("mac_kernel", 1.042, 0.0015), ("tensor_kernel", 1.070, 0.004)]
    tr = Trace(1, 1.0, [], {"K1": 0, "K3": 0, "K4": 0}, {"linear": (0.0025, "bytes")}, [],
               device, host)

    def read(name, t=tr):
        return harness.load_module("metrics", name).read(t)

    assert read("linear.ms_per_req") == pytest.approx(10.0)
    assert read("linear.kernels_per_req") == 5.0
    assert read("linear.roofline") == pytest.approx(25.0)
    bare = Trace(1, 1.0, [], {"K1": 0, "K3": 0, "K4": 0}, {}, [], device,
                 [op for op in host if op[0] != "linear"])
    for name in ("linear.ms_per_req", "linear.kernels_per_req", "linear.roofline"):
        assert read(name, bare) is None
