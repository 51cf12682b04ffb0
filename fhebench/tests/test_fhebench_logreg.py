"""The logistic-regression cell (ckks_n16_l30.logreg_idash) at a CI preset
on the CPU: its files with the configuration swapped for ci_deep (N = 2^10,
16 limbs), 100 samples of 4 features, a pool of 2 and a learning rate of
16, so that the weights after a step reach |X w| ~ 1 and the cubic term
shows. The harness runs it and prints the contract's line; a step with its
SlotSum returning its input or rotating by a wrong step, its sigmoid
without the cubic term, its learning rate 20% off, or its weights one
level off comes out not correct; the check's partial decryption equals the
whole one; the control fails the cell's limit at the cell's own size; the
work count is the step's 308 key switches; the Galois readers scale the
traced entry's time to the pool's mean."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fhebench import harness, inputs
from fhebench.reference import ckks as ref_ckks
from fhebench.reference import logreg as ref
from fhebench.reference import secret_key
from fhebench.tools import control_logreg
from fhebench.work import logreg as work_logreg

import fhebench_ci as ci

NAME = "ckks_n16_l30.logreg_idash"
SEED = 2**31 + 11
# at ci_deep the step's update reads up to 2.0e-5 in a slot and 1.6e-5 as a
# weight's mean (both entries); the faults below read 3e-3 and more
CI_LIMITS = {"max_err": 2e-4, "mean_err": 1e-4}


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def files() -> tuple[dict, dict, dict]:
    _, mix, cell = harness.cell_files(harness.workload(harness.manifest(), NAME))
    mix = dict(mix, pool=2, sample=2, samples=100, features=4, lr=16.0)
    return ci.config("ci_deep"), mix, dict(cell, limits=CI_LIMITS)


def test_cell_runs_at_ci():
    line = harness.run_cell(NAME, SEED, 0.3, False, device="cpu", files=files())
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checked"]
    assert line["correct"] is True, line["checked"]
    assert list(line["metrics"]) == ["req_per_s", "latency_p50_ms", "latency_p95_ms",
                                     "peak_mem_gib", "setup_s"]
    assert line["checked"]["bad_level"]["value"] == 0


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
    """Every pool entry's step, judged: {name: (value, limit)}."""
    mod, cfg, mix, cell, c = circuit
    samples = [(i, c.export(c.request(entry))) for i, entry in enumerate(c.pool)]
    return {n: (v, lim) for n, v, lim in mod.judge(cfg, cell, mix, SEED, samples, "cpu")}


def test_every_entry_is_correct(circuit):
    got = judged(circuit)
    assert all(v <= lim for v, lim in got.values()), got
    x, y = ref.dataset(inputs.stream(SEED, "messages"), 100, 4)
    assert ref.max_abs_z(ref.leg(x, y, 16.0, 2), x) > 0.5


def _level_off(step):
    def run(self, *args):
        return [self.be.drop_to_level(w, w.level - 1) for w in step(self, *args)]
    return run


def _wrong_last_step(self, ct):
    """A SlotSum whose last doubling rotates by 1, not slots/2: each slot's
    mean over the slots is still summed in full, its value is not."""
    be, s = self.be, 1
    while s < be.params.slots:
        step = 1 if 2 * s == be.params.slots else s
        ct = be.add(ct, be.rotate_hoisted(ct, [step])[step])
        s *= 2
    return ct


FAULTS = ["slot_sum_unchanged", "slot_sum_wrong_step", "no_cubic_term", "lr_off", "level_off"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_faulty_step_is_not_correct(circuit, fault, monkeypatch):
    from gpufhe_tpu_torch.models import logreg_train

    trainer = logreg_train.EncryptedLogRegTrainer
    if fault == "slot_sum_unchanged":
        monkeypatch.setattr(trainer, "_slot_sum", lambda self, ct: ct)
    elif fault == "slot_sum_wrong_step":
        monkeypatch.setattr(trainer, "_slot_sum", _wrong_last_step)
    elif fault == "no_cubic_term":
        monkeypatch.setattr(logreg_train, "SIG_C3", 0.0)
    elif fault == "lr_off":
        monkeypatch.setattr(circuit[4].trainer, "lr", circuit[4].trainer.lr * 1.2)
    else:
        monkeypatch.setattr(trainer, "step", _level_off(trainer.step))
    got = judged(circuit)
    assert any(v > lim for v, lim in got.values()), got
    if fault == "slot_sum_wrong_step":  # only the slots show it
        assert got["mean_err"][0] <= got["mean_err"][1] < got["max_err"][1] < got["max_err"][0]


def test_partial_decryption_is_the_whole_one(circuit):
    """The check reads the leading limbs_needed limbs of each output: there
    the centred residues are the message's coefficients, as over all."""
    mod, cfg, mix, cell, c = circuit
    out = c.request(c.pool[1])
    level, primes = out.levels[0], cfg["q_primes"]
    s = secret_key(inputs.stream(SEED, "keys"), cfg["n"])
    k = ref.limbs_needed(primes, c.scale, 2.0)
    assert k < mod.KEEP_LIMBS < level
    whole = c.trainer.step(c.pool[1], c.x, c.xm, c.y)[0]
    full = ref_ckks.decrypt_decode(whole.c[0].numpy(), whole.c[1].numpy(), s, primes[:level],
                                   c.scale)
    part = ref.decrypt_weights([(out.c[0][:k].numpy(), out.c[1][:k].numpy())], c.scale, s,
                               primes[:k])[0]
    assert np.abs(part - full).max() < 1e-12


def test_output_kept_has_one_size_at_every_level(circuit):
    _, _, _, _, c = circuit
    shapes = {tuple(t.shape) for entry in c.pool for t in c.request(entry).c}
    assert len(shapes) == 1


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 98765])
def test_control_fails_the_limit(seed):
    cfg, mix, cell = harness.cell_files(harness.workload(harness.manifest(), NAME))
    number, value, limit = control_logreg.reading(cfg, mix, cell, seed)
    assert value > limit, (number, value, limit)


def test_work_is_the_steps_key_switches():
    cfg, mix, _ = harness.cell_files(harness.workload(harness.manifest(), NAME))
    w = work_logreg.logreg_pool(cfg["n"], [30], 15, 1, mix["features"], 15)
    assert len(w.macs) == 2 * 18 + 2 + 18 * 15 == 308
    # 18 at level 30 (2 digits), 1 at 29, 1 at 28, 18 at 27, 270 at 26
    assert sorted(set(w.macs)) == [(2, 41), (2, 42), (2, 43), (2, 44), (2, 45)]
    pool = harness.load_module("circuits", mix["circuit"]).work(cfg, {}, mix)
    assert pool.requests == 5 and len(pool.macs) == 5 * 308
    assert pool.least_s()["K4"][0] == pytest.approx(
        sum(work_logreg.logreg_pool(cfg["n"], [lvl], 15, 1, 18, 15).least_s()["K4"][0]
            for lvl in (30, 25, 20, 15, 10)) / 5)


def test_galois_metrics_on_a_hand_built_trace():
    """Two hoisted rotations: the shared ModUp outside both `galois` spans,
    each span holding its key's K4 launch and its ModDown; device time and
    count read from the spans alone, nothing where no span was opened."""
    from fhebench.trace import Trace

    host = [("ks.mod_up", 1.000, 0.010), ("cudaLaunchKernel", 1.001, 0.0004),
            ("galois", 1.020, 0.010), ("ks.inner", 1.021, 0.004),
            ("cudaLaunchKernel", 1.022, 0.0004), ("ks.mod_down", 1.026, 0.003),
            ("cudaLaunchKernel", 1.027, 0.0004),
            ("galois", 1.040, 0.010), ("cudaLaunchKernel", 1.041, 0.0004)]
    device = [("k1_pass", 1.005, 0.002), ("mac_kernel", 1.030, 0.003),
              ("k1_pass", 1.034, 0.001), ("mac_kernel", 1.050, 0.004)]
    tr = Trace(1, 1.0, [], {"K1": 0, "K3": 0, "K4": 0}, {}, [], device, host)
    ms = harness.load_module("metrics", "galois.ms_per_req").read(tr)
    assert ms == pytest.approx(8.0)
    assert harness.load_module("metrics", "galois.per_req").read(tr) == 2.0
    bare = Trace(1, 1.0, [], {"K1": 0, "K3": 0, "K4": 0}, {}, [], device[:1], host[:2])
    assert harness.load_module("metrics", "galois.per_req").read(bare) is None
    # a request whose entry's rotations are 1.25 times the pool's mean least time
    named = Trace(1, 1.0, [], {"K1": 0, "K3": 0, "K4": 0}, {}, [], device,
                  [("fhebench.galois_norm=0.8", 0.999, 0.06)] + host)
    assert harness.load_module("metrics", "galois.ms_per_req").read(named) == pytest.approx(6.4)
    assert harness.load_module("metrics", "galois.per_req").read(named) == 2.0


def test_each_entry_names_its_galois_work(circuit):
    """The span around a request scales the entry's Galois time to the
    pool's mean: norm x (rotation level + offset) is the same for every
    entry, and the entries' norms average 1 over their costs."""
    mod, cfg, mix, _, c = circuit
    norms = [float(c.span[id(entry)].split("=")[1]) for entry in c.pool]
    cost = [lvl - 4 + mod.GALOIS_LIMB_OFFSET for lvl in mod.entry_levels(cfg, mix)]
    assert [n * k for n, k in zip(norms, cost)] == pytest.approx([np.mean(cost)] * len(cost))
    assert all(name.startswith(mod.GALOIS_NORM + "=") for name in c.span.values())
