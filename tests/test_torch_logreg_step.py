"""One step of the port's encrypted logistic-regression training
(models/logreg_train.py, EncryptedLogRegTrainer.step on the port's
DeviceBackend, on the CPU at ci_deep: N = 2^10, 16 limbs) against the
benchmark's plain reference (fhebench/reference/logreg.py, float64, written
from the update's equations), from two entry levels; and the same step with
the cubic term left out, or one SlotSum doubling skipped, held to fail the
same tolerance.

The data are seeded: 100 samples of 4 features uniform in [-1, 1] and
weights N(0, 1.5^2), so |X w| reaches 2.5, where the cubic term moves the
update by 0.052 (and the short SlotSum by 0.19).
"""

import numpy as np
import pytest
import torch

from fhebench.reference import logreg as ref
from gpufhe_tpu_torch.ciphertext import ct as dct
from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
from gpufhe_tpu_torch.encoding import encoder
from gpufhe_tpu_torch.keys.device_keygen import device_keygen
from gpufhe_tpu_torch.models import logreg_train as ptrain
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import preset

M, F, LR = 100, 4, 1.0
# Each output weight carries its input's fresh public-key encryption noise
# (at N = 2^10 and Delta = 2^28 about 6e-5 in the widest of 512 slots; the
# step reads 5.7e-5 and 6.0e-5) and the step's own, far less: the gradient
# is summed before lr/m scales it. 1e-3 leaves 16x room above the step and
# 50x below the smaller fault.
TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    params = preset("ci_deep")
    ctx = make_context(params, device="cpu")
    chest = device_keygen(params, np.random.default_rng(11),
                          rotations=tuple(ptrain.train_rotations(params.slots)), ctx=ctx)
    tr = ptrain.EncryptedLogRegTrainer(DeviceBackend(params, ctx, chest), M, lr=LR)
    rng = np.random.default_rng(12)
    x = rng.uniform(-1.0, 1.0, size=(M, F))
    y = (x @ rng.normal(size=F) + rng.normal(size=M) > 0).astype(np.float64)
    w0 = rng.normal(size=F) * 1.5
    enc = np.random.default_rng(13)

    def encrypt(z, level):
        return dct.encrypt(encoder.encode(np.asarray(z, np.complex128), params), params,
                           chest.device_pk, ctx, enc, params.scale, level=level)

    top = params.num_limbs
    x_cts = [encrypt(tr.slot_vec(x[:, j]), top) for j in range(F)]
    y_ct = encrypt(tr.slot_vec(y), top)
    ws = {level: [encrypt(np.full(params.slots, w), level) for w in w0] for level in (top, 11)}
    return tr, x, y, w0, x_cts, tr.prepare(x_cts), y_ct, ws


def step_error(setup, level):
    tr, x, y, w0, x_cts, xm_cts, y_ct, ws = setup
    out = tr.step(ws[level], x_cts, xm_cts, y_ct)
    want = ref.step(w0, x, y, LR)
    assert [w.level for w in out] == [level - 5] * F
    return max(float(np.abs(tr.be.decrypt_decode(w) - wj).max()) for w, wj in zip(out, want))


@pytest.mark.parametrize("level", [16, 11])
def test_step_matches_the_plain_reference(setup, level):
    assert np.abs(setup[1] @ setup[3]).max() > 1.5  # the cubic term matters here
    assert step_error(setup, level) < TOL


def _skip_last_doubling(self, ct):
    be, s = self.be, 1
    while 2 * s < be.params.slots:
        ct = be.add(ct, be.rotate_hoisted(ct, [s])[s])
        s *= 2
    return ct


@pytest.mark.parametrize("fault", ["no_cubic_term", "slot_sum_short"])
def test_a_faulty_step_fails_the_tolerance(setup, fault, monkeypatch):
    if fault == "no_cubic_term":
        monkeypatch.setattr(ptrain, "SIG_C3", 0.0)
    else:
        monkeypatch.setattr(ptrain.EncryptedLogRegTrainer, "_slot_sum", _skip_last_doubling)
    assert step_error(setup, 16) > 10 * TOL


def test_plain_reference_agrees_with_the_modules_mirror():
    """Two cleartext versions written apart: the benchmark's, from the
    equations, and the model's own mirror."""
    rng = np.random.default_rng(14)
    x, y, w = rng.uniform(-1, 1, size=(50, 3)), rng.integers(0, 2, 50), rng.normal(size=3)
    tr = ptrain.EncryptedLogRegTrainer.__new__(ptrain.EncryptedLogRegTrainer)
    tr.lr, tr.m = 0.5, 50
    assert np.abs(ref.step(w, x, y, 0.5) - tr.reference(w, x, y, 1)).max() < 1e-12
    assert np.abs(ref.leg(x, y, 0.5, 3)[3] - tr.reference(np.zeros(3), x, y, 3)).max() < 1e-12


def test_sum_gain_keeps_the_update_constant_12_bits():
    """The SlotSum's summands are carried K times larger: K the largest power
    of two up to the slots that leaves lr/(m K) at Delta 2^12 or more."""
    assert ptrain._sum_gain(1 / 1579, 2.0**28, 2**15) == 32  # iDASH's 1579 records
    assert ptrain._sum_gain(LR / M, 2.0**28, 512) == 512  # capped at the slots
    assert ptrain._sum_gain(1e-9, 2.0**28, 512) == 1
