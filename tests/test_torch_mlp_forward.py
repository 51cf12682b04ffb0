"""The port's encrypted MLP forward (models/mlp.py, EncryptedMLP on the
port's DeviceBackend, on the CPU at ci_deep: N = 2^10, 512 slots, 16 limbs)
on a square-activation network scaled to the slots, 48-16-16-4: against the
benchmark's plain reference (fhebench/reference/mlp.py, float64 from the
network's equations), decrypted by the reference, lifted at the top level
and not at the lowest (models/mlp.py _lift_of); one `linear` span per
layer in a traced forward, each holding its layer's `galois` spans (one
for the batch of its babies, one a giant); and
the benchmark's work count of SecureML's 784-128-128-10 network at 16384
slots against the plan's own pruning (host arithmetic only).
"""

import math
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fhebench import inputs
from fhebench.reference import mlp as ref
from fhebench.reference import secret_key
from fhebench.work import mlp as work_mlp
from gpufhe_tpu_torch.ciphertext import ct as dct
from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
from gpufhe_tpu_torch.ciphertext.linalg import BsgsPlan, bsgs_steps_from_diags, nonzero_diags
from gpufhe_tpu_torch.encoding import encoder
from gpufhe_tpu_torch.keys.device_keygen import device_keygen
from gpufhe_tpu_torch.models import mlp
from gpufhe_tpu_torch.models.mlp import EncryptedMLP, mlp_rotations_for
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import preset

DIMS = [48, 16, 16, 4]
SEED = 2**31 + 23
# The output is judged against the reference's forward of the input as it
# decrypts, so the fresh encryption's noise is no part of it: what is left
# is each rotation's, plaintext product's and rescale's own error, 1.5e-6 to
# 7.9e-6 in the widest of the 512 slots at N = 2^10 and Delta = 2^28 over
# three seeds (without the lift 1.5e-5 to 1.8e-4: models/mlp.py). 5e-5
# leaves six times the first; a wrong rotation or a dropped layer reads 1e-2
# and more (fhebench/tests/test_fhebench_mlp.py).
TOL = 5e-5
# entered at its lowest level the forward takes no lift and reads the
# rotations' ModDown bias: 2.4e-5, 4.0e-5 and 1.1e-4 over three seeds; 5e-4
# leaves four times the widest, and a wrong rotation still reads 1e-2
TOL_FLAT = 5e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def forward():
    params = preset("ci_deep")
    ctx = make_context(params, device="cpu")
    layers, images = ref.draw(inputs.stream(SEED, "messages"), DIMS, 1)
    chest = device_keygen(params, inputs.stream(SEED, "keys"),
                          rotations=tuple(mlp_rotations_for(layers, params.slots)), ctx=ctx)
    model = EncryptedMLP(DeviceBackend(params, ctx, chest), layers)
    z = np.zeros(params.slots, dtype=np.complex128)
    z[: DIMS[0]] = images[0]
    ct = dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx,
                     inputs.stream(SEED, "encrypt"), params.scale)
    model(ct)  # each layer's plan, built once
    return params, layers, model, ct


def lifted_scale(params, lift: int, layers: int, level: int) -> float:
    """The output's scale from `level`: the input at lift Delta, each layer's
    diagonals at Delta / sqrt(lift) and one rescale, each square one
    rescale."""
    s, q = params.scale * lift, params.q_primes
    for i in range(layers):
        s, level = s * (params.scale / math.sqrt(lift)) / q[level - 1], level - 1
        if i < layers - 1:
            s, level = s * s / q[level - 1], level - 1
    return s


def test_forward_matches_the_plain_reference(forward):
    params, layers, model, ct = forward
    out = model(ct)
    primes = params.q_primes
    assert out.level == ref.out_level(len(primes), len(DIMS) - 2, len(DIMS) - 1, 1)
    assert model.lift == mlp._lift_of(params.scale, ct.level, model.levels_used) == 256
    assert out.scale == pytest.approx(lifted_scale(params, model.lift, len(layers), ct.level),
                                    rel=1e-12)
    s = secret_key(inputs.stream(SEED, "keys"), params.n)
    x = ref.decrypt([c.numpy() for c in ct.c], s, primes, params.scale)
    want = ref.expected(layers, x, params.slots)
    got = ref.decrypt([c.numpy() for c in out.c], s, primes[: out.level], out.scale)
    assert np.abs(want[: DIMS[-1]]).max() > 0.1
    err = np.abs(got - want).max()
    assert err < TOL, err
    # the reference's forward is the model's own cleartext forward on the image
    assert np.abs(ref.forward(layers, x[: DIMS[0]].real).real
                  - model.reference(x[: DIMS[0]].real)).max() < 1e-12


def gap(params, layers, ct, out) -> float:
    """The widest gap over all slots of `out` to the plain reference's
    forward of `ct` as it decrypts."""
    s = secret_key(inputs.stream(SEED, "keys"), params.n)
    x = ref.decrypt([c.numpy() for c in ct.c], s, params.q_primes[: ct.level], params.scale)
    want = ref.expected(layers, x, params.slots)
    got = ref.decrypt([c.numpy() for c in out.c], s, params.q_primes[: out.level], out.scale)
    return float(np.abs(got - want).max())


def test_the_lift_holds_the_key_switch_bias_down(forward, monkeypatch):
    """Unlifted, the same forward reads the ModDown bias of its baby
    rotations, at least five times the lifted forward's error here."""
    params, layers, model, ct = forward
    lifted = gap(params, layers, ct, model(ct))
    monkeypatch.setattr(mlp, "_LIFT_BITS", 0)
    flat = EncryptedMLP(model.be, layers)
    unlifted = gap(params, layers, ct, flat(ct))
    assert flat.lift == 1
    assert 5 * lifted < unlifted, (lifted, unlifted)


def test_the_lowest_entry_takes_no_lift(forward):
    """Entered at levels_used + 1 the last product lies on the two lowest
    limbs, whose margin a lift would eat into (models/mlp.py _lift_of): the
    forward takes none and decodes within its unlifted error."""
    params, layers, model, _ = forward
    z = np.zeros(params.slots, dtype=np.complex128)
    z[: DIMS[0]] = ref.draw(inputs.stream(SEED, "messages"), DIMS, 1)[1][0]
    chest_pk, ctx = model.be.chest.device_pk, model.be.ctx
    ct = dct.encrypt(encoder.encode(z, params), params, chest_pk, ctx,
                     inputs.stream(SEED, "encrypt"), params.scale, level=model.levels_used + 1)
    fresh = EncryptedMLP(model.be, layers)
    out = fresh(ct)
    assert fresh.lift == 1 and out.level == 1
    assert out.scale == pytest.approx(lifted_scale(params, 1, len(layers), ct.level), rel=1e-12)
    assert gap(params, layers, ct, out) < TOL_FLAT


def test_one_linear_span_per_layer_holds_its_galois_spans(forward):
    params, layers, model, ct = forward
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(ct)
    spans = sorted(((ev.name(), ev.start_ns(), ev.end_ns())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name() in ("linear", "galois", "ckks.mul")), key=lambda s: s[1])
    linear = [(s, e) for name, s, e in spans if name == "linear"]
    assert len(linear) == len(layers)
    for name, s, e in spans:
        inside = [i for i, (ls, le) in enumerate(linear) if ls <= s and e <= le]
        if name == "galois":
            assert len(inside) == 1
        elif name == "ckks.mul":  # the squares lie between the products
            assert inside == []
    # each product's rotations: one span for its hoisted babies, whose key
    # switches finish in one batch (ct.py ct_baby_sums), and one a giant
    g = math.isqrt(params.slots)
    for (ls, le), (w, _) in zip(linear, layers):
        steps = bsgs_steps_from_diags(nonzero_diags(_embed(w, params.slots)), params.slots)
        babies = [s for s in steps if s < g]
        assert babies
        assert sum(1 for name, s, e in spans if name == "galois" and ls <= s and e <= le) == \
            1 + len(steps) - len(babies)


def _embed(w, slots):
    m = np.zeros((slots, slots))
    m[: w.shape[0], : w.shape[1]] = w
    return m


def test_work_counts_are_the_plans_at_the_published_widths():
    """SecureML's network A at 16384 slots: the benchmark's counts of
    diagonals, babies and giants equal what BsgsPlan._from_block keeps and
    what bsgs_steps_from_diags gives (no encoding: the backend is a stub)."""
    dims, slots = [784, 128, 128, 10], 16384
    g = 128
    stub = types.SimpleNamespace(params=types.SimpleNamespace(slots=slots, scale=2.0**28),
                                 encode_slots=lambda d, scale, level: None)
    rng = np.random.default_rng(5)
    layers = [(rng.normal(size=(d_out, d_in)), None) for d_in, d_out in zip(dims, dims[1:])]
    counted = work_mlp.products(dims, slots)
    for (w, _), p in zip(layers, counted):
        plan = BsgsPlan._from_block(stub, w, level=12)
        assert len(plan.pt) == p.diagonals
        assert sorted({bi for (_, bi, _) in plan.pt} - {0}) == list(p.babies)
        assert sorted({gi * g for (gi, _, _) in plan.pt if gi}) == list(p.giants)
        assert len({gi for (gi, _, _) in plan.pt}) == p.groups
        i, k = np.nonzero(w)
        steps = bsgs_steps_from_diags(set(((k - i) % slots).tolist()), slots)
        assert steps == sorted(p.babies + p.giants)
    assert [p.diagonals for p in counted] == [911, 255, 137]
    assert [len(p.babies) for p in counted] == [127, 127, 127]
    assert [len(p.giants) for p in counted] == [7, 1, 1]
    assert len(mlp_rotations_for(layers, slots)) == 134
