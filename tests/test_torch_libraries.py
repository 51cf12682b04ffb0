"""The port's function libraries against the reference's.

compare.py (sign, step, compare, relu, absval, maximum, minimum) and
approx.py (inverse, sqrt, rsqrt, exp, layer_norm, softmax, slot_sum) on the
port's DeviceBackend (on the CPU) against the same functions of gpufhe_tpu
on its GoldenBackend; exact.py's predicates on BFVDeviceBackend and
BGVDeviceBackend against BFVGoldenBackend and BGVGoldenBackend. Same keys
(interop.chest_from_reference), same numpy-seeded inputs, the presets of the
reference's own tests (ci_deep, ci_attn, boot_ci_deep, bfv_eq, bgv_ci).
Every output == the reference's limb for limb at an equal level, scales
within 1e-12 relative; each decode within the tolerance of the reference
test it mirrors (file:line beside it); the integer predicates exact in every
slot. linalg.rotate_composed takes the integer backends' one-shot rotate,
as the reference's does.
"""

import numpy as np
import pytest
import torch

from gpufhe_tpu.ciphertext import approx as rapprox
from gpufhe_tpu.ciphertext import bfv as rbfv
from gpufhe_tpu.ciphertext import bgv as rbgv
from gpufhe_tpu.ciphertext import compare as rcmp
from gpufhe_tpu.ciphertext import exact as rexact
from gpufhe_tpu.ciphertext import linalg as rlinalg
from gpufhe_tpu.ciphertext.backend import GoldenBackend
from gpufhe_tpu.ciphertext.bfv_backend import BFVGoldenBackend
from gpufhe_tpu.ciphertext.bgv_backend import BGVGoldenBackend
from gpufhe_tpu.golden import bfv as rgbfv
from gpufhe_tpu.golden import bgv as rgbgv
from gpufhe_tpu.golden import ckks as rgckks
from gpufhe_tpu.keys import keys as rkeys
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch import interop
from gpufhe_tpu_torch.ciphertext import approx
from gpufhe_tpu_torch.ciphertext import bfv as pbfv
from gpufhe_tpu_torch.ciphertext import bgv as pbgv
from gpufhe_tpu_torch.ciphertext import compare as cmp
from gpufhe_tpu_torch.ciphertext import ct as pct
from gpufhe_tpu_torch.ciphertext import exact
from gpufhe_tpu_torch.ciphertext import linalg
from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
from gpufhe_tpu_torch.ciphertext.bfv_backend import BFVDeviceBackend
from gpufhe_tpu_torch.ciphertext.bgv_backend import BGVDeviceBackend
from gpufhe_tpu_torch.encoding import encoder as penc
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import preset


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's PyTorch CPU work: its tensors are
    small (N <= 2^10), and tier-1 runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_ct_equal(got, want):
    assert got.level == want.level and len(got.c) == len(want.c)
    if hasattr(want, "scale"):
        assert abs(got.scale / want.scale - 1.0) < 1e-12
    assert getattr(got, "pt_factor", None) == getattr(want, "pt_factor", None)
    for g, w in zip(got.c, want.c):
        assert (g.numpy() == np.asarray(w).astype(np.int64)).all()


class CKKSPair:
    """DeviceBackend (CPU) and GoldenBackend on one reference chest."""

    def __init__(self, name, rotations=(), seed=0):
        self.params, self.rparams = preset(name), ref_preset(name)
        self.rchest = rkeys.keygen(self.rparams, np.random.default_rng(seed),
                                   rotations=tuple(rotations))
        self.chest = interop.chest_from_reference(self.rchest, "cpu")
        self.ctx = make_context(self.params, device="cpu")
        self.be = DeviceBackend(self.params, self.ctx, self.chest)
        self.rbe = GoldenBackend(self.rparams, self.rchest)

    def encrypt(self, x, seed):
        z = np.zeros(self.params.slots, dtype=np.complex128)
        z[: len(x)] = x
        pt = penc.encode(z, self.params)
        return (pct.encrypt(pt, self.params, self.chest.device_pk, self.ctx,
                            np.random.default_rng(seed), self.params.scale),
                rgckks.encrypt(pt, self.rparams, self.rchest.pk, np.random.default_rng(seed),
                               self.params.scale))

    def run(self, port_fn, ref_fn, *xs_seeds):
        """Both sides on the same inputs; the outputs held ==; the port's
        decoded real parts returned."""
        pairs = [self.encrypt(x, s) for x, s in xs_seeds]
        out = port_fn(self.be, *[p for p, _ in pairs])
        assert_ct_equal(out, ref_fn(self.rbe, *[r for _, r in pairs]))
        return np.real(self.be.decrypt_decode(out))


# -- compare.py at ci_deep (tests/test_compare.py:16) -----------------------


@pytest.fixture(scope="module")
def deep():
    return CKKSPair("ci_deep")


def _signed(rng, lo, hi, size=64):
    return rng.uniform(lo, hi, size=size) * rng.choice([-1.0, 1.0], size=size)


# each function on its reference test's input: (rng seed, |x| upper end, the
# encryption's seed), the cleartext function, the tolerance
@pytest.mark.parametrize("fn,draw,want,tol", [
    ("sign", (1, 1.0, 2), np.sign, 0.02),  # tests/test_compare.py:42
    ("step", (1, 1.0, 2), lambda x: (x > 0).astype(float), 0.02),  # :55
    ("relu", (3, 0.9, 4), lambda x: np.maximum(x, 0.0), 0.02),  # :65
    ("absval", (3, 0.9, 4), np.abs, 0.02),  # :68
])
def test_compare_unary_matches_reference(deep, fn, draw, want, tol):
    seed, hi, enc_seed = draw
    x = _signed(np.random.default_rng(seed), 0.08, hi)
    got = deep.run(getattr(cmp, fn), getattr(rcmp, fn), (x, enc_seed))[:64]
    assert np.abs(got - want(x)).max() < tol


@pytest.mark.parametrize("fn,want", [("maximum", np.maximum), ("minimum", np.minimum)])
def test_compare_max_min_matches_reference(deep, fn, want):
    rng = np.random.default_rng(5)
    a = rng.uniform(-0.8, 0.8, size=64)
    b = a + _signed(rng, 0.2, 0.8)
    got = deep.run(getattr(cmp, fn), getattr(rcmp, fn), (a, 6), (b, 7))[:64]
    assert np.abs(got - want(a, b)).max() < 0.02  # tests/test_compare.py:120, :123


def test_compare_scaled_range_matches_reference(deep):
    rng = np.random.default_rng(8)
    a = rng.uniform(-4.0, 4.0, size=64)
    b = a + _signed(rng, 0.9, 4.0)
    got = deep.run(lambda be, x, y: cmp.compare(be, x, y, half_range=4.0),
                   lambda be, x, y: rcmp.compare(be, x, y, half_range=4.0), (a, 9), (b, 10))[:64]
    assert np.abs(got - (a > b)).max() < 0.02  # tests/test_compare.py:137
    assert cmp.sign_levels(1, 2) == rcmp.sign_levels(1, 2)


# -- approx.py at ci_deep (tests/test_approx.py:18) --------------------------


def _full(deep, lo, hi, seed):
    return np.random.default_rng(seed).uniform(lo, hi, size=deep.params.slots)


def test_inverse_matches_reference(deep):
    x = _full(deep, 0.2, 1.0, 1)
    got = deep.run(lambda be, c: approx.inverse(be, c, iters=5),
                   lambda be, c: rapprox.inverse(be, c, iters=5), (x, 2))
    assert (np.abs(got - 1.0 / x) * x).max() < 5e-3  # tests/test_approx.py:41


def test_inverse_bound_and_out_scale_matches_reference(deep):
    x = _full(deep, 1.0, 4.0, 2)
    kw = dict(bound=4.0, iters=5, out_scale=3.0)
    got = deep.run(lambda be, c: approx.inverse(be, c, **kw),
                   lambda be, c: rapprox.inverse(be, c, **kw), (x, 3))
    assert (np.abs(got - 3.0 / x) * x / 3.0).max() < 5e-3  # tests/test_approx.py:54


def test_sqrt_matches_reference(deep):
    x = _full(deep, 0.1, 1.0, 4)
    got = deep.run(lambda be, c: approx.sqrt(be, c, iters=6),
                   lambda be, c: rapprox.sqrt(be, c, iters=6), (x, 5))
    assert np.abs(got - np.sqrt(x)).max() < 5e-3  # tests/test_approx.py:66


def test_exp_matches_reference(deep):
    x = _full(deep, -2.0, 2.0, 8)
    got = deep.run(lambda be, c: approx.exp(be, c, half_range=2.0),
                   lambda be, c: rapprox.exp(be, c, half_range=2.0), (x, 9))
    assert (np.abs(got - np.exp(x)) / np.exp(x)).max() < 2e-3  # tests/test_approx.py:86


def test_rsqrt_bound_matches_reference(deep):
    x = _full(deep, 1.0, 6.0, 22)
    got = deep.run(lambda be, c: approx.rsqrt(be, c, bound=6.0, iters=6),
                   lambda be, c: rapprox.rsqrt(be, c, bound=6.0, iters=6), (x, 23))
    assert np.abs(got - 1.0 / np.sqrt(x)).max() < 5e-3  # tests/test_approx.py:106


def test_level_and_rotation_helpers_match_reference():
    for it in range(1, 8):
        assert approx.inverse_levels(it) == rapprox.inverse_levels(it)
        assert approx.sqrt_levels(it) == rapprox.sqrt_levels(it)
        assert approx.rsqrt_levels(it) == rapprox.rsqrt_levels(it)
        assert approx.layer_norm_levels(it) == rapprox.layer_norm_levels(it)
    assert approx.rotations_for_layernorm(128, 8) == rapprox.rotations_for_layernorm(128, 8)
    assert approx.rotations_for_softmax(128) == rapprox.rotations_for_softmax(128)
    assert (approx.exp_coeffs(2.0, 15) == rapprox.exp_coeffs(2.0, 15)).all()


def test_layer_norm_matches_reference():
    """tests/test_approx.py:133 at ci_attn (d = 8, iters 4)."""
    params = preset("ci_attn")
    pair = CKKSPair("ci_attn", approx.rotations_for_layernorm(params.slots, 8), seed=30)
    rng = np.random.default_rng(31)
    x = rng.uniform(-1.0, 1.0, size=params.slots)
    gamma, beta = rng.uniform(0.5, 1.5, size=8), rng.uniform(-0.3, 0.3, size=8)
    kw = dict(eps=5e-2, gamma=gamma, beta=beta, var_bound=1.0, iters=4)
    got = pair.run(lambda be, c: approx.layer_norm(be, c, 8, **kw),
                   lambda be, c: rapprox.layer_norm(be, c, 8, **kw), (x, 32))
    blocks = x.reshape(-1, 8)
    mean = blocks.mean(axis=1, keepdims=True)
    var = ((blocks - mean) ** 2).mean(axis=1, keepdims=True)
    want = ((blocks - mean) / np.sqrt(var + 5e-2) * gamma + beta).reshape(-1)
    assert np.abs(got - want).max() < 5e-2  # tests/test_approx.py:147


def test_softmax_and_slot_sum_match_reference():
    """tests/test_approx.py:161 at boot_ci_deep."""
    params = preset("boot_ci_deep")
    pair = CKKSPair("boot_ci_deep", approx.rotations_for_softmax(params.slots), seed=10)
    rng = np.random.default_rng(11)
    x = rng.uniform(-1.0, 1.0, size=params.slots)
    got = pair.run(lambda be, c: approx.softmax(be, c, half_range=1.0, inv_iters=7),
                   lambda be, c: rapprox.softmax(be, c, half_range=1.0, inv_iters=7), (x, 12))
    want = np.exp(x) / np.exp(x).sum()
    assert np.abs(got - want).max() < 2e-2 * want.max()  # tests/test_approx.py:173
    total = pair.run(approx.slot_sum, rapprox.slot_sum, (x * 0.01, 13))
    assert np.abs(total - 0.01 * x.sum()).max() < 1e-2  # tests/test_pipeline.py:109


# -- exact.py over the integer backends (tests/test_exact_predicates.py) -----


@pytest.fixture(scope="module")
def bfv_eq():
    params, rparams = preset("bfv_eq"), ref_preset("bfv_eq")
    rchest = rbfv.keygen(rparams, np.random.default_rng(51))
    chest = interop.chest_from_reference(rchest, "cpu")
    ctx = make_context(params, device="cpu")
    be, rbe = BFVDeviceBackend(params, ctx, chest), BFVGoldenBackend(rparams, rchest)

    def encrypt(v, seed):
        raw = np.empty(params.n, dtype=np.int64)
        raw[rbe.rings[0]], raw[rbe.rings[1]] = v, v
        pt = rgbfv.encode(raw, rparams)
        return (pbfv.encrypt(pt, params, chest.device_pk, ctx, np.random.default_rng(seed)),
                rgbfv.encrypt(pt, rparams, rchest.pk, np.random.default_rng(seed)))

    return params, be, rbe, encrypt


def _exact(be, rbe, port_out, ref_out, want):
    assert_ct_equal(port_out, ref_out)
    got = be.decrypt_decode(port_out)
    assert (got[0] == want).all() and (got[1] == want).all()


def test_is_zero_matches_reference(bfv_eq):
    params, be, rbe, encrypt = bfv_eq
    v = np.random.default_rng(1).integers(0, params.plain_modulus, size=params.slots)
    v[::7] = 0
    ct, rct = encrypt(v, 2)
    _exact(be, rbe, exact.ct_is_zero(be, ct), rexact.ct_is_zero(rbe, rct), (v == 0))


def test_equals_plain_and_member_match_reference(bfv_eq):
    params, be, rbe, encrypt = bfv_eq
    rng = np.random.default_rng(3)
    v = rng.integers(0, 10, size=params.slots)
    w = rng.integers(0, 10, size=params.slots)
    ct, rct = encrypt(v, 4)
    _exact(be, rbe, exact.ct_equals_plain(be, ct, w), rexact.ct_equals_plain(rbe, rct, w),
           v == w)
    _exact(be, rbe, exact.ct_member_plain(be, ct, [2, 5, 9]),
           rexact.ct_member_plain(rbe, rct, [2, 5, 9]), np.isin(v, [2, 5, 9]))


def test_equals_two_ciphertexts_matches_reference(bfv_eq):
    params, be, rbe, encrypt = bfv_eq
    rng = np.random.default_rng(5)
    va, vb = rng.integers(0, 4, size=params.slots), rng.integers(0, 4, size=params.slots)
    (a, ra), (b, rb) = encrypt(va, 6), encrypt(vb, 7)
    _exact(be, rbe, exact.ct_equals(be, a, b), rexact.ct_equals(rbe, ra, rb), va == vb)


@pytest.fixture(scope="module")
def bgv_ci():
    params, rparams = preset("bgv_ci"), ref_preset("bgv_ci")
    rchest = rbgv.keygen(rparams, np.random.default_rng(61), rotations=(1, 2, 4))
    chest = interop.chest_from_reference(rchest, "cpu")
    ctx = make_context(params, device="cpu")
    be, rbe = BGVDeviceBackend(params, ctx, chest), BGVGoldenBackend(rparams, rchest)
    v = np.random.default_rng(62).integers(0, params.plain_modulus, size=params.slots)
    raw = np.empty(params.n, dtype=np.int64)
    raw[rbe.rings[0]], raw[rbe.rings[1]] = v, v
    pt = rgbgv.encode(raw, rparams)
    ct = pbgv.encrypt(pt, params, chest.device_pk, ctx, np.random.default_rng(63))
    rct = rgbgv.encrypt(pt, rparams, rchest.pk, np.random.default_rng(63))
    return params, be, rbe, v, ct, rct


def test_pow_const_on_bgv_matches_reference(bgv_ci):
    """tests/test_exact_predicates.py:90: x^5 on BGV, ModSwitch-aligned."""
    params, be, rbe, v, ct, rct = bgv_ci
    want = pow(v.astype(object), 5) % params.plain_modulus
    _exact(be, rbe, exact.ct_pow_const(be, ct, 5), rexact.ct_pow_const(rbe, rct, 5),
           want.astype(np.int64))


def test_rotate_composed_on_bgv_matches_reference(bgv_ci):
    """Power-of-two keys compose a rotation by 7 through the backend's
    one-shot rotate, == the reference's limb for limb."""
    params, be, rbe, v, ct, rct = bgv_ci
    _exact(be, rbe, linalg.rotate_composed(be, ct, 7), rlinalg.rotate_composed(rbe, rct, 7),
           np.roll(v, -7))
