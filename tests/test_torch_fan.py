"""The fused diagonal fan, both ModRaises, Galois-key truncation and the
linear maps of gpufhe_tpu_torch against gpufhe_tpu, with the same keys
(carried by interop.chest_from_reference) and the same draws, limb for limb:

- ct_diag_fan (through DeviceBackend.make_fan_plan / apply_fan) at tiny2
  against the reference's jnp ct_diag_fan and its golden model, on the
  output sets of tests/test_fftboot.py::test_fused_diag_fan_backend_parity;
- ct_mod_raise at tiny2 and ct_mod_raise2 at boot_dw_ci against the
  reference's jnp functions, and ct_mod_raise2 against the golden model on
  coefficients at the centring rule's boundary;
- the fan, hoisted rotations and conjugation with truncated keys == with
  full keys;
- BsgsPlan / matmul_plain at tiny2 and the factored CtS at fft_ci_small
  against the reference's GoldenBackend.
"""

import numpy as np
import pytest
import torch

from gpufhe_tpu.ciphertext import ct as rct
from gpufhe_tpu.ciphertext import fftboot as rfb
from gpufhe_tpu.ciphertext.backend import DeviceBackend as RefDeviceBackend
from gpufhe_tpu.ciphertext.backend import GoldenBackend
from gpufhe_tpu.ciphertext.linalg import matmul_plain as ref_matmul_plain
from gpufhe_tpu.golden import ckks as gckks
from gpufhe_tpu.keys import keys as rkeys
from gpufhe_tpu.ops.context import make_context as ref_context
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch import interop
from gpufhe_tpu_torch.ciphertext import ct as pct
from gpufhe_tpu_torch.ciphertext import fftboot as pfb
from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
from gpufhe_tpu_torch.ciphertext.linalg import bsgs_rotations, matmul_plain
from gpufhe_tpu_torch.encoding import encoder as penc
from gpufhe_tpu_torch.keys.keys import truncate_galois_device
from gpufhe_tpu_torch.ops import mac_cuda
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.ops.ntt import ntt_fwd
from gpufhe_tpu_torch.params.params import preset


def _assert_ct_equal(got, want, rel=0.0):
    assert got.level == want.level and len(got.c) == len(want.c)
    assert abs(got.scale / want.scale - 1.0) <= rel
    for g, w in zip(got.c, want.c):
        assert (g.cpu().numpy() == np.asarray(w).astype(np.int64)).all()


def _slots(ns, rng):
    return rng.normal(size=ns) + 1j * rng.normal(size=ns)


def _stack(name, rotations, conjugation, seed=7):
    params, rparams = preset(name), ref_preset(name)
    rchest = rkeys.keygen(rparams, np.random.default_rng(seed), rotations=tuple(rotations),
                          conjugation=conjugation)
    chest = interop.chest_from_reference(rchest, "cpu")
    ctx = make_context(params, device="cpu")
    return params, rparams, ctx, chest, rchest


def _encrypt(params, rparams, ctx, chest, rchest, z, seed, level=None, rctx=None):
    pt = penc.encode(z, params)
    ct = pct.encrypt(pt, params, chest.device_pk, ctx, np.random.default_rng(seed),
                     params.scale, level=level)
    gold = gckks.encrypt(pt, rparams, rchest.pk, np.random.default_rng(seed), params.scale,
                         level=level)
    _assert_ct_equal(ct, gold)
    ref = None
    if rctx is not None:
        ref = rct.encrypt(pt, rparams, rchest.device_pk, rctx, np.random.default_rng(seed),
                          params.scale, level=level)
    return ct, gold, ref


@pytest.fixture(scope="module")
def tiny2():
    params = preset("tiny2")
    rots = (1, 3, params.slots - 1)
    return (*_stack("tiny2", rots, conjugation=True), ref_context(ref_preset("tiny2")))


def test_diag_fan_matches_reference_jnp_and_golden(tiny2):
    params, rparams, ctx, chest, rchest, rctx = tiny2
    rng = np.random.default_rng(0)
    ns = params.slots
    z = _slots(ns, rng)
    ct, gold, ref = _encrypt(params, rparams, ctx, chest, rchest, z, 1, rctx=rctx)
    d1, d2, d3 = _slots(ns, rng), _slots(ns, rng), _slots(ns, rng)
    sets = [{0: d1, 1: d2, 3: d3}, {1: d1, ns - 1: d2}]
    be = DeviceBackend(params, ctx, chest)
    out = be.apply_fan(ct, be.make_fan_plan(sets, ct.level))
    rbe = RefDeviceBackend(rparams, rctx, rchest)
    out_ref = rbe.apply_fan(ref, rbe.make_fan_plan(sets, ref.level))
    gbe = GoldenBackend(rparams, rchest)
    out_gold = gbe.apply_fan(gold, gbe.make_fan_plan(sets, gold.level))
    assert len(out) == len(out_ref) == len(out_gold) == 2
    for o, r, g in zip(out, out_ref, out_gold):
        _assert_ct_equal(o, r)
        _assert_ct_equal(o, g, rel=1e-12)
    want = [d1 * z + d2 * np.roll(z, -1) + d3 * np.roll(z, -3),
            d1 * np.roll(z, -1) + d2 * np.roll(z, -(ns - 1))]
    for o, w in zip(out, want):
        assert np.abs(be.decrypt_decode(o) - w).max() < 1e-3


def test_mod_raise_matches_reference_jnp(tiny2):
    params, rparams, ctx, chest, rchest, rctx = tiny2
    z = _slots(params.slots, np.random.default_rng(4)) * 0.3
    ct, gold, ref = _encrypt(params, rparams, ctx, chest, rchest, z, 5, level=1, rctx=rctx)
    got = pct.ct_mod_raise(ct, params, ctx)
    assert got.level == params.num_limbs
    _assert_ct_equal(got, rct.ct_mod_raise(ref, rparams, rctx))
    _assert_ct_equal(got, gckks.ct_mod_raise(gold, rparams))


@pytest.fixture(scope="module")
def dw():
    params, rparams, ctx, chest, rchest = _stack("boot_dw_ci", (), conjugation=False, seed=3)
    return params, rparams, ctx, chest, rchest, ref_context(rparams)


def test_mod_raise2_matches_reference_jnp(dw):
    params, rparams, ctx, chest, rchest, rctx = dw
    z = np.random.default_rng(4).normal(size=params.slots) * 0.3 + 0j
    ct, gold, ref = _encrypt(params, rparams, ctx, chest, rchest, z, 5, level=2, rctx=rctx)
    got = pct.ct_mod_raise2(ct, params, ctx)
    assert got.level == params.num_limbs
    _assert_ct_equal(got, rct.ct_mod_raise2(ref, rparams, rctx))
    _assert_ct_equal(got, gckks.ct_mod_raise(gold, rparams))


def test_mod_raise2_centring_boundary(dw):
    """Coefficients v = x0 + q0 t at and around Q0 // 2 = half1 q0 + rem (t
    == half1 with x0 on both sides of rem), 0 and Q0 - 1, against the
    golden model's centred CRT lift."""
    params, rparams, ctx, _, _, _ = dw
    q0, q1 = params.q_primes[:2]
    big = q0 * q1
    half = big // 2
    special = [0, 1, half - 1, half, half + 1, big - 1, half - q0, half + q0,
               (half // q0) * q0, (half // q0) * q0 + q0 - 1]
    rng = np.random.default_rng(9)
    v = np.concatenate([special, rng.integers(0, big, size=params.n - len(special))])
    coeff = np.stack([v % q0, v % q1]).astype(np.int64)
    comps = [ntt_fwd(torch.from_numpy(np.roll(coeff, k, axis=1)), ctx, limbs=[0, 1])
             for k in (0, 3)]
    ct = pct.Ciphertext(comps, 2, params.scale)
    got = pct.ct_mod_raise2(ct, params, ctx)
    gold = gckks.Ciphertext([c.numpy() for c in comps], 2, params.scale)
    _assert_ct_equal(got, gckks.ct_mod_raise(gold, rparams))


def test_truncated_galois_keys_give_equal_results(tiny2):
    params, rparams, ctx, _, rchest, _ = tiny2
    chest = interop.chest_from_reference(rchest, "cpu")  # truncated in place below
    be = DeviceBackend(params, ctx, chest)
    rng = np.random.default_rng(0)
    ns = params.slots
    ct = pct.encrypt(penc.encode(_slots(ns, rng), params), params, chest.device_pk, ctx,
                     np.random.default_rng(1), params.scale)
    lvl = params.num_limbs - 1
    ct = be.drop_to_level(ct, lvl)
    d1 = _slots(ns, rng)
    sets = [{0: d1, 1: d1, 3: d1}]

    def run():
        return ([be.apply_fan(ct, be.make_fan_plan(sets, lvl))[0], be.conjugate(ct)]
                + list(be.rotate_hoisted(ct, [1, 3]).values()))

    want = run()
    truncate_galois_device(chest, {1: lvl, 3: lvl, ns - 1: params.num_limbs}, lvl, params)
    alpha = len(params.p_primes)
    assert chest.galois_key(1).b_mont.shape[1] == lvl + alpha
    assert chest.galois_key(ns - 1).b_mont.shape[1] == params.num_limbs + alpha
    assert chest.conj_key().a_mont.shape[1] == lvl + alpha
    for g, w in zip(run(), want):
        _assert_ct_equal(g, w)


def test_mac_writes_into_out():
    params = preset("tiny2")
    ctx = make_context(params, device="cpu")
    rng = np.random.default_rng(2)
    q = np.asarray(params.q_primes, dtype=np.int64)[:, None]
    rand = lambda *lead: torch.from_numpy(  # noqa: E731
        rng.integers(0, q, size=(*lead, len(q), params.n), dtype=np.int64))
    x, y0, y1 = rand(3), rand(3), rand(3)
    rows = ctx.index(range(len(q)), torch.int32)
    want = mac_cuda.mac(x, y0, y1, rows, rows, ctx)
    stack = torch.zeros((2, 4, len(q), params.n), dtype=torch.int64)
    got = mac_cuda.mac(x, y0, y1, rows, rows, ctx, out=stack[:, 2])
    assert torch.equal(got, want) and torch.equal(stack[:, 2], want)
    assert not stack[:, [0, 1, 3]].any()
    with pytest.raises(ValueError):
        mac_cuda.mac(x, y0, y1, rows, rows, ctx, out=stack[:, :, 0])


def test_bsgs_matmul_matches_golden_backend():
    params = preset("tiny2")
    rots = bsgs_rotations(params.slots)
    params, rparams, ctx, chest, rchest = _stack("tiny2", rots, conjugation=True)
    rng = np.random.default_rng(0)
    ns = params.slots
    z = _slots(ns, rng)
    ct, gold, _ = _encrypt(params, rparams, ctx, chest, rchest, z, 1)
    m = (rng.normal(size=(ns, ns)) + 1j * rng.normal(size=(ns, ns))) / ns
    b = (rng.normal(size=(ns, ns)) + 1j * rng.normal(size=(ns, ns))) / ns
    be = DeviceBackend(params, ctx, chest)
    out = matmul_plain(be, ct, m, b)
    _assert_ct_equal(out, ref_matmul_plain(GoldenBackend(rparams, rchest), gold, m, b),
                     rel=1e-12)
    assert np.abs(be.decrypt_decode(out) - (m @ z + b @ np.conj(z))).max() < 1e-4


def test_factored_cts_matches_golden_backend():
    params = preset("fft_ci_small")
    rots = pfb.factored_rotations(params.slots, radix_log=2)
    assert rots == rfb.factored_rotations(params.slots, radix_log=2)
    params, rparams, ctx, chest, rchest = _stack("fft_ci_small", rots, conjugation=True)
    z = _slots(params.slots, np.random.default_rng(0))
    ct, gold, _ = _encrypt(params, rparams, ctx, chest, rchest, z, 1)
    be, gbe = DeviceBackend(params, ctx, chest), GoldenBackend(rparams, rchest)
    got = pfb.FactoredCtS(be, level=params.num_limbs, radix_log=2)(ct)
    want = rfb.FactoredCtS(gbe, level=params.num_limbs, radix_log=2)(gold)
    for g, w in zip(got, want):
        _assert_ct_equal(g, w, rel=1e-12)
