"""The rotation family of gpufhe_tpu_torch.ciphertext.ct against
gpufhe_tpu.ciphertext.ct (jnp path) and the golden model, with the same keys
(carried over by interop.chest_from_reference) and the same draws, limb for
limb: ct_rotate, ct_conjugate, ct_rotate_hoisted, ct_key_switch,
ct_mul_plain and ct_plain_mac (mirroring tests/test_pipeline.py:119-161),
plus the stored config4_rotations limb trace."""

import dataclasses

import numpy as np
import pytest
import torch

from gpufhe_tpu.ciphertext import ct as rct
from gpufhe_tpu.encoding import encoder as renc
from gpufhe_tpu.golden import ckks as gckks
from gpufhe_tpu.golden import vectors as gv
from gpufhe_tpu.keys import keys as rkeys
from gpufhe_tpu.ops.context import make_context as ref_context
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch import interop
from gpufhe_tpu_torch.ciphertext import ct as pct
from gpufhe_tpu_torch.encoding import encoder as penc
from gpufhe_tpu_torch.golden import ckks as pgolden
from gpufhe_tpu_torch.keys import keys as pkeys
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import preset

DECODE_TOL = 1e-2  # tests/test_pipeline.py:109
STEPS = (1, 3)


def _assert_ct_equal(got, want):
    assert got.level == want.level and got.scale == want.scale and len(got.c) == len(want.c)
    for g, w in zip(got.c, want.c):
        assert (g.cpu().numpy() == np.asarray(w).astype(np.int64)).all()


def _slots(params, rng):
    return rng.normal(size=params.slots) + 1j * rng.normal(size=params.slots)


@pytest.fixture(scope="module", params=["tiny2", "ci_small"])
def stack(request):
    params, rparams = preset(request.param), ref_preset(request.param)
    rchest = rkeys.keygen(rparams, np.random.default_rng(17), rotations=STEPS, conjugation=True)
    chest = interop.chest_from_reference(rchest, "cpu")
    return params, rparams, make_context(params, device="cpu"), ref_context(rparams), chest, rchest


def _encrypt_both(stack, z, seed):
    params, rparams, ctx, rctx, chest, rchest = stack
    pt = penc.encode(z, params)
    ct = pct.encrypt(pt, params, chest.device_pk, ctx, np.random.default_rng(seed), params.scale)
    rc = rct.encrypt(pt, rparams, rchest.device_pk, rctx, np.random.default_rng(seed),
                     params.scale)
    _assert_ct_equal(ct, rc)
    gold = gckks.encrypt(pt, rparams, rchest.pk, np.random.default_rng(seed), params.scale)
    return ct, rc, gold


def _decode(stack, ct):
    params, _, ctx, _, chest, _ = stack
    return pct.decrypt_decode(ct, params, chest.device_sk, ctx)


def test_chest_carries_over(stack):
    params, _, _, _, chest, rchest = stack
    assert chest.params.q_primes == params.q_primes and chest.params == params
    for s in STEPS:
        assert (chest.galois_key(s).b_mont.numpy() == np.asarray(rchest.galois_key(s).b_mont)).all()
        assert (chest.galois[s][0].a.numpy() == rchest.galois[s][0].a).all()
    assert (chest.conj_key().a_mont.numpy() == np.asarray(rchest.conj_key().a_mont)).all()
    assert (chest.sk.s == rchest.sk.s).all() and chest.eph is None


@pytest.mark.parametrize("steps", STEPS)
def test_rotate_matches_reference_and_golden(stack, steps):
    params, rparams, ctx, rctx, chest, rchest = stack
    z = _slots(params, np.random.default_rng(3))
    ct, rc, gold = _encrypt_both(stack, z, 41)
    got = pct.ct_rotate(ct, steps, params, ctx, chest.galois_key(steps))
    _assert_ct_equal(got, rct.ct_rotate(rc, steps, rparams, rctx, rchest.galois_key(steps)))
    _assert_ct_equal(got, gckks.ct_rotate(gold, steps, rparams, rchest.golden_galois_key(steps)))
    assert np.abs(_decode(stack, got) - np.roll(z, -steps)).max() < DECODE_TOL


def test_conjugate_matches_reference_and_golden(stack):
    params, rparams, ctx, rctx, chest, rchest = stack
    z = _slots(params, np.random.default_rng(4))
    ct, rc, gold = _encrypt_both(stack, z, 51)
    got = pct.ct_conjugate(ct, params, ctx, chest.conj_key())
    _assert_ct_equal(got, rct.ct_conjugate(rc, rparams, rctx, rchest.conj_key()))
    _assert_ct_equal(got, gckks.ct_conjugate(gold, rparams, rchest.conj[0]))
    assert np.abs(_decode(stack, got) - np.conj(z)).max() < DECODE_TOL


def test_hoisted_rotations_match_reference_and_golden(stack):
    params, rparams, ctx, rctx, chest, rchest = stack
    z = _slots(params, np.random.default_rng(6))
    ct, rc, gold = _encrypt_both(stack, z, 71)
    got = pct.ct_rotate_hoisted(ct, list(STEPS), params, ctx,
                                {s: chest.galois_key(s) for s in STEPS})
    want = rct.ct_rotate_hoisted(rc, list(STEPS), rparams, rctx,
                                 {s: rchest.galois_key(s) for s in STEPS})
    gold_out = gckks.ct_rotate_hoisted(gold, list(STEPS), rparams,
                                       {s: rchest.golden_galois_key(s) for s in STEPS})
    for g, w, gw, s in zip(got, want, gold_out, STEPS):
        _assert_ct_equal(g, w)
        _assert_ct_equal(g, gw)
        assert np.abs(_decode(stack, g) - np.roll(z, -s)).max() < DECODE_TOL


def test_key_switch_matches_golden(stack):
    """ct_key_switch with a Galois key: the automorphism's key switch alone
    (the jnp key switch is held == in the tests above and in
    tests/test_torch_keyswitch.py)."""
    params, rparams, ctx, rctx, chest, rchest = stack
    ct, rc, gold = _encrypt_both(stack, _slots(params, np.random.default_rng(8)), 81)
    got = pct.ct_key_switch(ct, params, ctx, chest.galois_key(1))
    _assert_ct_equal(got, gckks.ct_key_switch(gold, rparams, rchest.golden_galois_key(1)))


def test_mul_plain_matches_reference_and_golden(stack):
    params, rparams, ctx, rctx, chest, rchest = stack
    rng = np.random.default_rng(9)
    z, w = _slots(params, rng), _slots(params, rng)
    ct, rc, gold = _encrypt_both(stack, z, 91)
    pt = penc.encode(w, params)
    pt_dev = penc.plaintext_to_device(pt, params, ctx)
    got = pct.ct_mul_plain(ct, pt_dev, params.scale, ctx)
    _assert_ct_equal(got, rct.ct_mul_plain(rc, renc.plaintext_to_device(pt, rparams, rctx),
                                           params.scale, rctx))
    pt_ntt = gckks.ntt_limbs(pt, rparams, rparams.q_primes)
    _assert_ct_equal(got, gckks.ct_mul_plain(gold, pt_ntt, params.scale, rparams))
    assert np.abs(_decode(stack, got) - z * w).max() < 10 * DECODE_TOL
    # a 3-component ciphertext: every component, two per K4 launch
    t3 = pct.ct_tensor(ct, ct, ctx)
    _assert_ct_equal(pct.ct_mul_plain(t3, pt_dev, params.scale, ctx),
                     rct.ct_mul_plain(rct.ct_tensor(rc, rc, rctx),
                                      renc.plaintext_to_device(pt, rparams, rctx),
                                      params.scale, rctx))


@pytest.mark.parametrize("scale_words", [1, 2])
def test_plain_mac_matches_reference(stack, scale_words):
    """sum_i pt_i * ct_i over 3 ciphertexts, the rescales, plus a constant."""
    params, rparams, ctx, rctx, chest, rchest = stack
    params = dataclasses.replace(params, scale_words=scale_words)
    rparams = dataclasses.replace(rparams, scale_words=scale_words)
    rng = np.random.default_rng(10 + scale_words)
    zs = [_slots(params, rng) * 0.5 for _ in range(3)]
    ws = [_slots(params, rng) * 0.5 for _ in range(3)]
    cts, rcs = zip(*[_encrypt_both(stack, z, 100 + i)[:2] for i, z in enumerate(zs)])
    pts = [penc.encode(w, params) for w in ws]
    lvl = params.num_limbs - scale_words
    const = np.random.default_rng(12).integers(
        0, np.asarray(params.q_primes[:lvl])[:, None], size=(lvl, params.n), dtype=np.int64)
    got = pct.ct_plain_mac(list(cts), [penc.plaintext_to_device(p, params, ctx) for p in pts],
                           torch.from_numpy(const), params, ctx, params.scale ** 2)
    want = rct.ct_plain_mac(list(rcs), [renc.plaintext_to_device(p, rparams, rctx) for p in pts],
                            np.asarray(const, dtype=np.uint32), rparams, rctx,
                            params.scale ** 2)
    _assert_ct_equal(got, want)
    pts_dev = [penc.plaintext_to_device(p, params, ctx) for p in pts]
    plain = pct.ct_plain_mac(list(cts), pts_dev, None, params, ctx, params.scale ** 2)
    if scale_words == 1:
        want_z = sum(z * w for z, w in zip(zs, ws))
        assert np.abs(_decode(stack, plain) - want_z).max() < DECODE_TOL


def test_config4_rotations_vector_limb_trace():
    """The stored golden trace (tiny2): golden keygen, two Galois keys,
    encrypt and hoisted rotations by 1 and 3 equal it limb for limb."""
    want = np.load(gv.VEC_DIR / "config4_rotations.npz")
    seed = int(want["seed"])
    params = preset(want["preset"].item().decode())
    ctx = make_context(params, device="cpu")
    rng = np.random.default_rng(seed)
    sk, pk = pgolden.keygen(params, rng, ctx=ctx)
    gks = {s: pkeys.upload_ks_key(pgolden.make_galois_key(params, s, sk, rng, ctx=ctx), params,
                                  ctx=ctx)
           for s in STEPS}
    pt = penc.encode(want["z"], params)
    ct = pct.encrypt(pt, params, pkeys.upload_public_key(pk, params, ctx=ctx), ctx,
                     np.random.default_rng(seed + 2), params.scale)
    outs = pct.ct_rotate_hoisted(ct, list(STEPS), params, ctx, gks)
    for o, s in zip(outs, STEPS):
        assert (o.c[0].numpy() == want[f"rot{s}_c0"]).all()
        assert (o.c[1].numpy() == want[f"rot{s}_c1"]).all()


def test_galois_helpers_match_golden():
    for n in (64, 256):
        for g in (5, 25, 125 % (2 * n), 2 * n - 1):
            assert (pgolden.automorphism_perm_eval(g, n) == gckks.automorphism_perm_eval(g, n)).all()
            x = np.random.default_rng(g).integers(-3, 4, size=n)
            assert (pgolden.apply_automorphism_coeff(x, g) == gckks.apply_automorphism_coeff(x, g)).all()
        for steps in (0, 1, 3, n // 2 - 1):
            assert pgolden.galois_exponent(steps, n) == gckks.galois_exponent(steps, n)
