"""The slice as a whole: encode -> encrypt -> ct_mul_full -> decrypt in
gpufhe_tpu_torch against gpufhe_tpu.ciphertext.ct with the same keys and
draws, limb for limb, and the stored config3_ckks limb trace
(as tests/test_vectors.py:46-79 holds the reference to it)."""

import dataclasses

import numpy as np
import pytest

from gpufhe_tpu.ciphertext import ct as rct
from gpufhe_tpu.encoding import encoder as renc
from gpufhe_tpu.golden import ckks as gckks
from gpufhe_tpu.golden import vectors as gv
from gpufhe_tpu.keys import keys as rkeys
from gpufhe_tpu.ops.context import make_context as ref_context
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch.ciphertext import ct as pct
from gpufhe_tpu_torch.encoding import encoder as penc
from gpufhe_tpu_torch.keys import keys as pkeys
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import preset

DECODE_TOL = 1e-2  # tests/test_pipeline.py:109


def _assert_ct_equal(got, want):
    assert got.level == want.level and got.scale == want.scale and len(got.c) == len(want.c)
    for g, w in zip(got.c, want.c):
        assert (g.cpu().numpy() == np.asarray(w).astype(np.int64)).all()


def _gaussian(rng, size):
    return rng.normal(size=size) + 1j * rng.normal(size=size)


def _slots(params, rng):
    return _gaussian(rng, params.slots)


def _stack(params, rparams, seed=7):
    ctx, rctx = make_context(params, device="cpu"), ref_context(rparams)
    chest = pkeys.keygen(params, np.random.default_rng(seed), ctx=ctx)
    rchest = rkeys.keygen(rparams, np.random.default_rng(seed))
    return ctx, rctx, chest, rchest


@pytest.fixture(scope="module", params=["tiny2", "ci_small"])
def stack(request):
    params, rparams = preset(request.param), ref_preset(request.param)
    return (params, rparams, *_stack(params, rparams))


def _encrypt_both(params, rparams, ctx, rctx, chest, rchest, z, seed):
    pt = penc.encode(z, params)
    assert (pt == renc.encode(z, rparams)).all()
    ct = pct.encrypt(pt, params, chest.device_pk, ctx, np.random.default_rng(seed), params.scale)
    rc = rct.encrypt(pt, rparams, rchest.device_pk, rctx, np.random.default_rng(seed), params.scale)
    _assert_ct_equal(ct, rc)
    return ct, rc


def test_encrypt_mul_full_decrypt_matches_reference(stack):
    params, rparams, ctx, rctx, chest, rchest = stack
    rng = np.random.default_rng(2)
    za, zb = _slots(params, rng), _slots(params, rng)
    a, ra = _encrypt_both(params, rparams, ctx, rctx, chest, rchest, za, 31)
    b, rb = _encrypt_both(params, rparams, ctx, rctx, chest, rchest, zb, 32)
    prod = pct.ct_mul_full(a, b, params, ctx, chest.device_rlk)
    prod_ref = rct.ct_mul_full(ra, rb, rparams, rctx, rchest.device_rlk)
    _assert_ct_equal(prod, prod_ref)
    coeff = pct.decrypt_to_coeff(prod, params, chest.device_sk, ctx)
    assert (coeff == rct.decrypt_to_coeff(prod_ref, rparams, rchest.device_sk, rctx)).all()
    got = pct.decrypt_decode(prod, params, chest.device_sk, ctx)
    assert np.abs(got - za * zb).max() < DECODE_TOL


def test_stagewise_ops_match_reference(stack):
    """add, sub, tensor, relinearize, rescale and the unfused ct_mul."""
    params, rparams, ctx, rctx, chest, rchest = stack
    rng = np.random.default_rng(4)
    za, zb = _slots(params, rng), _slots(params, rng)
    a, ra = _encrypt_both(params, rparams, ctx, rctx, chest, rchest, za, 41)
    b, rb = _encrypt_both(params, rparams, ctx, rctx, chest, rchest, zb, 42)
    _assert_ct_equal(pct.ct_add(a, b, ctx), rct.ct_add(ra, rb, rctx))
    _assert_ct_equal(pct.ct_sub(a, b, ctx), rct.ct_sub(ra, rb, rctx))
    t, rt = pct.ct_tensor(a, b, ctx), rct.ct_tensor(ra, rb, rctx)
    _assert_ct_equal(t, rt)
    r, rr = (pct.ct_relinearize(t, params, ctx, chest.device_rlk),
             rct.ct_relinearize(rt, rparams, rctx, rchest.device_rlk))
    _assert_ct_equal(r, rr)
    s = pct.ct_rescale(r, params, ctx)
    _assert_ct_equal(s, rct.ct_rescale(rr, rparams, rctx))
    # a second multiply one level down (uneven last decomposition group)
    s2 = pct.ct_mul(s, s, params, ctx, chest.device_rlk)
    _assert_ct_equal(s2, gckks.ct_mul(*(2 * [gckks.Ciphertext(
        [c.numpy() for c in s.c], s.level, s.scale)]), rparams, rchest.rlk))
    got = pct.decrypt_decode(s2, params, chest.device_sk, ctx)
    assert np.abs(got - (za * zb) ** 2).max() < 1e-1
    pt_dev = penc.plaintext_to_device(penc.encode(zb, params), params, ctx)
    assert (pt_dev.numpy() == np.asarray(renc.plaintext_to_device(
        renc.encode(zb, rparams), rparams, rctx)).astype(np.int64)).all()


def test_mul_full_double_word_scale_matches_reference():
    """scale_words = 2: two rescales back to back inside ct_mul_full."""
    params = dataclasses.replace(preset("tiny2"), scale_words=2)
    rparams = dataclasses.replace(ref_preset("tiny2"), scale_words=2)
    ctx, rctx, chest, rchest = _stack(params, rparams, seed=8)
    rng = np.random.default_rng(6)
    a, ra = _encrypt_both(params, rparams, ctx, rctx, chest, rchest, _slots(params, rng), 51)
    b, rb = _encrypt_both(params, rparams, ctx, rctx, chest, rchest, _slots(params, rng), 52)
    prod = pct.ct_mul_full(a, b, params, ctx, chest.device_rlk)
    assert prod.level == params.num_limbs - 2
    _assert_ct_equal(prod, rct.ct_mul_full(ra, rb, rparams, rctx, rchest.device_rlk))


def test_config3_vectors_limb_trace():
    """The stored golden trace (tiny2): keys, encrypt, tensor, relinearize,
    rescale and decrypt of the port equal it limb for limb."""
    want = np.load(gv.VEC_DIR / "config3_ckks.npz")
    seed = int(want["seed"])
    params = preset(want["preset"].item().decode())
    ctx = make_context(params, device="cpu")
    chest = pkeys.keygen(params, np.random.default_rng(seed), ctx=ctx)
    pa, pb = penc.encode(want["za"], params), penc.encode(want["zb"], params)
    ca = pct.encrypt(pa, params, chest.device_pk, ctx, np.random.default_rng(seed + 2), params.scale)
    cb = pct.encrypt(pb, params, chest.device_pk, ctx, np.random.default_rng(seed + 3), params.scale)
    assert (ca.c[0].numpy() == want["ct_a0"]).all() and (ca.c[1].numpy() == want["ct_a1"]).all()
    t = pct.ct_tensor(ca, cb, ctx)
    for i in range(3):
        assert (t.c[i].numpy() == want[f"tensor_d{i}"]).all()
    r = pct.ct_relinearize(t, params, ctx, chest.device_rlk)
    assert (r.c[0].numpy() == want["relin_c0"]).all() and (r.c[1].numpy() == want["relin_c1"]).all()
    for s in (pct.ct_rescale(r, params, ctx), pct.ct_mul_full(ca, cb, params, ctx, chest.device_rlk)):
        assert (s.c[0].numpy() == want["rescale_c0"]).all()
        assert (s.c[1].numpy() == want["rescale_c1"]).all()
        assert (pct.decrypt_to_coeff(s, params, chest.device_sk, ctx) == want["decrypt_coeff"]).all()


def test_config5_boot_decode_error_reference():
    """The decode check of chip_smoke.py, made on the reference's golden model.

    With chip_smoke's seeds, config5_boot (N = 2^16, Delta = 2^28) decodes the
    product of two unit-disk slot vectors within DECODE_TOL, while complex
    Gaussian slots (|z_a z_b| up to ~12) exceed it: the error is the scheme's
    noise times |z|, in the reference as in the port, which is why the smoke
    draws its slots on the unit disk.
    """
    import chip_smoke

    params = ref_preset("config5_boot")
    seed = chip_smoke.SEED
    rng = np.random.default_rng(seed)
    sk, pk = gckks.keygen(params, rng)
    rlk = gckks.make_relin_key(params, sk, rng)
    errors = {}
    for name, draw in (("unit_disk", chip_smoke.unit_disk), ("gaussian", _gaussian)):
        zr = np.random.default_rng(seed + 1)
        za, zb = draw(zr, params.slots), draw(zr, params.slots)
        ca, cb = (gckks.encrypt(gckks.encode(z, params.scale, params.q_primes, params.n), params,
                                pk, np.random.default_rng(s), params.scale)
                  for z, s in ((za, seed + 2), (zb, seed + 3)))
        got = gckks.decrypt_decode(gckks.ct_mul(ca, cb, params, rlk), params, sk)
        errors[name] = float(np.abs(got - za * zb).max())
    print(f"config5_boot reference max |dec - za*zb|: {errors}")
    assert errors["unit_disk"] < chip_smoke.DECODE_TOL == DECODE_TOL <= errors["gaussian"]
