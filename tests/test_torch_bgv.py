"""gpufhe_tpu_torch.ciphertext.bgv and bgv_backend against gpufhe_tpu's BGV.

With the same keys (the port's own keygen, held == the reference's, or the
reference's chest carried over by interop.chest_from_reference) and the
same draws, every op gives the limbs and pt_factor of the reference's golden
model (gpufhe_tpu/golden/bgv.py) at bgv_tiny and bgv_ci: encrypt, add, sub,
the plaintext multiply, tensor, relinearisation with the t-corrected ModDown
(its tables are held against the reference's in tests/test_torch_convert.py),
ModSwitch, the fused ct_mul, rotation, hoisted rotation, and a BSGS matvec
through BGVDeviceBackend against the reference's BGVGoldenBackend. The
stored limb trace tests/vectors/bgv_integer.npz is reproduced from its seed,
one ct_mul is held == the reference's jnp ct_mul, and ModSwitch's centred
lift is held at its boundary. Exact integer decrypts use no tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpufhe_tpu.ciphertext import bgv as rbgv
from gpufhe_tpu.ciphertext import linalg as rlinalg
from gpufhe_tpu.ciphertext.bgv_backend import BGVGoldenBackend
from gpufhe_tpu.golden import bgv as rgbgv
from gpufhe_tpu.golden import vectors as gv
from gpufhe_tpu.ops.context import make_context as ref_context
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch import interop
from gpufhe_tpu_torch.ciphertext import bgv as pbgv
from gpufhe_tpu_torch.ciphertext import linalg
from gpufhe_tpu_torch.ciphertext.bgv_backend import BGVDeviceBackend
from gpufhe_tpu_torch.golden import bgv as gbgv
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import preset
from gpufhe_tpu_torch.primitives import rns as prns

STEPS = (1, 2, 5)


def _limbs(ct) -> list:
    return [np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c).astype(np.int64)
            for c in ct.c]


def _assert_equal(got, want):
    assert got.level == want.level and got.pt_factor == want.pt_factor
    assert len(got.c) == len(want.c)
    for g, w in zip(_limbs(got), _limbs(want)):
        assert (g == w).all()


@pytest.fixture(scope="module", params=["bgv_tiny", "bgv_ci"])
def stack(request):
    """The port's keygen on the CPU and the reference golden keys from the
    same seed; the port's chest is held == the golden keys in
    test_keygen_matches_reference."""
    params, rparams = preset(request.param), ref_preset(request.param)
    ctx = make_context(params, device="cpu")
    chest = pbgv.keygen(params, np.random.default_rng(7), rotations=STEPS, ctx=ctx)
    rng = np.random.default_rng(7)
    sk, pk = rgbgv.keygen(rparams, rng)
    rlk = rgbgv.make_relin_key(rparams, sk, rng)
    gks = {s: rgbgv.make_galois_key(rparams, s, sk, rng) for s in STEPS}
    return params, rparams, ctx, chest, (sk, pk, rlk, gks)


def _enc(stack, z, seed):
    params, rparams, ctx, chest, (sk, pk, _, _) = stack
    ct = pbgv.encrypt(gbgv.encode(z, params), params, chest.device_pk, ctx,
                      np.random.default_rng(seed))
    gold = rgbgv.encrypt(rgbgv.encode(z, rparams), rparams, pk, np.random.default_rng(seed))
    _assert_equal(ct, gold)
    return ct, gold


def _dec(stack, ct):
    params, _, ctx, chest, _ = stack
    return pbgv.decrypt_decode(ct, params, chest.device_sk, ctx)


def _msgs(params, seed, count=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, params.plain_modulus, size=params.n) for _ in range(count)]


def test_keygen_matches_reference(stack):
    """The chest (keys.keygen with err_factor t) and the golden BGV key
    functions in the same draw order both give the reference's keys."""
    params, rparams, ctx, chest, (sk, pk, rlk, gks) = stack
    assert params.plain_modulus == rparams.plain_modulus > 0
    rng = np.random.default_rng(7)
    gsk, gpk = gbgv.keygen(params, rng, ctx=ctx)
    grlk = gbgv.make_relin_key(params, gsk, rng, ctx=ctx)
    ggk = gbgv.make_galois_key(params, STEPS[0], gsk, rng, ctx=ctx)
    assert torch.equal(gpk.b, chest.pk.b) and torch.equal(grlk.b, chest.rlk.b)
    assert torch.equal(ggk.a, chest.galois[STEPS[0]][0].a)
    assert (chest.sk.s == sk.s).all()
    assert (chest.pk.b.numpy() == pk.b).all() and (chest.pk.a.numpy() == pk.a).all()
    assert (chest.rlk.b.numpy() == rlk.b).all() and (chest.rlk.a.numpy() == rlk.a).all()
    for s in STEPS:
        assert (chest.galois[s][0].b.numpy() == gks[s].b).all()
    # a BGVKeyChest, the reference's fields in its order: no conj, no eph
    assert isinstance(chest, pbgv.BGVKeyChest)
    assert ([f.name for f in dataclasses.fields(chest)]
            == [f.name for f in dataclasses.fields(rbgv.BGVKeyChest)])


def test_encode_and_slot_helpers_match_reference(stack):
    params, rparams, _, _, _ = stack
    z = _msgs(params, 0, 1)[0]
    assert (gbgv.encode(z, params) == rgbgv.encode(z, rparams)).all()
    assert (gbgv.decode(gbgv.encode(z, params), params) == z).all()
    for s in STEPS:
        assert (gbgv.slot_rotation_perm(params, s) == rgbgv.slot_rotation_perm(rparams, s)).all()
    assert (gbgv.slot_orbit_rings(params) == rgbgv.slot_orbit_rings(rparams)).all()


def test_encrypt_decrypt_add_sub_mul_plain(stack):
    params, rparams, ctx, _, _ = stack
    t = params.plain_modulus
    za, zb = _msgs(params, 1)
    a, ga = _enc(stack, za, 21)
    b, gb = _enc(stack, zb, 22)
    assert (_dec(stack, a) == za).all()
    _assert_equal(pbgv.ct_add(a, b, ctx), rgbgv.ct_add(ga, gb, rparams))
    _assert_equal(pbgv.ct_sub(a, b, ctx), rgbgv.ct_sub(ga, gb, rparams))
    assert (_dec(stack, pbgv.ct_sub(a, b, ctx)) == (za - zb) % t).all()
    pt_b = gbgv.encode(zb, params)
    mp = pbgv.ct_mul_plain(a, pbgv.plaintext_to_device(pt_b, params, ctx, a.level), ctx)
    _assert_equal(mp, rgbgv.ct_mul_plain(ga, pt_b, rparams))
    assert (_dec(stack, mp) == za * zb % t).all()


def test_tensor_relin_modswitch_and_fused_mul(stack):
    """The three stages one by one, the fused ct_mul, and a second multiply
    on the product (pt_factor != 1), all == the golden model."""
    params, rparams, ctx, chest, (_, _, rlk, _) = stack
    t = params.plain_modulus
    za, zb = _msgs(params, 2)
    a, ga = _enc(stack, za, 31)
    b, gb = _enc(stack, zb, 32)
    tt, gt = pbgv.ct_tensor(a, b, params, ctx), rgbgv.ct_tensor(ga, gb, rparams)
    _assert_equal(tt, gt)
    r, gr = pbgv.ct_relinearize(tt, params, ctx, chest.device_rlk), rgbgv.ct_relinearize(
        gt, rparams, rlk)
    _assert_equal(r, gr)
    m, gm = pbgv.ct_modswitch(r, params, ctx), rgbgv.ct_modswitch(gr, rparams)
    _assert_equal(m, gm)
    fused = pbgv.ct_mul(a, b, params, ctx, chest.device_rlk)
    _assert_equal(fused, gm)
    assert fused.pt_factor != 1 and (_dec(stack, fused) == za * zb % t).all()
    m2 = pbgv.ct_mul(fused, fused, params, ctx, chest.device_rlk)
    _assert_equal(m2, rgbgv.ct_mul(gm, gm, rparams, rlk))
    assert (_dec(stack, m2) == (za * zb % t) ** 2 % t).all()


def test_rotations_match_reference(stack):
    params, rparams, ctx, chest, (_, _, _, gks) = stack
    z = _msgs(params, 3, 1)[0]
    ct, gold = _enc(stack, z, 41)
    for s in STEPS[:2]:
        got = pbgv.ct_rotate(ct, s, params, ctx, chest.galois_key(s))
        _assert_equal(got, rgbgv.ct_rotate(gold, s, rparams, gks[s]))
        assert (_dec(stack, got) == z[gbgv.slot_rotation_perm(params, s)]).all()
    outs = pbgv.ct_rotate_hoisted(ct, list(STEPS), params, ctx,
                                  {s: chest.galois_key(s) for s in STEPS})
    for s, got, want in zip(STEPS, outs, rgbgv.ct_rotate_hoisted(gold, list(STEPS), rparams,
                                                                 gks)):
        _assert_equal(got, want)
        assert (_dec(stack, got) == z[gbgv.slot_rotation_perm(params, s)]).all()


@pytest.mark.parametrize("lift", ["below", "at", "above"])
def test_modswitch_centred_lift_at_its_boundary(lift):
    """u = [-x t^-1]_{q_last} at q_last // 2 - 1, q_last // 2 (kept) and
    q_last // 2 + 1 (lifted to u - q_last): == the golden modswitch_coeff."""
    params, rparams = preset("bgv_tiny"), ref_preset("bgv_tiny")
    ctx = make_context(params, device="cpu")
    level = params.num_limbs
    q_last, t = params.q_primes[-1], params.plain_modulus
    u = q_last // 2 + {"below": -1, "at": 0, "above": 1}[lift]
    rng = np.random.default_rng(6)
    x = np.stack([rng.integers(0, q, size=params.n) for q in params.q_primes])
    x[-1] = (-u * t) % q_last  # then -x_last t^-1 = u mod q_last
    ksc = prns.make_ks_context(params, level, device="cpu")
    got = prns.bgv_modswitch(torch.from_numpy(x), params, level, ctx, ksc).numpy()
    assert (got == rgbgv.modswitch_coeff(x, rparams, rparams.q_primes)).all()


def test_backend_matvec_matches_golden_backend():
    """A BSGS matvec through BGVDeviceBackend == the reference's
    BGVGoldenBackend limb for limb (keys carried over by interop), exact
    A v mod t on both rings, and add_plain on a ModSwitched ciphertext."""
    params, rparams = preset("bgv_tiny"), ref_preset("bgv_tiny")
    n_s, t = params.slots, params.plain_modulus
    rots = tuple(linalg.bsgs_rotations(n_s))
    assert rots == tuple(rlinalg.bsgs_rotations(n_s))
    rchest = rbgv.keygen(rparams, np.random.default_rng(9), rotations=rots)
    chest = interop.chest_from_reference(rchest, "cpu")
    assert chest.params == params
    ctx = make_context(params, device="cpu")
    rng = np.random.default_rng(6)
    a_mat = rng.integers(0, t, size=(n_s, n_s))
    v = rng.integers(0, t, size=(2, n_s))
    g_be, d_be = BGVGoldenBackend(rparams, rchest), BGVDeviceBackend(params, ctx, chest)
    assert (d_be.rings == g_be.rings).all()
    raw = np.empty(params.n, dtype=np.int64)
    raw[d_be.rings[0]], raw[d_be.rings[1]] = v[0], v[1]
    ct = pbgv.encrypt(gbgv.encode(raw, params), params, chest.device_pk, ctx,
                      np.random.default_rng(61))
    gold = rgbgv.encrypt(rgbgv.encode(raw, rparams), rparams, rchest.pk,
                         np.random.default_rng(61))
    out = linalg.matmul_plain(d_be, ct, a_mat)
    gout = rlinalg.matmul_plain(g_be, gold, a_mat)
    _assert_equal(out, gout)
    want = (a_mat.astype(object) @ v.T.astype(object) % t).T.astype(np.int64)
    assert (d_be.decrypt_decode(out) == want).all()
    d = rng.integers(0, t, size=(2, n_s))
    summed = d_be.add_plain(out, d)
    _assert_equal(summed, g_be.add_plain(gout, d))
    assert out.pt_factor != 1 and (d_be.decrypt_decode(summed) == (want + d) % t).all()


def test_stored_bgv_vector_reproduced():
    """tests/vectors/bgv_integer.npz from its seed (golden/vectors.py
    gen_bgv_integer) through the port's keygen and ops."""
    ref = np.load(gv.VEC_DIR / "bgv_integer.npz")
    params = preset(bytes(ref["preset"]).decode())
    seed = int(ref["seed"])
    t = params.plain_modulus
    ctx = make_context(params, device="cpu")
    rng = np.random.default_rng(seed)
    sk, pk = gbgv.keygen(params, rng, ctx=ctx)
    chest = pbgv.keygen(params, np.random.default_rng(seed), rotations=(1,), ctx=ctx)
    assert (chest.sk.s == sk.s).all() and torch.equal(chest.pk.b, pk.b)
    mrng = np.random.default_rng(seed + 1)
    m1 = mrng.integers(0, t, size=params.n, dtype=np.int64)
    m2 = mrng.integers(0, t, size=params.n, dtype=np.int64)
    assert (m1 == ref["m1"]).all() and (m2 == ref["m2"]).all()
    c1, c2 = (pbgv.encrypt(gbgv.encode(m, params), params, chest.device_pk, ctx,
                           np.random.default_rng(seed + 2 + i)) for i, m in enumerate((m1, m2)))
    prod = pbgv.ct_mul(c1, c2, params, ctx, chest.device_rlk)
    rot = pbgv.ct_rotate(c1, 1, params, ctx, chest.galois_key(1))
    for got, key in ((c1, "ct1"), (prod, "mul"), (rot, "rot1")):
        limbs = _limbs(got)
        assert (limbs[0] == ref[f"{key}_c0"]).all() and (limbs[1] == ref[f"{key}_c1"]).all()
    assert prod.pt_factor == int(ref["mul_pt_factor"])
    assert (pbgv.decrypt_decode(prod, params, chest.device_sk, ctx) == m1 * m2 % t).all()


def test_ct_mul_matches_reference_device_path():
    """One fused ct_mul == the reference's jnp ct_mul at bgv_tiny, with the
    reference's chest carried over."""
    params, rparams = preset("bgv_tiny"), ref_preset("bgv_tiny")
    rchest = rbgv.keygen(rparams, np.random.default_rng(13))
    chest = interop.chest_from_reference(rchest, "cpu")
    ctx, rctx = make_context(params, device="cpu"), ref_context(rparams)
    za, zb = _msgs(params, 14)
    cts, rcts = [], []
    for i, z in enumerate((za, zb)):
        pt = gbgv.encode(z, params)
        cts.append(pbgv.encrypt(pt, params, chest.device_pk, ctx, np.random.default_rng(i)))
        rcts.append(rbgv.encrypt(pt, rparams, rchest.device_pk, rctx, np.random.default_rng(i)))
        _assert_equal(cts[-1], rcts[-1])
    got = pbgv.ct_mul(*cts, params, ctx, chest.device_rlk)
    _assert_equal(got, rbgv.ct_mul(*rcts, rparams, rctx, rchest.device_rlk))
    back = interop.integer_ciphertext_from_numpy(_limbs(got), got.level, got.pt_factor, "cpu")
    _assert_equal(back, got)
