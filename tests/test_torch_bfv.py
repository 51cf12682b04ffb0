"""gpufhe_tpu_torch.ciphertext.bfv, bfv_backend and scheme switching against
gpufhe_tpu's BFV.

With the same keys (the port's own keygen, held == the reference's golden
keys, or the reference's chest carried over by interop) and the same draws,
every op gives the reference golden model's limbs (gpufhe_tpu/golden/bfv.py)
at bfv_tiny and bfv_ci: encrypt, add, sub, the plaintext multiply and add,
the BEHZ tensor over the aux basis, relinearisation and rotations with the
plain ModDown (a BFV key switch that read BGV's t-folded tables would still
decrypt, so only these limb tests catch it), the fused ct_mul, ModReduce,
both scheme switches with their message factors, and a BSGS matvec through
BFVDeviceBackend against BFVGoldenBackend. The stored limb trace
tests/vectors/bfv_integer.npz is reproduced from its seed, one ct_mul is
held == the reference's jnp ct_mul, the aux basis and its tables against
the reference's, and the Shenoy-Kumaresan centred lift at its boundary.
"""

import math

import numpy as np
import pytest
import torch

from gpufhe_tpu.ciphertext import bfv as rbfv
from gpufhe_tpu.ciphertext import linalg as rlinalg
from gpufhe_tpu.ciphertext.bfv_backend import BFVGoldenBackend
from gpufhe_tpu.golden import bfv as rgbfv
from gpufhe_tpu.golden import bgv as rgbgv
from gpufhe_tpu.golden import vectors as gv
from gpufhe_tpu.ops.context import make_context as ref_context
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch import interop
from gpufhe_tpu_torch.ciphertext import bfv as pbfv
from gpufhe_tpu_torch.ciphertext import bgv as pbgv
from gpufhe_tpu_torch.ciphertext import linalg
from gpufhe_tpu_torch.ciphertext.bfv_backend import BFVDeviceBackend
from gpufhe_tpu_torch.ciphertext.bgv_backend import BGVDeviceBackend
from gpufhe_tpu_torch.golden import bfv as gbfv
from gpufhe_tpu_torch.golden import bgv as gbgv
from gpufhe_tpu_torch.ops import rescale_cuda
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import preset
from gpufhe_tpu_torch.primitives import rns as prns

STEPS = (1, 3)


def _limbs(ct) -> list:
    return [np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c).astype(np.int64)
            for c in ct.c]


def _assert_equal(got, want):
    assert got.level == want.level and len(got.c) == len(want.c)
    assert getattr(got, "pt_factor", None) == getattr(want, "pt_factor", None)
    for g, w in zip(_limbs(got), _limbs(want)):
        assert (g == w).all()


@pytest.fixture(scope="module", params=["bfv_tiny", "bfv_ci"])
def stack(request):
    params, rparams = preset(request.param), ref_preset(request.param)
    ctx = make_context(params, device="cpu")
    chest = pbfv.keygen(params, np.random.default_rng(21), rotations=STEPS, ctx=ctx)
    rng = np.random.default_rng(21)
    sk, pk = rgbfv.keygen(rparams, rng)
    rlk = rgbfv.make_relin_key(rparams, sk, rng)
    gks = {s: rgbfv.make_galois_key(rparams, s, sk, rng) for s in STEPS}
    return params, rparams, ctx, chest, (sk, pk, rlk, gks)


def _pair(stack, seed):
    """(message, port ciphertext, golden ciphertext) from the same draws."""
    params, rparams, ctx, chest, (_, pk, _, _) = stack
    m = np.random.default_rng(seed).integers(0, params.plain_modulus, size=params.n)
    ct = pbfv.encrypt(gbfv.encode(m, params), params, chest.device_pk, ctx,
                      np.random.default_rng(seed + 100))
    gold = rgbfv.encrypt(rgbfv.encode(m, rparams), rparams, pk,
                         np.random.default_rng(seed + 100))
    _assert_equal(ct, gold)
    return m, ct, gold


def _dec(stack, ct):
    params, _, ctx, chest, _ = stack
    return pbfv.decrypt_decode(ct, params, chest.device_sk, ctx)


def test_keygen_is_the_ckks_keygen_and_matches_reference(stack):
    params, _, _, chest, (sk, pk, rlk, gks) = stack
    assert (chest.sk.s == sk.s).all() and (chest.pk.b.numpy() == pk.b).all()
    assert (chest.rlk.b.numpy() == rlk.b).all() and (chest.rlk.a.numpy() == rlk.a).all()
    for s in STEPS:
        assert (chest.galois[s][0].b.numpy() == gks[s].b).all()


def test_encrypt_decrypt_and_linear_ops(stack):
    params, rparams, ctx, _, _ = stack
    t = params.plain_modulus
    m1, a, ga = _pair(stack, 1)
    m2, b, gb = _pair(stack, 2)
    assert (_dec(stack, a) == m1).all()
    _assert_equal(pbfv.ct_add(a, b, ctx), rgbfv.ct_add(ga, gb, rparams))
    _assert_equal(pbfv.ct_sub(a, b, ctx), rgbfv.ct_sub(ga, gb, rparams))
    pt2 = gbfv.encode(m2, params)
    mp = pbfv.ct_mul_plain(a, pbfv.plaintext_to_device(pt2, params, ctx, a.level), ctx)
    _assert_equal(mp, rgbfv.ct_mul_plain(ga, pt2, rparams))
    assert (_dec(stack, mp) == m1 * m2 % t).all()
    ap = pbfv.ct_add_plain(a, pt2, params, ctx)
    _assert_equal(ap, rgbfv.ct_add_plain(ga, pt2, rparams))
    assert (_dec(stack, ap) == (m1 + m2) % t).all()


def test_tensor_relin_mul_and_mod_reduce(stack):
    """The BEHZ tensor, the plain-ModDown relinearisation, the fused ct_mul,
    a chained second multiply and ModReduce, all == the golden model."""
    params, rparams, ctx, chest, (_, _, rlk, _) = stack
    t = params.plain_modulus
    m1, a, ga = _pair(stack, 3)
    m2, b, gb = _pair(stack, 4)
    tt, gt = pbfv.ct_tensor(a, b, params, ctx), rgbfv.ct_tensor(ga, gb, rparams)
    _assert_equal(tt, gt)
    r, gr = pbfv.ct_relinearize(tt, params, ctx, chest.device_rlk), rgbfv.ct_relinearize(
        gt, rparams, rlk)
    _assert_equal(r, gr)
    prod = pbfv.ct_mul(a, b, params, ctx, chest.device_rlk)
    _assert_equal(prod, gr)
    assert (_dec(stack, prod) == m1 * m2 % t).all()
    m3, c, gc = _pair(stack, 5)
    chained = pbfv.ct_mul(prod, c, params, ctx, chest.device_rlk)
    _assert_equal(chained, rgbfv.ct_mul(gr, gc, rparams, rlk))
    assert (_dec(stack, chained) == m1 * m2 % t * m3 % t).all()
    red = pbfv.ct_mod_reduce(prod, params, ctx)
    _assert_equal(red, rgbfv.ct_mod_reduce(gr, rparams))
    assert (_dec(stack, red) == m1 * m2 % t).all()


def test_relinearisation_uses_the_plain_moddown(stack):
    """The BGV ModDown on the same limbs gives other limbs: the equality
    above holds only with the plain tables."""
    params, _, ctx, chest, _ = stack
    _, a, _ = _pair(stack, 6)
    tt = pbfv.ct_tensor(a, a, params, ctx)
    want = pbfv.ct_relinearize(tt, params, ctx, chest.device_rlk)
    bgv = pbgv.ct_relinearize(pbgv.BGVCiphertext(tt.c, tt.level, 1), params, ctx,
                              chest.device_rlk)
    assert any(not torch.equal(x, y) for x, y in zip(want.c, bgv.c))


def test_rotations_match_reference(stack):
    params, rparams, ctx, chest, (_, _, _, gks) = stack
    m, ct, gold = _pair(stack, 8)
    for s in STEPS:
        got = pbfv.ct_rotate(ct, s, params, ctx, chest.galois_key(s))
        _assert_equal(got, rgbfv.ct_rotate(gold, s, rparams, gks[s]))
        assert (_dec(stack, got) == m[gbfv.slot_rotation_perm(params, s)]).all()
    outs = pbfv.ct_rotate_hoisted(ct, list(STEPS), params, ctx,
                                  {s: chest.galois_key(s) for s in STEPS})
    for s, got, want in zip(STEPS, outs, rgbfv.ct_rotate_hoisted(gold, list(STEPS), rparams,
                                                                 gks)):
        _assert_equal(got, want)
        assert (_dec(stack, got) == m[gbfv.slot_rotation_perm(params, s)]).all()


def test_scheme_switching_matches_reference():
    """bgv_to_bfv on a fresh and on a ModSwitched ciphertext (pt_factor !=
    1) and bfv_to_bgv: limbs and factors == the golden model's, decrypts
    exact with the factors applied."""
    params, rparams = preset("bgv_tiny"), ref_preset("bgv_tiny")
    t = params.plain_modulus
    ctx = make_context(params, device="cpu")
    chest = pbgv.keygen(params, np.random.default_rng(31), ctx=ctx)
    rng = np.random.default_rng(31)
    sk, pk = rgbgv.keygen(rparams, rng)
    rlk = rgbgv.make_relin_key(rparams, sk, rng)
    r = np.random.default_rng(2)
    m1, m2 = (r.integers(0, t, size=params.n) for _ in range(2))
    c1, c2 = (pbgv.encrypt(gbgv.encode(m, params), params, chest.device_pk, ctx,
                           np.random.default_rng(3 + i)) for i, m in enumerate((m1, m2)))
    g1, g2 = (rgbgv.encrypt(rgbgv.encode(m, rparams), rparams, pk, np.random.default_rng(3 + i))
              for i, m in enumerate((m1, m2)))
    prod, gprod = pbgv.ct_mul(c1, c2, params, ctx, chest.device_rlk), rgbgv.ct_mul(
        g1, g2, rparams, rlk)
    for ct, gold, want in ((c1, g1, m1), (prod, gprod, m1 * m2 % t)):
        out, factor = pbfv.bgv_to_bfv(ct, params, ctx)
        gout, gfactor = rgbfv.bgv_to_bfv(gold, rparams)
        _assert_equal(out, gout)
        assert factor == gfactor
        got = pbfv.decrypt(out, params, chest.device_sk, ctx) * pow(factor, -1, t) % t
        assert (gbfv.decode(got, params) == want).all()
        back = pbfv.bfv_to_bgv(out, params, ctx)
        _assert_equal(back, rgbfv.bfv_to_bgv(gout, rparams))
        got = pbgv.decrypt(back, params, chest.device_sk, ctx) * pow(factor, -1, t) % t
        assert (gbgv.decode(got, params) == want).all()
    assert prod.pt_factor != 1


def test_cross_scheme_pipeline():
    """BGV BSGS matvec through BGVDeviceBackend, switch to BFV, square under
    BFV (one chest serves both: same secret), exact mod t."""
    params = preset("bgv_tiny")
    t, n_s = params.plain_modulus, params.slots
    ctx = make_context(params, device="cpu")
    chest = pbgv.keygen(params, np.random.default_rng(40),
                        rotations=tuple(linalg.bsgs_rotations(n_s)), ctx=ctx)
    be = BGVDeviceBackend(params, ctx, chest)
    rng = np.random.default_rng(41)
    a_mat, v = rng.integers(0, t, size=(n_s, n_s)), rng.integers(0, t, size=n_s)
    raw = np.empty(params.n, dtype=np.int64)
    raw[be.rings[0]] = raw[be.rings[1]] = v
    ct = pbgv.encrypt(gbgv.encode(raw, params), params, chest.device_pk, ctx,
                      np.random.default_rng(42))
    bfv_ct, factor = pbfv.bgv_to_bfv(linalg.matmul_plain(be, ct, a_mat), params, ctx)
    sq = pbfv.ct_mul(bfv_ct, bfv_ct, params, ctx, chest.device_rlk)
    got = gbfv.decode(pbfv.decrypt(sq, params, chest.device_sk, ctx) * pow(factor, -2, t) % t,
                      params)[be.rings]
    av = a_mat.astype(object) @ v.astype(object) % t
    assert (got == (av * av % t).astype(np.int64)).all()


def test_backend_matvec_matches_golden_backend():
    """A BSGS matvec, add_plain, and mul then rescale (ModReduce) through
    BFVDeviceBackend == the reference's BFVGoldenBackend limb for limb."""
    params, rparams = preset("bfv_tiny"), ref_preset("bfv_tiny")
    n_s, t = params.slots, params.plain_modulus
    rots = tuple(linalg.bsgs_rotations(n_s))
    rchest = rbfv.keygen(rparams, np.random.default_rng(9), rotations=rots)
    chest = interop.chest_from_reference(rchest, "cpu")
    ctx = make_context(params, device="cpu")
    rng = np.random.default_rng(6)
    a_mat = rng.integers(0, t, size=(n_s, n_s))
    v = rng.integers(0, t, size=(2, n_s))
    g_be, d_be = BFVGoldenBackend(rparams, rchest), BFVDeviceBackend(params, ctx, chest)
    raw = np.empty(params.n, dtype=np.int64)
    raw[d_be.rings[0]], raw[d_be.rings[1]] = v[0], v[1]
    ct = pbfv.encrypt(gbfv.encode(raw, params), params, chest.device_pk, ctx,
                      np.random.default_rng(61))
    gold = rgbfv.encrypt(rgbfv.encode(raw, rparams), rparams, rchest.pk,
                         np.random.default_rng(61))
    out = linalg.matmul_plain(d_be, ct, a_mat)
    _assert_equal(out, rlinalg.matmul_plain(g_be, gold, a_mat))
    want = (a_mat.astype(object) @ v.T.astype(object) % t).T.astype(np.int64)
    assert (d_be.decrypt_decode(out) == want).all()
    d = rng.integers(0, t, size=(2, n_s))
    summed = d_be.add_plain(ct, d)
    _assert_equal(summed, g_be.add_plain(gold, d))
    assert (d_be.decrypt_decode(summed) == (v + d) % t).all()
    prod = d_be.rescale(d_be.mul(ct, ct))
    _assert_equal(prod, g_be.rescale(g_be.mul(gold, gold)))
    assert (d_be.decrypt_decode(prod) == v * v % t).all()


def test_stored_bfv_vector_reproduced():
    """tests/vectors/bfv_integer.npz from its seed (golden/vectors.py
    gen_bfv_integer) through the port's keygen and ops."""
    ref = np.load(gv.VEC_DIR / "bfv_integer.npz")
    params = preset(bytes(ref["preset"]).decode())
    seed, t = int(ref["seed"]), params.plain_modulus
    ctx = make_context(params, device="cpu")
    chest = pbfv.keygen(params, np.random.default_rng(seed), rotations=(1,), ctx=ctx)
    mrng = np.random.default_rng(seed + 1)
    m1 = mrng.integers(0, t, size=params.n, dtype=np.int64)
    m2 = mrng.integers(0, t, size=params.n, dtype=np.int64)
    c1, c2 = (pbfv.encrypt(gbfv.encode(m, params), params, chest.device_pk, ctx,
                           np.random.default_rng(seed + 2 + i)) for i, m in enumerate((m1, m2)))
    prod = pbfv.ct_mul(c1, c2, params, ctx, chest.device_rlk)
    sw = pbfv.bfv_to_bgv(c1, params, ctx)
    outs = {"ct1": c1, "mul": prod, "modred": pbfv.ct_mod_reduce(prod, params, ctx),
            "rot1": pbfv.ct_rotate(c1, 1, params, ctx, chest.galois_key(1)), "switch": sw}
    for key, got in outs.items():
        limbs = _limbs(got)
        assert (limbs[0] == ref[f"{key}_c0"]).all() and (limbs[1] == ref[f"{key}_c1"]).all()
    assert sw.pt_factor == int(ref["switch_pt_factor"])
    assert (pbfv.decrypt_decode(prod, params, chest.device_sk, ctx) == m1 * m2 % t).all()


def test_ct_mul_matches_reference_device_path():
    """One ct_mul == the reference's jnp ct_mul at bfv_tiny, the reference's
    chest carried over."""
    params, rparams = preset("bfv_tiny"), ref_preset("bfv_tiny")
    rchest = rbfv.keygen(rparams, np.random.default_rng(23))
    chest = interop.chest_from_reference(rchest, "cpu")
    ctx, rctx = make_context(params, device="cpu"), ref_context(rparams)
    cts, rcts = [], []
    for i in range(2):
        m = np.random.default_rng(i).integers(0, params.plain_modulus, size=params.n)
        pt = gbfv.encode(m, params)
        cts.append(pbfv.encrypt(pt, params, chest.device_pk, ctx, np.random.default_rng(i)))
        rcts.append(rbfv.encrypt(pt, rparams, rchest.device_pk, rctx, np.random.default_rng(i)))
        _assert_equal(cts[-1], rcts[-1])
    got = pbfv.ct_mul(*cts, params, ctx, chest.device_rlk)
    _assert_equal(got, rbfv.ct_mul(*rcts, rparams, rctx, rchest.device_rlk))
    back = interop.integer_ciphertext_from_numpy(_limbs(got), got.level, None, "cpu")
    _assert_equal(back, got)


@pytest.mark.parametrize("name", ["bfv_tiny", "bfv_ci"])
def test_mul_tables_match_reference(name):
    """The aux basis, its constants and the three conversions' K3 tables ==
    the reference's BFVMulTables (canonical values)."""
    params, rparams = preset(name), ref_preset(name)
    level = params.num_limbs
    auxp, aux_ctx, tabs = pbfv.make_bfv_mul_context(params, level, device="cpu")
    rauxp, _, rtabs = rbfv.make_bfv_mul_context(rparams, level)
    assert auxp.q_primes == rauxp.q_primes and aux_ctx.primes == rauxp.q_primes
    assert tabs.m_sk == rauxp.q_primes[-1]
    assert (tabs.q2aux.conv.numpy() == np.asarray(rtabs.q2aux_conv_plain)).all()
    assert (tabs.b2q.conv.numpy() == np.asarray(rtabs.b2q_conv_plain)).all()
    assert (tabs.b2msk.conv.numpy() == np.asarray(rtabs.b2msk_conv_plain)).all()
    assert (tabs.msk_mod_q.numpy()[:, 0] == np.asarray(rtabs.msk_mod_q)).all()
    for tb in (tabs.q2aux, tabs.b2q, tabs.b2msk):
        assert tb.k3_refusal is None


@pytest.mark.parametrize("alpha", ["zero", "below", "at", "above", "top"])
def test_sk_conversion_centred_lift_at_its_boundary(alpha):
    """y over B and m_sk built so that the overflow count alpha is 0,
    m_sk // 2 - 1, m_sk // 2 (kept), m_sk // 2 + 1 (lifted to alpha - m_sk)
    or m_sk - 1: == the golden _sk_convert_to_q."""
    params = preset("bfv_tiny")
    level = params.num_limbs
    auxp, _, tabs = pbfv.make_bfv_mul_context(params, level, device="cpu")
    aux = auxp.q_primes
    m_sk = aux[-1]
    target = {"zero": 0, "below": m_sk // 2 - 1, "at": m_sk // 2, "above": m_sk // 2 + 1,
              "top": m_sk - 1}[alpha]
    rng = np.random.default_rng(8)
    y = np.stack([rng.integers(0, p, size=params.n) for p in aux])
    conv_sk = pbfv.base_convert(torch.from_numpy(y[:-1]), tabs.b2msk)[0].numpy()
    big_b = math.prod(aux[:-1])
    y[-1] = (conv_sk - target * (big_b % m_sk)) % m_sk  # then alpha = target
    ctx = make_context(params, device="cpu")
    got = pbfv.sk_convert_to_q(torch.from_numpy(y), tabs, ctx.col("q", range(level))).numpy()
    assert (got == rgbfv._sk_convert_to_q(y, aux, params.q_primes[:level])).all()


def test_key_switch_tables_are_cached_per_scheme():
    """make_ks_context keys on params: a BFV chain's CKKS view and the BGV
    reading of the same primes get different ModDown tables, the same ModUp;
    the drop tables key on t, [-t^-1]_{q_l} 0 for the CKKS view."""
    params = preset("bfv_ci")
    plain = prns.make_ks_context(gbfv._ckks_view(params), 6, device="cpu")
    folded = prns.make_ks_context(params, 6, device="cpu")
    assert plain is not folded and not torch.equal(plain.p2q.conv, folded.p2q.conv)
    assert torch.equal(plain.modup[0].conv, folded.modup[0].conv)
    tabs = [rescale_cuda.drop_tables(params.q_primes[:6], 1, p.plain_modulus, "cpu")[0]
            for p in (gbfv._ckks_view(params), params)]
    assert tabs[0] is not tabs[1]
    negtinv = [int(tab[1]) for tab in tabs]  # the header's second word
    assert negtinv[0] == 0 and negtinv[1] != 0
