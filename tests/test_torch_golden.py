"""The port's golden model (gpufhe_tpu_torch/golden/*) against the reference's
(gpufhe_tpu/golden/*), limb for limb (`==`), from the same seeds:

- every function of arithmetic (30- and 60-bit moduli), ntt (the native and
  the numpy path, the 60-bit prime, the O(N^2) definition and the
  schoolbook product) and rns;
- keygen without ctx, the relinearisation, Galois, conjugation and
  encapsulation keys, CKKS and BGV, against the reference's keygen; and
  with ctx (on the CPU) equal to without;
- every CKKS op at tiny2 and ci_small, every BGV op at bgv_tiny and bgv_ci,
  every BFV op (the switches too) at bfv_tiny and bfv_ci;
- vectors.GENERATORS regenerated in memory against all six files of
  tests/vectors, and write_all into a temporary directory (tests/vectors
  untouched);
- the smoke's golden_vectors phase (chip_smoke.golden_vector_run) on the
  CPU: the port's device path reproduces the five device-reachable files.
"""

import hashlib

import numpy as np
import pytest
import torch

from gpufhe_tpu.golden import arithmetic as rga
from gpufhe_tpu.golden import bfv as rgbfv
from gpufhe_tpu.golden import bgv as rgbgv
from gpufhe_tpu.golden import ckks as rgckks
from gpufhe_tpu.golden import ntt as rgn
from gpufhe_tpu.golden import rns as rgrns
from gpufhe_tpu.golden import vectors as rgv
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch.golden import arithmetic as ga
from gpufhe_tpu_torch.golden import bfv as gbfv
from gpufhe_tpu_torch.golden import bgv as gbgv
from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.golden import native
from gpufhe_tpu_torch.golden import ntt as gn
from gpufhe_tpu_torch.golden import rns as grns
from gpufhe_tpu_torch.golden import vectors as gv
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import preset

Q30 = 1073479681  # a 30-bit prime, 1 mod 2^9
Q60 = rgv._find_prime_60bit(2 * 256)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's PyTorch CPU work: its tensors are
    small (N <= 2^10), and tier-1 runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=["native", "numpy"])
def ntt_path(request, monkeypatch):
    """The golden NTT's two paths: the C library, and numpy where none loads."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    else:
        assert native.get_lib() is not None, "no C compiler: the native path cannot load"
    return request.param


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert (got.astype(object) == want.astype(object)).all()


def _same_ct(got, want):
    assert got.level == want.level and len(got.c) == len(want.c)
    for name in ("scale", "pt_factor"):
        assert getattr(got, name, None) == getattr(want, name, None)
    for g, w in zip(got.c, want.c):
        assert g.dtype == np.int64
        _same(g, w)


def _same_key(got, want):
    _same(gckks.host_limbs(got.b), want.b)
    _same(gckks.host_limbs(got.a), want.a)


# --- arithmetic -------------------------------------------------------------


@pytest.mark.parametrize("q", [97, Q30, Q60], ids=["q7", "q30", "q60"])
def test_arithmetic_matches_reference(q):
    rng = np.random.default_rng(q % 1000)
    a = [int(v) for v in rng.integers(0, min(q, 1 << 62), size=64)]
    b = [int(v) % q for v in rng.integers(0, 1 << 62, size=64)]
    a[0], b[0], b[1] = q - 1, q - 1, 0
    for name in ("vec_add", "vec_sub", "vec_mul"):
        got, want = getattr(ga, name)(a, b, q), getattr(rga, name)(a, b, q)
        assert got.dtype == want.dtype
        _same(got, want)
    pairs = (np.array(a), np.array(b)), (np.array(b), np.array(a))
    for name in ("poly_add", "poly_sub"):
        for g, w in zip(getattr(ga, name)(*pairs, q), getattr(rga, name)(*pairs, q)):
            _same(g, w)


def test_montgomery_matches_reference():
    for q in (97, Q30, (1 << 31) - 1):
        assert ga.mont_constants(q) == rga.mont_constants(q)
        qinv_neg, _ = ga.mont_constants(q)
        rng = np.random.default_rng(q % 1000)
        a = rng.integers(0, 1 << 32, size=256, dtype=np.uint64)
        b = rng.integers(0, q, size=256, dtype=np.uint64)
        _same(ga.mont_mul(a, b, q, qinv_neg), rga.mont_mul(a, b, q, qinv_neg))
        x = rng.integers(0, q, size=256)
        _same(ga.to_mont(x, q), rga.to_mont(x, q))
        _same(ga.from_mont(x, q), rga.from_mont(x, q))
        _same(ga.from_mont(ga.to_mont(x, q), q), x)
    assert (ga.R, ga.R_BITS, ga.R_MASK) == (rga.R, rga.R_BITS, rga.R_MASK)
    with pytest.raises(ValueError):
        ga.mont_constants(1 << 31)


# --- ntt --------------------------------------------------------------------


@pytest.mark.parametrize("q", [Q30, Q60], ids=["q30", "q60"])
def test_ntt_matches_reference(q, ntt_path):
    n = 256
    psi = gn.find_primitive_root_2n(q, 2 * n)
    assert psi == rgn.find_primitive_root_2n(q, 2 * n)
    x = np.random.default_rng(5).integers(0, 1 << 62, size=(3, n)) % q
    fwd = gn.ntt_fwd(x, q, psi)
    _same(fwd, rgn.ntt_fwd(x, q, psi))
    _same(gn.ntt_inv(fwd, q, psi), x)
    _same(gn.ntt_inv(x, q, psi), rgn.ntt_inv(x, q, psi))
    # the numpy path keeps Python integers at and above 2^31, as the reference's
    assert fwd.dtype == (object if (q >= 1 << 31 and ntt_path == "numpy") else np.int64)


@pytest.mark.parametrize("q", [97, Q60], ids=["q7", "q60"])
def test_ntt_definition_and_schoolbook_product(q):
    n = 16
    psi = gn.find_primitive_root_2n(q, 2 * n)
    rng = np.random.default_rng(3)
    x, y = (rng.integers(0, 1 << 62, size=n) % q for _ in range(2))
    naive = gn.ntt_naive(x, q, psi)
    _same(naive, rgn.ntt_naive(x, q, psi))
    _same(naive, gn.ntt_fwd(x, q, psi))
    prod = gn.negacyclic_mul(x, y, q)
    _same(prod, rgn.negacyclic_mul(x, y, q))
    pointwise = [int(a) * int(b) % q for a, b in zip(gn.ntt_fwd(x, q, psi), gn.ntt_fwd(y, q, psi))]
    _same(gn.ntt_inv(np.array(pointwise, dtype=object), q, psi), prod)


def test_prime_helpers_match_reference():
    for v in (2, 3, 97, 561, Q30, Q60, Q60 + 2, (1 << 61) - 1):
        assert gn.is_prime(v) == rgn.is_prime(v)
    assert gv._find_prime_60bit(2 * 4096) == rgv._find_prime_60bit(2 * 4096)


def test_native_library_is_built_from_the_port_source():
    assert native.get_lib() is not None
    assert native.lib_path().parent.name == "build"
    assert native.lib_path().parent.parent == gn.native._SOURCE.parent
    assert native.ntt_u64(np.zeros((1, 8), dtype=np.int64), 1 << 62, 3, False) is None


# --- rns --------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tiny2", "ci_small"])
def test_rns_matches_reference(name):
    params = preset(name)
    qs, ps = params.q_primes, params.p_primes
    rng = np.random.default_rng(11)
    x = np.stack([rng.integers(0, q, size=params.n) for q in qs + ps])
    _same(grns.conv_matrix(qs, ps), rgrns.conv_matrix(qs, ps))
    _same(grns.qhat_inv(qs), rgrns.qhat_inv(qs))
    _same(grns.base_convert(x[: len(qs)], qs, ps), rgrns.base_convert(x[: len(qs)], qs, ps))
    _same(grns.center_reduce(x[-1], ps[-1], qs), rgrns.center_reduce(x[-1], ps[-1], qs))
    _same(grns.rescale_coeff(x[: len(qs)], qs), rgrns.rescale_coeff(x[: len(qs)], qs))
    _same(grns.mod_down_coeff(x, qs, ps), rgrns.mod_down_coeff(x, qs, ps))


# --- keys -------------------------------------------------------------------


def _keys(mod, params, seed, *, ctx=None, steps=(1,), conj=True):
    """sk, pk, rlk, Galois keys, conj key drawn in one rng's order."""
    rng = np.random.default_rng(seed)
    kw = {} if ctx is None else {"ctx": ctx}
    sk, pk = mod.keygen(params, rng, **kw)
    rlk = mod.make_relin_key(params, sk, rng, **kw)
    gks = {s: mod.make_galois_key(params, s, sk, rng, **kw) for s in steps}
    ck = mod.make_conj_key(params, sk, rng, **kw) if conj else None
    return sk, pk, rlk, gks, ck


@pytest.mark.parametrize("name", ["tiny2", "ci_small", "boot_dw_ci_enc"])
def test_ckks_keygen_without_ctx_matches_reference(name):
    params, rparams = preset(name), ref_preset(name)
    got = _keys(gckks, params, 5)
    want = _keys(rgckks, rparams, 5)
    _same(got[0].s, want[0].s)
    _same(got[1].b, want[1].b)
    _same(got[1].a, want[1].a)
    assert isinstance(got[1].b, np.ndarray) and isinstance(got[2].b, np.ndarray)
    for g, w in zip((got[2], got[3][1], got[4]), (want[2], want[3][1], want[4])):
        _same_key(g, w)
    # the encapsulation keys' form: make_kskey with a target function
    rng, rrng = np.random.default_rng(6), np.random.default_rng(6)
    s_eph = gckks.sample_sparse_ternary(rng, params.n, 8)
    assert (s_eph == rgckks.sample_sparse_ternary(rrng, rparams.n, 8)).all()
    qp = params.q_primes + params.p_primes
    target = gckks.ntt_limbs(gckks.small_to_rns(got[0].s, qp), params, qp)
    _same_key(gckks.make_kskey(params, lambda primes: target, gckks.SecretKey(s_eph), rng),
              rgckks.make_kskey(rparams, lambda primes: target, rgckks.SecretKey(s_eph), rrng))


@pytest.mark.parametrize("name", ["tiny2", "bgv_tiny"])
def test_keygen_with_ctx_equals_without(name):
    """The device path's keys (ctx on the CPU: the port's NTT and modular
    ops) equal the golden ones from the same seed."""
    params = preset(name)
    mod = gbgv if params.plain_modulus else gckks
    ctx = make_context(params, device="cpu")
    conj = mod is gckks
    host = _keys(mod, params, 9, conj=conj)
    dev = _keys(mod, params, 9, ctx=ctx, conj=conj)
    assert isinstance(dev[1].b, torch.Tensor) and isinstance(dev[2].a, torch.Tensor)
    _same(dev[1].b.numpy(), host[1].b)
    _same(dev[1].a.numpy(), host[1].a)
    for d, h in zip((dev[2], dev[3][1], dev[4]), (host[2], host[3][1], host[4])):
        if h is not None:
            _same(d.b.numpy(), h.b)
            _same(d.a.numpy(), h.a)


@pytest.mark.parametrize("name", ["bgv_tiny", "bgv_ci"])
def test_bgv_keygen_matches_reference(name):
    params, rparams = preset(name), ref_preset(name)
    got = _keys(gbgv, params, 4, conj=False)
    want = _keys(rgbgv, rparams, 4, conj=False)
    _same(got[0].s, want[0].s)
    _same(got[1].b, want[1].b)
    _same(got[1].a, want[1].a)
    _same_key(got[2], want[2])
    _same_key(got[3][1], want[3][1])


# --- CKKS ops ---------------------------------------------------------------


def _slots(params, rng):
    return rng.normal(size=params.slots) + 1j * rng.normal(size=params.slots)


@pytest.fixture(scope="module", params=["tiny2", "ci_small"])
def ckks(request):
    name = request.param
    params, rparams = preset(name), ref_preset(name)
    keys, rkeys = _keys(gckks, params, 21, steps=(1, 3)), _keys(rgckks, rparams, 21, steps=(1, 3))
    rng = np.random.default_rng(22)
    pts = [gckks.encode(_slots(params, rng), params.scale, params.q_primes, params.n)
           for _ in range(2)]
    cts = [gckks.encrypt(pt, params, keys[1], np.random.default_rng(23 + i), params.scale)
           for i, pt in enumerate(pts)]
    rcts = [rgckks.encrypt(pt, rparams, rkeys[1], np.random.default_rng(23 + i), params.scale)
            for i, pt in enumerate(pts)]
    return params, rparams, keys, rkeys, pts, cts, rcts


def test_ckks_encrypt_decrypt_match_reference(ckks):
    params, rparams, keys, rkeys, pts, cts, rcts = ckks
    for c, r in zip(cts, rcts):
        _same_ct(c, r)
    _same(gckks.decrypt_to_coeff(cts[0], params, keys[0]),
          rgckks.decrypt_to_coeff(rcts[0], rparams, rkeys[0]))
    assert (gckks.decrypt_decode(cts[0], params, keys[0])
            == rgckks.decrypt_decode(rcts[0], rparams, rkeys[0])).all()
    at2 = gckks.encrypt(pts[0], params, keys[1], np.random.default_rng(4), params.scale, level=2)
    _same_ct(at2, rgckks.encrypt(pts[0], rparams, rkeys[1], np.random.default_rng(4),
                                 params.scale, level=2))


def test_ckks_arithmetic_matches_reference(ckks):
    params, rparams, keys, rkeys, pts, cts, rcts = ckks
    (a, b), (ra, rb) = cts, rcts
    _same_ct(gckks.ct_add(a, b, params), rgckks.ct_add(ra, rb, rparams))
    _same_ct(gckks.ct_sub(a, b, params), rgckks.ct_sub(ra, rb, rparams))
    pt_ntt = gckks.ntt_limbs(pts[1], params, params.q_primes)
    _same_ct(gckks.ct_mul_plain(a, pt_ntt, params.scale, params),
             rgckks.ct_mul_plain(ra, pt_ntt, params.scale, rparams))
    t = gckks.ct_tensor(a, b, params)
    _same_ct(t, rgckks.ct_tensor(ra, rb, rparams))
    level = params.num_limbs
    for g, w in zip(gckks.key_switch_core(t.c[2], params, level, keys[2]),
                    rgckks.key_switch_core(t.c[2], rparams, level, rkeys[2])):
        _same(g, w)
    r = gckks.ct_relinearize(t, params, keys[2])
    _same_ct(r, rgckks.ct_relinearize(t, rparams, rkeys[2]))
    _same_ct(gckks.ct_rescale(r, params), rgckks.ct_rescale(r, rparams))
    prod = gckks.ct_mul(a, b, params, keys[2])
    _same_ct(prod, rgckks.ct_mul(ra, rb, rparams, rkeys[2]))
    _same_ct(gckks.ct_key_switch(a, params, keys[3][1]),
             rgckks.ct_key_switch(ra, rparams, rkeys[3][1]))
    with pytest.raises(ValueError):
        gckks.ct_add(a, prod, params)


def test_ckks_rotations_match_reference(ckks):
    params, rparams, keys, rkeys, pts, cts, rcts = ckks
    a, ra = cts[0], rcts[0]
    _same_ct(gckks.ct_rotate(a, 1, params, keys[3][1]), rgckks.ct_rotate(ra, 1, rparams,
                                                                         rkeys[3][1]))
    _same_ct(gckks.ct_conjugate(a, params, keys[4]), rgckks.ct_conjugate(ra, rparams, rkeys[4]))
    for g, w in zip(gckks.hoist_decompose(a, params), rgckks.hoist_decompose(ra, rparams)):
        _same(g, w)
    for g, w in zip(gckks.ct_rotate_hoisted(a, [1, 3], params, keys[3]),
                    rgckks.ct_rotate_hoisted(ra, [1, 3], rparams, rkeys[3])):
        _same_ct(g, w)


def test_ckks_diag_fan_and_mod_raise_match_reference(ckks):
    params, rparams, keys, rkeys, pts, cts, rcts = ckks
    a, ra = cts[0], rcts[0]
    qp = params.q_primes + params.p_primes
    rng = np.random.default_rng(31)
    diag = lambda: gckks.ntt_limbs(gckks.encode(_slots(params, rng), params.scale, qp,  # noqa: E731
                                                params.n), params, qp)
    sets = [{0: diag(), 1: diag(), 3: diag()}, {3: diag()}]
    for g, w in zip(gckks.ct_diag_fan(a, sets, params.scale, params, keys[3]),
                    rgckks.ct_diag_fan(ra, sets, params.scale, rparams, rkeys[3])):
        _same_ct(g, w)
    low = gckks.Ciphertext([c[: params.scale_words] for c in a.c], params.scale_words, a.scale)
    rlow = rgckks.Ciphertext([c[: params.scale_words] for c in ra.c], params.scale_words,
                             ra.scale)
    _same_ct(gckks.ct_mod_raise(low, params), rgckks.ct_mod_raise(rlow, rparams))
    assert gckks.ks_groups(params, 3) == rgckks.ks_groups(rparams, 3)
    assert gckks.gadget_factors(params) == rgckks.gadget_factors(rparams)


# --- BGV and BFV ops --------------------------------------------------------


def _integer(mod, rmod, name, seed):
    params, rparams = preset(name), ref_preset(name)
    keys = _keys(mod, params, seed, steps=(1, 2), conj=False)
    rkeys = _keys(rmod, rparams, seed, steps=(1, 2), conj=False)
    rng = np.random.default_rng(seed + 1)
    ms = [rng.integers(0, params.plain_modulus, size=params.n) for _ in range(2)]
    pts = [mod.encode(m, params) for m in ms]
    cts = [mod.encrypt(pt, params, keys[1], np.random.default_rng(seed + 2 + i))
           for i, pt in enumerate(pts)]
    rcts = [rmod.encrypt(pt, rparams, rkeys[1], np.random.default_rng(seed + 2 + i))
            for i, pt in enumerate(pts)]
    for c, r in zip(cts, rcts):
        _same_ct(c, r)
    return params, rparams, keys, rkeys, ms, pts, cts, rcts


@pytest.mark.parametrize("name", ["bgv_tiny", "bgv_ci"])
def test_bgv_ops_match_reference(name):
    params, rparams, keys, rkeys, ms, pts, (a, b), (ra, rb) = _integer(gbgv, rgbgv, name, 41)
    t = params.plain_modulus
    _same(gbgv.decrypt(a, params, keys[0]), rgbgv.decrypt(ra, rparams, rkeys[0]))
    assert (gbgv.decrypt_decode(a, params, keys[0]) == ms[0] % t).all()
    assert gbgv.noise_budget_bits(a, params, keys[0]) == rgbgv.noise_budget_bits(ra, rparams,
                                                                                 rkeys[0])
    _same_ct(gbgv.ct_add(a, b, params), rgbgv.ct_add(ra, rb, rparams))
    _same_ct(gbgv.ct_sub(a, b, params), rgbgv.ct_sub(ra, rb, rparams))
    _same_ct(gbgv.ct_mul_plain(a, pts[1], params), rgbgv.ct_mul_plain(ra, pts[1], rparams))
    tens = gbgv.ct_tensor(a, b, params)
    _same_ct(tens, rgbgv.ct_tensor(ra, rb, rparams))
    level = params.num_limbs
    qs = params.q_primes
    raised = gckks.intt_limbs(gckks.ntt_limbs(np.concatenate([a.c[0], a.c[0][:2]]), params,
                                              qs + params.p_primes), params, qs + params.p_primes)
    _same(gbgv.mod_down_coeff_bgv(raised, params, qs), rgbgv.mod_down_coeff_bgv(raised, rparams,
                                                                               qs))
    for g, w in zip(gbgv.key_switch_core_bgv(tens.c[2], params, level, keys[2]),
                    rgbgv.key_switch_core_bgv(tens.c[2], rparams, level, rkeys[2])):
        _same(g, w)
    relin = gbgv.ct_relinearize(tens, params, keys[2])
    _same_ct(relin, rgbgv.ct_relinearize(tens, rparams, rkeys[2]))
    _same(gbgv.modswitch_coeff(a.c[0], params, qs), rgbgv.modswitch_coeff(a.c[0], rparams, qs))
    _same_ct(gbgv.ct_modswitch(relin, params), rgbgv.ct_modswitch(relin, rparams))
    prod = gbgv.ct_mul(a, b, params, keys[2])
    _same_ct(prod, rgbgv.ct_mul(ra, rb, rparams, rkeys[2]))
    assert (gbgv.decrypt_decode(prod, params, keys[0]) == ms[0] * ms[1] % t).all()
    _same_ct(gbgv.ct_rotate(a, 1, params, keys[3][1]), rgbgv.ct_rotate(ra, 1, rparams,
                                                                       rkeys[3][1]))
    for g, w in zip(gbgv.ct_rotate_hoisted(a, [1, 2], params, keys[3]),
                    rgbgv.ct_rotate_hoisted(ra, [1, 2], rparams, rkeys[3])):
        _same_ct(g, w)
    _same(gbgv.slot_orbit_rings(params), rgbgv.slot_orbit_rings(rparams))
    _same(gbgv.slot_rotation_perm(params, 2), rgbgv.slot_rotation_perm(rparams, 2))


@pytest.mark.parametrize("name", ["bfv_tiny", "bfv_ci"])
def test_bfv_ops_match_reference(name):
    params, rparams, keys, rkeys, ms, pts, (a, b), (ra, rb) = _integer(gbfv, rgbfv, name, 51)
    t = params.plain_modulus
    _same(gbfv.decrypt(a, params, keys[0]), rgbfv.decrypt(ra, rparams, rkeys[0]))
    assert gbfv.noise_budget_bits(a, params, keys[0]) == rgbfv.noise_budget_bits(ra, rparams,
                                                                                 rkeys[0])
    _same_ct(gbfv.ct_add(a, b, params), rgbfv.ct_add(ra, rb, rparams))
    _same_ct(gbfv.ct_sub(a, b, params), rgbfv.ct_sub(ra, rb, rparams))
    _same_ct(gbfv.ct_mul_plain(a, pts[1], params), rgbfv.ct_mul_plain(ra, pts[1], rparams))
    _same_ct(gbfv.ct_add_plain(a, pts[1], params), rgbfv.ct_add_plain(ra, pts[1], rparams))
    assert gbfv.bfv_aux_params(params).q_primes == rgbfv.bfv_aux_params(rparams).q_primes
    tens = gbfv.ct_tensor(a, b, params)
    _same_ct(tens, rgbfv.ct_tensor(ra, rb, rparams))
    aux = gbfv.bfv_aux_params(params).q_primes
    y = np.stack([np.random.default_rng(i).integers(0, p, size=params.n) for i, p in
                  enumerate(aux)])
    _same(gbfv._sk_convert_to_q(y, aux, params.q_primes),
          rgbfv._sk_convert_to_q(y, aux, params.q_primes))
    _same_ct(gbfv.ct_relinearize(tens, params, keys[2]),
             rgbfv.ct_relinearize(tens, rparams, rkeys[2]))
    prod = gbfv.ct_mul(a, b, params, keys[2])
    _same_ct(prod, rgbfv.ct_mul(ra, rb, rparams, rkeys[2]))
    assert (gbfv.decrypt_decode(prod, params, keys[0]) == ms[0] * ms[1] % t).all()
    _same_ct(gbfv.ct_mod_reduce(prod, params), rgbfv.ct_mod_reduce(prod, rparams))
    _same_ct(gbfv.ct_rotate(a, 1, params, keys[3][1]), rgbfv.ct_rotate(ra, 1, rparams,
                                                                       rkeys[3][1]))
    for g, w in zip(gbfv.ct_rotate_hoisted(a, [1, 2], params, keys[3]),
                    rgbfv.ct_rotate_hoisted(ra, [1, 2], rparams, rkeys[3])):
        _same_ct(g, w)
    back = gbfv.bfv_to_bgv(a, params)
    _same_ct(back, rgbfv.bfv_to_bgv(ra, rparams))
    sw, factor = gbfv.bgv_to_bfv(back, params)
    rsw, rfactor = rgbfv.bgv_to_bfv(rgbfv.bfv_to_bgv(ra, rparams), rparams)
    _same_ct(sw, rsw)
    assert factor == rfactor
    _same(gbfv._scalar_mul_rns(a.c[0], 12345, params.q_primes),
          rgbfv._scalar_mul_rns(a.c[0], 12345, params.q_primes))


# --- the known-answer vectors -------------------------------------------------


def _digests(paths) -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in paths}


@pytest.mark.parametrize("name", list(rgv.GENERATORS))
def test_vector_regenerated_in_memory_equals_file(name):
    assert list(gv.GENERATORS) == list(rgv.GENERATORS)
    assert gv.VEC_DIR == rgv.VEC_DIR
    got = gv.GENERATORS[name]()
    want = np.load(gv.VEC_DIR / f"{name}.npz")
    assert sorted(got) == sorted(want.files)
    for key in want.files:
        g = np.asarray(got[key])
        assert g.dtype == want[key].dtype and g.shape == want[key].shape, key
        assert (g == want[key]).all(), key


def test_write_all_into_a_temporary_directory(tmp_path):
    """write_all writes the six files where it is told; the checked-in
    tests/vectors stay as they are."""
    before = _digests(sorted(gv.VEC_DIR.glob("*.npz")))
    paths = gv.write_all(tmp_path)
    assert [p.parent for p in paths] == [tmp_path] * 6
    assert _digests(sorted(gv.VEC_DIR.glob("*.npz"))) == before
    for p in paths:
        got, want = np.load(p), np.load(gv.VEC_DIR / p.name)
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert (got[key] == want[key]).all(), (p.name, key)


@pytest.mark.parametrize("name", ["config2_rns", "config3_ckks", "config4_rotations",
                                  "bgv_integer", "bfv_integer"])
def test_smoke_golden_vectors_on_the_cpu(name):
    """chip_smoke.py's golden_vectors phase, run here on the CPU: the port's
    device path (its plain kernels here) reproduces each file."""
    import chip_smoke

    counts = chip_smoke.golden_vector_run(name, "cpu")
    assert counts["arrays"] > 0 and counts["limbs"] > 0
