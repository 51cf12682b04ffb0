"""Golden RNS-BFV pipeline in numpy: scale-invariant exact integers mod t
(counterpart of gpufhe_tpu/golden/bfv.py).

BFV shares almost everything with the CKKS golden machinery:

  * its keys are CKKS's (b = -a s + e, gadget rows g_d s' + e: errors not
    times t, unlike BGV's), so keygen, make_relin_key and make_galois_key
    are golden/ckks.py's;
  * the message rides the top bits, c0 + c1 s = Delta m + e (mod Q) with
    Delta = floor(Q / t), and decryption rounds t x / Q;
  * plaintext packing is golden/bgv.py's exact negacyclic NTT mod t.

Its own part is the scale-invariant multiply (BEHZ / HPS family):

  1. extend both ciphertexts from Q to an auxiliary basis B and m_sk by the
     approximate base conversion (golden/rns.py base_convert): its +u Q
     error survives the t/Q scaling as an exact multiple of t and vanishes
     mod t; only the basis must hold the larger intermediate
     (bfv_aux_params);
  2. tensor the pair in the NTT domain over Q and over the aux basis;
  3. scale by t/Q over the aux basis: y = (t d - conv_{Q->aux}([t d]_Q)) Q^{-1},
     an exact division giving floor(t d / Q) - v with |v| <= L/2 as noise;
  4. convert back to Q exactly by Shenoy-Kumaresan: m_sk recovers the
     centred overflow count of the approximate B -> q conversion;
  5. relinearise with the plain CKKS hybrid key switch (additive noise).

Every approximation above (canonical conversions, the per-term reduction
order, the centred count) is part of the bit-exact contract with the device
path (ciphertext/bfv.py). The big-integer rounding of the decryption is
exact in Python integers. As in golden/ckks.py, the ops are numpy only.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from gpufhe_tpu_torch.golden import bgv as gbgv
from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.golden import rns as grns
from gpufhe_tpu_torch.golden.ntt import is_prime
from gpufhe_tpu_torch.params.params import CKKSParams, gen_ntt_primes

# plaintext packing: the exact negacyclic NTT mod t (shared with BGV)
encode = gbgv.encode
decode = gbgv.decode
slot_rotation_perm = gbgv.slot_rotation_perm
slot_orbit_rings = gbgv.slot_orbit_rings

# keys: CKKS's (errors not times t); each takes the keyword ctx as golden/ckks.py's
keygen = gckks.keygen
make_relin_key = gckks.make_relin_key
make_galois_key = gckks.make_galois_key


@functools.lru_cache(maxsize=None)
def bfv_aux_params(params: CKKSParams, level: int | None = None) -> CKKSParams:
    """The auxiliary basis of the scale-invariant multiply as parameters:
    q_primes = B then m_sk (last), no special primes.

    Sized so prod(B) > 2 t N L^2 Q with margin, the bound on the scaled
    tensor (Shenoy-Kumaresan needs |y| < prod(B) / 2) and on the t d
    intermediate. Primes come from the 28-, 29- and 30-bit NTT classes in
    turn, skipping those of the Q and P chains and t, until the basis is
    large enough (at N=2^16 a class holds about a hundred); every one is
    below 2^30, as the kernels need.
    """
    lvl = level if level is not None else params.num_limbs
    t = params.plain_modulus
    if t <= 1:
        raise ValueError("BFV needs plain_modulus set")
    big_q = math.prod(params.q_primes[:lvl])
    bits_needed = (math.log2(t) + math.log2(params.n) + 2.0 * math.log2(max(lvl, 2))
                   + math.log2(big_q) + 4.0)
    used = set(params.q_primes + params.p_primes) | {t}
    two_n = 2 * params.n
    cands: list[int] = []
    for bits_class in (28, 29, 30):
        try:
            got = gen_ntt_primes(bits_class, two_n, 4 * lvl + 40)
        except ValueError:  # the class holds fewer: take all of them
            got, p = [], ((1 << bits_class) - 1) // two_n * two_n + 1
            while p >= (1 << (bits_class - 1)):
                if is_prime(p):
                    got.append(p)
                p -= two_n
        cands.extend(q for q in got if q not in used)
        if sum(math.log2(q) for q in cands) >= bits_needed + 31:
            break
    k, bits = 0, 0.0
    while bits < bits_needed:
        if k >= len(cands):
            raise ValueError(f"NTT-prime classes exhausted sizing the BFV aux basis: "
                             f"{bits:.0f} of {bits_needed:.0f} bits (N={params.n}, level={lvl})")
        bits += math.log2(cands[k])
        k += 1
    if k >= len(cands):
        raise ValueError("no candidate left for the redundant modulus m_sk")
    return CKKSParams(n=params.n, q_primes=tuple(cands[: k + 1]), p_primes=(),
                      scale_bits=params.scale_bits, sigma=params.sigma, plain_modulus=t)


def _ckks_view(params: CKKSParams) -> CKKSParams:
    """params with plain_modulus cleared: BFV key switching uses the plain
    ModDown by P (additive noise), not BGV's t-corrected one."""
    return dataclasses.replace(params, plain_modulus=0)


@dataclasses.dataclass
class BFVCiphertext:
    c: list  # NTT-domain int64[K, N] components
    level: int

    def primes(self, params):
        return params.q_primes[: self.level]


def delta_rns(params: CKKSParams, level: int) -> np.ndarray:
    """Delta = floor(Q_level / t) reduced into each q_i; int64[level, 1]."""
    primes = params.q_primes[:level]
    d = math.prod(primes) // params.plain_modulus
    return np.array([d % q for q in primes], dtype=np.int64)[:, None]


def round_decode_coeff(centered, t: int, big_q: int) -> np.ndarray:
    """round(t x / Q) mod t over centered big-integer coefficients, rounding
    half up (Python's floor division does so for negative x too)."""
    return np.array([((int(x) * t * 2 + big_q) // (2 * big_q)) % t for x in centered],
                    dtype=np.int64)


def _inner_product_centered(ct, params: CKKSParams, sk):
    """(centred big-integer coefficients of c0 + sum c_i s^i, big_q)."""
    primes = params.q_primes[: ct.level]
    coeff = gckks.inner_product_coeff(ct, params, sk.s)
    return gckks.crt_compose_centered(coeff, primes), math.prod(primes)


def noise_budget_bits(ct, params: CKKSParams, sk) -> float:
    """log2(Delta / (2*|e|_inf)): bits of rounding margin left. `ct` is any
    BFV ciphertext (the device one, its components on any device, or numpy
    limbs)."""
    t = params.plain_modulus
    centered, big_q = _inner_product_centered(ct, params, sk)
    m = round_decode_coeff(centered, t, big_q)
    delta = big_q // t
    worst = 0
    for x, mm in zip(centered, m):
        e = int(x) - delta * int(mm)
        e = ((e + big_q // 2) % big_q) - big_q // 2  # centre mod Q
        worst = max(worst, abs(e))
    return math.log2(delta / (2 * worst)) if worst else float("inf")


# ---------------------------------------------------------------------------
# Encrypt / decrypt
# ---------------------------------------------------------------------------


def _delta_m(pt_coeff, params: CKKSParams, level: int) -> np.ndarray:
    """Delta m over the level's primes, int64[level, N], m the plaintext mod t."""
    primes = params.q_primes[:level]
    m = np.asarray(pt_coeff, dtype=np.int64) % params.plain_modulus
    return delta_rns(params, level) * m[None, :] % np.array(primes, np.int64)[:, None]


def encrypt(pt_coeff: np.ndarray, params: CKKSParams, pk, rng,
            level: int | None = None) -> BFVCiphertext:
    """pt_coeff: int64[N] plaintext coefficients mod t (from encode)."""
    level = level if level is not None else params.num_limbs
    primes = params.q_primes[:level]
    n = params.n
    v = gckks.ntt_limbs(gckks.small_to_rns(gckks.sample_ternary(rng, n), primes), params, primes)
    e0 = gckks.small_to_rns(gckks.sample_gauss(rng, n, params.sigma), primes)
    e1 = gckks.ntt_limbs(gckks.small_to_rns(gckks.sample_gauss(rng, n, params.sigma), primes),
                         params, primes)
    m_ntt = gckks.ntt_limbs(gckks.poly_add(_delta_m(pt_coeff, params, level), e0, primes),
                            params, primes)
    c0 = gckks.poly_add(gckks.poly_mul(gckks.host_limbs(pk.b[:level]), v, primes), m_ntt,
                        primes)
    c1 = gckks.poly_add(gckks.poly_mul(gckks.host_limbs(pk.a[:level]), v, primes), e1, primes)
    return BFVCiphertext(c=[c0, c1], level=level)


def decrypt(ct: BFVCiphertext, params: CKKSParams, sk) -> np.ndarray:
    """-> int64[N] plaintext coefficients mod t: round(t x / Q) mod t."""
    centered, big_q = _inner_product_centered(ct, params, sk)
    return round_decode_coeff(centered, params.plain_modulus, big_q)


def decrypt_decode(ct, params, sk):
    return decode(decrypt(ct, params, sk), params)


# ---------------------------------------------------------------------------
# Linear homomorphic ops
# ---------------------------------------------------------------------------


def _same_level(a: BFVCiphertext, b: BFVCiphertext) -> None:
    if a.level != b.level:
        raise ValueError(f"operands at levels {a.level} and {b.level}")


def ct_add(a: BFVCiphertext, b: BFVCiphertext, params) -> BFVCiphertext:
    _same_level(a, b)
    primes = a.primes(params)
    return BFVCiphertext([gckks.poly_add(x, y, primes) for x, y in zip(a.c, b.c)], a.level)


def ct_sub(a: BFVCiphertext, b: BFVCiphertext, params) -> BFVCiphertext:
    _same_level(a, b)
    primes = a.primes(params)
    return BFVCiphertext([gckks.poly_sub(x, y, primes) for x, y in zip(a.c, b.c)], a.level)


def ct_mul_plain(ct: BFVCiphertext, pt_coeff: np.ndarray, params) -> BFVCiphertext:
    """Multiply by an unscaled integer plaintext: Delta m m2 stays on Delta."""
    primes = ct.primes(params)
    pt_ntt = gckks.ntt_limbs(gbgv._plain_rns(pt_coeff, primes), params, primes)
    return BFVCiphertext([gckks.poly_mul(x, pt_ntt, primes) for x in ct.c], ct.level)


def ct_add_plain(ct: BFVCiphertext, pt_coeff: np.ndarray, params) -> BFVCiphertext:
    """Add a plaintext: c0 += Delta m2 (NTT domain)."""
    primes = ct.primes(params)
    dm_ntt = gckks.ntt_limbs(_delta_m(pt_coeff, params, ct.level), params, primes)
    return BFVCiphertext([gckks.poly_add(ct.c[0], dm_ntt, primes)] + list(ct.c[1:]), ct.level)


# ---------------------------------------------------------------------------
# The scale-invariant multiply
# ---------------------------------------------------------------------------


def _sk_convert_to_q(y_aux: np.ndarray, aux: tuple[int, ...],
                     q_primes: tuple[int, ...]) -> np.ndarray:
    """Shenoy-Kumaresan exact conversion from B and m_sk to Q.

    y_aux: int64[k+1, N] canonical residues over B = aux[:-1] and the
    redundant modulus m_sk = aux[-1]; valid for |y| < prod(B) / 2.
    """
    b_primes, m_sk = aux[:-1], aux[-1]
    big_b = math.prod(b_primes)
    # the overflow count of the approximate conversion, recovered mod m_sk
    conv_sk = grns.base_convert(y_aux[:-1], b_primes, (m_sk,))[0]
    alpha = (conv_sk - y_aux[-1]) % m_sk * pow(big_b, -1, m_sk) % m_sk
    alpha = np.where(alpha > m_sk // 2, alpha - m_sk, alpha)  # centred
    conv_q = grns.base_convert(y_aux[:-1], b_primes, q_primes)
    out = np.empty((len(q_primes), y_aux.shape[1]), dtype=np.int64)
    for i, q in enumerate(q_primes):
        out[i] = (conv_q[i] - alpha * (big_b % q)) % q
    return out


def ct_tensor(a: BFVCiphertext, b: BFVCiphertext, params) -> BFVCiphertext:
    """(d0, d1, d2) = round(t/Q (a x b)) over Q, the BEHZ-style multiply
    (the module docstring's steps 1-4): a three-component ciphertext."""
    _same_level(a, b)
    level = a.level
    t = params.plain_modulus
    q_primes = a.primes(params)
    auxp = bfv_aux_params(params, level)
    aux = auxp.q_primes
    big_q = math.prod(q_primes)
    q_arr = np.array(q_primes, dtype=np.int64)[:, None]

    def to_aux_ntt(comp):  # 1. Q -> aux (coefficient domain, approximate)
        conv = grns.base_convert(gckks.intt_limbs(comp, params, q_primes), q_primes, aux)
        return gckks.ntt_limbs(conv, auxp, aux)

    d_q = gckks._tensor(a.c, b.c, q_primes)  # 2. over both bases
    d_aux = gckks._tensor([to_aux_ntt(c) for c in a.c], [to_aux_ntt(c) for c in b.c], aux)
    out = []
    for dq_ntt, daux_ntt in zip(d_q, d_aux):  # 3. and 4. per component
        dq = gckks.intt_limbs(dq_ntt, params, q_primes)
        daux = gckks.intt_limbs(daux_ntt, auxp, aux)
        r_aux = grns.base_convert(dq * t % q_arr, q_primes, aux)  # [t d]_Q in the aux basis
        y = np.empty_like(daux)
        for i, p in enumerate(aux):
            y[i] = (daux[i] * t - r_aux[i]) % p * pow(big_q % p, -1, p) % p
        out.append(gckks.ntt_limbs(_sk_convert_to_q(y, aux, q_primes), params, q_primes))
    return BFVCiphertext(out, level)


def ct_relinearize(ct: BFVCiphertext, params, rlk) -> BFVCiphertext:
    """The plain CKKS hybrid key switch of the d2 component."""
    if len(ct.c) != 3:
        raise ValueError("relinearisation takes a three-component ciphertext")
    primes = ct.primes(params)
    ks0, ks1 = gckks.key_switch_core(ct.c[2], _ckks_view(params), ct.level, rlk)
    return BFVCiphertext([gckks.poly_add(ct.c[0], ks0, primes),
                          gckks.poly_add(ct.c[1], ks1, primes)], ct.level)


def ct_mul(a: BFVCiphertext, b: BFVCiphertext, params, rlk) -> BFVCiphertext:
    return ct_relinearize(ct_tensor(a, b, params), params, rlk)


def ct_mod_reduce(ct: BFVCiphertext, params) -> BFVCiphertext:
    """Drop q_last by golden/rns.py rescale_coeff's exact centred division:
    Delta shrinks to floor(Q'/t) and the plaintext gains at most |m| of
    noise (the standard BFV modulus switch)."""
    primes = ct.primes(params)
    new = [gckks.ntt_limbs(grns.rescale_coeff(gckks.intt_limbs(comp, params, primes), primes),
                           params, primes[:-1]) for comp in ct.c]
    return BFVCiphertext(new, ct.level - 1)


# ---------------------------------------------------------------------------
# Rotations (CKKS Galois keys, BGV slot semantics)
# ---------------------------------------------------------------------------


def ct_rotate(ct: BFVCiphertext, steps: int, params, gk) -> BFVCiphertext:
    gckks._two_components(ct)
    primes = ct.primes(params)
    perm = gckks.automorphism_perm_eval(gckks.galois_exponent(steps, params.n), params.n)
    ks0, ks1 = gckks.key_switch_core(ct.c[1][:, perm], _ckks_view(params), ct.level, gk)
    return BFVCiphertext([gckks.poly_add(ct.c[0][:, perm], ks0, primes), ks1], ct.level)


def ct_rotate_hoisted(ct: BFVCiphertext, steps_list, params, gks: dict) -> list:
    """Many rotations sharing one gadget decomposition (CKKS hoisting)."""
    return gckks._rotate_hoisted(ct, steps_list, _ckks_view(params), gks,
                                 gckks._hoisted_key_switch,
                                 lambda c0, c1: BFVCiphertext([c0, c1], ct.level))


# ---------------------------------------------------------------------------
# Scheme switching BGV <-> BFV: exact, noise-preserving scalar maps
# ---------------------------------------------------------------------------
#
# Both schemes share keys and the NTT-mod-t packing; their invariants differ
# by a scalar: BGV holds m + t e, BFV Delta m + e. Multiplying every
# component by [t^{-1}]_Q maps the former to (1 + kQ)/t m + e, a BFV
# ciphertext of k m with k = t t^{-1} div Q = -Q^{-1} (mod t); multiplying by
# t maps BFV to -r m + t e with r = Q mod t, a BGV ciphertext. The factors k
# and -r are tracked (BGV's pt_factor; a returned factor for BFV), not
# corrected in the ciphertext, which would scale the noise by up to t/2.


def _scalar_mul_rns(c, value: int, primes) -> np.ndarray:
    v = np.array([value % q for q in primes], dtype=np.int64)[:, None]
    return c * v % np.array(primes, dtype=np.int64)[:, None]


def bgv_to_bfv(ct, params: CKKSParams) -> tuple[BFVCiphertext, int]:
    """BGV ciphertext -> (BFV ciphertext, message factor): decrypt(out) ==
    factor * (the BGV message) mod t."""
    t = params.plain_modulus
    primes = params.q_primes[: ct.level]
    big_q = math.prod(primes)
    tinv = pow(t, -1, big_q)
    k = (t * tinv - 1) // big_q % t
    out = BFVCiphertext([_scalar_mul_rns(c, tinv, primes) for c in ct.c], ct.level)
    # the BGV message is m_raw * pt_factor; out decrypts to k * m_raw
    return out, k * pow(int(ct.pt_factor), -1, t) % t


def bfv_to_bgv(ct: BFVCiphertext, params: CKKSParams):
    """BFV ciphertext -> BGV ciphertext, its message factor folded into
    pt_factor (BGV's decrypt returns the message itself)."""
    t = params.plain_modulus
    primes = params.q_primes[: ct.level]
    r = math.prod(primes) % t
    return gbgv.BGVCiphertext([_scalar_mul_rns(c, t, primes) for c in ct.c], ct.level,
                              pow(-r % t, -1, t))
