"""Golden RNS-BGV pipeline in numpy: exact integer arithmetic mod t
(counterpart of gpufhe_tpu/golden/bgv.py).

It reuses the CKKS golden machinery (golden/ckks.py: limb NTTs, the RNS
conversions, the hybrid key switch); what is BGV's own:

  * encode / decode: slots are integers mod the plaintext modulus t (prime,
    t = 1 mod 2N) packed by the exact negacyclic NTT mod t, which BFV
    shares;
  * errors enter times t (c0 + c1 s = m + t e mod Q), so decryption is a
    centred reduction mod t; the keys are CKKS's with every error drawn
    times t, in the reference's draw order;
  * ModSwitch (the rescale's analogue) and the key switch's ModDown divide
    by q_last and P with a correction delta = 0 (mod t), which keeps the
    slots up to the tracked factor q_last^{-1} mod t.

Ciphertexts track `pt_factor`, the product of the dropped q_last mod t;
decryption multiplies by it. As in golden/ckks.py, the ops and keygen
without `ctx` are numpy only; with `ctx`, keygen computes the same keys on
ctx's device (ciphertext/bgv.py keygen).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.golden import ntt as gn
from gpufhe_tpu_torch.golden import rns as grns
from gpufhe_tpu_torch.params.params import CKKSParams

# ---------------------------------------------------------------------------
# Plaintext packing: negacyclic NTT mod t
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _psi_t(params: CKKSParams) -> int:
    t = params.plain_modulus
    if not t or (t - 1) % (2 * params.n):
        raise ValueError("the integer schemes need a prime t = 1 mod 2N")
    return gn.find_primitive_root_2n(t, 2 * params.n)


def encode(slots: np.ndarray, params: CKKSParams) -> np.ndarray:
    """int slots[N] mod t -> plaintext coefficients int64[N] mod t."""
    t = params.plain_modulus
    slots = np.asarray(slots, dtype=np.int64) % t
    if slots.shape != (params.n,):
        raise ValueError(f"expected {params.n} slots, got shape {slots.shape}")
    return gn.ntt_inv(slots, t, _psi_t(params))


def decode(pt_coeff: np.ndarray, params: CKKSParams) -> np.ndarray:
    t = params.plain_modulus
    return gn.ntt_fwd(np.asarray(pt_coeff, dtype=np.int64) % t, t, _psi_t(params))


def slot_rotation_perm(params: CKKSParams, steps: int) -> np.ndarray:
    """Slot permutation realised by the 5^steps automorphism:
    rotated[j] = original[perm[j]]."""
    t = params.plain_modulus
    g = gckks.galois_exponent(steps, params.n)
    e = encode(np.arange(params.n) % t, params)
    return decode(gckks.apply_automorphism_coeff(e, g) % t, params)


@functools.lru_cache(maxsize=None)
def slot_orbit_rings(params: CKKSParams) -> np.ndarray:
    """Orbit ordering of the N integer slots: int64[2, N/2].

    rings[r, k] is the raw slot index at position k of ring r; rotation by
    one step maps position k -> k-1 cyclically within each ring, so in orbit
    order a rotation by s is a plain left-rotation of both rings (the
    semantics of the BSGS linear algebra, ciphertext/linalg.py). Read from
    slot_rotation_perm's two cycles."""
    n = params.n
    perm = slot_rotation_perm(params, 1)
    seen = np.zeros(n, dtype=bool)
    rings = []
    for start in range(n):
        if seen[start]:
            continue
        cyc, j = [], start
        while not seen[j]:
            seen[j] = True
            cyc.append(j)
            j = int(perm[j])
        rings.append(cyc)
    if len(rings) != 2 or any(len(r) != n // 2 for r in rings):
        raise ValueError(f"expected two N/2 slot orbits, got {[len(r) for r in rings]}")
    out = np.array(rings, dtype=np.int64)
    out.flags.writeable = False
    return out


# ---------------------------------------------------------------------------
# Ciphertexts and keys (errors times t)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BGVCiphertext:
    c: list  # NTT-domain int64[K, N] components
    level: int
    pt_factor: int  # product of the dropped q_last mod t (undone at decrypt)

    def primes(self, params):
        return params.q_primes[: self.level]


def keygen(params: CKKSParams, rng: np.random.Generator, *, ctx=None):
    """BGV secret and public key, b = -a s + t e (NTT domain); with ctx the
    same values as tensors on ctx's device."""
    return gckks.keygen(params, rng, ctx=ctx, err_factor=params.plain_modulus)


def make_relin_key(params: CKKSParams, sk, rng, *, ctx=None) -> gckks.KSKey:
    """Gadget rows b_d = -a s + t e + g_d s^2 over the full QP chain."""
    return gckks.make_relin_key(params, sk, rng, ctx=ctx, err_factor=params.plain_modulus)


def make_galois_key(params: CKKSParams, steps: int, sk, rng, *, ctx=None) -> gckks.KSKey:
    """Gadget rows b_d = -a s + t e + g_d sigma_g(s) for the rotation by `steps`."""
    return gckks.make_galois_key(params, steps, sk, rng, ctx=ctx,
                                 err_factor=params.plain_modulus)


# ---------------------------------------------------------------------------
# Encrypt / decrypt
# ---------------------------------------------------------------------------


def _plain_rns(pt_coeff, primes) -> np.ndarray:
    """Integer plaintext coefficients reduced into each prime: int64[K, N]."""
    return np.stack([np.asarray(pt_coeff, dtype=np.int64) % q for q in primes])


def encrypt(pt_coeff: np.ndarray, params: CKKSParams, pk, rng,
            level: int | None = None) -> BGVCiphertext:
    t = params.plain_modulus
    level = level if level is not None else params.num_limbs
    primes = params.q_primes[:level]
    n = params.n
    v = gckks.ntt_limbs(gckks.small_to_rns(gckks.sample_ternary(rng, n), primes), params, primes)
    e0 = gckks.small_to_rns(t * gckks.sample_gauss(rng, n, params.sigma), primes)
    e1 = gckks.ntt_limbs(gckks.small_to_rns(t * gckks.sample_gauss(rng, n, params.sigma),
                                            primes), params, primes)
    m_ntt = gckks.ntt_limbs(gckks.poly_add(_plain_rns(pt_coeff, primes), e0, primes), params,
                            primes)
    c0 = gckks.poly_add(gckks.poly_mul(gckks.host_limbs(pk.b[:level]), v, primes), m_ntt,
                        primes)
    c1 = gckks.poly_add(gckks.poly_mul(gckks.host_limbs(pk.a[:level]), v, primes), e1, primes)
    return BGVCiphertext(c=[c0, c1], level=level, pt_factor=1)


def decrypt(ct: BGVCiphertext, params: CKKSParams, sk) -> np.ndarray:
    """-> int64[N] plaintext coefficients mod t (pt_factor undone)."""
    t = params.plain_modulus
    primes = ct.primes(params)
    centered = gckks.crt_compose_centered(gckks.inner_product_coeff(ct, params, sk.s), primes)
    return (centered % t * ct.pt_factor % t).astype(np.int64)


def decrypt_decode(ct, params, sk):
    return decode(decrypt(ct, params, sk), params)


def noise_budget_bits(ct, params: CKKSParams, sk) -> float:
    """log2(Q / (2*|m + t*e|_inf)): bits of headroom before t*e wraps Q.

    Decryption fails once the centred inner product |m + t*e| reaches Q/2.
    `ct` is any BGV ciphertext (the device one, its components on any
    device, or numpy limbs)."""
    primes = params.q_primes[: ct.level]
    centered = gckks.crt_compose_centered(gckks.inner_product_coeff(ct, params, sk.s), primes)
    big_q = math.prod(primes)
    worst = max(abs(int(x)) for x in centered)
    return math.log2(big_q / (2 * worst)) if worst else float("inf")


# ---------------------------------------------------------------------------
# Homomorphic ops
# ---------------------------------------------------------------------------


def _same_level_and_factor(a: BGVCiphertext, b: BGVCiphertext) -> None:
    if a.level != b.level or a.pt_factor != b.pt_factor:
        raise ValueError(f"operands differ: levels {a.level}, {b.level}; pt_factors "
                         f"{a.pt_factor}, {b.pt_factor}")


def ct_add(a: BGVCiphertext, b: BGVCiphertext, params) -> BGVCiphertext:
    _same_level_and_factor(a, b)
    primes = a.primes(params)
    return BGVCiphertext([gckks.poly_add(x, y, primes) for x, y in zip(a.c, b.c)], a.level,
                         a.pt_factor)


def ct_sub(a: BGVCiphertext, b: BGVCiphertext, params) -> BGVCiphertext:
    _same_level_and_factor(a, b)
    primes = a.primes(params)
    return BGVCiphertext([gckks.poly_sub(x, y, primes) for x, y in zip(a.c, b.c)], a.level,
                         a.pt_factor)


def ct_mul_plain(ct: BGVCiphertext, pt_coeff: np.ndarray, params) -> BGVCiphertext:
    primes = ct.primes(params)
    pt_ntt = gckks.ntt_limbs(_plain_rns(pt_coeff, primes), params, primes)
    return BGVCiphertext([gckks.poly_mul(x, pt_ntt, primes) for x in ct.c], ct.level,
                         ct.pt_factor)


def ct_tensor(a: BGVCiphertext, b: BGVCiphertext, params) -> BGVCiphertext:
    if a.level != b.level:
        raise ValueError(f"operands at levels {a.level} and {b.level}")
    return BGVCiphertext(gckks._tensor(a.c, b.c, a.primes(params)), a.level,
                         a.pt_factor * b.pt_factor % params.plain_modulus)


def mod_down_coeff_bgv(x: np.ndarray, params: CKKSParams,
                       q_primes: tuple[int, ...]) -> np.ndarray:
    """t-corrected division by P: delta = t [x t^{-1}]_P, out = (x - delta) / P."""
    t = params.plain_modulus
    p_primes = params.p_primes
    k = len(q_primes)
    big_p = math.prod(p_primes)
    p_arr = np.array(p_primes, dtype=np.int64)[:, None]
    tinv = np.array([pow(t, -1, p) for p in p_primes], dtype=np.int64)[:, None]
    conv = grns.base_convert(x[k:] * tinv % p_arr, p_primes, q_primes)  # [x t^{-1}]_P -> Q
    out = np.empty((k, x.shape[1]), dtype=np.int64)
    for i, q in enumerate(q_primes):
        out[i] = (x[i] - t * conv[i]) % q * pow(big_p, -1, q) % q
    return out


def key_switch_core_bgv(d2, params, level, ksk):
    """CKKS's key_switch_core with the t-corrected ModDown."""
    d2_coeff = gckks.intt_limbs(d2, params, params.q_primes[:level])
    return gckks._switch(gckks._raise(d2_coeff, params, level), None, params, level, ksk,
                         mod_down_coeff_bgv)


def ct_relinearize(ct: BGVCiphertext, params, rlk) -> BGVCiphertext:
    if len(ct.c) != 3:
        raise ValueError("relinearisation takes a three-component ciphertext")
    primes = ct.primes(params)
    ks0, ks1 = key_switch_core_bgv(ct.c[2], params, ct.level, rlk)
    return BGVCiphertext([gckks.poly_add(ct.c[0], ks0, primes),
                          gckks.poly_add(ct.c[1], ks1, primes)], ct.level, ct.pt_factor)


def modswitch_coeff(x: np.ndarray, params, primes: tuple[int, ...]) -> np.ndarray:
    """Drop q_last with delta = 0 mod t: out = (x + t [-x t^{-1}]_qlast) / qlast."""
    t = params.plain_modulus
    q_last = primes[-1]
    u = (-x[-1]) % q_last * pow(t, -1, q_last) % q_last
    lifted = grns.center_reduce(u, q_last, primes[:-1])
    out = np.empty((len(primes) - 1, x.shape[1]), dtype=np.int64)
    for i, q in enumerate(primes[:-1]):
        out[i] = (x[i] + t * lifted[i]) % q * pow(q_last, -1, q) % q
    return out


def ct_modswitch(ct: BGVCiphertext, params) -> BGVCiphertext:
    t = params.plain_modulus
    primes = ct.primes(params)
    new = [gckks.ntt_limbs(modswitch_coeff(gckks.intt_limbs(comp, params, primes), params,
                                           primes), params, primes[:-1]) for comp in ct.c]
    return BGVCiphertext(new, ct.level - 1, ct.pt_factor * (primes[-1] % t) % t)


def ct_mul(a: BGVCiphertext, b: BGVCiphertext, params, rlk) -> BGVCiphertext:
    return ct_modswitch(ct_relinearize(ct_tensor(a, b, params), params, rlk), params)


def ct_rotate(ct: BGVCiphertext, steps: int, params, gk) -> BGVCiphertext:
    gckks._two_components(ct)
    primes = ct.primes(params)
    perm = gckks.automorphism_perm_eval(gckks.galois_exponent(steps, params.n), params.n)
    ks0, ks1 = key_switch_core_bgv(ct.c[1][:, perm], params, ct.level, gk)
    return BGVCiphertext([gckks.poly_add(ct.c[0][:, perm], ks0, primes), ks1], ct.level,
                         ct.pt_factor)


def _hoisted_key_switch_bgv(raised, perm, params, level, ksk):
    """golden/ckks.py _hoisted_key_switch with the t-corrected ModDown."""
    return gckks._switch(raised, perm, params, level, ksk, mod_down_coeff_bgv)


def ct_rotate_hoisted(ct: BGVCiphertext, steps_list, params, gks: dict) -> list:
    """Rotate by many step counts sharing one gadget decomposition (the
    decomposition is scheme-agnostic; the scheme enters at the t-corrected
    ModDown). gks maps steps -> KSKey."""
    return gckks._rotate_hoisted(ct, steps_list, params, gks, _hoisted_key_switch_bgv,
                                 lambda c0, c1: BGVCiphertext([c0, c1], ct.level, ct.pt_factor))
