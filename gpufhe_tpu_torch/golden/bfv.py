"""Host side of BFV: the auxiliary basis, Delta, the rounding decode.

Counterpart of the host parts of gpufhe_tpu/golden/bfv.py (bfv_aux_params,
_ckks_view, delta_rns, round_decode_coeff, _inner_product_centered,
noise_budget_bits, and the aliases of its packing and keys). BFV keys are CKKS keys (errors not times t) and its slots are
BGV's (golden/bgv.py); the message rides the top bits, c0 + c1 s = Delta m
+ e (mod Q) with Delta = floor(Q / t), and decryption rounds t x / Q.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from gpufhe_tpu_torch.golden import bgv as gbgv
from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.golden.ntt import is_prime
from gpufhe_tpu_torch.params.params import CKKSParams, gen_ntt_primes

# plaintext packing: the exact negacyclic NTT mod t (shared with BGV)
encode = gbgv.encode
decode = gbgv.decode
slot_rotation_perm = gbgv.slot_rotation_perm
slot_orbit_rings = gbgv.slot_orbit_rings

# keys: CKKS's (errors not times t)
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
