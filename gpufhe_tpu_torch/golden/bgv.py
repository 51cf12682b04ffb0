"""Host side of the integer schemes: slot packing mod t and the BGV keys.

Counterpart of the host parts of gpufhe_tpu/golden/bgv.py (encode, decode,
slot_rotation_perm, slot_orbit_rings, keygen, make_relin_key,
make_galois_key, noise_budget_bits). Slots are integers mod the plaintext modulus t (prime,
t = 1 mod 2N), packed by the exact negacyclic NTT mod t on the host
(golden/ntt.py), so BGV and BFV share this packing. BGV's keys are CKKS's
with every error drawn times t, in the reference's draw order; as in
golden/ckks.py, the draws stay on the host and the NTTs and products run on
the context's device.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.golden import ntt as gn
from gpufhe_tpu_torch.ops.context import Context
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
# Keys: errors times t
# ---------------------------------------------------------------------------


def keygen(params: CKKSParams, rng: np.random.Generator, ctx: Context):
    """BGV secret and public key, b = -a s + t e (NTT domain)."""
    return gckks.keygen(params, rng, ctx, params.plain_modulus)


def make_relin_key(params: CKKSParams, sk: gckks.SecretKey, rng: np.random.Generator,
                   ctx: Context) -> gckks.KSKey:
    """Gadget rows b_d = -a s + t e + g_d s^2 over the full QP chain."""
    return gckks.make_relin_key(params, sk, rng, ctx, params.plain_modulus)


def make_galois_key(params: CKKSParams, steps: int, sk: gckks.SecretKey,
                    rng: np.random.Generator, ctx: Context) -> gckks.KSKey:
    """Gadget rows b_d = -a s + t e + g_d sigma_g(s) for the rotation by `steps`."""
    return gckks.make_galois_key(params, steps, sk, rng, ctx, params.plain_modulus)


# ---------------------------------------------------------------------------
# Noise budget (diagnostic: reads the secret key)
# ---------------------------------------------------------------------------


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
