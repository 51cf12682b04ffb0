"""Golden modular vector arithmetic, in numpy (counterpart of
gpufhe_tpu/golden/arithmetic.py).

The bit-exact semantics of the kernel layer: canonical residues in [0, MOD)
under elementwise add, sub and mul, with numpy's `%` on negative operands,
and the Montgomery product with R = 2^32 that ops/modops.py computes. A
fixed operand x is stored as x * 2^32 mod q, and mont_mul(a, x_mont) gives
a * x.

This is numpy on purpose, as the whole golden layer is: it is the
independent oracle the port's kernels and torch ops are held against, so it
reaches none of them. Products are exact at every width: int64 below 2^31
(a product then stays below 2^62), Python integers (object arrays) from
2^31 on.
"""

from __future__ import annotations

import numpy as np

_INT64_SAFE_MOD = 1 << 31  # a * b < 2^62 fits int64 iff MOD < 2^31


def _as_mod_array(x, MOD: int) -> np.ndarray:
    """x as an array of a dtype wide enough for exact arithmetic mod MOD."""
    if MOD < _INT64_SAFE_MOD:
        return np.asarray(x, dtype=np.int64)
    return np.asarray(x, dtype=object)


def _operands(a, b, MOD: int) -> tuple[np.ndarray, np.ndarray]:
    a, b = _as_mod_array(a, MOD), _as_mod_array(b, MOD)
    if a.shape != b.shape:
        raise ValueError(f"operand shapes differ: {a.shape} and {b.shape}")
    return a, b


def vec_add(a, b, MOD: int) -> np.ndarray:
    """Elementwise (a + b) % MOD, canonical residues in [0, MOD)."""
    a, b = _operands(a, b, MOD)
    return (a + b) % MOD


def vec_sub(a, b, MOD: int) -> np.ndarray:
    """Elementwise (a - b) % MOD, non-negative even where a < b."""
    a, b = _operands(a, b, MOD)
    return (a - b) % MOD


def vec_mul(a, b, MOD: int) -> np.ndarray:
    """Elementwise (a * b) % MOD, exact for any modulus."""
    a, b = _operands(a, b, MOD)
    return (a * b) % MOD


def poly_add(a, b, MOD: int):
    """Componentwise sum of two ciphertext pairs (c0, c1)."""
    return (vec_add(a[0], b[0], MOD), vec_add(a[1], b[1], MOD))


def poly_sub(a, b, MOD: int):
    """Componentwise difference of two ciphertext pairs (c0, c1)."""
    return (vec_sub(a[0], b[0], MOD), vec_sub(a[1], b[1], MOD))


# ---------------------------------------------------------------------------
# Montgomery arithmetic (the values ops/modops.py computes)
# ---------------------------------------------------------------------------

R_BITS = 32
R = 1 << R_BITS
R_MASK = R - 1


def mont_constants(q: int) -> tuple[int, int]:
    """(qinv_neg, r2) for modulus q: -q^{-1} mod 2^32 and 2^64 mod q."""
    if q % 2 == 0 or not 1 < q < (1 << 31):
        raise ValueError("Montgomery constants need an odd modulus below 2^31")
    qinv = pow(q, -1, R)
    return (R - qinv) % R, (R * R) % q


def mont_mul(a, b, q: int, qinv_neg: int) -> np.ndarray:
    """Montgomery product a * b * 2^-32 mod q in [0, q), for a in [0, 2^32)
    and b in [0, q) (REDC holds for a * b < R q)."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    t = a * b  # < 2^63, exact in uint64
    m = (t & R_MASK) * np.uint64(qinv_neg) & np.uint64(R_MASK)
    u = (t + m * np.uint64(q)) >> np.uint64(R_BITS)
    u = np.where(u >= q, u - np.uint64(q), u)
    return u.astype(np.int64)


def to_mont(x, q: int) -> np.ndarray:
    """x * 2^32 mod q."""
    qinv_neg, r2 = mont_constants(q)
    return mont_mul(x, r2, q, qinv_neg)


def from_mont(x, q: int) -> np.ndarray:
    """x * 2^-32 mod q."""
    qinv_neg, _ = mont_constants(q)
    return mont_mul(x, 1, q, qinv_neg)
