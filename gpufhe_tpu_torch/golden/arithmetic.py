"""Host modular constants (counterpart of gpufhe_tpu/golden/arithmetic.py).

Montgomery form uses R = 2^32, as in the reference: a fixed operand x is
stored as x * 2^32 mod q, and ops/modops.mont_mul(a, x_mont) yields a * x.
"""

from __future__ import annotations

R = 1 << 32


def mont_constants(q: int) -> tuple[int, int]:
    """(qinv_neg, r2) for modulus q: -q^{-1} mod 2^32 and 2^64 mod q."""
    if q % 2 == 0 or not 1 < q < (1 << 31):
        raise ValueError("Montgomery constants need an odd modulus below 2^31")
    qinv = pow(q, -1, R)
    return (R - qinv) % R, (R * R) % q

