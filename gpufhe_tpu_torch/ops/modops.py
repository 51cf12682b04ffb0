"""Elementwise modular arithmetic on int64 tensors.

Counterpart of gpufhe_tpu/ops/modops.py. The reference builds 64-bit
products from 16-bit pieces because the TPU's vector unit has no widening
multiply; here residues are int64 and every prime is below 2^30, so a
product of a 32-bit operand and a canonical residue (< 2^62) is exact in
one int64 multiply. The functions keep the reference's contracts (same
operand domains, same canonical or lazy results), so they agree with it
element for element.

`q`, `qinv_neg` and the constants broadcast against the data, typically as
[L, 1] columns against [L, N] limb planes.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def add_mod(a, b, q):
    """(a + b) mod q for a, b in [0, q)."""
    s = a + b
    return torch.where(s >= q, s - q, s)


def sub_mod(a, b, q):
    """(a - b) mod q for a, b in [0, q)."""
    d = a - b
    return torch.where(d < 0, d + q, d)


def neg_mod(a, q):
    """(-a) mod q for a in [0, q)."""
    return torch.where(a == 0, a, q - a)


def _mullo32(a, b):
    """(a * b) mod 2^32 for a, b in [0, 2^32), without leaving int64."""
    lo = a * (b & _M16)
    hi = ((a * (b >> 16)) & _M16) << 16
    return (lo + hi) & _M32


def mulhi32(a, b):
    """floor(a * b / 2^32) for a, b in [0, 2^32), without leaving int64."""
    return ((a >> 16) * b + (((a & _M16) * b) >> 16)) >> 16


def mont_mul(a, b, q, qinv_neg):
    """Montgomery product a * b * 2^-32 mod q, canonical in [0, q).

    Valid for any a in [0, 2^32) when b is in [0, q). With b in Montgomery
    form (b * 2^32 mod q) this is the plain product a * b mod q. REDC:
    t + m*q is divisible by 2^32, and its low halves sum to 0 or 2^32.
    """
    t = a * b  # < 2^32 * q < 2^62
    t_lo = t & _M32
    m = _mullo32(t_lo, qinv_neg)
    u = (t >> 32) + ((m * q) >> 32) + (t_lo != 0).to(t.dtype)
    return torch.where(u >= q, u - q, u)


def mont_mac(pairs, q, qinv_neg):
    """sum_i a_i * b_i * 2^-32 mod q, canonical — the key-switch inner product.

    The same result as the reference's paired-REDC mont_mac (and as the
    per-term mont_mul + add_mod chain): each int64 product is reduced mod q
    and summed with a conditional subtract, and one REDC (a Montgomery
    multiply by 1) applies the 2^-32 to the whole sum.
    Requirements: every a_i in [0, 2^32), every b_i in [0, q).
    """
    acc = None
    for a, b in pairs:
        term = torch.remainder(a * b, q)
        acc = term if acc is None else add_mod(acc, term, q)
    return mont_mul(acc, torch.ones_like(acc), q, qinv_neg)


def shoup_mul(a, w, w_shoup, q):
    """a * w mod q in [0, 2q) for any a in [0, 2^32) and canonical w < q.

    w_shoup = floor(w * 2^32 / q). The quotient estimate mulhi32(a, w_shoup)
    undershoots floor(a*w/q) by at most one; the lazy result equals the
    reference's element for element.
    """
    return a * w - mulhi32(a, w_shoup) * q


def shoup_np(w, q):
    """Host Shoup companions floor(w * 2^32 / q) for canonical w < q (int64)."""
    import numpy as np

    w = np.asarray(w, dtype=np.uint64)
    q = np.asarray(q, dtype=np.uint64)
    return ((w << np.uint64(32)) // q).astype(np.int64)


def mul_mod(a, b, q):
    """General a * b mod q for canonical a, b (one exact int64 product)."""
    return torch.remainder(a * b, q)


def to_mont(x, q, qinv_neg, r2):
    """Canonical -> Montgomery form: x * 2^32 mod q."""
    return mont_mul(x, r2, q, qinv_neg)


def from_mont(x, q, qinv_neg):
    """Montgomery -> canonical form: x * 2^-32 mod q."""
    return mont_mul(x, torch.ones_like(x), q, qinv_neg)


def barrett_reduce_u32(x, q):
    """Reduce any value in [0, 2^32) to [0, q)."""
    return torch.remainder(x, q)
