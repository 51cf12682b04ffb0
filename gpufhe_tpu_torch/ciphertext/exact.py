"""Exact integer predicates over BFV/BGV backends: equality, zero-test,
private set membership.

Fermat's little theorem over the plaintext field Z_t (t prime):
x^(t-1) = 1 for x != 0 and 0 for x == 0, so

    is_zero(x)        = 1 - x^(t-1)
    equals(a, b)      = is_zero(a - b)
    member(x, S)      = sum_{s in S} equals(x, s)     (exact 0/1: at most
                                                       one term fires)

Exponentiation is square-and-multiply on ciphertexts; with t - 1 a power of
two (presets like bfv_eq: t = 257) it is log2(t-1) squarings. BFV is the
natural host — its multiply keeps the level, so the full x^(t-1) ladder
costs only noise (~log2(t * N * L) bits per squaring) on a chain sized for
the budget. The generic ops (ct_pow_const) also run on BGV — operands are
level-aligned via ModSwitch between hops — but there a Fermat ladder needs
log2(t) + popcount(t-1) LEVELS, so full predicates are only practical on
BFV. The CKKS counterpart is the approximate sign/compare suite in
ciphertext/compare.py; these are EXACT. A copy of gpufhe_tpu/ciphertext/
exact.py, which imports only numpy, run over the port's BGVDeviceBackend
and BFVDeviceBackend (tests/test_torch_libraries.py).
"""

from __future__ import annotations

import numpy as np


def _level_align(be, a, b):
    """Bring two cts to a common level (BGV: mul drops one level per hop, so
    square-and-multiply operands diverge; rescale/ModSwitch keeps the
    plaintext on both integer schemes). No-op for BFV."""
    while be.level(a) > be.level(b):
        a = be.rescale(a)
    while be.level(b) > be.level(a):
        b = be.rescale(b)
    return a, b


def ct_pow_const(be, ct, e: int):
    """ct^e by square-and-multiply (e >= 1). On BGV this consumes about
    log2(e) + popcount(e) levels; on BFV the level never moves."""
    assert e >= 1
    result = None
    base = ct
    while e:
        if e & 1:
            if result is None:
                result = base
            else:
                result = be.mul(*_level_align(be, result, base))
        e >>= 1
        if e:
            base = be.mul(base, base)
    return result


def _const_pt(be, value: int, level: int):
    n_s = be.params.slots
    return be.encode_slots(np.full(n_s, value, dtype=np.int64), 1.0, level)


def ct_is_zero(be, ct):
    """1 - ct^(t-1): slot-wise 1 where the slot is 0 (mod t), else 0."""
    t = be.t
    p = ct_pow_const(be, ct, t - 1)
    neg = be.mul_plain(p, _const_pt(be, t - 1, be.level(p)))  # * (-1)
    return be.add_plain(neg, np.ones(be.params.slots, dtype=np.int64))


def ct_equals_plain(be, ct, values):
    """Slot-wise [ct == values] as an exact 0/1 ciphertext."""
    t = be.t
    vals = np.asarray(values, dtype=np.int64) % t
    diff = be.add_plain(ct, (-vals) % t)
    return ct_is_zero(be, diff)


def ct_equals(be, a, b):
    """Slot-wise [a == b] for two ciphertexts."""
    return ct_is_zero(be, be.sub(a, b))


def ct_member_plain(be, ct, values: list[int]):
    """Slot-wise [ct in values] (exact 0/1; |values| zero-tests)."""
    acc = None
    for v in values:
        eq = ct_equals_plain(be, ct, np.full(be.params.slots, v, dtype=np.int64))
        acc = eq if acc is None else be.add(acc, eq)
    return acc
