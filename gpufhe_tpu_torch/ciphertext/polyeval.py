"""Chebyshev polynomial evaluation on ciphertexts (baby-step/giant-step).

Evaluates f(y) for slot values y in [-1, 1] from Chebyshev coefficients, in
O(sqrt(d)) ciphertext multiplies and O(log d) depth:

  * babies T_1..T_G (G ~ sqrt(d)) via T_{a+b} = 2 T_a T_b - T_{a-b}
  * giants T_{2G}, T_{4G}, ... by the same doubling identity
  * recursion f = q(T) * T_m + r(T) with (q, r) = chebdiv(f, T_m)

Noise behaviour is what production EvalMod needs: unlike the cos double-angle
ladder (bootstrap.py _evalmod), input error is NOT amplified by 2^r — the
sine is evaluated directly, so output error ~ input error * ||f'||.

Scale management is ACTIVE: mixed-depth adds are aligned by a one-level
constant multiply that lands on the exact target scale (`_align_to`, a
one-term `_mac_to`), so the
evaluator is robust to prime chains whose q_i drift from 2^scale_bits (the
N=2^16 regime).

A copy of gpufhe_tpu/ciphertext/polyeval.py, which imports only numpy: the
port keeps its own so that it imports nothing of gpufhe_tpu.
"""

from __future__ import annotations

import math

import numpy as np
from numpy.polynomial import chebyshev as C


def chebyshev_coeffs(fn, degree: int) -> np.ndarray:
    """Chebyshev interpolation coefficients of fn on [-1, 1]."""
    return C.chebinterpolate(fn, degree)


def sine_coeffs(k_bound: float, degree: int | None = None) -> np.ndarray:
    """Coefficients of sin(2 pi k_bound y) on [-1, 1] (EvalMod kernel)."""
    omega = 2.0 * math.pi * k_bound
    if degree is None:
        degree = int(omega + 25)  # tail decays super-exponentially past omega
    return chebyshev_coeffs(lambda y: np.sin(omega * y), degree)


def _ones(be):
    return np.ones(be.params.slots, dtype=np.complex128)


def _rescale_prod(be, from_level: int) -> float:
    """The product of the primes a rescale from `from_level` divides by: the
    backend's own where it has one, else the single top prime (a
    single-word backend without the method)."""
    if hasattr(be, "rescale_prod"):
        return be.rescale_prod(from_level)
    return float(be.params.q_primes[from_level - 1])


def _mac_to(be, terms: list, scale: float, level: int):
    """sum c * ct over terms [(ct, c), ...] at exactly (scale, level): each
    ct dropped to one rescale above `level`, times the constant c at the
    scale that lands it there, then one rescale (a fused plaintext MAC where
    the backend has one)."""
    w = be.params.scale_words
    pairs = []
    for ct, c in terms:
        assert ct.level >= level + w, (ct.level, level)
        ct = be.drop_to_level(ct, level + w)
        s_x = scale * _rescale_prod(be, ct.level) / ct.scale
        pairs.append((ct, be.encode_slots(_ones(be) * c, s_x, ct.level)))
    if hasattr(be, "plain_mac"):  # fused: one dispatch (bit-exact)
        return be.plain_mac(pairs)
    prods = [be.mul_plain(ct, pt) for ct, pt in pairs]
    acc = prods[0]
    for p in prods[1:]:
        acc = be.add(acc, p)
    return be.rescale(acc)


def _align_to(be, ct, scale: float, level: int):
    """Bring ct to exactly (scale, level): one const-multiply + rescale."""
    return _mac_to(be, [(ct, 1.0)], scale, level)


class ChebyshevEvaluator:
    """Evaluate sum_j c_j T_j(y) homomorphically for y with slots in [-1,1]."""

    def __init__(self, be, coeffs: np.ndarray, baby_log: int = 3):
        self.be = be
        self.c = np.asarray(coeffs, dtype=np.float64)
        self.d = len(self.c) - 1
        self.G = 1 << baby_log
        assert self.d >= 1

    # -- Chebyshev basis ----------------------------------------------------
    def _build_basis(self, y):
        """T[j] for j in 1..G plus giants G*2^i covering the degree."""
        be = self.be
        T = {1: y}

        def get(j):
            if j in T:
                return T[j]
            a = (j + 1) // 2
            b = j // 2
            prod = be.mul(get(a), get(b))
            two = be.add(prod, prod)
            if a == b:  # T_{a-b} = T_0 = 1
                out = be.add_plain(two, -1.0)
            else:  # T_{a-b} = T_1 = y
                yc = _align_to(be, y, two.scale, two.level)
                out = be.sub(two, yc)
            T[j] = out
            return out

        for j in range(2, self.G + 1):
            get(j)
        m = 2 * self.G
        while m // 2 < self.d:
            get(m)
            m *= 2
        del get  # get's closure holds get: a cycle that would keep T until a collection
        return T

    # -- evaluation ---------------------------------------------------------
    def _eval_small(self, c: np.ndarray, T: dict, target=None):
        """Sum c_j T_j using the baby/giant set; lands exactly on `target`
        (level, scale) when given (the free plaintext scales absorb it)."""
        be = self.be
        delta = be.params.scale
        terms = []  # (T_j, coeff)
        for j in range(1, len(c)):
            if abs(c[j]) > 1e-13:
                terms.append((T[j], float(c[j])))
        if not terms:
            assert target is not None or True
            w = be.params.scale_words
            lvl, s_t = (
                (target[0] + w, target[1] * _rescale_prod(be, target[0] + w))
                if target is not None
                else (T[1].level, T[1].scale * delta)
            )
            base = be.mul_plain(
                be.drop_to_level(T[1], lvl),
                be.encode_slots(np.zeros(be.params.slots) + 0j, s_t / T[1].scale, lvl),
            )
            out = be.rescale(base)  # encrypted zero at exactly (target)
            return be.add_plain(out, float(c[0]))
        if target is None:
            lvl = min(be.level(ct) for ct, _ in terms)
            s_t = max(ct.scale for ct, _ in terms) * delta
        else:
            lvl = target[0] + be.params.scale_words
            s_t = target[1] * _rescale_prod(be, lvl)
        assert all(be.level(ct) >= lvl for ct, _ in terms)
        pairs = []
        for ct, coeff in terms:
            ct = be.drop_to_level(ct, lvl)
            pt = be.encode_slots(
                np.full(be.params.slots, coeff, dtype=np.complex128),
                s_t / ct.scale, lvl,
            )
            pairs.append((ct, pt))
        if hasattr(be, "plain_mac"):  # fused fan: one dispatch (bit-exact)
            return be.plain_mac(pairs, float(c[0]))
        acc = None
        for ct, pt in pairs:
            term = be.mul_plain(ct, pt)
            acc = term if acc is None else be.add(acc, term)
        acc = be.rescale(acc)
        return be.add_plain(acc, float(c[0]))

    def _eval(self, c: np.ndarray, T: dict, target=None):
        d = len(c) - 1
        if d <= self.G:
            return self._eval_small(c, T, target)
        m = self.G
        while 2 * m <= d:
            m *= 2
        unit = np.zeros(m + 1)
        unit[m] = 1.0
        q, r = C.chebdiv(c, unit)
        be = self.be
        if target is None:
            qv = self._eval(q, T)
            prod = be.mul(qv, T[m])
        else:
            # steer the q-branch so prod lands EXACTLY on target — the free
            # plaintext scales inside the q-branch absorb the adjustment
            lv = target[0] + be.params.scale_words
            assert T[m].level >= lv, (T[m].level, lv)
            s_q = target[1] * _rescale_prod(be, lv) / T[m].scale
            qv = self._eval(q, T, target=(lv, s_q))
            prod = be.mul(qv, be.drop_to_level(T[m], lv))
        rv = self._eval(r, T, target=(prod.level, prod.scale))
        return be.add(prod, rv)

    def __call__(self, y):
        T = self._build_basis(y)
        return self._eval(self.c, T)
