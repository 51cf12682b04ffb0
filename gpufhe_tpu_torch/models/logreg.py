"""Encrypted logistic-regression inference — the framework's demo workload.

Computes sigmoid(<w, x> + b) on an encrypted feature vector x (cleartext
model w, b), end to end under CKKS:

  * masked slot dot-product: elementwise mul_plain with w, then a
    log2(slots) rotate-and-add tree reduction so every slot holds the sum
  * degree-3 odd polynomial approximation of sigmoid on [-8, 8]
    (0.5 + 1.20096*(x/8) - 0.81562*(x/8)^3, the standard minimax cubic;
    max approximation error ~0.06 over the interval — the homomorphic
    evaluation itself adds only ~1e-3 noise on top)

Backend-generic (ciphertext/backend.py); a copy of gpufhe_tpu/models/
logreg.py, equal to it limb for limb on the port's DeviceBackend. Levels consumed: 1 (mask) + log2 reduction is free + 2 (cubic via
x * (a + c*x^2)) + 1 (scale by t) = 4.
"""

from __future__ import annotations

import math

import numpy as np


def rotations_needed(slots: int) -> list[int]:
    return [1 << i for i in range(int(math.log2(slots)))]


def _rotate_sum(be, ct):
    """Leave sum(slots) in every slot: log2(slots) rotate-and-adds."""
    n_s = be.params.slots
    for shift in rotations_needed(n_s):
        ct = be.add(ct, be.rotate_hoisted(ct, [shift])[shift])
    return ct


class EncryptedLogReg:
    """Cleartext model, encrypted inputs."""

    def __init__(self, be, w: np.ndarray, b: float, x_bound: float = 8.0):
        self.be = be
        slots = be.params.slots
        assert len(w) <= slots
        self.w = np.zeros(slots, dtype=np.float64)
        self.w[: len(w)] = w
        self.b = float(b)
        self.t = float(x_bound)
        # minimax cubic for sigmoid on [-x_bound, x_bound], variable u = x/t
        self.c1, self.c3 = 1.20096, -0.81562

    def __call__(self, ct_x):
        """ct_x: slots = features (zero-padded). Returns ct of sigmoid score."""
        be = self.be
        lvl = be.level(ct_x)
        assert lvl >= 5, "logreg inference consumes 4 levels; need level >= 5"
        wpt = be.encode_slots(
            self.w.astype(np.complex128) / self.t, be.params.scale, lvl
        )
        u = be.rescale(be.mul_plain(ct_x, wpt))  # slots: w_i x_i / t
        u = _rotate_sum(be, u)  # every slot: <w, x>/t
        u = be.add_plain(u, self.b / self.t)  # u = (wx + b)/t in [-1, 1]

        # sigmoid(t*u) ~ 0.5 + c1*u + c3*u^3  =  0.5 + u*(c1 + c3*u^2)
        u2 = be.mul(u, u)
        inner = self._mul_const(u2, self.c3)
        inner = be.add_plain(inner, self.c1)
        out = be.mul(u, inner)
        return be.add_plain(out, 0.5)

    def _mul_const(self, ct, c: float):
        be = self.be
        pt = be.encode_slots(
            np.full(be.params.slots, c, dtype=np.complex128),
            be.params.scale,
            be.level(ct),
        )
        return be.rescale(be.mul_plain(ct, pt))

    def reference(self, x: np.ndarray) -> float:
        """True (unapproximated) sigmoid score."""
        z = float(self.w[: len(x)] @ x + self.b)
        return 1.0 / (1.0 + math.exp(-z))

    def reference_poly(self, x: np.ndarray) -> float:
        """Cleartext evaluation of the same cubic the circuit computes."""
        u = float(self.w[: len(x)] @ x + self.b) / self.t
        return 0.5 + self.c1 * u + self.c3 * u**3
