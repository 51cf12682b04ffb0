"""Homomorphic comparison: composite-polynomial sign and what it unlocks.

sign(x) is approximated by composing two low-degree odd polynomials
(Cheon-Kim-Kim "Efficient homomorphic comparison methods with optimal
complexity", Asiacrypt 2020 pattern):

  g3(x) = (4589 x - 16577 x^3 + 25614 x^5 - 12860 x^7) / 2^10   (domain pull)
  f3(x) = (  35 x -    35 x^3 +    21 x^5 -     5 x^7) / 2^4    (sharpening)

  sign(x) ~ f3∘...∘f3 ∘ g3∘...∘g3 (x)       for x in [-1,1], |x| >= eps

g3 repetitions shrink the undecided band eps geometrically; f3 repetitions
then square-converge the output toward ±1. Each degree-7 step costs 4 levels
(depth-3 Chebyshev basis + one MAC rescale) and is evaluated with the same
BSGS ChebyshevEvaluator the bootstrap EvalMod uses (polyeval.py), so the
scale bookkeeping is already production-grade. Affine post-maps (e.g. the
(1+sign)/2 step function) are folded into the LAST composition step's
coefficients — they cost zero extra levels.

Derived ops: step (0/1 comparator), relu, abs, maximum/minimum of two
ciphertexts. Backend-generic (ciphertext/backend.py). A copy of gpufhe_tpu/
ciphertext/compare.py, which imports only numpy and polyeval: on the port's
DeviceBackend every output equals the reference's limb for limb
(tests/test_torch_libraries.py).
"""

from __future__ import annotations

import numpy as np
from numpy.polynomial import chebyshev as C

from gpufhe_tpu_torch.ciphertext.polyeval import ChebyshevEvaluator, _align_to

# power-basis odd coefficients, x^0..x^7
_F3_POW = np.array([0, 35, 0, -35, 0, 21, 0, -5], dtype=np.float64) / 16.0
_G3_POW = np.array(
    [0, 4589, 0, -16577, 0, 25614, 0, -12860], dtype=np.float64
) / 1024.0

_F3_CHEB = C.poly2cheb(_F3_POW)
_G3_CHEB = C.poly2cheb(_G3_POW)

#: levels one degree-7 composition step consumes (depth-3 basis + MAC rescale)
STEP_LEVELS = 4


def sign_levels(n_g: int, n_f: int) -> int:
    """Levels consumed by sign/step with the given composition counts."""
    return STEP_LEVELS * (n_g + n_f)


def _affine_cheb(coeffs: np.ndarray, a: float, b: float) -> np.ndarray:
    """Chebyshev coefficients of a*p(x) + b."""
    out = coeffs * a
    out[0] += b
    return out


def sign(be, ct, n_g: int = 1, n_f: int = 2, baby_log: int = 3,
         affine: tuple[float, float] | None = None):
    """sign(x) for slot values in [-1, 1] with |x| >= ~eps(n_g).

    n_g=1 resolves |x| >= ~0.05; each extra g3 pass divides eps by ~2.7.
    n_f controls output flatness: error to ±1 decays doubly-exponentially
    in n_f. `affine=(a, b)` folds a*sign(x)+b into the final step for free.
    """
    assert n_g >= 0 and n_f >= 1
    steps = [_G3_CHEB] * n_g + [_F3_CHEB] * n_f
    if affine is not None:
        steps[-1] = _affine_cheb(steps[-1], *affine)
    for c in steps:
        ct = ChebyshevEvaluator(be, c, baby_log=baby_log)(ct)
    return ct


def step(be, ct, n_g: int = 1, n_f: int = 2, baby_log: int = 3):
    """Heaviside step: ~1 for x > 0, ~0 for x < 0 (x in [-1, 1])."""
    return sign(be, ct, n_g, n_f, baby_log, affine=(0.5, 0.5))


def compare(be, a, b, half_range: float = 1.0, n_g: int = 1, n_f: int = 2):
    """(a > b) as ~0/1 slots; |a - b| may span [-2*half_range, 2*half_range]."""
    d = be.sub(a, b)
    if half_range != 0.5:
        # scale the difference into [-1, 1] with a free constant multiply
        d = _scale_const(be, d, 0.5 / half_range)
    return step(be, d, n_g=n_g, n_f=n_f)


def _scale_const(be, ct, k: float):
    pt = be.encode_slots(
        np.full(be.params.slots, k, dtype=np.complex128),
        be.params.scale, be.level(ct),
    )
    return be.rescale(be.mul_plain(ct, pt))


def _mul_signish(be, ct, s):
    """x * s for s at a deeper level: align x down, then one ct-ct mult."""
    x = _align_to(be, ct, s.scale, s.level)
    return be.mul(x, s)


def relu(be, ct, n_g: int = 1, n_f: int = 2):
    """max(x, 0) = x * (1 + sign(x))/2 for x in [-1, 1]."""
    s = step(be, ct, n_g=n_g, n_f=n_f)
    return _mul_signish(be, ct, s)


def absval(be, ct, n_g: int = 1, n_f: int = 2):
    """|x| = x * sign(x) for x in [-1, 1]."""
    return _mul_signish(be, ct, sign(be, ct, n_g=n_g, n_f=n_f))


def maximum(be, a, b, n_g: int = 1, n_f: int = 2):
    """max(a, b) = (a + b)/2 + |a - b|/2; a, b and the result in [-1, 1]."""
    d = _scale_const(be, be.sub(a, b), 0.5)  # (a-b)/2 in [-1, 1]
    m = _scale_const(be, be.add(a, b), 0.5)
    ad = absval(be, d, n_g=n_g, n_f=n_f)
    return be.add(_align_to(be, m, ad.scale, ad.level), ad)


def minimum(be, a, b, n_g: int = 1, n_f: int = 2):
    d = _scale_const(be, be.sub(a, b), 0.5)
    m = _scale_const(be, be.add(a, b), 0.5)
    ad = absval(be, d, n_g=n_g, n_f=n_f)
    return be.sub(_align_to(be, m, ad.scale, ad.level), ad)
