"""Homomorphic function approximation: inverse, sqrt, exp, softmax.

The iterative/polynomial toolkit that turns CKKS arithmetic into the
elementary functions encrypted ML needs beyond comparisons
(ciphertext/compare.py):

* ``inverse`` — Goldschmidt division: for a = x/bound in (0, 1],
  1/a = prod_i (1 + r^(2^i)) with r = 1 - a; relative error |r|^(2^iters)
  decays doubly-exponentially. One ct-ct square + one ct-ct multiply per
  iteration (2 levels).
* ``sqrt`` — the coupled Newton iteration of Cheon-Kim-Kim-Lee ("Numerical
  method for comparison on homomorphically encrypted numbers", Asiacrypt
  2019 pattern): a_{k+1} = a_k (1 - b_k/2), b_{k+1} = b_k^2 (b_k - 3)/4
  with a_0 = x, b_0 = x - 1 converges to sqrt(x) on [0, 1].
* ``exp`` — Chebyshev interpolant on [-half_range, half_range], evaluated
  with the production BSGS evaluator (polyeval.ChebyshevEvaluator, the same
  machinery the bootstrap EvalMod uses).
* ``softmax`` — exp over every slot, a log2(slots) rotate-and-add tree to
  put the slot-sum in every slot, a Goldschmidt reciprocal of the sum, and
  one ct-ct multiply. The building block of encrypted attention
  (models/attention.py).
* ``rsqrt`` — the sqrt coupled-Newton accumulator seeded at 1 instead of x:
  the multiplier product converges to 1/sqrt(x) directly (no divide).
* ``layer_norm`` — block-wise LayerNorm: rotate-add block means, centered
  square for the variance, rsqrt, cleartext gamma/beta. The normalization
  layer of the encrypted transformer block (models/transformer.py).

All functions are backend-generic (ciphertext/backend.py) and consume the
CKKS level budget noted on each docstring. A copy of gpufhe_tpu/ciphertext/
approx.py, which imports only numpy and polyeval: the port keeps its own so
that it imports nothing of gpufhe_tpu. On the port's DeviceBackend every
output equals the reference's limb for limb (tests/test_torch_libraries.py).
"""

from __future__ import annotations

import numpy as np
from numpy.polynomial import chebyshev as C

from gpufhe_tpu_torch.ciphertext.polyeval import ChebyshevEvaluator, _align_to, _rescale_prod


def _scale_const(be, ct, k: float):
    """k * x via one plaintext multiply + rescale (1 level).

    The constant is encoded at Delta * q_dropped / ct.scale rather than at
    Delta, so the OUTPUT scale is exactly Delta: iterative circuits
    (Goldschmidt, coupled Newton) square their operands every iteration,
    which DOUBLES any accumulated scale excess (the float-inf failure mode
    of composed layer_norms) — anchoring every affine kills the compounding
    at no cost (same machinery as polyeval._align_to)."""
    s_x = be.params.scale * _rescale_prod(be, be.level(ct)) / ct.scale
    pt = be.encode_slots(
        np.full(be.params.slots, k, dtype=np.complex128),
        s_x, be.level(ct),
    )
    return be.rescale(be.mul_plain(ct, pt))


def _affine(be, ct, a: float, b: float):
    """a*x + b in one plaintext multiply + rescale (1 level)."""
    out = _scale_const(be, ct, a)
    if b != 0.0:
        out = be.add_plain(out, b)
    return out


def inverse_levels(iters: int) -> int:
    """Levels consumed by inverse() (excluding the bound normalization)."""
    return 2 * iters - 1


def inverse(be, ct, bound: float = 1.0, iters: int = 6,
            out_scale: float = 1.0):
    """out_scale/x for slot values x in [eps*bound, bound].

    Goldschmidt: a = x/bound, r0 = 1 - a, y = (1+r0)(1+r0^2)(1+r0^4)... =
    (1 - r0^(2^iters)) / a. Relative error (1-eps)^(2^iters): iters=6
    resolves eps=0.05 to ~4e-2, eps=0.15 to ~3e-5; add an iteration to
    square the error. `out_scale` is folded into the final un-normalize for
    free. Levels: 1 (normalize) + 2*iters - 1.
    """
    assert iters >= 1
    # r = 1 - x/bound and y = 2 - x/bound, each one affine level off ct
    r = _affine(be, ct, -1.0 / bound, 1.0)
    y = be.add_plain(r, 1.0)
    for _ in range(iters - 1):
        r = be.mul(r, r)
        y = be.mul(y, be.add_plain(r, 1.0))
    k = out_scale / bound
    if k != 1.0:
        y = _scale_const(be, y, k)
    return y


def sqrt_levels(iters: int) -> int:
    """Levels consumed by sqrt() (excluding the bound normalization)."""
    return 2 * iters


def sqrt(be, ct, bound: float = 1.0, iters: int = 6):
    """sqrt(x) for slot values x in [0, bound] (accurate from ~0.01*bound up).

    Coupled Newton iteration on a = x/bound in [0, 1]:
        a <- a (1 - b/2),   b <- b^2 (b - 3) / 4,   b0 = a0 - 1.
    b_k = (a-1)-shaped error term converging to 0; a_k -> sqrt(a).
    Levels: 1 (normalize) + 2 per iteration. Error after k iterations is
    ~ (1 - x/bound)^(2^k) in the worst corner; iters=6 gives ~1e-3 over
    [0.05, 1].
    """
    assert iters >= 1
    s = float(np.sqrt(bound))
    a = _scale_const(be, ct, 1.0 / bound) if bound != 1.0 else ct
    b = _affine(be, ct, 1.0 / bound, -1.0)
    for i in range(iters):
        # a update: a * (1 - b/2); fold the final sqrt(bound) un-normalize
        # into the last iteration's affine for free
        scale_out = s if (i == iters - 1 and bound != 1.0) else 1.0
        half = _affine(be, b, -0.5 * scale_out, scale_out)
        a = be.mul(_align_to(be, a, half.scale, half.level), half)
        if i != iters - 1:
            quarter = _affine(be, b, 0.25, -0.75)  # (b - 3)/4
            b = be.mul(be.mul(b, b), quarter)
    return a


def rsqrt_levels(iters: int) -> int:
    """Levels consumed by rsqrt() (including the bound normalization)."""
    return 2 * iters


def rsqrt(be, ct, bound: float = 1.0, iters: int = 6):
    """1/sqrt(x) for slot values x in [lo, bound], lo not too small.

    Same coupled Newton iteration as sqrt() — a_k = x * prod(1 - b_i/2)
    converges to sqrt(x), so seeding the accumulator at 1 instead of x makes
    the SAME multiplier product converge to sqrt(x)/x = 1/sqrt(x); the
    1/sqrt(bound) un-normalize folds into the seed. Worst-corner error is
    (1 - lo/bound)^(2^iters): iters=6 resolves lo/bound=0.1 to ~1e-3.
    Levels: 2 per iteration (the b-chain and the accumulator interleave).
    """
    assert iters >= 1
    y0 = 1.0 / float(np.sqrt(bound))
    b = _affine(be, ct, 1.0 / bound, -1.0)      # b0 = x/bound - 1
    y = _affine(be, b, -0.5 * y0, y0)           # y1 = y0 * (1 - b0/2)
    for _ in range(iters - 1):
        quarter = _affine(be, b, 0.25, -0.75)   # (b - 3)/4
        b = be.mul(be.mul(b, b), quarter)
        half = _affine(be, b, -0.5, 1.0)
        y = be.mul(_align_to(be, y, half.scale, half.level), half)
    return y


def rotations_for_layernorm(slots: int, d: int) -> list[int]:
    """Galois steps layer_norm() needs: intra-block sum + block fill trees."""
    steps = set()
    for j in range(int(np.log2(d))):
        steps.add(1 << j)
        steps.add(slots - (1 << j))
    return sorted(steps)


def _block_mean(be, ct, d: int, weight: float):
    """weight * (block sum) replicated into every slot of its block.

    Blocks are the contiguous d-slot groups of the attention packing
    (models/attention.py): a log2(d) rotate-add tree puts each block's sum
    at its start slot (interior slots hold cross-block wrap sums), a masked
    plaintext multiply keeps the starts scaled by `weight`, and a reversed
    tree of negative rotations fills each block from its start. 1 level.
    """
    slots = be.params.slots
    s = ct
    for j in range(int(np.log2(d))):
        st = 1 << j
        s = be.add(s, be.rotate_hoisted(s, [st])[st])
    starts = np.zeros(slots, dtype=np.complex128)
    starts[::d] = weight
    pt = be.encode_slots(starts, be.params.scale, be.level(s))
    s = be.rescale(be.mul_plain(s, pt))
    for j in range(int(np.log2(d))):
        st = slots - (1 << j)
        s = be.add(s, be.rotate_hoisted(s, [st])[st])
    return s


def layer_norm_levels(iters: int, affine: bool = True) -> int:
    """Levels consumed by layer_norm()."""
    return rsqrt_levels(iters) + 4 + (1 if affine else 0)


def layer_norm(be, ct, d: int, eps: float = 1e-2, gamma=None, beta=None,
               var_bound: float = 1.0, iters: int = 5):
    """LayerNorm over each contiguous d-slot block: gamma * (x - mean) /
    sqrt(var + eps) + beta.

    gamma/beta are cleartext length-d feature vectors (or None). `eps` also
    floors the rsqrt input for all-constant blocks (unused zero blocks stay
    bounded: centered ~ 0 there and the Newton accumulator is bounded by
    construction). Accuracy needs var + eps in [lo, var_bound + eps] with
    (1 - lo/(var_bound + eps))^(2^iters) small — budget iters like rsqrt.
    Levels: 4 + 2*iters (+1 with gamma/beta).
    """
    mean = _block_mean(be, ct, d, 1.0 / d)
    centered = be.sub(_align_to(be, ct, mean.scale, mean.level), mean)
    var = _block_mean(be, be.mul(centered, centered), d, 1.0 / d)
    var = be.add_plain(var, eps)
    r = rsqrt(be, var, bound=var_bound + eps, iters=iters)
    out = be.mul(_align_to(be, centered, r.scale, r.level), r)
    if gamma is not None:
        g = np.tile(np.asarray(gamma, dtype=np.complex128),
                    be.params.slots // d)
        pt = be.encode_slots(g, be.params.scale, be.level(out))
        out = be.rescale(be.mul_plain(out, pt))
    if beta is not None:
        out = be.add_plain(
            out, np.tile(np.asarray(beta, dtype=np.complex128),
                         be.params.slots // d))
    return out


def exp_coeffs(half_range: float, degree: int = 15) -> np.ndarray:
    """Chebyshev coefficients of u -> e^(half_range * u) on u in [-1, 1]."""
    return C.Chebyshev.interpolate(
        lambda u: np.exp(half_range * u), degree
    ).coef


def exp(be, ct, half_range: float = 1.0, degree: int = 15, baby_log: int = 3):
    """e^x for slot values x in [-half_range, half_range].

    One normalization level (skipped when half_range == 1) plus the BSGS
    Chebyshev evaluation (~ceil(log2(degree)) + 2 levels). Interpolation
    error is minimax-quality: degree 15 covers half_range <= 3 to ~1e-7.
    """
    u = _scale_const(be, ct, 1.0 / half_range) if half_range != 1.0 else ct
    return ChebyshevEvaluator(be, exp_coeffs(half_range, degree),
                              baby_log=baby_log)(u)


def rotations_for_softmax(slots: int) -> list[int]:
    """Galois steps softmax() needs: the power-of-two rotate-add tree."""
    return [1 << j for j in range(int(np.log2(slots)))]


def slot_sum(be, ct):
    """Put sum(slots) in every slot: log2(slots) rotate-and-add passes."""
    n = be.params.slots
    k = 1
    while k < n:
        ct = be.add(ct, be.rotate_hoisted(ct, [k])[k])
        k <<= 1
    return ct


def softmax(be, ct, half_range: float = 1.0, degree: int = 15,
            inv_iters: int = 7, baby_log: int = 3, replicated: int = 1):
    """softmax over ALL slots, for logits in [-half_range, half_range].

    exp -> rotate-add slot sum -> Goldschmidt reciprocal (bound =
    slots * e^half_range; the sum is at least slots * e^-half_range, so the
    reciprocal's eps is e^(-2*half_range) — budget inv_iters accordingly:
    half_range=1 wants >= 7 iterations for ~1e-3 relative) -> one ct-ct
    multiply. Levels: exp + 1 + inverse_levels(inv_iters) + 2.

    Callers packing m < slots logits must tile them slots/m times
    (np.tile) and pass replicated=slots//m: the rotate-add tree then sums
    `replicated * true_sum`, and the correction is folded into the
    reciprocal's output scale for free.
    """
    n = be.params.slots
    e = exp(be, ct, half_range=half_range, degree=degree, baby_log=baby_log)
    s = slot_sum(be, e)
    inv = inverse(be, s, bound=n * float(np.exp(half_range)),
                  iters=inv_iters, out_scale=float(replicated))
    return be.mul(_align_to(be, e, inv.scale, inv.level), inv)
