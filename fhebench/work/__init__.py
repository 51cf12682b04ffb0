"""The roofline arithmetic: the work the RNS algorithms need per request,
counted from the configuration and the circuit alone, and the least time
the card could take for it.

What is counted is the standard RNS hybrid key-switching algorithm (Han and
Ki, CT-RSA 2020) with its tensor, ModUp, inner product, ModDown and rescale
or ModSwitch, BEHZ's auxiliary-basis multiply for BFV (Bajard, Eynard,
Hasan and Zucca, SAC 2016), and for the bootstrap every key switch and
rotation its plan performs (work/bootstrap.py). Where two orders of the
same algorithm differ (a ModDown and rescale in the evaluation domain or in
the coefficient domain), the cheaper is counted. Nothing is read from the
library's launches: the count is the algorithm's, so it reads the same
whatever implements it.

Three kernels are counted:
- K1, limb-NTTs: one N-point negacyclic transform of one limb.
- K3, base conversions: (source limbs, destination limbs) per polynomial;
  a ModUp digit goes to the limbs it lacks only.
- K4, key-switch inner products: (digits D, limbs T) per polynomial, both
  key components.

Each operation's least time is the larger of two figures:
- bytes: each input residue read once and each output residue written once,
  at 4 bytes a residue (every prime is below 2^30, so 4 bytes is the least
  any implementation stores) and HBM_BYTES_PER_S; key rows are inputs,
  twiddle and conversion tables are not (an implementation may compute
  them);
- products: INT_OPS_PER_S, the card's 32-bit integer peak (132 SMs x 64
  multiply-adds per clock x 2 operations x 1.98 GHz, each multiply-add 2
  operations), counting per modular product by a constant 3 multiply-adds
  (Shoup: the high word of x w', and the low words of x w and of the
  quotient times q) and per term of an unreduced sum 2 (the low and high
  words of a 60-bit product accumulated in 64 bits), with one reduction (3)
  per output residue of a sum.

A later change that alters the algorithm (drops transforms, merges a
ModDown into a rescale, changes BFV's auxiliary basis) makes these counts
stale; repairing them is a change of the benchmark, never of a PR that
claims a gain.
"""

from __future__ import annotations

import dataclasses
import math

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet
INT_OPS_PER_S = 132 * 64 * 2 * 1.98e9  # 33.45e12: 32-bit multiply-adds, 2 ops each
BYTES_PER_RESIDUE = 4
MULADDS_PER_MODMUL = 3
MULADDS_PER_TERM = 2


def digits(level: int, alpha: int) -> list[int]:
    """The limb counts of the key-switch decomposition groups at `level`."""
    return [min(alpha, level - d) for d in range(0, level, alpha)]


@dataclasses.dataclass
class Work:
    """The counted operations of one request at ring degree n."""

    n: int
    ntt_limbs: int = 0
    convs: list = dataclasses.field(default_factory=list)  # (src limbs, dst limbs)
    macs: list = dataclasses.field(default_factory=list)  # (digits, limbs)

    def ntt(self, limbs: int) -> None:
        self.ntt_limbs += limbs

    def conv(self, src: int, dst: int, times: int = 1) -> None:
        self.convs.extend([(src, dst)] * times)

    def mac(self, d: int, limbs: int, times: int = 1) -> None:
        self.macs.extend([(d, limbs)] * times)

    # -- the algorithms' building blocks ---------------------------------
    def mod_up(self, level: int, alpha: int, coeff_in: bool = False) -> None:
        """Raise one polynomial at `level` (evaluation domain unless
        coeff_in) to D digits over the active Q and P, in the evaluation
        domain: iNTT, one conversion per digit to the limbs it lacks, and
        the NTT of those limbs (of every limb when the input came in the
        coefficient domain and has no evaluation-domain copy)."""
        if not coeff_in:
            self.ntt(level)
        for a in digits(level, alpha):
            self.conv(a, level + alpha - a)
        self.ntt(sum(level + alpha - a for a in digits(level, alpha))
                 + (level if coeff_in else 0))

    def inner_product(self, level: int, alpha: int, times: int = 1) -> None:
        self.mac(len(digits(level, alpha)), level + alpha, times)

    def mod_down_drop(self, level: int, alpha: int, drop: int, add_pair: bool) -> None:
        """ModDown by P of the two accumulators at `level`, then `drop`
        rescales (or modulus switches), output in the evaluation domain:
        the cheaper of the two orders. add_pair: a pair (d0, d1) in the
        evaluation domain is added to the result (a multiply's), which the
        coefficient-domain order has to transform too."""
        eval_order = 2 * alpha + 2 * level + 2 * sum(level - j for j in range(drop))
        coeff_order = 2 * (level + alpha) + (2 * level if add_pair else 0) + 2 * (level - drop)
        self.ntt(min(eval_order, coeff_order))
        self.conv(alpha, level, times=2)

    def key_switch(self, level: int, alpha: int, drop: int = 0, add_pair: bool = False,
                   coeff_in: bool = False) -> None:
        self.mod_up(level, alpha, coeff_in)
        self.inner_product(level, alpha)
        self.mod_down_drop(level, alpha, drop, add_pair)

    def rescale(self, level: int, drop: int) -> None:
        """`drop` rescales of a pair in the evaluation domain."""
        self.ntt(min(2 * sum(level - j for j in range(drop)), 2 * level + 2 * (level - drop)))

    # -- least times -----------------------------------------------------
    def _least(self, bytes_, muladds) -> float:
        return max(bytes_ * BYTES_PER_RESIDUE / HBM_BYTES_PER_S,
                   2 * muladds / INT_OPS_PER_S)

    def least_s(self) -> dict:
        """Least seconds per kernel and which bound it: {"K1": (s, "bytes")...}."""
        n = self.n
        out = {}
        k1 = (2 * n * self.ntt_limbs, n // 2 * int(math.log2(n)) * MULADDS_PER_MODMUL
              * self.ntt_limbs)
        out["K1"] = self._pick([k1])
        out["K3"] = self._pick([
            ((s + d) * n, n * (s * MULADDS_PER_MODMUL + s * d * MULADDS_PER_TERM
                               + d * MULADDS_PER_MODMUL))
            for s, d in self.convs])
        out["K4"] = self._pick([
            ((d * t + 2 * d * t + 2 * t) * n,
             n * 2 * t * (d * MULADDS_PER_TERM + MULADDS_PER_MODMUL))
            for d, t in self.macs])
        return out

    def _pick(self, ops) -> tuple:
        total, by_bytes = 0.0, 0.0
        for b, m in ops:
            t_b = b * BYTES_PER_RESIDUE / HBM_BYTES_PER_S
            t = self._least(b, m)
            total += t
            by_bytes += t if t == t_b else 0.0
        return total, ("bytes" if by_bytes >= total / 2 else "products")


def ckks_square_chain(n: int, level: int, alpha: int, words: int, squarings: int) -> Work:
    """A chain of ct_mul_full squarings: tensor, relinearisation and
    `words` rescales each, from `level`."""
    w = Work(n)
    for _ in range(squarings):
        w.key_switch(level, alpha, drop=words, add_pair=True)
        level -= words
    return w


def bgv_square_chain(n: int, level: int, alpha: int, squarings: int) -> Work:
    """BGV squarings: tensor, relinearisation and one modulus switch each."""
    return ckks_square_chain(n, level, alpha, 1, squarings)


def behz_aux_limbs(t: int, n: int, level: int, q_bits: float, word_bits: int = 30) -> int:
    """The fewest auxiliary limbs (B and m_sk) of BEHZ's multiply at `level`:
    prod(B) above 2 t N L^2 Q with a margin of 2^4 (Shenoy-Kumaresan needs
    |y| < prod(B) / 2, y the scaled tensor), from primes below 2^word_bits,
    and one redundant prime m_sk."""
    bits = math.log2(t) + math.log2(n) + 2 * math.log2(max(level, 2)) + q_bits + 4
    return math.ceil(bits / word_bits) + 1


def bfv_square_chain(n: int, level: int, alpha: int, aux: int, squarings: int) -> Work:
    """BFV squarings (the level stays): both operands to the coefficient
    domain and on to the auxiliary basis B and m_sk (`aux` limbs), the
    tensor over both bases, the exact t/Q scaling over the auxiliary basis
    ([t d]_Q converted too), the Shenoy-Kumaresan conversion back to Q
    (B -> m_sk, B -> Q), then the relinearisation of the coefficient-domain
    d2 and the pair's transform back."""
    w = Work(n)
    b = aux - 1
    for _ in range(squarings):
        w.ntt(4 * level)  # iNTT a0, a1, b0, b1
        w.conv(level, aux, times=4)
        w.ntt(4 * aux)  # the four operands over the auxiliary basis
        w.ntt(3 * level + 3 * aux)  # the tensor's three components back
        w.conv(level, aux, times=3)  # [t d]_Q
        w.conv(b, 1, times=3)
        w.conv(b, level, times=3)
        w.mod_up(level, alpha, coeff_in=True)
        w.inner_product(level, alpha)
        # ModDown of both accumulators and the pair in the evaluation domain
        w.ntt(2 * alpha + 4 * level)
        w.conv(alpha, level, times=2)
    return w
