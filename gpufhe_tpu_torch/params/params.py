"""Scheme parameters, presets and NTT-friendly prime generation.

Counterpart of gpufhe_tpu/params/params.py. The presets draw the same primes
in the same order, so a preset here and there names the same chain
(tests/test_torch_params.py checks every field). Every preset of the
reference is here: the CKKS multiply and rotation presets, the double-word
(scale_words = 2) ones with sparse-secret encapsulation, the CI-scale
factored-transform, bootstrap and model presets, the mid-scale and N=2^16
bootstraps (config5_boot_h's chain ordered for its circuit by
order_primes_for_circuit), and the integer schemes' (BGV and BFV:
plain_modulus t > 0) from N=2^7 to bfv_n16 at N=2^16.

Word-size discipline: every prime is odd, q = 1 mod 2N and q < 2^30, so a
product of two canonical residues is below 2^60 and fits an int64.
"""

from __future__ import annotations

import dataclasses
import functools
import math

from gpufhe_tpu_torch.golden.ntt import find_primitive_root_2n, is_prime

MAX_WORD_PRIME = (1 << 30) - 1


def gen_ntt_primes(bits: int, two_n: int, count: int, skip: int = 0) -> list[int]:
    """`count` distinct primes p = 1 (mod two_n) descending from 2^bits.

    `skip` lets different roles (q-chain, p-chain) draw disjoint primes from
    the same size class.
    """
    if bits > 30:
        raise ValueError("primes must stay below 2^30")
    primes: list[int] = []
    p = ((1 << bits) - 1) // two_n * two_n + 1
    seen = 0
    while len(primes) < count:
        if p < (1 << (bits - 1)):
            raise ValueError(f"not enough {bits}-bit NTT primes for 2N={two_n}")
        if is_prime(p):
            if seen >= skip:
                primes.append(p)
            seen += 1
        p -= two_n
    return primes


def order_primes_for_circuit(cands: list[int], scale_bits: int, ops: list[str],
                             count: int) -> list[int]:
    """Order a prime chain so the rescales track the scale through a known
    circuit (the reference's greedy, in its order).

    ops, in drop order, say what consumes each level, with d = log2(scale /
    2^scale_bits) and e = log2(q / 2^scale_bits): 'lin' (a plaintext multiply
    and rescale, d' = d - e), 'sq' (a square and rescale, d' = 2d - e), 'sq_z'
    (as 'sq', and records d_z, the Horner operand's) and 'h' (a multiply by
    that operand, d' = d + d_z - e). Each step takes the remaining prime that
    minimises |d'|; levels beyond ops take the rest, balanced by sign. The
    last element of the result is dropped first.
    """
    target = float(1 << scale_bits)
    rem = list(cands)
    d = d_z = 0.0
    drop_order = []

    def e_of(q):
        return math.log2(q / target)

    for op in ops[:count]:
        if op == "lin":
            nxt = lambda q: d - e_of(q)  # noqa: E731
        elif op in ("sq", "sq_z"):
            nxt = lambda q: 2 * d - e_of(q)  # noqa: E731
        elif op == "h":
            nxt = lambda q: d + d_z - e_of(q)  # noqa: E731
        else:
            raise ValueError(op)
        best = min(rem, key=lambda q: abs(nxt(q)))
        rem.remove(best)
        d = nxt(best)
        if op == "sq_z":
            d_z = d
        drop_order.append(best)
    acc = 0.0
    while len(drop_order) < count:
        best = min(rem, key=lambda q: abs(acc + e_of(q)))
        rem.remove(best)
        acc += e_of(best)
        drop_order.append(best)
    return list(reversed(drop_order))


def gen_balanced_ntt_primes(scale_bits: int, two_n: int, count: int,
                            exclude: tuple[int, ...] = ()) -> list[int]:
    """`count` NTT primes nearest 2^scale_bits from both sides, ordered so that
    a chain of squarings (d' = 2d - e) keeps its scale drift within one
    candidate gap (the reference's greedy). The last element is dropped
    first."""
    cands = balanced_prime_candidates(scale_bits, two_n, exclude)
    target = 1 << scale_bits
    if len(cands) < count:
        raise ValueError(f"only {len(cands)} balanced primes near 2^{scale_bits}")
    cands = cands[: count + 4]  # a small surplus improves the greedy
    d = 0.0
    order = []
    for _ in range(count):
        best = min(cands, key=lambda q: abs(math.log2(q / target) - 2 * d))
        cands.remove(best)
        d = 2 * d - math.log2(best / target)
        order.append(best)
    return list(reversed(order))


def balanced_prime_candidates(
    scale_bits: int, two_n: int, exclude: tuple[int, ...] = ()
) -> list[int]:
    """NTT primes within 1.5x of 2^scale_bits, nearest first (the reference's order)."""
    target = 1 << scale_bits
    lo, hi = int(target / 1.5), int(target * 1.5)
    cands = []
    p = hi // two_n * two_n + 1
    while p >= lo:
        if p not in exclude and is_prime(p) and p < (1 << 30):
            cands.append(p)
        p -= two_n
    cands.sort(key=lambda q: abs(math.log2(q / target)))
    return cands


@dataclasses.dataclass(frozen=True)
class CKKSParams:
    """Static CKKS parameters (hashable, so usable as a cache key)."""

    n: int  # ring degree (power of two); slots = n // 2
    q_primes: tuple[int, ...]  # ciphertext modulus chain
    p_primes: tuple[int, ...]  # key-switch special primes P
    scale_bits: int  # log2 of the encoding scale
    sigma: float = 3.2  # discrete gaussian error stddev
    hamming_weight: int = 0  # 0 -> dense uniform ternary secret
    # > 0: keygen also draws an ephemeral sparse secret of this weight and
    # the key-switch keys to and from it (sparse-secret encapsulation)
    eph_hamming_weight: int = 0
    # BGV / BFV plaintext modulus t (prime, t = 1 mod 2N); 0 -> CKKS
    plain_modulus: int = 0
    scale_words: int = 1  # limbs dropped per rescale

    def __post_init__(self):
        if self.n & (self.n - 1):
            raise ValueError("ring degree must be a power of two")
        for q in self.q_primes + self.p_primes:
            if q > MAX_WORD_PRIME or q % (2 * self.n) != 1:
                raise ValueError(f"prime {q} is not an NTT-friendly prime < 2^30")
        if len(set(self.q_primes + self.p_primes)) != len(self.q_primes) + len(
            self.p_primes
        ):
            raise ValueError("q/p primes must be pairwise distinct")

    @property
    def num_limbs(self) -> int:
        return len(self.q_primes)

    @property
    def alpha(self) -> int:
        """Number of special primes = key-switch decomposition group size."""
        return max(len(self.p_primes), 1)

    @property
    def dnum(self) -> int:
        """Gadget decomposition count at full level."""
        return math.ceil(len(self.q_primes) / self.alpha)

    @property
    def scale(self) -> float:
        return float(2**self.scale_bits)

    @property
    def slots(self) -> int:
        return self.n // 2

    @property
    def big_q(self) -> int:
        return math.prod(self.q_primes)

    @property
    def big_p(self) -> int:
        return math.prod(self.p_primes)

    @functools.cached_property
    def psi(self) -> tuple[int, ...]:
        """Primitive 2N-th roots of unity for every prime (q-chain then p-chain)."""
        return tuple(
            find_primitive_root_2n(q, 2 * self.n) for q in self.q_primes + self.p_primes
        )


def _mk(n: int, n_q: int, n_p: int, scale_bits: int, q0_bits: int = 30,
        qi_bits: int = 28, p_bits: int = 30) -> CKKSParams:
    two_n = 2 * n
    q0 = gen_ntt_primes(q0_bits, two_n, 1)
    qi = gen_ntt_primes(qi_bits, two_n, n_q - 1)
    # p-chain primes are drawn below the q0 prime from the same 30-bit class
    pp = gen_ntt_primes(p_bits, two_n, n_p, skip=1 if p_bits == q0_bits else 0)
    return CKKSParams(n=n, q_primes=tuple(q0 + qi), p_primes=tuple(pp),
                      scale_bits=scale_bits)


def _sparse(p: CKKSParams) -> CKKSParams:
    """A sparse base secret of weight 16 keeps the ModRaise overflow small."""
    return dataclasses.replace(p, hamming_weight=16)


def _dw_ci(**kw) -> CKKSParams:
    """Double-word CI chain: N=2^7, two 30-bit base primes, 22 28-bit limbs,
    4 special primes (dnum = 6), Delta = 2^56 over limb pairs."""
    two_n = 2 * 2**7
    q0 = gen_ntt_primes(30, two_n, 2)
    pp = gen_ntt_primes(30, two_n, 4, skip=2)
    qi = gen_ntt_primes(28, two_n, 22)
    return CKKSParams(n=2**7, q_primes=tuple(q0 + qi), p_primes=tuple(pp),
                      scale_bits=56, scale_words=2, **kw)


def _config5_boot_dw() -> CKKSParams:
    """N=2^16, Delta=2^56: 2 x 30-bit base primes + 46 balanced 28-bit limbs
    (23 double levels), 10 special primes (dnum = 5), dense base secret and
    an ephemeral sparse secret of weight 32."""
    two_n = 2 * 2**16
    q0 = gen_ntt_primes(30, two_n, 2)
    pp = gen_ntt_primes(30, two_n, 10, skip=2)
    picked = balanced_prime_candidates(28, two_n, exclude=tuple(q0 + pp))[:46]
    if len(picked) < 46:
        raise ValueError("not enough balanced 28-bit primes for config5_boot_dw")
    # pair +e with -e so that every pair's product stays near 2^56 (each
    # double rescale divides by one pair)
    picked.sort(key=lambda q: math.log2(q / 2**28))
    qi = []
    for i in range(23):
        qi.extend([picked[i], picked[45 - i]])
    return CKKSParams(n=2**16, q_primes=tuple(q0 + qi), p_primes=tuple(pp),
                      scale_bits=56, scale_words=2, eph_hamming_weight=32)


def _ci_xf() -> CKKSParams:
    """The transformer-block CI chain: N=2^8, a 30-bit base, 59 balanced
    28-bit limbs (about 30 sequential squarings double the scale drift each
    time), 6 special primes."""
    two_n = 2 * 2**8
    q0 = gen_ntt_primes(30, two_n, 1)
    pp = gen_ntt_primes(30, two_n, 6, skip=1)
    qi = gen_balanced_ntt_primes(28, two_n, 59, exclude=tuple(q0 + pp))
    return CKKSParams(n=2**8, q_primes=tuple(q0 + qi), p_primes=tuple(pp), scale_bits=28)


def _boot_mid_dw() -> CKKSParams:
    """The mid-scale double-word bootstrap: N=2^14, 2 x 30-bit base primes and
    34 balanced 28-bit limbs (17 double levels) paired as in
    config5_boot_dw, 6 special primes, eph h=32."""
    two_n = 2 * 2**14
    q0 = gen_ntt_primes(30, two_n, 2)
    pp = gen_ntt_primes(30, two_n, 6, skip=2)
    picked = balanced_prime_candidates(28, two_n, exclude=tuple(q0 + pp))[:34]
    if len(picked) < 34:
        raise ValueError("not enough balanced 28-bit primes for boot_mid_dw")
    picked.sort(key=lambda q: math.log2(q / 2**28))
    qi = []
    for i in range(17):
        qi.extend([picked[i], picked[33 - i]])
    return CKKSParams(n=2**14, q_primes=tuple(q0 + qi), p_primes=tuple(pp),
                      scale_bits=56, scale_words=2, eph_hamming_weight=32)


def _config5_boot_h() -> CKKSParams:
    """The bootstrappable config 5: N=2^16, a 30-bit base prime, 29 balanced
    28-bit limbs ordered for the factored bootstrap at radix_log 2 (8 CtS
    stages, the Chebyshev EvalMod's square, constant and 2 Horner steps and 8
    doublings, 8 StC stages), 5 special primes (dnum = 6) and a sparse h=64
    secret."""
    two_n = 2 * 2**16
    q0 = gen_ntt_primes(30, two_n, 1)
    pp = gen_ntt_primes(30, two_n, 5, skip=1)
    cands = balanced_prime_candidates(28, two_n, exclude=tuple(q0 + pp))
    ops = ["lin"] * 8 + ["sq_z", "lin", "h", "h"] + ["sq"] * 8 + ["lin"] * 8
    qi = order_primes_for_circuit(cands, 28, ops, 29)
    return CKKSParams(n=2**16, q_primes=tuple(q0 + qi), p_primes=tuple(pp), scale_bits=28,
                      hamming_weight=64)


def _with_t(p: CKKSParams, t: int | None = None) -> CKKSParams:
    """An integer-scheme preset: the chain of p with plaintext modulus t
    (default: the first 16-bit NTT prime for p's ring)."""
    t = t if t is not None else gen_ntt_primes(16, 2 * p.n, 1)[0]
    return dataclasses.replace(p, plain_modulus=t)


_PRESETS = {
    "tiny": lambda: _mk(n=2**6, n_q=3, n_p=1, scale_bits=28),
    "tiny2": lambda: _mk(n=2**8, n_q=4, n_p=2, scale_bits=28),
    "ci_small": lambda: _mk(n=2**10, n_q=6, n_p=2, scale_bits=28),
    "config1_ntt": lambda: _mk(n=2**12, n_q=1, n_p=1, scale_bits=28),
    "config2_rns": lambda: _mk(n=2**14, n_q=10, n_p=2, scale_bits=28),
    "config3_ckks": lambda: _mk(n=2**15, n_q=12, n_p=3, scale_bits=28),
    "config4_rotation": lambda: _mk(n=2**15, n_q=12, n_p=3, scale_bits=28),
    # N=2^16, 30 q-limbs, alpha=15 special primes, dnum=2: the headline
    # multiply configuration
    "config5_boot": lambda: _mk(n=2**16, n_q=30, n_p=15, scale_bits=28),
    # the double-word multiply configuration: N=2^16, 48 q-limbs, alpha=10,
    # dnum=5, scale_words=2
    "config5_boot_dw": _config5_boot_dw,
    # its CI-scale mirrors: a sparse base secret, or encapsulation
    "boot_dw_ci": lambda: _dw_ci(hamming_weight=16),
    "boot_dw_ci_enc": lambda: _dw_ci(eph_hamming_weight=16),
    # factored-transform CI: the smallest, and one with levels for 4 stages
    "fft_ci_small": lambda: _mk(n=2**7, n_q=6, n_p=2, scale_bits=28),
    "fft_ci": lambda: _mk(n=2**8, n_q=8, n_p=2, scale_bits=28),
    # CI bootstraps at N=2^7: dense transforms with the Taylor cos EvalMod
    # (sparse secret), factored transforms, Chebyshev EvalMod, and a dense
    # base secret with encapsulation
    "boot_ci": lambda: _sparse(_mk(n=2**7, n_q=15, n_p=3, scale_bits=28)),
    "boot_ci_f": lambda: _sparse(_mk(n=2**7, n_q=17, n_p=3, scale_bits=28)),
    "boot_ci_cheb": lambda: _sparse(_mk(n=2**7, n_q=13, n_p=3, scale_bits=28)),
    "boot_ci_enc": lambda: dataclasses.replace(_mk(n=2**7, n_q=13, n_p=3, scale_bits=28),
                                               eph_hamming_weight=16),
    # bootstrap plus compute headroom (N=2^7, 19 limbs, sparse h=16), the
    # composite-polynomial chain, and the attention and transformer CI chains
    "boot_ci_deep": lambda: _sparse(_mk(n=2**7, n_q=19, n_p=3, scale_bits=28)),
    "ci_deep": lambda: _mk(n=2**10, n_q=16, n_p=4, scale_bits=28),
    "ci_attn": lambda: _mk(n=2**8, n_q=24, n_p=4, scale_bits=28),
    "ci_xf": _ci_xf,
    # the sharded-bootstrap stress presets: double-word at N=2^14, and
    # single-word at N=2^12 (sparse h=16)
    "boot_mid_dw": _boot_mid_dw,
    "boot_mid": lambda: _sparse(_mk(n=2**12, n_q=20, n_p=4, scale_bits=28)),
    # config5_boot with the whole chain below 2^29 (q0 and P from the 29-bit
    # class), and the bootstrappable single-word config 5
    "config5_boot_s29": lambda: _mk(n=2**16, n_q=30, n_p=15, scale_bits=28, q0_bits=29,
                                    p_bits=29),
    "config5_boot_h": _config5_boot_h,
    # the integer schemes (one chain serves BGV and BFV): CI scale, the
    # smallest (128-slot rings), the production-width bfv_n16 (N=2^16, 30
    # q-limbs, alpha=15, dnum=2, t = 786433 = 6 * 2^17 + 1) and bfv_eq
    # (t = 257, the Fermat equality circuits' modulus, with a deep chain)
    "bgv_ci": lambda: _with_t(_mk(n=2**10, n_q=6, n_p=2, scale_bits=28)),
    "bgv_tiny": lambda: _with_t(_mk(n=2**8, n_q=4, n_p=2, scale_bits=28)),
    "bfv_ci": lambda: _with_t(_mk(n=2**10, n_q=6, n_p=2, scale_bits=28)),
    "bfv_tiny": lambda: _with_t(_mk(n=2**8, n_q=4, n_p=2, scale_bits=28)),
    "bfv_n16": lambda: _with_t(_mk(n=2**16, n_q=30, n_p=15, scale_bits=28), 786433),
    "bfv_eq": lambda: _with_t(_mk(n=2**7, n_q=12, n_p=3, scale_bits=28), 257),
}


@functools.lru_cache(maxsize=None)
def preset(name: str) -> CKKSParams:
    """Named parameter presets (every preset of gpufhe_tpu's registry)."""
    try:
        return _PRESETS[name]()
    except KeyError:
        raise KeyError(f"unknown preset {name!r}") from None


def make_context(name_or_params, *, device: str = "cuda"):
    """The device context (ops/context.py make_context) of a preset name or a
    CKKSParams, on the card unless `device` says otherwise."""
    from gpufhe_tpu_torch.ops.context import make_context as _make

    if isinstance(name_or_params, str):
        name_or_params = preset(name_or_params)
    return _make(name_or_params, device=device)
