"""CKKS parameters, presets and NTT-friendly prime generation.

Counterpart of gpufhe_tpu/params/params.py. The presets draw the same primes
in the same order, so a preset here and there names the same chain
(tests/test_torch_params.py checks every prime). Only the CKKS presets of the
multiply path are carried over.

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


@dataclasses.dataclass(frozen=True)
class CKKSParams:
    """Static CKKS parameters (hashable, so usable as a cache key)."""

    n: int  # ring degree (power of two); slots = n // 2
    q_primes: tuple[int, ...]  # ciphertext modulus chain
    p_primes: tuple[int, ...]  # key-switch special primes P
    scale_bits: int  # log2 of the encoding scale
    sigma: float = 3.2  # discrete gaussian error stddev
    hamming_weight: int = 0  # 0 -> dense uniform ternary secret
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
}


@functools.lru_cache(maxsize=None)
def preset(name: str) -> CKKSParams:
    """Named parameter presets (the CKKS subset of gpufhe_tpu's registry)."""
    try:
        return _PRESETS[name]()
    except KeyError:
        raise KeyError(f"unknown preset {name!r}") from None
