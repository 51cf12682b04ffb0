"""Golden RNS tooling in numpy (counterpart of gpufhe_tpu/golden/rns.py): the
approximate base conversion, the rescale and the ModDown that
primitives/rns.py and kernel K3 are held against, bit for bit.

  base conversion  B -> t :  y_t = sum_i [x_i * bhat_i^{-1}]_{b_i} * [bhat_i]_t  (mod t)
                             (off by a small multiple of B, which ModDown and
                             the rescale absorb as noise)
  rescale by q_last:         c'_i = [q_last^{-1}]_{q_i} * (c_i - centred([c]_{q_last})) mod q_i
  ModDown by P:              c'_j = [P^{-1}]_{q_j} * (c_j - conv_{P->q_j}([c]_P)) mod q_j

Arrays are int64[K, N] canonical residues (primes below 2^31, so every
product fits int64); sums over source limbs are reduced term by term.
conv_matrix and qhat_inv also build the tables of the port's K3.
"""

from __future__ import annotations

import math

import numpy as np


def conv_matrix(src: tuple[int, ...], dst: tuple[int, ...]) -> np.ndarray:
    """M[t, i] = [prod(src)/src_i mod dst_t]; int64[len(dst), len(src)]."""
    big = math.prod(src)
    return np.array([[(big // b) % t for b in src] for t in dst], dtype=np.int64)


def qhat_inv(src: tuple[int, ...]) -> np.ndarray:
    """[(prod(src)/src_i)^{-1} mod src_i]; int64[len(src)]."""
    big = math.prod(src)
    return np.array([pow(big // b, -1, b) for b in src], dtype=np.int64)


def base_convert(x: np.ndarray, src: tuple[int, ...], dst: tuple[int, ...]) -> np.ndarray:
    """Approximate fast base conversion int64[len(src), N] -> int64[len(dst), N].

    The result is congruent to x + u * prod(src) for a small |u| <= len(src)/2
    per coefficient (the classic approximation error).
    """
    src_arr = np.array(src, dtype=np.int64)[:, None]
    v = x * qhat_inv(src)[:, None] % src_arr
    m = conv_matrix(src, dst)
    out = np.empty((len(dst), x.shape[1]), dtype=np.int64)
    for t_idx, t in enumerate(dst):
        acc = np.zeros(x.shape[1], dtype=np.int64)
        for i in range(len(src)):
            acc = (acc + v[i] * m[t_idx, i]) % t  # per-term reduce: no overflow
        out[t_idx] = acc
    return out


def center_reduce(x: np.ndarray, q_from: int, dst: tuple[int, ...]) -> np.ndarray:
    """The exact lift of int64[N] residues mod q_from (centred) into each
    destination prime: int64[len(dst), N]."""
    centered = np.where(x > q_from // 2, x - q_from, x)  # in (-q/2, q/2]
    return np.stack([centered % t for t in dst]).astype(np.int64)


def rescale_coeff(x: np.ndarray, primes: tuple[int, ...]) -> np.ndarray:
    """Drop the last limb: (x - centred([x]_last)) / q_last on the others.

    x: int64[K, N] in the coefficient domain; returns int64[K-1, N]."""
    q_last = primes[-1]
    lifted = center_reduce(x[-1], q_last, primes[:-1])
    out = np.empty((len(primes) - 1, x.shape[1]), dtype=np.int64)
    for i, q in enumerate(primes[:-1]):
        out[i] = (x[i] - lifted[i]) % q * pow(q_last, -1, q) % q
    return out


def mod_down_coeff(x: np.ndarray, q_primes: tuple[int, ...],
                   p_primes: tuple[int, ...]) -> np.ndarray:
    """Divide by P = prod(p_primes): int64[K+alpha, N] -> int64[K, N], the
    first K rows the Q-basis limbs, the last alpha the P-basis limbs
    (coefficient domain)."""
    k = len(q_primes)
    big_p = math.prod(p_primes)
    p_part = base_convert(x[k:], p_primes, q_primes)
    out = np.empty((k, x.shape[1]), dtype=np.int64)
    for i, q in enumerate(q_primes):
        out[i] = (x[i] - p_part[i]) % q * pow(big_p, -1, q) % q
    return out
