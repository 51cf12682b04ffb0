"""Prime and root-of-unity helpers and the golden negacyclic NTT (counterpart
of gpufhe_tpu/golden/ntt.py).

The transform the whole framework is held against:

    fwd:  X_k = sum_j x_j psi^j omega^(j k)              mod q, omega = psi^2
    inv:  x_j = N^-1 psi^-j sum_k X_k omega^(-j k)       mod q

in natural order, psi a primitive 2N-th root of unity mod q (the negacyclic
wrap: a product in the transform domain is a product mod X^N + 1). The
transform is exact, so any algorithm gives the reference's values. Below
2^62 it runs in the native library (golden/native.py, C) where a C compiler
is found; otherwise, and at any width, an iterative radix-2 pass per stage
in numpy: int64 below 2^31, Python integers (object arrays) from there on,
so the 60-bit prime of the config1 vector is exact too. It is host numpy on
purpose and reaches none of the port's kernels (golden/arithmetic.py).
"""

from __future__ import annotations

import functools

import numpy as np

from gpufhe_tpu_torch.golden import native


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def find_primitive_root_2n(q: int, two_n: int) -> int:
    """Smallest-found psi with multiplicative order exactly two_n mod q."""
    if (q - 1) % two_n:
        raise ValueError("q must be NTT-friendly: q = 1 mod 2N")
    for g in range(2, 10_000):
        psi = pow(g, (q - 1) // two_n, q)
        if pow(psi, two_n // 2, q) == q - 1:  # psi^N == -1 -> order is 2N
            return psi
    raise ValueError(f"no primitive {two_n}-th root found mod {q}")


def _dtype_for(q: int):
    return np.int64 if q < (1 << 31) else object


@functools.lru_cache(maxsize=None)
def _power_table(root: int, n: int, q: int) -> np.ndarray:
    """[root^0, root^1, ..., root^(n-1)] mod q."""
    out = np.empty(n, dtype=_dtype_for(q))
    acc = 1
    for i in range(n):
        out[i] = acc
        acc = acc * root % q
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=None)
def _bit_reverse(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _cyclic_ntt(x: np.ndarray, omega: int, q: int) -> np.ndarray:
    """Cyclic NTT of length n along the last axis, natural order in and out:
    bit-reversed input, then log2(n) butterfly stages on [blocks, 2, m]."""
    n = x.shape[-1]
    pw = _power_table(omega, n, q)
    a = x[..., _bit_reverse(n)]
    m = 1
    while m < n:
        blocks = a.reshape(*a.shape[:-1], n // (2 * m), 2, m)
        even = blocks[..., 0, :]
        odd = blocks[..., 1, :] * pw[:: n // (2 * m)][:m] % q
        a = np.stack([(even + odd) % q, (even - odd) % q], axis=-2).reshape(x.shape)
        m *= 2
    return a


def _native(x, q: int, psi: int, inverse: bool):
    """The native transform (int64), or None where it does not run."""
    if q >= (1 << 62):
        return None
    out = native.ntt_u64(np.asarray(x, dtype=np.int64) % q, q, psi, inverse)
    return None if out is None else out.astype(np.int64)


def ntt_fwd(x, q: int, psi: int) -> np.ndarray:
    """Negacyclic forward NTT along the last axis (natural order in and out)."""
    out = _native(x, q, psi, inverse=False)
    if out is not None:
        return out
    x = np.asarray(x, dtype=_dtype_for(q)) % q
    n = x.shape[-1]
    y = x * _power_table(psi, n, q) % q
    return _cyclic_ntt(y, psi * psi % q, q)


def ntt_inv(X, q: int, psi: int) -> np.ndarray:
    """Negacyclic inverse NTT along the last axis; exact inverse of ntt_fwd."""
    out = _native(X, q, psi, inverse=True)
    if out is not None:
        return out
    X = np.asarray(X, dtype=_dtype_for(q)) % q
    n = X.shape[-1]
    y = _cyclic_ntt(X, pow(int(psi) * int(psi) % q, -1, q), q)
    return y * _power_table(pow(psi, -1, q), n, q) % q * pow(n, -1, q) % q


def ntt_naive(x, q: int, psi: int) -> np.ndarray:
    """The O(N^2) definition, for checking ntt_fwd at small N."""
    x = np.asarray(x, dtype=object) % q
    n = x.shape[-1]
    out = np.empty(n, dtype=object)
    for k in range(n):
        out[k] = sum(int(x[j]) * pow(psi, j * (2 * k + 1), q) % q for j in range(n)) % q
    return out.astype(_dtype_for(q)) if q < (1 << 31) else out


def negacyclic_mul(a, b, q: int) -> np.ndarray:
    """Schoolbook product mod (X^N + 1, q): the NTT-free oracle."""
    a = np.asarray(a, dtype=object)
    b = np.asarray(b, dtype=object)
    n = a.shape[-1]
    out = np.zeros(n, dtype=object)
    for i in range(n):
        ai = int(a[i])
        if ai == 0:
            continue
        for j in range(n):
            k = i + j
            term = ai * int(b[j])
            if k >= n:
                out[k - n] = (out[k - n] - term) % q
            else:
                out[k] = (out[k] + term) % q
    return out.astype(_dtype_for(q)) if q < (1 << 31) else out
