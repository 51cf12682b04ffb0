"""Prime and root-of-unity helpers (counterpart of gpufhe_tpu/golden/ntt.py:27-60).

The transforms themselves live in ops/ntt.py: the port's golden layer runs
its polynomial products through the port's own NTT.
"""

from __future__ import annotations


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
