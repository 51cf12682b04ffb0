"""The plain reference for BGV and BFV outputs: the plaintext polynomial the
circuit should give, and the decryption of a ciphertext with the secret
worked out again from the seed.

With t = 1 mod 2N the plaintext ring Z_t[X]/(X^N + 1) splits into N slots
(the evaluations at the primitive 2N-th roots of unity mod t), so a slotwise
power of a message is the power of its polynomial in that ring. Messages
are drawn as uniform coefficients mod t, which makes every slot uniform mod
t as well; the expected output is computed by an NTT mod t in whatever
slot order, since the comparison is of coefficients.

BFV (Fan-Vercauteren): m = round(t x / Q) mod t, x = c0 + c1 s centred mod Q.
BGV (Brakerski-Gentry-Vaikuntanathan, with the modulus switch that scales
the message by each dropped prime q mod t): m = factor (x mod t), x centred
mod the active Q, factor the product of the dropped primes mod t.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fhebench.reference.ring import Ring, crt_centered, decrypt_residues


def power_poly(m: np.ndarray, t: int, squarings: int, dtype=torch.int64,
               device="cpu") -> np.ndarray:
    """m(X)^(2^squarings) in Z_t[X]/(X^N + 1) as coefficients int64[N].

    `dtype` is the integer type the slotwise products are taken in: int64
    holds every product of two residues below 2^31; a narrower type (the
    control) wraps."""
    ring = Ring((t,), len(m), device)
    slots = ring.fwd(torch.as_tensor(np.asarray(m, np.int64))[None, :])
    tq = ring.q.to(dtype)
    x = slots.to(dtype)
    for _ in range(squarings):
        x = x * x % tq
    return ring.inv(x.to(torch.int64) % ring.q)[0].cpu().numpy()


def bfv_decrypt(c0, c1, s: np.ndarray, primes, t: int, device="cpu") -> np.ndarray:
    x = crt_centered(decrypt_residues(c0, c1, s, primes, device), primes)
    big_q = math.prod(int(q) for q in primes)
    # round(t x / Q) = floor((2 t x + Q) / (2 Q)), in Python integers
    return np.asarray(((2 * t * x + big_q) // (2 * big_q)) % t, dtype=np.int64)


def bgv_factor(primes, t: int, level: int, squarings: int) -> int:
    """The message factor after `squarings` squarings from `level`, each
    followed by one modulus switch (factor -> factor^2 q_last mod t)."""
    f = 1
    for _ in range(squarings):
        f = f * f * (int(primes[level - 1]) % t) % t
        level -= 1
    return f


def bgv_decrypt(c0, c1, s: np.ndarray, primes, t: int, factor: int,
                device="cpu") -> np.ndarray:
    x = crt_centered(decrypt_residues(c0, c1, s, primes, device), primes)
    return np.asarray((x % t) * factor % t, dtype=np.int64)
