"""The plain reference for CKKS outputs: decrypt with the secret worked out
again from the seed, decode by the canonical embedding, and measure the gap
to the message the circuit should give.

Slot j of a plaintext m(X) at scale Delta is m(zeta^(5^j)) / Delta with
zeta = e^(i pi / N), j < N/2: the standard CKKS packing (Cheon, Kim, Kim and
Song, Asiacrypt 2017), computed here by one complex FFT.
"""

from __future__ import annotations

import numpy as np

from fhebench.reference.ring import crt_centered, decrypt_residues


def slot_positions(n: int) -> np.ndarray:
    """Index p with 2p + 1 = 5^j mod 2N, for each slot j."""
    out = np.empty(n // 2, dtype=np.int64)
    g = 1
    for j in range(n // 2):
        out[j] = (g - 1) // 2
        g = g * 5 % (2 * n)
    return out


def decode(coeffs: np.ndarray, scale: float) -> np.ndarray:
    """Signed integer coefficients (object or int64 [N]) -> complex slots."""
    n = len(coeffs)
    m = np.asarray(coeffs, dtype=object).astype(np.float64) / scale
    # m(zeta^(2p+1)) = sum_k (m_k zeta^k) e^(2 pi i k p / N) = N ifft(m zeta^k)[p]
    ev = np.fft.ifft(m * np.exp(1j * np.pi * np.arange(n) / n)) * n
    return ev[slot_positions(n)]


def decrypt_decode(c0, c1, s: np.ndarray, primes, scale: float, device="cpu") -> np.ndarray:
    """The slots of a two-component ciphertext over `primes` at `scale`."""
    return decode(crt_centered(decrypt_residues(c0, c1, s, primes, device), primes), scale)


def squared_scale(scale: float, primes, level: int, squarings: int, words: int) -> float:
    """The scale after `squarings` multiplies of a ciphertext at `level` by
    itself, each followed by `words` rescales (each divides by the last
    active prime), starting at `scale`."""
    for _ in range(squarings):
        scale = scale * scale
        for _ in range(words):
            scale /= primes[level - 1]
            level -= 1
    return scale


def max_gap(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max())
