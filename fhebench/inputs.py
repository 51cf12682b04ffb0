"""The benchmark's inputs, all from --seed: one NumPy stream per purpose, so
the library's key generator, the messages, the encryption noise and the
choice of the requests checked never share draws. The same seed gives the
same inputs; every seed gives the same sizes."""

from __future__ import annotations

import numpy as np

STREAMS = {"keys": 1, "messages": 2, "encrypt": 3, "sample": 4}


def stream(seed: int, name: str) -> np.random.Generator:
    return np.random.default_rng([seed & (2**64 - 1), STREAMS[name]])


def messages(mix: dict, n: int, t: int, seed: int) -> list[np.ndarray]:
    """The pool's messages: complex slot vectors (CKKS) or plaintext
    coefficients mod t (BGV, BFV), by the mix's distribution."""
    rng = stream(seed, "messages")
    dist = mix["message"]["dist"]
    out = []
    for _ in range(mix["pool"]):
        if dist == "complex_gauss":  # s (N(0,1) + i N(0,1)) in every slot
            s = mix["message"]["scale"]
            out.append((rng.normal(size=n // 2) + 1j * rng.normal(size=n // 2)) * s)
        elif dist == "unit_phase":  # e^(i theta), theta uniform
            out.append(np.exp(1j * rng.uniform(0.0, 2 * np.pi, size=n // 2)))
        elif dist == "uniform_mod_t":  # uniform coefficients, so uniform slots
            out.append(rng.integers(0, t, size=n, dtype=np.int64))
        else:
            raise ValueError(f"unknown message distribution {dist!r}")
    return out
