"""The benchmark's plain reference (PyTorch int64 ops and NumPy).

It imports nothing of the library under test and takes nothing that the
library made: it works the secret out again from the seed's key stream,
computes what each circuit should give from the harness's messages, and
reads the library's outputs only to judge them.
"""

from __future__ import annotations

import numpy as np


def secret_key(key_rng: np.random.Generator, n: int) -> np.ndarray:
    """The dense ternary secret: the first draw from the key stream, N
    coefficients uniform in {-1, 0, 1} (the configurations' key generators
    draw it so, before anything else)."""
    return key_rng.integers(-1, 2, size=n, dtype=np.int64)
