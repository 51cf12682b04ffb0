"""Encrypted linear layer: cleartext weight matrix x encrypted vector.

y = W x + b on an encrypted slot vector, via the BSGS plaintext-matrix
product (ciphertext/linalg.py) — the building block for private-inference
pipelines (each layer costs one level + one hoisted rotation fan). A copy
of gpufhe_tpu/models/linear.py over the port's linalg.
"""

from __future__ import annotations

import numpy as np

from gpufhe_tpu_torch.ciphertext.linalg import BsgsPlan, bsgs_rotations


class EncryptedLinear:
    """W: [slots, slots] (zero-pad smaller layers), b: [slots] or scalar."""

    def __init__(self, be, w: np.ndarray, b=0.0, level: int | None = None):
        self.be = be
        n_s = be.params.slots
        assert w.shape == (n_s, n_s)
        self.level = level if level is not None else be.params.num_limbs
        self.plan = BsgsPlan(be, w.astype(np.complex128), None, self.level)
        self.b = b

    @staticmethod
    def rotations(slots: int) -> list[int]:
        return bsgs_rotations(slots)

    def __call__(self, ct):
        out = self.plan.apply(ct)
        if np.any(self.b != 0.0):
            out = self.be.add_plain(out, self.b)
        return out
