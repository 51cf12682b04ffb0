"""Private information retrieval (PIR) over BFV: oblivious record lookup.

The classic exact-FHE application: a client encrypts a one-hot selection
vector for row i; the server — holding a PLAINTEXT database of integer
records mod t — computes record = db.T @ onehot homomorphically (one BSGS
plaintext-matrix product, ciphertext/linalg.py) and returns one ciphertext.
The server learns nothing about i; the client decrypts its record.

Runs on any exact-integer backend (BFV or BGV — both expose the orbit-ring
linalg surface); BFV's scale-invariant Delta embedding is the usual PIR
choice. A copy of gpufhe_tpu/models/pir.py over the port's linalg and its
integer backends.
"""

from __future__ import annotations

import numpy as np

from gpufhe_tpu_torch.ciphertext import linalg


def pir_matrix(db: np.ndarray, n_slots: int) -> np.ndarray:
    """Server-side plaintext operator: db [rows, cols] -> [n_slots, n_slots]
    padded db.T so that A @ onehot(i) lands record i in the first `cols`
    slots."""
    rows, cols = db.shape
    assert rows <= n_slots and cols <= n_slots, "database exceeds slot capacity"
    a = np.zeros((n_slots, n_slots), dtype=np.int64)
    a[:cols, :rows] = db.T
    return a


def encode_query(be, index: int, rows: int) -> np.ndarray:
    """Client-side one-hot selection vector (orbit order, both rings)."""
    n_s = be.params.slots
    assert 0 <= index < rows <= n_s
    q = np.zeros(n_s, dtype=np.int64)
    q[index] = 1
    return q


def pir_retrieve(be, ct_query, db: np.ndarray):
    """Server: one BSGS product; returns the encrypted record ciphertext."""
    return linalg.matmul_plain(be, ct_query, pir_matrix(db, be.params.slots))


def pir_rotations(n_slots: int) -> tuple[int, ...]:
    """Galois rotation steps the server-side BSGS product needs (keygen)."""
    return tuple(linalg.bsgs_rotations(n_slots))
