"""The plain reference's ring arithmetic: Z_q[X]/(X^N + 1) over a chain of
primes, in plain PyTorch int64 ops (device-agnostic), and the CRT in Python
integers.

The negacyclic NTT is the textbook one, in natural order:

    fwd:  X_k = sum_j x_j psi^(j (2k + 1))          mod q
    inv:  x_j = N^-1 sum_k X_k psi^(-j (2k + 1))    mod q

with psi the primitive 2N-th root of unity found first by g^((q-1)/2N) for
g = 2, 3, ... . That is the evaluation-domain layout the library under test
documents for its ciphertexts (value k = the polynomial at psi^(2k+1)); the
reference computes it from the definition and its own root search, and
takes no table from the library. Every prime is below 2^31, so a product of
two residues fits an int64.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def find_psi(q: int, two_n: int) -> int:
    """The first g^((q-1)/2N), g = 2, 3, ..., whose N-th power is -1 mod q."""
    if (q - 1) % two_n:
        raise ValueError(f"{q} is not 1 mod {two_n}")
    for g in range(2, 100_000):
        psi = pow(g, (q - 1) // two_n, q)
        if pow(psi, two_n // 2, q) == q - 1:
            return psi
    raise ValueError(f"no primitive {two_n}-th root of unity mod {q}")


def _powers(base: torch.Tensor, q: torch.Tensor, n: int) -> torch.Tensor:
    """[K, n] table of base^j mod q (base, q: [K, 1]), by doubling blocks."""
    out = torch.ones((base.shape[0], n), dtype=torch.int64, device=base.device)
    step, width = base.clone(), 1
    while width < n:
        out[:, width:2 * width] = out[:, :width] * step % q
        step = step * step % q
        width *= 2
    return out


def _bit_reverse(n: int, device) -> torch.Tensor:
    bits = n.bit_length() - 1
    idx = torch.arange(n, device=device)
    rev = torch.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


class Ring:
    """NTT tables of one prime chain at ring degree n on one device."""

    def __init__(self, primes, n: int, device="cpu"):
        self.primes = tuple(int(q) for q in primes)
        self.n = n
        self.device = torch.device(device)

        def col(values):
            return torch.tensor(values, dtype=torch.int64, device=self.device)[:, None]

        self.q = col(self.primes)
        psi = [find_psi(q, 2 * n) for q in self.primes]
        self.psi_pow = _powers(col(psi), self.q, n)
        self.omega_pow = _powers(col([p * p % q for p, q in zip(psi, self.primes)]), self.q, n)
        inv_psi = [pow(p, -1, q) for p, q in zip(psi, self.primes)]
        self.omega_inv_pow = _powers(col([p * p % q for p, q in zip(inv_psi, self.primes)]),
                                     self.q, n)
        n_inv = col([pow(n, -1, q) for q in self.primes])
        self.psi_inv_pow_n = _powers(col(inv_psi), self.q, n) * n_inv % self.q
        self.rev = _bit_reverse(n, self.device)

    def _cyclic(self, x: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
        """Cyclic NTT of every limb row of x [K, n] (natural order in and out)."""
        k, n = x.shape
        q = self.q[:, :, None]
        a = x[:, self.rev]
        m = 1
        while m < n:
            blocks = a.reshape(k, n // (2 * m), 2, m)
            tw = pw[:, :: n // (2 * m)][:, None, :m]  # omega^(j n / 2m), j < m
            even, odd = blocks[:, :, 0, :], blocks[:, :, 1, :] * tw % q
            a = torch.stack([(even + odd) % q, (even - odd) % q], dim=2).reshape(k, n)
            m *= 2
        return a

    def fwd(self, x: torch.Tensor) -> torch.Tensor:
        """Coefficients [K, n] (any integers) -> evaluations [K, n]."""
        x = x.to(self.device, torch.int64) % self.q
        return self._cyclic(x * self.psi_pow % self.q, self.omega_pow)

    def inv(self, x: torch.Tensor) -> torch.Tensor:
        """Evaluations [K, n] -> canonical coefficients [K, n]."""
        x = x.to(self.device, torch.int64) % self.q
        return self._cyclic(x, self.omega_inv_pow) * self.psi_inv_pow_n % self.q


def crt_centered(residues: np.ndarray, primes) -> np.ndarray:
    """Canonical residues int64[K, N] -> the integers in (-Q/2, Q/2] they
    stand for (object array [N]), Q the product of the K primes."""
    primes = [int(q) for q in primes]
    big_q = math.prod(primes)
    acc = np.zeros(residues.shape[1], dtype=object)
    for row, q in zip(residues, primes):
        q_hat = big_q // q
        acc += row.astype(object) * (q_hat * pow(q_hat, -1, q) % big_q)
    acc %= big_q
    return np.where(acc > big_q // 2, acc - big_q, acc)


def decrypt_residues(c0, c1, s: np.ndarray, primes, device="cpu") -> np.ndarray:
    """c0 + c1 s for a two-component ciphertext in the evaluation domain
    over `primes` (c0, c1: int64 [K, N]), as canonical coefficient residues
    int64[K, N] on the host. s: the signed secret coefficients int64[N]."""
    ring = Ring(primes, len(s), device)
    s_eval = ring.fwd(torch.as_tensor(np.asarray(s, np.int64))[None, :].expand(len(primes), -1))
    c0 = torch.as_tensor(np.asarray(c0, np.int64), device=ring.device)
    c1 = torch.as_tensor(np.asarray(c1, np.int64), device=ring.device)
    return ring.inv((c0 + c1 * s_eval % ring.q) % ring.q).cpu().numpy()
