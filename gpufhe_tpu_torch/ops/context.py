"""Device context: per-prime constants and NTT tables, held on one device.

Counterpart of gpufhe_tpu/ops/context.py. The reference stores its four-step
DFT matrices as signed int8 digit planes for the TPU's matrix unit; the port's
NTT (ops/ntt.py, kernel csrc/ntt.cu) runs radix-2 butterflies on 64-bit
integers instead, so its tables are root powers. Every table covers the FULL
prime chain (q-chain then p-chain); a transform selects its rows with a limb
index vector, so one table set serves every level.

Four-step split N = n1 * n2 (fourstep_split, as in the reference). With
j = j1*n2 + j2 and k = k2*n1 + k1 the forward negacyclic transform is

    X[k2*n1 + k1] = sum_j2 w2^(j2 k2) * psi^(j2 (2 k1 + 1)) *
                    sum_j1 x[j1*n2 + j2] * psi1^j1 * w1^(j1 k1)

with psi1 = psi^n2, w1 = psi^(2 n2) and w2 = psi^(2 n1). The tables per
direction are the root powers w^e = psi^(2e) for e < N/2 (every sub-transform
root is a power of w), a 1-D table over j1 (the psi1 pre-twist, or for the
inverse the psi1^-j1 / N post-scale), and two rows that give the twiddle
psi^(+-e), e = j2 (2 k1 + 1) mod 2N, as lo[e mod n1] * hi[e div n1]: lo holds
psi^(+-e) for e < n1 and hi holds psi^(+-n1 e) for e < 2 n2. No table has N
entries per prime besides w.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from gpufhe_tpu_torch.golden.arithmetic import mont_constants
from gpufhe_tpu_torch.params.params import CKKSParams


def fourstep_split(n: int) -> tuple[int, int]:
    """Factor n = n1 * n2 with n1 >= n2, both powers of two (n1 = n2 or 2*n2)."""
    log = n.bit_length() - 1
    n1 = 1 << ((log + 1) // 2)
    return n1, n // n1


@dataclasses.dataclass(frozen=True)
class NTTTables:
    """One direction's tables, int64, stacked over the full prime chain."""

    w: torch.Tensor  # [L, N/2]   w^e (forward) or w^-e (inverse), w = psi^2
    tab1d: torch.Tensor  # [L, n1]    psi1^j1 (fwd) | psi1^-j1 * N^-1 (inv)
    lo: torch.Tensor  # [L, n1]    psi^e (fwd) | psi^-e (inv), e < n1
    hi: torch.Tensor  # [L, 2*n2]  psi^(n1 e) (fwd) | psi^-(n1 e) (inv)


@dataclasses.dataclass(frozen=True)
class Context:
    """All per-limb device constants for the q-chain followed by the p-chain."""

    primes: tuple[int, ...]
    n: int
    n1: int
    n2: int
    q: torch.Tensor  # int64[L]
    qinv_neg: torch.Tensor  # int64[L]  -q^-1 mod 2^32
    r2: torch.Tensor  # int64[L]  2^64 mod q
    mu: torch.Tensor  # int64[L]  floor(2^64 / q), the kernels' Barrett constant
    ntt_fwd: NTTTables
    ntt_inv: NTTTables
    cache: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def num_total(self) -> int:
        return len(self.primes)

    def index(self, limbs, dtype=torch.int64) -> torch.Tensor:
        """Chain-row index tensor (slice, range or list of rows) on this device.

        Cached per selection, which keeps the host-to-device copy, and the
        stream sync that it implies, off the hot path.
        """
        key = ("index", dtype, self._rows(limbs))
        if key not in self.cache:
            self.cache[key] = torch.tensor(key[2], dtype=dtype, device=self.device)
        return self.cache[key]

    def col(self, name: str, limbs) -> torch.Tensor:
        """Per-limb constant shaped [L, 1], broadcast-ready against [L, N] (cached)."""
        key = ("col", name, self._rows(limbs))
        if key not in self.cache:
            self.cache[key] = getattr(self, name)[self.index(limbs)][:, None]
        return self.cache[key]

    def _rows(self, limbs) -> tuple[int, ...]:
        if isinstance(limbs, slice):
            limbs = range(self.num_total)[limbs]
        return tuple(int(i) for i in limbs)


def pow_table(base: np.ndarray, count: int, q: np.ndarray) -> np.ndarray:
    """[L, count] table of base^e mod q per row, vectorised over rows.

    Two short sequential loops (within a block, then across blocks) and one
    broadcast product: products of canonical residues < 2^60 are exact.
    """
    base = np.asarray(base, dtype=np.int64)[:, None]
    q = np.asarray(q, dtype=np.int64)[:, None]
    blk = min(count, 512)
    first = np.empty((base.shape[0], blk), dtype=np.int64)
    first[:, :1] = 1
    for i in range(1, blk):
        first[:, i : i + 1] = first[:, i - 1 : i] * base % q
    step = first[:, -1:] * base % q  # base^blk
    nblk = -(-count // blk)
    steps = np.empty((base.shape[0], nblk), dtype=np.int64)
    steps[:, :1] = 1
    for i in range(1, nblk):
        steps[:, i : i + 1] = steps[:, i - 1 : i] * step % q
    out = steps[:, :, None] * first[:, None, :] % q[:, :, None]
    return out.reshape(base.shape[0], -1)[:, :count]


def ntt_tables_np(primes, psis, n: int) -> tuple[dict, dict]:
    """Host-side forward and inverse tables (int64 numpy) for a prime chain."""
    n1, n2 = fourstep_split(n)
    two_n = 2 * n
    q = np.asarray(primes, dtype=np.int64)
    pp = pow_table(np.asarray(psis, dtype=np.int64), two_n, q)  # psi^e, e < 2N
    neg = lambda e: (two_n - e) % two_n  # psi^-e = psi^(2N - e)
    e = np.arange(n // 2)
    j1 = np.arange(n1)
    hi = n1 * np.arange(2 * n2)
    n_inv = np.array([pow(n, -1, int(p)) for p in primes], dtype=np.int64)[:, None]
    fwd = {"w": pp[:, 2 * e], "tab1d": pp[:, n2 * j1], "lo": pp[:, j1], "hi": pp[:, hi]}
    inv = {
        "w": pp[:, neg(2 * e)],
        "tab1d": pp[:, neg(n2 * j1)] * n_inv % q[:, None],
        "lo": pp[:, neg(j1)],
        "hi": pp[:, neg(hi)],
    }
    return fwd, inv


@functools.lru_cache(maxsize=4)
def make_context(params: CKKSParams, device: str = "cuda") -> Context:
    """Build the device context for a parameter set (host precompute, one upload)."""
    primes = params.q_primes + params.p_primes
    n = params.n
    n1, n2 = fourstep_split(n)
    consts = [mont_constants(q) for q in primes]
    fwd, inv = ntt_tables_np(primes, params.psi, n)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)

    return Context(
        primes=primes,
        n=n,
        n1=n1,
        n2=n2,
        q=dev(primes),
        qinv_neg=dev([c[0] for c in consts]),
        r2=dev([c[1] for c in consts]),
        mu=dev([(1 << 64) // q for q in primes]),
        ntt_fwd=NTTTables(**{k: dev(v) for k, v in fwd.items()}),
        ntt_inv=NTTTables(**{k: dev(v) for k, v in inv.items()}),
    )
