"""Host side of CKKS: samplers, canonical-embedding encoder, key generation.

Counterpart of the host parts of gpufhe_tpu/golden/ckks.py. Randomness comes
from an explicit numpy.random.Generator, drawn in the reference's order, so a
seed gives keys and ciphertexts bit-identical to the reference's. Polynomial
products run through the port's own NTT on the context's device; keys are
int64 tensors there (canonical, NTT domain).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from gpufhe_tpu_torch.ops.context import Context
from gpufhe_tpu_torch.ops.modops import add_mod, mul_mod, neg_mod
from gpufhe_tpu_torch.ops.ntt import ntt_fwd
from gpufhe_tpu_torch.params.params import CKKSParams

# ---------------------------------------------------------------------------
# Encoder: canonical embedding via FFT over the odd powers of zeta = e^(i*pi/N)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _slot_positions(n: int) -> np.ndarray:
    """j-th slot evaluates m at zeta^(5^j); position (5^j - 1)/2 in the odd grid."""
    two_n = 2 * n
    idx = np.empty(n // 2, dtype=np.int64)
    g = 1
    for j in range(n // 2):
        idx[j] = (g - 1) // 2
        g = g * 5 % two_n
    return idx


def encode(z: np.ndarray, scale: float, primes: tuple[int, ...], n: int) -> np.ndarray:
    """complex[n//2] -> int64[K, n] coefficient-domain plaintext at scale."""
    z = np.asarray(z, dtype=np.complex128)
    if z.shape != (n // 2,):
        raise ValueError(f"expected {n // 2} slots, got shape {z.shape}")
    pos = _slot_positions(n)
    ev = np.zeros(n, dtype=np.complex128)
    ev[pos] = z
    ev[(n - 1) - pos] = np.conj(z)  # zeta^(2n - t) = conj(zeta^t)
    k = np.arange(n)
    tw = np.exp(1j * np.pi * k / n)
    m = np.real(np.fft.fft(ev) / n / tw)
    scaled = np.rint(m * scale)
    if np.abs(scaled).max() < 2**62:  # int64 fast path (same residues)
        coeffs = scaled.astype(np.int64)
        return np.remainder(coeffs[None, :], np.asarray(primes, dtype=np.int64)[:, None])
    coeffs = scaled.astype(object)
    return np.stack([(coeffs % q).astype(np.int64) for q in primes])


def crt_compose_centered(x: np.ndarray, primes: tuple[int, ...]) -> np.ndarray:
    """int64[K, N] RNS residues -> object[N] centered integers in (-Q/2, Q/2]."""
    big_q = math.prod(primes)
    acc = np.zeros(x.shape[1], dtype=object)
    for i, q in enumerate(primes):
        qhat = big_q // q
        acc += x[i].astype(object) * (pow(qhat, -1, q) * qhat % big_q)
    acc %= big_q
    return np.where(acc > big_q // 2, acc - big_q, acc)


def decode(pt: np.ndarray, scale: float, primes: tuple[int, ...], n: int) -> np.ndarray:
    """int64[K, n] coefficient-domain plaintext -> complex[n//2] slot values."""
    coeffs = crt_compose_centered(pt, primes).astype(np.float64) / scale
    k = np.arange(n)
    tw = np.exp(1j * np.pi * k / n)
    ev = np.fft.ifft(coeffs * tw) * n
    return ev[_slot_positions(n)]


# ---------------------------------------------------------------------------
# Sampling (explicit rng, the reference's draw order)
# ---------------------------------------------------------------------------


def sample_uniform(rng: np.random.Generator, primes: tuple[int, ...], n: int) -> np.ndarray:
    return np.stack([rng.integers(0, q, size=n, dtype=np.int64) for q in primes])


def sample_ternary(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(-1, 2, size=n, dtype=np.int64)


def sample_sparse_ternary(rng: np.random.Generator, n: int, h: int) -> np.ndarray:
    """Ternary secret with exactly h nonzero (+-1) coefficients."""
    s = np.zeros(n, dtype=np.int64)
    idx = rng.choice(n, size=h, replace=False)
    s[idx] = rng.integers(0, 2, size=h, dtype=np.int64) * 2 - 1
    return s


def sample_gauss(rng: np.random.Generator, n: int, sigma: float) -> np.ndarray:
    return np.rint(rng.normal(0.0, sigma, size=n)).astype(np.int64)


def small_to_rns(small: np.ndarray, primes: tuple[int, ...]) -> np.ndarray:
    """Signed small poly int64[N] -> canonical residues int64[K, N]."""
    return np.remainder(small[None, :], np.asarray(primes, dtype=np.int64)[:, None])


# ---------------------------------------------------------------------------
# Keys (canonical, NTT domain, on the context's device)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SecretKey:
    s: np.ndarray  # signed ternary int64[N], host only


@dataclasses.dataclass
class PublicKey:
    b: torch.Tensor  # int64[L, N] NTT domain: -a*s + e
    a: torch.Tensor  # int64[L, N] NTT domain


@dataclasses.dataclass
class KSKey:
    """Hybrid key-switch key: dnum gadget rows over the full Q*P chain."""

    b: torch.Tensor  # int64[dnum, L+alpha, N] NTT domain
    a: torch.Tensor  # int64[dnum, L+alpha, N] NTT domain


def ntt_small(small: np.ndarray, primes: tuple[int, ...], ctx: Context) -> torch.Tensor:
    """Signed small poly -> NTT-domain residues over the given chain prefix rows."""
    rows = [ctx.primes.index(p) for p in primes]
    x = torch.from_numpy(small_to_rns(small, primes)).to(ctx.device)
    return ntt_fwd(x, ctx, limbs=rows)


def gadget_factors(params: CKKSParams) -> list[int]:
    """g_d = P * Qhat_d * [Qhat_d^{-1}]_{Q_d} over the full-level basis."""
    alpha = params.alpha
    qs = params.q_primes
    big_q, big_p = params.big_q, params.big_p
    out = []
    for d0 in range(0, len(qs), alpha):
        q_d = math.prod(qs[d0 : d0 + alpha])
        qhat_d = big_q // q_d
        out.append(big_p * qhat_d * pow(qhat_d, -1, q_d) % (big_q * big_p))
    return out


def keygen(params: CKKSParams, rng: np.random.Generator, ctx: Context):
    """Secret + public key (reference golden/ckks.py keygen, same draws)."""
    primes = params.q_primes
    if params.hamming_weight:
        s = sample_sparse_ternary(rng, params.n, params.hamming_weight)
    else:
        s = sample_ternary(rng, params.n)
    s_ntt = ntt_small(s, primes, ctx)
    a = torch.from_numpy(sample_uniform(rng, primes, params.n)).to(ctx.device)
    e = ntt_small(sample_gauss(rng, params.n, params.sigma), primes, ctx)
    q = ctx.col("q", range(len(primes)))
    b = add_mod(mul_mod(neg_mod(a, q), s_ntt, q), e, q)
    return SecretKey(s), PublicKey(b=b, a=a)


def make_relin_key(params: CKKSParams, sk: SecretKey, rng: np.random.Generator,
                   ctx: Context) -> KSKey:
    """Key-switch key from s^2 to s (reference make_relin_key / make_kskey)."""
    qp = params.q_primes + params.p_primes
    q = ctx.col("q", range(len(qp)))
    s_ntt = ntt_small(sk.s, qp, ctx)
    s2 = mul_mod(s_ntt, s_ntt, q)
    bs, as_ = [], []
    for g in gadget_factors(params):
        a = torch.from_numpy(sample_uniform(rng, qp, params.n)).to(ctx.device)
        e = ntt_small(sample_gauss(rng, params.n, params.sigma), qp, ctx)
        g_rns = torch.tensor([g % p for p in qp], dtype=torch.int64, device=ctx.device)[:, None]
        b = add_mod(mul_mod(neg_mod(a, q), s_ntt, q), e, q)
        bs.append(add_mod(b, mul_mod(g_rns, s2, q), q))
        as_.append(a)
    return KSKey(b=torch.stack(bs), a=torch.stack(as_))
