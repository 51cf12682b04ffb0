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

from gpufhe_tpu_torch.golden import ntt as gn
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
# Host NTT helpers over limb stacks (numpy, the reference's golden ones): the
# host code of ciphertext/threshold.py runs on them
# ---------------------------------------------------------------------------


def _psis(params: CKKSParams, primes: tuple[int, ...]) -> tuple[int, ...]:
    lookup = dict(zip(params.q_primes + params.p_primes, params.psi))
    return tuple(lookup[q] for q in primes)


def ntt_limbs(x: np.ndarray, params: CKKSParams, primes: tuple[int, ...]) -> np.ndarray:
    psis = _psis(params, primes)
    return np.stack([gn.ntt_fwd(x[i], primes[i], psis[i]) for i in range(len(primes))])


def intt_limbs(x: np.ndarray, params: CKKSParams, primes: tuple[int, ...]) -> np.ndarray:
    psis = _psis(params, primes)
    return np.stack([gn.ntt_inv(x[i], primes[i], psis[i]) for i in range(len(primes))])


def _pointwise(op, a: np.ndarray, b: np.ndarray, primes: tuple[int, ...]) -> np.ndarray:
    q = np.array(primes, dtype=np.int64)[:, None]
    return op(a, b) % q


def poly_add(a, b, primes):
    return _pointwise(lambda x, y: x + y, a, b, primes)


def poly_sub(a, b, primes):
    return _pointwise(lambda x, y: x - y, a, b, primes)


def poly_mul(a, b, primes):
    return _pointwise(lambda x, y: x * y, a, b, primes)  # eval-domain pointwise


def host_limbs(x) -> np.ndarray:
    """A limb array (a tensor on any device, or numpy) as int64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


def inner_product_coeff(ct, params: CKKSParams, s: np.ndarray) -> np.ndarray:
    """c0 + sum_k c_k s^k in the coefficient domain, int64[level, N], on the
    host: the decryption's inner product over the ciphertext's primes, for
    any scheme's ciphertext (its components on any device, or numpy)."""
    primes = params.q_primes[: ct.level]
    s_ntt = ntt_limbs(small_to_rns(s, primes), params, primes)
    acc = host_limbs(ct.c[0])
    s_pow = s_ntt
    for comp in ct.c[1:]:
        acc = poly_add(acc, poly_mul(host_limbs(comp), s_pow, primes), primes)
        s_pow = poly_mul(s_pow, s_ntt, primes)
    return intt_limbs(acc, params, primes)


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


def keygen(params: CKKSParams, rng: np.random.Generator, ctx: Context, err_factor: int = 1):
    """Secret + public key (reference golden/ckks.py keygen, same draws).

    The error is drawn times err_factor: 1 for CKKS and BFV, t for BGV
    (reference golden/bgv.py keygen, b = -a s + t e)."""
    primes = params.q_primes
    if params.hamming_weight:
        s = sample_sparse_ternary(rng, params.n, params.hamming_weight)
    else:
        s = sample_ternary(rng, params.n)
    s_ntt = ntt_small(s, primes, ctx)
    a = torch.from_numpy(sample_uniform(rng, primes, params.n)).to(ctx.device)
    e = ntt_small(err_factor * sample_gauss(rng, params.n, params.sigma), primes, ctx)
    q = ctx.col("q", range(len(primes)))
    b = add_mod(mul_mod(neg_mod(a, q), s_ntt, q), e, q)
    return SecretKey(s), PublicKey(b=b, a=a)


def make_kskey(params: CKKSParams, s_target_fn, sk: SecretKey, rng: np.random.Generator,
               ctx: Context, err_factor: int = 1) -> KSKey:
    """Key-switch key from s' to sk.s, where s_target_fn(primes) gives s' in
    the NTT domain over those primes (reference golden make_kskey, same draws:
    per gadget factor, a uniform `a` and then a Gaussian error, times
    err_factor: t for BGV's gadget rows, reference golden/bgv.py:83-155)."""
    qp = params.q_primes + params.p_primes
    q = ctx.col("q", range(len(qp)))
    s_ntt = ntt_small(sk.s, qp, ctx)
    s_target = s_target_fn(qp)
    bs, as_ = [], []
    for g in gadget_factors(params):
        a = torch.from_numpy(sample_uniform(rng, qp, params.n)).to(ctx.device)
        e = ntt_small(err_factor * sample_gauss(rng, params.n, params.sigma), qp, ctx)
        g_rns = torch.tensor([g % p for p in qp], dtype=torch.int64, device=ctx.device)[:, None]
        b = add_mod(mul_mod(neg_mod(a, q), s_ntt, q), e, q)
        bs.append(add_mod(b, mul_mod(g_rns, s_target, q), q))
        as_.append(a)
    return KSKey(b=torch.stack(bs), a=torch.stack(as_))


def make_relin_key(params: CKKSParams, sk: SecretKey, rng: np.random.Generator,
                   ctx: Context, err_factor: int = 1) -> KSKey:
    """Key-switch key from s^2 to s (reference make_relin_key)."""

    def s2_ntt(primes):
        s_ntt = ntt_small(sk.s, primes, ctx)
        return mul_mod(s_ntt, s_ntt, ctx.col("q", range(len(primes))))

    return make_kskey(params, s2_ntt, sk, rng, ctx, err_factor)


# ---------------------------------------------------------------------------
# Galois automorphisms X -> X^g
# ---------------------------------------------------------------------------


def galois_exponent(steps: int, n: int) -> int:
    """Automorphism X -> X^g rotating slots left by `steps`: g = 5^steps mod 2N."""
    return pow(5, steps, 2 * n)


def apply_automorphism_coeff(x: np.ndarray, g: int) -> np.ndarray:
    """m(X) -> m(X^g) on signed or canonical coefficient vectors (last axis)."""
    n = x.shape[-1]
    out = np.zeros_like(x)
    idx = np.arange(n) * g % (2 * n)
    sign = np.where(idx >= n, -1, 1)
    out[..., idx % n] = x * sign
    return out


def automorphism_perm_eval(g: int, n: int) -> np.ndarray:
    """Permutation p with (sigma_g x)_eval[k] = x_eval[p[k]] in natural NTT order.

    Point k holds m(psi^(2k+1)); sigma_g m there is m(psi^((2k+1) g)), the
    input's point k' with 2k'+1 = (2k+1) g mod 2N.
    """
    kk = (np.arange(n) * 2 + 1) * g % (2 * n)
    return (kk - 1) // 2


def _automorphism_target(sk: SecretKey, g: int, ctx: Context):
    def sg_ntt(primes):
        return ntt_small(apply_automorphism_coeff(sk.s, g), primes, ctx)

    return sg_ntt


def make_galois_key(params: CKKSParams, steps: int, sk: SecretKey, rng: np.random.Generator,
                    ctx: Context, err_factor: int = 1) -> KSKey:
    """Key switching sigma_g(s) -> s for the rotation by `steps`."""
    g = galois_exponent(steps, params.n)
    return make_kskey(params, _automorphism_target(sk, g, ctx), sk, rng, ctx, err_factor)


def make_conj_key(params: CKKSParams, sk: SecretKey, rng: np.random.Generator,
                  ctx: Context) -> KSKey:
    """Key switching for complex conjugation, g = 2N - 1."""
    g = 2 * params.n - 1
    return make_kskey(params, _automorphism_target(sk, g, ctx), sk, rng, ctx)
