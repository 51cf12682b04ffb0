"""Golden CKKS pipeline in numpy: the end-to-end parity oracle (counterpart of
gpufhe_tpu/golden/ckks.py).

The canonical-embedding encoder, the samplers, key generation, public-key
encryption, add and sub, the tensor, hybrid key switching (relinearisation,
rotations, conjugation, hoisted rotations, the fused diagonal fan), the
rescale, ModRaise and decryption. Every algorithmic choice (the approximate
base conversion, the centred rescale lift, the gadget, the NTT domain at
rest) is the one the device path makes, so ciphertext limbs compare with
`==` at every stage. Randomness comes from an explicit
numpy.random.Generator, drawn in the reference's order, so a seed gives the
reference's keys and ciphertexts limb for limb.

Why numpy, not torch: this is the oracle the port's kernels (K1, K3, K4)
and its torch ops are held against, on the CPU here and on the card in
chip_smoke.py. So its ciphertext ops, and keygen without `ctx`, run only on
numpy and the golden NTT (golden/ntt.py, golden/native.py) and reach
nothing of the port's ops, primitives or ciphertext. They take numpy limbs,
and keys whose arrays are numpy or torch tensors on any device (the port's
KeyChest keeps canonical switching keys as CPU tensors and pk on the
context's device): host_limbs reads them on the host at each op's entry.

Key generation also serves the device path: with `ctx` it draws the same
values from the same rng and computes them with the port's own NTT and
modular ops on ctx's device (keys/keys.py keygen), returning int64 tensors
there. Only that path imports torch and the port's ops, lazily.

A polynomial is int64[K, N] canonical residues; ciphertexts stay in the NTT
(evaluation) domain at rest, K their level (active q-primes).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from gpufhe_tpu_torch.golden import ntt as gn
from gpufhe_tpu_torch.golden import rns as grns
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
# NTT helpers over limb stacks
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
    """A limb array as int64 numpy on the host: numpy as it is, a torch
    tensor on any device copied to the host (read without importing torch)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.int64)


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
# Keys and ciphertexts
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SecretKey:
    s: np.ndarray  # signed ternary int64[N], host only


@dataclasses.dataclass
class PublicKey:
    b: np.ndarray  # int64[L, N] NTT domain: -a*s + e (a tensor when drawn with ctx)
    a: np.ndarray  # int64[L, N] NTT domain


@dataclasses.dataclass
class KSKey:
    """Hybrid key-switch key: dnum gadget rows over the full Q*P chain."""

    b: np.ndarray  # int64[dnum, L+alpha, N] NTT domain (a tensor when drawn with ctx)
    a: np.ndarray  # int64[dnum, L+alpha, N] NTT domain


@dataclasses.dataclass
class Ciphertext:
    """NTT-domain ciphertext; c[k] holds int64[K, N] for component k."""

    c: list  # list of int64[K, N]
    level: int  # number of active q-primes
    scale: float

    def primes(self, params: CKKSParams) -> tuple[int, ...]:
        return params.q_primes[: self.level]


def ks_groups(params: CKKSParams, level: int) -> list[tuple[int, int]]:
    """(start, stop) limb index ranges of the active decomposition groups."""
    alpha = params.alpha
    return [(d, min(d + alpha, level)) for d in range(0, level, alpha)]


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


def ntt_small(small: np.ndarray, primes: tuple[int, ...], ctx) -> "torch.Tensor":  # noqa: F821
    """The device path's helper: a signed small poly -> its NTT-domain
    residues over the given rows of ctx's chain, an int64 tensor on ctx's
    device, by the port's own NTT."""
    import torch

    from gpufhe_tpu_torch.ops.ntt import ntt_fwd

    rows = [ctx.primes.index(p) for p in primes]
    x = torch.from_numpy(small_to_rns(small, primes)).to(ctx.device)
    return ntt_fwd(x, ctx, limbs=rows)


class _KeyArith:
    """The key generator's arithmetic over a prefix of the Q*P chain: on the
    host by the golden NTT and numpy (ctx None), or on ctx's device by the
    port's NTT and modular ops. Both give the same canonical values."""

    def __init__(self, params: CKKSParams, ctx):
        self.params, self.ctx = params, ctx
        if ctx is not None:
            import torch

            from gpufhe_tpu_torch.ops import modops

            self._torch, self._modops = torch, modops

    def _q(self, primes):
        return self.ctx.col("q", [self.ctx.primes.index(p) for p in primes])

    def ntt_small(self, small: np.ndarray, primes):
        if self.ctx is None:
            return ntt_limbs(small_to_rns(small, primes), self.params, primes)
        return ntt_small(small, primes, self.ctx)

    def uniform(self, rng: np.random.Generator, primes):
        a = sample_uniform(rng, primes, self.params.n)  # sampled directly in the NTT domain
        return a if self.ctx is None else self._torch.from_numpy(a).to(self.ctx.device)

    def column(self, value: int, primes):
        col = np.array([value % p for p in primes], dtype=np.int64)[:, None]
        return col if self.ctx is None else self._torch.from_numpy(col).to(self.ctx.device)

    def mul(self, x, y, primes):
        if self.ctx is None:
            return poly_mul(x, y, primes)
        return self._modops.mul_mod(x, y, self._q(primes))

    def add(self, x, y, primes):
        if self.ctx is None:
            return poly_add(x, y, primes)
        return self._modops.add_mod(x, y, self._q(primes))

    def neg(self, x, primes):
        if self.ctx is None:
            return poly_sub(np.zeros_like(x), x, primes)
        return self._modops.neg_mod(x, self._q(primes))

    def stack(self, rows):
        return np.stack(rows) if self.ctx is None else self._torch.stack(rows)


def keygen(params: CKKSParams, rng: np.random.Generator, *, ctx=None, err_factor: int = 1):
    """Secret and public key, b = -a s + err_factor e (NTT domain).

    The error is drawn times err_factor: 1 for CKKS and BFV, t for BGV
    (golden/bgv.py keygen). Without ctx the key is numpy, made by the golden
    NTT; with ctx the same values are int64 tensors on ctx's device."""
    arith = _KeyArith(params, ctx)
    primes = params.q_primes
    if params.hamming_weight:
        s = sample_sparse_ternary(rng, params.n, params.hamming_weight)
    else:
        s = sample_ternary(rng, params.n)
    s_ntt = arith.ntt_small(s, primes)
    a = arith.uniform(rng, primes)
    e = arith.ntt_small(err_factor * sample_gauss(rng, params.n, params.sigma), primes)
    b = arith.add(arith.mul(arith.neg(a, primes), s_ntt, primes), e, primes)
    return SecretKey(s), PublicKey(b=b, a=a)


def make_kskey(params: CKKSParams, s_target_ntt_fn, sk: SecretKey, rng: np.random.Generator,
               *, ctx=None, err_factor: int = 1) -> KSKey:
    """Key-switch key from s' to sk.s, where s_target_ntt_fn(primes) gives s'
    in the NTT domain over those primes (a tensor on ctx's device when ctx
    is given). Per gadget factor: a uniform `a`, then a Gaussian error times
    err_factor (t for BGV's gadget rows)."""
    arith = _KeyArith(params, ctx)
    qp = params.q_primes + params.p_primes
    s_ntt = arith.ntt_small(sk.s, qp)
    bs, as_ = [], []
    for g in gadget_factors(params):
        a = arith.uniform(rng, qp)
        e = arith.ntt_small(err_factor * sample_gauss(rng, params.n, params.sigma), qp)
        b = arith.add(arith.mul(arith.neg(a, qp), s_ntt, qp), e, qp)
        bs.append(arith.add(b, arith.mul(arith.column(g, qp), s_target_ntt_fn(qp), qp), qp))
        as_.append(a)
    return KSKey(b=arith.stack(bs), a=arith.stack(as_))


def make_relin_key(params: CKKSParams, sk: SecretKey, rng: np.random.Generator, *, ctx=None,
                   err_factor: int = 1) -> KSKey:
    """Key-switch key from s^2 to s."""
    arith = _KeyArith(params, ctx)

    def s2_ntt(primes):
        s_ntt = arith.ntt_small(sk.s, primes)
        return arith.mul(s_ntt, s_ntt, primes)

    return make_kskey(params, s2_ntt, sk, rng, ctx=ctx, err_factor=err_factor)


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


def _automorphism_target(params: CKKSParams, sk: SecretKey, g: int, ctx):
    arith = _KeyArith(params, ctx)
    return lambda primes: arith.ntt_small(apply_automorphism_coeff(sk.s, g), primes)


def make_galois_key(params: CKKSParams, steps: int, sk: SecretKey, rng, *, ctx=None,
                    err_factor: int = 1) -> KSKey:
    """Key switching sigma_g(s) -> s for the rotation by `steps`."""
    g = galois_exponent(steps, params.n)
    return make_kskey(params, _automorphism_target(params, sk, g, ctx), sk, rng, ctx=ctx,
                      err_factor=err_factor)


def make_conj_key(params: CKKSParams, sk: SecretKey, rng, *, ctx=None) -> KSKey:
    """Key switching for complex conjugation, g = 2N - 1."""
    g = 2 * params.n - 1
    return make_kskey(params, _automorphism_target(params, sk, g, ctx), sk, rng, ctx=ctx)


# ---------------------------------------------------------------------------
# Encrypt / decrypt
# ---------------------------------------------------------------------------


def encrypt(pt_coeff: np.ndarray, params: CKKSParams, pk: PublicKey, rng: np.random.Generator,
            scale: float, level: int | None = None) -> Ciphertext:
    level = level if level is not None else params.num_limbs
    primes = params.q_primes[:level]
    n = params.n
    v = ntt_limbs(small_to_rns(sample_ternary(rng, n), primes), params, primes)
    e0 = small_to_rns(sample_gauss(rng, n, params.sigma), primes)
    e1 = ntt_limbs(small_to_rns(sample_gauss(rng, n, params.sigma), primes), params, primes)
    m_ntt = ntt_limbs(poly_add(np.asarray(pt_coeff)[:level], e0, primes), params, primes)
    c0 = poly_add(poly_mul(host_limbs(pk.b[:level]), v, primes), m_ntt, primes)
    c1 = poly_add(poly_mul(host_limbs(pk.a[:level]), v, primes), e1, primes)
    return Ciphertext(c=[c0, c1], level=level, scale=scale)


def decrypt_to_coeff(ct: Ciphertext, params: CKKSParams, sk: SecretKey) -> np.ndarray:
    return inner_product_coeff(ct, params, sk.s)


def decrypt_decode(ct: Ciphertext, params: CKKSParams, sk: SecretKey) -> np.ndarray:
    return decode(decrypt_to_coeff(ct, params, sk), ct.scale, ct.primes(params), params.n)


# ---------------------------------------------------------------------------
# Ciphertext ops
# ---------------------------------------------------------------------------


def _same_level_and_scale(a: Ciphertext, b: Ciphertext) -> None:
    if a.level != b.level or a.scale != b.scale:
        raise ValueError(f"operands differ: levels {a.level}, {b.level}; scales {a.scale}, "
                         f"{b.scale}")


def ct_add(a: Ciphertext, b: Ciphertext, params: CKKSParams) -> Ciphertext:
    _same_level_and_scale(a, b)
    primes = a.primes(params)
    return Ciphertext([poly_add(x, y, primes) for x, y in zip(a.c, b.c)], a.level, a.scale)


def ct_sub(a: Ciphertext, b: Ciphertext, params: CKKSParams) -> Ciphertext:
    _same_level_and_scale(a, b)
    primes = a.primes(params)
    return Ciphertext([poly_sub(x, y, primes) for x, y in zip(a.c, b.c)], a.level, a.scale)


def ct_mul_plain(ct: Ciphertext, pt_ntt: np.ndarray, pt_scale: float, params) -> Ciphertext:
    primes = ct.primes(params)
    return Ciphertext([poly_mul(x, pt_ntt[: ct.level], primes) for x in ct.c], ct.level,
                      ct.scale * pt_scale)


def _tensor(a: list, b: list, primes) -> list:
    """(a0, a1) x (b0, b1) -> (d0, d1, d2), NTT-domain pointwise."""
    d0 = poly_mul(a[0], b[0], primes)
    d1 = poly_add(poly_mul(a[0], b[1], primes), poly_mul(a[1], b[0], primes), primes)
    return [d0, d1, poly_mul(a[1], b[1], primes)]


def ct_tensor(a: Ciphertext, b: Ciphertext, params: CKKSParams) -> Ciphertext:
    """(a0,a1) x (b0,b1) -> (d0,d1,d2), NTT-domain pointwise."""
    if a.level != b.level:
        raise ValueError(f"operands at levels {a.level} and {b.level}")
    return Ciphertext(_tensor(a.c, b.c, a.primes(params)), a.level, a.scale * b.scale)


def _mod_down(coeff: np.ndarray, params: CKKSParams, q_primes: tuple[int, ...]) -> np.ndarray:
    """The plain ModDown by P (additive noise): CKKS's, and BFV's."""
    return grns.mod_down_coeff(coeff, q_primes, params.p_primes)


def _raise(x_coeff: np.ndarray, params: CKKSParams, level: int) -> list:
    """ModUp of each decomposition group of a coefficient-domain poly to the
    active Q*P basis (its own limbs kept), in the NTT domain."""
    q_primes = params.q_primes[:level]
    p_primes = params.p_primes
    k, alpha = level, len(p_primes)
    raised = []
    for d0, d1 in ks_groups(params, level):
        others = q_primes[:d0] + q_primes[d1:] + p_primes
        conv = grns.base_convert(x_coeff[d0:d1], q_primes[d0:d1], others)
        full = np.empty((k + alpha, params.n), dtype=np.int64)
        full[d0:d1] = x_coeff[d0:d1]
        full[:d0] = conv[:d0]
        full[d1:k] = conv[d0 : k - (d1 - d0)]
        full[k:] = conv[k - (d1 - d0) :]
        raised.append(ntt_limbs(full, params, q_primes + p_primes))
    return raised


def _switch(raised: list, perm, params: CKKSParams, level: int, ksk: KSKey, mod_down):
    """Inner product of the (permuted) raised polys with the key over the
    active Q*P basis, then ModDown to Q: (ks0, ks1) in the NTT domain."""
    q_primes = params.q_primes[:level]
    alpha = len(params.p_primes)
    qp_active = q_primes + params.p_primes
    qp_idx = list(range(level)) + list(range(params.num_limbs, params.num_limbs + alpha))
    key_b, key_a = host_limbs(ksk.b), host_limbs(ksk.a)
    acc0 = np.zeros((level + alpha, params.n), dtype=np.int64)
    acc1 = np.zeros_like(acc0)
    for d, r in enumerate(raised):
        rg = r if perm is None else r[:, perm]
        acc0 = poly_add(acc0, poly_mul(rg, key_b[d][qp_idx], qp_active), qp_active)
        acc1 = poly_add(acc1, poly_mul(rg, key_a[d][qp_idx], qp_active), qp_active)
    return tuple(ntt_limbs(mod_down(intt_limbs(acc, params, qp_active), params, q_primes),
                           params, q_primes) for acc in (acc0, acc1))


def key_switch_core(d2: np.ndarray, params: CKKSParams, level: int,
                    ksk: KSKey) -> tuple[np.ndarray, np.ndarray]:
    """Hybrid key switch of one NTT-domain poly int64[K, N]: (ks0, ks1),
    int64[K, N] NTT domain, the P-scaled and mod-downed inner products
    <ModUp(decomp(d2)), ksk>."""
    d2_coeff = intt_limbs(d2, params, params.q_primes[:level])
    return _switch(_raise(d2_coeff, params, level), None, params, level, ksk, _mod_down)


def ct_relinearize(ct: Ciphertext, params: CKKSParams, rlk: KSKey) -> Ciphertext:
    if len(ct.c) != 3:
        raise ValueError("relinearisation takes a three-component ciphertext")
    primes = ct.primes(params)
    ks0, ks1 = key_switch_core(ct.c[2], params, ct.level, rlk)
    return Ciphertext([poly_add(ct.c[0], ks0, primes), poly_add(ct.c[1], ks1, primes)],
                      ct.level, ct.scale)


def ct_rescale(ct: Ciphertext, params: CKKSParams) -> Ciphertext:
    primes = ct.primes(params)
    new = [ntt_limbs(grns.rescale_coeff(intt_limbs(comp, params, primes), primes), params,
                     primes[:-1]) for comp in ct.c]
    return Ciphertext(new, ct.level - 1, ct.scale / primes[-1])


def ct_mul(a: Ciphertext, b: Ciphertext, params: CKKSParams, rlk: KSKey) -> Ciphertext:
    return ct_rescale(ct_relinearize(ct_tensor(a, b, params), params, rlk), params)


def _two_components(ct) -> None:
    if len(ct.c) != 2:
        raise ValueError("the key switch takes a two-component ciphertext")


def ct_key_switch(ct: Ciphertext, params: CKKSParams, ksk: KSKey) -> Ciphertext:
    """Re-encrypt under the key ksk was generated for (message unchanged):
    the sparse-secret encapsulation of the bootstrap's ModRaise."""
    _two_components(ct)
    primes = ct.primes(params)
    ks0, ks1 = key_switch_core(ct.c[1], params, ct.level, ksk)
    return Ciphertext([poly_add(ct.c[0], ks0, primes), ks1], ct.level, ct.scale)


def _galois(ct: Ciphertext, g: int, params: CKKSParams, ksk: KSKey) -> Ciphertext:
    _two_components(ct)
    primes = ct.primes(params)
    perm = automorphism_perm_eval(g, params.n)
    ks0, ks1 = key_switch_core(ct.c[1][:, perm], params, ct.level, ksk)
    return Ciphertext([poly_add(ct.c[0][:, perm], ks0, primes), ks1], ct.level, ct.scale)


def ct_rotate(ct: Ciphertext, steps: int, params: CKKSParams, gk: KSKey) -> Ciphertext:
    """Rotate slots left by `steps` (Galois automorphism + key switch)."""
    return _galois(ct, galois_exponent(steps, params.n), params, gk)


def ct_conjugate(ct: Ciphertext, params: CKKSParams, ck: KSKey) -> Ciphertext:
    return _galois(ct, 2 * params.n - 1, params, ck)


# ---------------------------------------------------------------------------
# Hoisted rotations and the fused diagonal fan
# ---------------------------------------------------------------------------


def hoist_decompose(ct: Ciphertext, params: CKKSParams):
    """The shared (hoisted) part of rotation key switching: decompose, ModUp
    and NTT the c1 component once for any number of rotations.

    Returns the raised gadget polys in the NTT domain over the active QP
    basis. Hoisting applies the automorphism to these after ModUp (it
    commutes up to the approximate conversion's error term, which ModDown
    absorbs as noise), so the results differ bit-wise from ct_rotate's but
    decrypt the same up to noise. Scheme-agnostic: it reads only c1 over Q.
    """
    return _raise(intt_limbs(ct.c[1], params, params.q_primes[: ct.level]), params, ct.level)


def _hoisted_key_switch(raised, perm, params: CKKSParams, level: int, ksk: KSKey):
    """Inner product of the permuted raised polys with the key, then ModDown."""
    return _switch(raised, perm, params, level, ksk, _mod_down)


def _rotate_hoisted(ct, steps_list, params: CKKSParams, gks: dict, key_switch, make):
    """The rotations of ct by each step, sharing one decomposition: make(c0,
    c1) builds each output ciphertext."""
    _two_components(ct)
    primes = ct.primes(params)
    raised = hoist_decompose(ct, params)
    out = []
    for steps in steps_list:
        perm = automorphism_perm_eval(galois_exponent(steps, params.n), params.n)
        ks0, ks1 = key_switch(raised, perm, params, ct.level, gks[steps])
        out.append(make(poly_add(ct.c[0][:, perm], ks0, primes), ks1))
    return out


def ct_rotate_hoisted(ct: Ciphertext, steps_list, params: CKKSParams, gks: dict) -> list:
    """Rotate one ciphertext by many step counts, sharing one decomposition.

    gks maps steps -> KSKey (Galois key). Returns one Ciphertext per step.
    """
    return _rotate_hoisted(ct, steps_list, params, gks, _hoisted_key_switch,
                           lambda c0, c1: Ciphertext([c0, c1], ct.level, ct.scale))


def ct_diag_fan(ct: Ciphertext, pt_sets: list, pt_scale: float, params: CKKSParams,
                gks: dict) -> list:
    """Fused rotation-fan linear combination ("double hoisting").

    For each dict D in pt_sets computes

        rescale^scale_words( sum_r D[r] * rot_r(ct) )

    with one hoisted decomposition shared by every rotation and one delayed
    ModDown per output: each rotation's gadget inner product stays in the
    extended QP basis, is multiplied there by the plaintext diagonal and
    accumulated, and a single ModDown lands the whole fan back in Q. This is
    the contract the device's ciphertext/ct.py ct_diag_fan mirrors limb for
    limb.

    pt_sets: dicts offset -> int64[K+alpha, N] NTT-domain plaintext residues
    over the active QP basis (the q-prefix rows double as the Q-basis
    plaintext of the c0 and zero-offset terms), all at scale pt_scale. The
    r=0 entry (no key switch) is optional; every set needs a nonzero offset.
    """
    _two_components(ct)
    level = k = ct.level
    alpha = len(params.p_primes)
    q_primes = params.q_primes[:level]
    p_primes = params.p_primes
    qp_active = q_primes + p_primes
    n = params.n

    offsets = sorted({r for dset in pt_sets for r in dset if r != 0})
    raised = hoist_decompose(ct, params)
    qp_idx = list(range(k)) + list(range(params.num_limbs, params.num_limbs + alpha))

    nsets = len(pt_sets)
    acc0, acc1, c0_acc = [None] * nsets, [None] * nsets, [None] * nsets

    def add(acc, x, primes):
        return x if acc is None else poly_add(acc, x, primes)

    for r in offsets:
        perm = automorphism_perm_eval(galois_exponent(r, n), n)
        key_b, key_a = host_limbs(gks[r].b), host_limbs(gks[r].a)
        t0 = t1 = None
        for d, rr in enumerate(raised):
            rg = rr[:, perm]
            t0 = add(t0, poly_mul(rg, key_b[d][qp_idx], qp_active), qp_active)
            t1 = add(t1, poly_mul(rg, key_a[d][qp_idx], qp_active), qp_active)
        c0g = ct.c[0][:, perm]
        for s, dset in enumerate(pt_sets):
            if r not in dset:
                continue
            pt = dset[r]
            acc0[s] = add(acc0[s], poly_mul(t0, pt, qp_active), qp_active)
            acc1[s] = add(acc1[s], poly_mul(t1, pt, qp_active), qp_active)
            c0_acc[s] = add(c0_acc[s], poly_mul(c0g, pt[:k], q_primes), q_primes)

    outs = []
    for s, dset in enumerate(pt_sets):
        if acc0[s] is None:
            raise ValueError("each set needs a nonzero offset")
        ks0 = grns.mod_down_coeff(intt_limbs(acc0[s], params, qp_active), q_primes, p_primes)
        ks1 = grns.mod_down_coeff(intt_limbs(acc1[s], params, qp_active), q_primes, p_primes)
        e0, e1 = c0_acc[s], None
        if 0 in dset:
            pt0 = dset[0][:k]
            e0 = add(e0, poly_mul(ct.c[0], pt0, q_primes), q_primes)
            e1 = poly_mul(ct.c[1], pt0, q_primes)
        out0 = poly_add(ntt_limbs(ks0, params, q_primes), e0, q_primes)
        out1 = ntt_limbs(ks1, params, q_primes)
        if e1 is not None:
            out1 = poly_add(out1, e1, q_primes)
        out = Ciphertext([out0, out1], level, ct.scale * pt_scale)
        for _ in range(params.scale_words):
            out = ct_rescale(out, params)
        outs.append(out)
    return outs


# ---------------------------------------------------------------------------
# ModRaise (bootstrapping step 0): re-embed an exhausted ciphertext mod q0
# into the full chain; the output encrypts m + q0 * I for a small I
# ---------------------------------------------------------------------------


def ct_mod_raise(ct: Ciphertext, params: CKKSParams) -> Ciphertext:
    """Re-embed a base-modulus ciphertext into the full chain.

    The base may be composite, `scale_words` limbs (double-word scale): the
    centred CRT value v in (-Q0/2, Q0/2] is reduced into every prime.
    """
    w = params.scale_words
    if ct.level != w or len(ct.c) != 2:
        raise ValueError(f"ModRaise takes a two-component ciphertext at level {w}")
    base = params.q_primes[:w]
    primes = params.q_primes
    new = []
    for comp in ct.c:
        v = crt_compose_centered(intt_limbs(comp, params, base), base)  # object ints, centred
        lifted = np.stack([(v % q).astype(np.int64) for q in primes])
        new.append(ntt_limbs(lifted, params, primes))
    return Ciphertext(c=new, level=params.num_limbs, scale=ct.scale)
