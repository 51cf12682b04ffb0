"""Ciphertext operations of the CKKS multiply path.

Counterpart of gpufhe_tpu/ciphertext/ct.py: encrypt (host draws in the
reference's order), decrypt, add/sub, tensor, relinearize, rescale, ct_mul
and the fused ct_mul_full (ct.py:244-308). Ciphertexts are int64[K, N]
canonical residues per component in the NTT domain, K the level's active
q-primes; every component equals the reference's limb for limb.

PyTorch runs eagerly, so the reference's jit cores become plain functions.
The reference's XLA fences (optimization_barrier) have no counterpart.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.keys.keys import DeviceKSKey, DevicePublicKey, DeviceSecretKey
from gpufhe_tpu_torch.ops.context import Context
from gpufhe_tpu_torch.ops.modops import add_mod, mont_mul, mul_mod, sub_mod
from gpufhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
from gpufhe_tpu_torch.params.params import CKKSParams
from gpufhe_tpu_torch.primitives.keyswitch import key_switch_core
from gpufhe_tpu_torch.primitives.rns import make_ks_context, rescale


@dataclasses.dataclass
class Ciphertext:
    """Device ciphertext: list of int64[K, N] components, NTT domain."""

    c: list  # [c0, c1] (or [d0, d1, d2] after the tensor)
    level: int
    scale: float

    def primes(self, params: CKKSParams) -> tuple[int, ...]:
        return params.q_primes[: self.level]


def encrypt(
    pt_coeff: np.ndarray,
    params: CKKSParams,
    pk: DevicePublicKey,
    ctx: Context,
    rng: np.random.Generator,
    scale: float,
    level: int | None = None,
) -> Ciphertext:
    """Public-key encrypt a coefficient-domain plaintext int64[L, N].

    c0 = pk.b * v + NTT(pt + e0), c1 = pk.a * v + NTT(e1), with v, e0, e1
    drawn on the host in the reference's order.
    """
    level = level if level is not None else params.num_limbs
    primes = params.q_primes[:level]
    n = params.n
    v = gckks.small_to_rns(gckks.sample_ternary(rng, n), primes)
    e0 = gckks.small_to_rns(gckks.sample_gauss(rng, n, params.sigma), primes)
    e1 = gckks.small_to_rns(gckks.sample_gauss(rng, n, params.sigma), primes)
    pt_pe0 = (pt_coeff[:level] + e0) % np.asarray(primes, dtype=np.int64)[:, None]
    host = torch.from_numpy(np.stack([v, pt_pe0, e1]))
    v_ntt, m_ntt, e1_ntt = ntt_fwd(host.to(ctx.device), ctx, limbs=range(level))
    q, qinv = ctx.col("q", range(level)), ctx.col("qinv_neg", range(level))
    c0 = add_mod(mont_mul(v_ntt, pk.b_mont[:level], q, qinv), m_ntt, q)
    c1 = add_mod(mont_mul(v_ntt, pk.a_mont[:level], q, qinv), e1_ntt, q)
    return Ciphertext([c0, c1], level, scale)


def decrypt_to_coeff(ct: Ciphertext, sk: DeviceSecretKey, ctx: Context) -> np.ndarray:
    """iNTT(sum_k c_k * s^k): canonical coefficient residues int64[K, N] (host)."""
    rows = range(ct.level)
    q, qinv = ctx.col("q", rows), ctx.col("qinv_neg", rows)
    s_mont = sk.s_mont[: ct.level]
    acc = ct.c[0]
    s_pow = s_mont  # s * R: mont_mul by it multiplies by s exactly
    for comp in ct.c[1:]:
        acc = add_mod(acc, mont_mul(comp, s_pow, q, qinv), q)
        s_pow = mont_mul(s_pow, s_mont, q, qinv)  # stays in Montgomery form
    return ntt_inv(acc, ctx, limbs=rows).cpu().numpy()


def decrypt_decode(ct: Ciphertext, params: CKKSParams, sk: DeviceSecretKey,
                   ctx: Context) -> np.ndarray:
    coeff = decrypt_to_coeff(ct, sk, ctx)
    return gckks.decode(coeff, ct.scale, ct.primes(params), params.n)


def ct_add(a: Ciphertext, b: Ciphertext, ctx: Context) -> Ciphertext:
    _check_pair(a, b)
    q = ctx.col("q", range(a.level))
    return Ciphertext([add_mod(x, y, q) for x, y in zip(a.c, b.c)], a.level, a.scale)


def ct_sub(a: Ciphertext, b: Ciphertext, ctx: Context) -> Ciphertext:
    _check_pair(a, b)
    q = ctx.col("q", range(a.level))
    return Ciphertext([sub_mod(x, y, q) for x, y in zip(a.c, b.c)], a.level, a.scale)


def _check_pair(a: Ciphertext, b: Ciphertext) -> None:
    if a.level != b.level or a.scale != b.scale or len(a.c) != len(b.c):
        raise ValueError("ciphertexts differ in level, scale or size")


def _tensor(ca, cb, ctx: Context, level: int):
    """(a0, a1) x (b0, b1) -> (d0, d1, d2), NTT-domain pointwise."""
    q = ctx.col("q", range(level))
    a0, a1 = ca
    b0, b1 = cb
    d1 = add_mod(mul_mod(a0, b1, q), mul_mod(a1, b0, q), q)
    return mul_mod(a0, b0, q), d1, mul_mod(a1, b1, q)


def ct_tensor(a: Ciphertext, b: Ciphertext, ctx: Context) -> Ciphertext:
    if a.level != b.level or len(a.c) != 2 or len(b.c) != 2:
        raise ValueError("ct_tensor takes two 2-component ciphertexts at one level")
    return Ciphertext(list(_tensor(a.c, b.c, ctx, a.level)), a.level, a.scale * b.scale)


def ct_relinearize(ct: Ciphertext, params: CKKSParams, ctx: Context,
                   rlk: DeviceKSKey) -> Ciphertext:
    if len(ct.c) != 3:
        raise ValueError("ct_relinearize takes a 3-component ciphertext")
    ksc = make_ks_context(params, ct.level, ctx.device)
    q = ctx.col("q", range(ct.level))
    ks0, ks1 = key_switch_core(ct.c[2], params, ct.level, ctx, ksc, rlk)
    return Ciphertext([add_mod(ct.c[0], ks0, q), add_mod(ct.c[1], ks1, q)], ct.level, ct.scale)


def ct_rescale(ct: Ciphertext, params: CKKSParams, ctx: Context) -> Ciphertext:
    """Divide by the last active prime: level K -> K-1, one batched transform each way."""
    level = ct.level
    ksc = make_ks_context(params, level, ctx.device)
    coeff = ntt_inv(torch.stack(ct.c), ctx, limbs=range(level))
    down = ntt_fwd(rescale(coeff, params, level, ctx, ksc), ctx, limbs=range(level - 1))
    return Ciphertext(list(down), level - 1, ct.scale / params.q_primes[level - 1])


def ct_mul(a: Ciphertext, b: Ciphertext, params: CKKSParams, ctx: Context,
           rlk: DeviceKSKey) -> Ciphertext:
    """Homomorphic multiply: tensor -> relinearize -> rescale."""
    return ct_rescale(ct_relinearize(ct_tensor(a, b, ctx), params, ctx, rlk), params, ctx)


def ct_mul_full(a: Ciphertext, b: Ciphertext, params: CKKSParams, ctx: Context,
                rlk: DeviceKSKey) -> Ciphertext:
    """Tensor + relinearize + scale_words rescales, limb-equal to the reference's
    _mul_full_core.

    The key switch stays in the coefficient domain (eval_out=False): iNTT(d_i)
    + ks_i equals iNTT(d_i + NTT(ks_i)) mod q, so the rescales run back to back
    without an NTT round trip, and one batched NTT brings both components back.
    """
    if a.level != b.level or len(a.c) != 2 or len(b.c) != 2:
        raise ValueError("ct_mul_full takes two 2-component ciphertexts at one level")
    level = a.level
    q = ctx.col("q", range(level))
    d0, d1, d2 = _tensor(a.c, b.c, ctx, level)
    ksc = make_ks_context(params, level, ctx.device)
    ks0, ks1 = key_switch_core(d2, params, level, ctx, ksc, rlk, eval_out=False)
    cc = add_mod(ntt_inv(torch.stack([d0, d1]), ctx, limbs=range(level)),
                 torch.stack([ks0, ks1]), q)
    scale = a.scale * b.scale
    lvl = level
    for _ in range(params.scale_words):
        cc = rescale(cc, params, lvl, ctx, make_ks_context(params, lvl, ctx.device))
        scale = scale / params.q_primes[lvl - 1]
        lvl -= 1
    out = ntt_fwd(cc, ctx, limbs=range(lvl))
    return Ciphertext(list(out), lvl, scale)
