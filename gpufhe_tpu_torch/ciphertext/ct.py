"""Ciphertext operations of the CKKS multiply and rotation paths.

Counterpart of gpufhe_tpu/ciphertext/ct.py: encrypt (host draws in the
reference's order), decrypt, add/sub, tensor, relinearize, rescale, ct_mul,
the fused ct_mul_full (ct.py:244-308), key switching, rotations and
conjugation (one-shot and hoisted), the plaintext multiply, the fused
plaintext MAC, the inner sums of a BSGS product (ct_baby_sums: the port's
own, batched), the fused diagonal fan of the bootstrap's linear transforms
and the single- and double-word ModRaise. Ciphertexts are int64[K, N] canonical residues per component
in the NTT domain, K the level's active q-primes; every component equals the
reference's limb for limb. The cores that BGV and BFV share with CKKS
(encrypt_core ... hoisted_galois_core) take limbs rather than a scaled
Ciphertext, and a KSContext where the scheme decides the ModDown.

Every inner product runs through kernel K4 (ops/mac_cuda.py) on the card:
the key switch's gadget MAC, the hoisted rotation's (with the automorphism
folded into K4's loads), the plaintext MAC and the plaintext multiply (a MAC
of one term), a BSGS group's inner sum, and both MAC levels of the diagonal
fan.

PyTorch runs eagerly, so the reference's jit cores become plain functions.
The reference's XLA fences (optimization_barrier) and GPUFHE_* switches
have no counterpart.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.keys.keys import DeviceKSKey, DevicePublicKey, DeviceSecretKey
from gpufhe_tpu_torch.ops.context import Context
from gpufhe_tpu_torch.ops import rescale_cuda, tensor_cuda
from gpufhe_tpu_torch.ops.mac_cuda import mac
from gpufhe_tpu_torch.ops.modops import add_mod, mont_mul, sub_mod
from gpufhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
from gpufhe_tpu_torch.params.params import CKKSParams
from gpufhe_tpu_torch.primitives.keyswitch import (gadget_mac, gadget_macs, hoist,
                                                   key_switch_core, ks_finish, qp_indices)
from gpufhe_tpu_torch.primitives.rns import KSContext, make_ks_context
from gpufhe_tpu_torch.utils.profiling import stage


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
    return Ciphertext(list(encrypt_core(pt_pe0, v, e1, pk, ctx, level)), level, scale)


# ---------------------------------------------------------------------------
# The cores that BGV and BFV share with CKKS (ciphertext/bgv.py, bfv.py): they
# take and return component limbs (int64[K, N], NTT domain unless named),
# not a scaled Ciphertext. Reference _encrypt_core, _decrypt_core,
# _add_core, _sub_core, _tensor_core, _mul_plain_core, _relin_core,
# _rescale_core, _galois_core and _hoisted_galois_core (its _hoist_core is
# primitives/keyswitch.py hoist).
# ---------------------------------------------------------------------------


def encrypt_core(pt_pe0: np.ndarray, v: np.ndarray, e1: np.ndarray, pk: DevicePublicKey,
                 ctx: Context, level: int) -> tuple:
    """(c0, c1) = (pk.b v + NTT(pt + e0), pk.a v + NTT(e1)) from the host's
    canonical coefficient residues int64[level, N] of pt + e0, v and e1."""
    host = torch.from_numpy(np.stack([v, pt_pe0, e1]))
    v_ntt, m_ntt, e1_ntt = ntt_fwd(host.to(ctx.device), ctx, limbs=range(level))
    q, qinv = ctx.col("q", range(level)), ctx.col("qinv_neg", range(level))
    c0 = add_mod(mont_mul(v_ntt, pk.b_mont[:level], q, qinv), m_ntt, q)
    c1 = add_mod(mont_mul(v_ntt, pk.a_mont[:level], q, qinv), e1_ntt, q)
    return c0, c1


def decrypt_core(cs, sk: DeviceSecretKey, ctx: Context, level: int) -> torch.Tensor:
    """iNTT(sum_k c_k * s^k): canonical coefficient residues int64[K, N] on
    ctx's device."""
    rows = range(level)
    q, qinv = ctx.col("q", rows), ctx.col("qinv_neg", rows)
    s_mont = sk.s_mont[:level]
    acc = cs[0]
    s_pow = s_mont  # s * R: mont_mul by it multiplies by s exactly
    for comp in cs[1:]:
        acc = add_mod(acc, mont_mul(comp, s_pow, q, qinv), q)
        s_pow = mont_mul(s_pow, s_mont, q, qinv)  # stays in Montgomery form
    return ntt_inv(acc, ctx, limbs=rows)


def add_core(ca, cb, ctx: Context, level: int) -> list:
    q = ctx.col("q", range(level))
    return [add_mod(x, y, q) for x, y in zip(ca, cb)]


def sub_core(ca, cb, ctx: Context, level: int) -> list:
    q = ctx.col("q", range(level))
    return [sub_mod(x, y, q) for x, y in zip(ca, cb)]


def tensor_core(ca, cb, ctx: Context, level: int) -> torch.Tensor:
    """(a0, a1) x (b0, b1) -> (d0, d1, d2), NTT-domain pointwise: one
    int64[3, level, N] stack (ops/tensor_cuda.py; one kernel launch on the
    card), which unpacks into the three components. Span `tensor`."""
    with stage("tensor"):
        return tensor_cuda.tensor(ca, cb, ctx, level)


def mul_plain_core(cs, pt_mont: torch.Tensor, ctx: Context, level: int) -> list:
    """c_k * pt for every component and an NTT-domain Montgomery plaintext,
    by K4 launches of one term: one for (c0, c1) and, for a 3-component
    ciphertext, one of a single output for c2."""
    rows = ctx.index(range(level), torch.int32)
    x = pt_mont[:level].contiguous()[None]
    comps = [c.contiguous()[None] for c in cs]
    out = list(mac(x, comps[0], comps[1], rows, rows, ctx))
    if len(comps) == 3:
        out.extend(mac(x, comps[2], None, rows, rows, ctx))
    return out


def relin_core(cs, ctx: Context, ksc: KSContext, rlk: DeviceKSKey, params: CKKSParams,
               level: int) -> tuple:
    """(d0, d1, d2) -> (d0 + ks0, d1 + ks1), the key switch of d2 by `ksc`'s
    ModDown (the t-corrected one for BGV tables)."""
    q = ctx.col("q", range(level))
    ks0, ks1 = key_switch_core(cs[2], params, level, ctx, ksc, rlk)
    return add_mod(cs[0], ks0, q), add_mod(cs[1], ks1, q)


def rescale_core(cs, ctx: Context, params: CKKSParams, level: int, words: int = 1,
                 bgv: bool = False) -> list:
    """Divide by the last `words` active primes (with bgv, BGV's ModSwitch of
    one): level K -> K - words, one batched transform each way and one drop
    (_drop_tail). Span `rescale`."""
    with stage("rescale"):
        return _drop_tail(ntt_inv(torch.stack(list(cs)), ctx, limbs=range(level)), params,
                          level, words, ctx, bgv, span=False)


def _drop_tail(cc: torch.Tensor, params: CKKSParams, level: int, words: int, ctx: Context,
               bgv: bool = False, span: bool = True) -> list:
    """The tail of every rescale and ModSwitch: coefficient-domain limbs
    int64[C, K, N] lose their last `words` limbs in one drop_limbs call (the
    rescale kernel on the card; BGV's t-corrected ModSwitch where bgv), and
    one batched NTT brings the C components back, int64[K - words, N] each.
    Span `rescale` around the drop, unless the caller's holds the tail. The
    callers hand `cc` over (no reference of theirs), so it is freed before
    the NTT allocates."""
    t = params.plain_modulus if bgv else 0
    with stage("rescale") if span else contextlib.nullcontext():
        cc = rescale_cuda.drop_limbs(
            cc, level, rescale_cuda.drop_tables(params.q_primes[:level], words, t, cc.device),
            bgv)
    return list(ntt_fwd(cc, ctx, limbs=range(level - words)))


def _rescaled_scale(scale: float, params: CKKSParams, level: int, words: int) -> float:
    """The scale after `words` rescales from `level`: scale / q_{K-1} / q_{K-2},
    divided in sequence as the reference rounds it."""
    for q_last in reversed(params.q_primes[level - words : level]):
        scale = scale / q_last
    return scale


def _mul_core(ca, cb, ctx: Context, rlk: DeviceKSKey, params: CKKSParams, level: int,
              bgv: bool = False) -> list:
    """Tensor, relinearise and drop fused, the CKKS ct_mul_full and the BGV
    ct_mul: the key switch of d2 stays in the coefficient domain
    (eval_out=False), d0 and d1 come there by one batched iNTT and are added
    in its ModDown (iNTT(d_i) + ks_i equals iNTT(d_i + NTT(ks_i)) mod q), and
    the tail drops scale_words limbs (with bgv, one by the ModSwitch) and
    brings both components back by one batched NTT. The iNTT reads d0 and
    d1 in place: they are the tensor's stack's first two rows."""
    d = tensor_core(ca, cb, ctx, level)
    ksc = make_ks_context(params, level, device=ctx.device)
    return _drop_tail(key_switch_core(d[2], params, level, ctx, ksc, rlk, eval_out=False,
                                      addend=ntt_inv(d[:2], ctx, limbs=range(level))),
                      params, level, 1 if bgv else params.scale_words, ctx, bgv)


def galois_core(cs, g: int, ctx: Context, ksc: KSContext, key: DeviceKSKey, params: CKKSParams,
                level: int) -> tuple:
    """Automorphism gather of both components, then the key switch of c1.
    Span `galois`."""
    with stage("galois"):
        perm = galois_perm(g, ctx)
        c0g, c1g = cs[0][:, perm], cs[1][:, perm]
        ks0, ks1 = key_switch_core(c1g, params, level, ctx, ksc, key)
        return add_mod(c0g, ks0, ctx.col("q", range(level))), ks1


def hoisted_galois_core(raised: torch.Tensor, c0: torch.Tensor, g: int, ctx: Context,
                        ksc: KSContext, key: DeviceKSKey, params: CKKSParams,
                        level: int) -> tuple:
    """One step of a hoisted rotation from the raised digits (keyswitch.hoist):
    one K4 launch reads them through the automorphism and the key, then
    iNTT, ModDown, NTT, plus the gathered c0. Span `galois` (the shared
    ModUp lies outside it)."""
    with stage("galois"):
        acc = gadget_mac(raised, params, level, ctx, key, perm=galois_perm(g, ctx, torch.int32))
        ks0, ks1 = ks_finish(acc, params, level, ctx, ksc)
        return add_mod(c0[:, galois_perm(g, ctx)], ks0, ctx.col("q", range(level))), ks1



def decrypt_to_coeff(ct: Ciphertext, params: CKKSParams, sk: DeviceSecretKey,
                     ctx: Context) -> np.ndarray:
    """iNTT(sum_k c_k * s^k): canonical coefficient residues int64[K, N] (host).

    `params` is the reference's parameter, unused: `ctx` holds the primes.
    """
    return decrypt_core(ct.c, sk, ctx, ct.level).cpu().numpy()


def decrypt_decode(ct: Ciphertext, params: CKKSParams, sk: DeviceSecretKey,
                   ctx: Context) -> np.ndarray:
    coeff = decrypt_to_coeff(ct, params, sk, ctx)
    return gckks.decode(coeff, ct.scale, ct.primes(params), params.n)


def ct_add(a: Ciphertext, b: Ciphertext, ctx: Context) -> Ciphertext:
    _check_pair(a, b)
    return Ciphertext(add_core(a.c, b.c, ctx, a.level), a.level, a.scale)


def ct_sub(a: Ciphertext, b: Ciphertext, ctx: Context) -> Ciphertext:
    _check_pair(a, b)
    return Ciphertext(sub_core(a.c, b.c, ctx, a.level), a.level, a.scale)


def _check_pair(a: Ciphertext, b: Ciphertext) -> None:
    if a.level != b.level or a.scale != b.scale or len(a.c) != len(b.c):
        raise ValueError("ciphertexts differ in level, scale or size")


def ct_tensor(a: Ciphertext, b: Ciphertext, ctx: Context) -> Ciphertext:
    if a.level != b.level or len(a.c) != 2 or len(b.c) != 2:
        raise ValueError("ct_tensor takes two 2-component ciphertexts at one level")
    return Ciphertext(list(tensor_core(a.c, b.c, ctx, a.level)), a.level, a.scale * b.scale)


def ct_relinearize(ct: Ciphertext, params: CKKSParams, ctx: Context,
                   rlk: DeviceKSKey) -> Ciphertext:
    if len(ct.c) != 3:
        raise ValueError("ct_relinearize takes a 3-component ciphertext")
    ksc = make_ks_context(params, ct.level, device=ctx.device)
    return Ciphertext(list(relin_core(ct.c, ctx, ksc, rlk, params, ct.level)), ct.level,
                      ct.scale)


def ct_rescale(ct: Ciphertext, params: CKKSParams, ctx: Context) -> Ciphertext:
    """Divide by the last active prime: level K -> K-1, one batched transform each way."""
    return _rescale(ct, params, ctx, 1)


def _rescale(ct: Ciphertext, params: CKKSParams, ctx: Context, words: int) -> Ciphertext:
    """Divide by the last `words` active primes (rescale_core)."""
    return Ciphertext(rescale_core(ct.c, ctx, params, ct.level, words), ct.level - words,
                      _rescaled_scale(ct.scale, params, ct.level, words))


def ct_mul(a: Ciphertext, b: Ciphertext, params: CKKSParams, ctx: Context,
           rlk: DeviceKSKey) -> Ciphertext:
    """Homomorphic multiply: tensor -> relinearize -> rescale. Span `ckks.mul`."""
    with stage("ckks.mul"):
        return ct_rescale(ct_relinearize(ct_tensor(a, b, ctx), params, ctx, rlk), params, ctx)


def ct_mul_full(a: Ciphertext, b: Ciphertext, params: CKKSParams, ctx: Context,
                rlk: DeviceKSKey) -> Ciphertext:
    """Tensor + relinearize + scale_words rescales, limb-equal to the reference's
    _mul_full_core (_mul_core). Span `ckks.mul`."""
    if a.level != b.level or len(a.c) != 2 or len(b.c) != 2:
        raise ValueError("ct_mul_full takes two 2-component ciphertexts at one level")
    with stage("ckks.mul"):
        level, words = a.level, params.scale_words
        return Ciphertext(_mul_core(a.c, b.c, ctx, rlk, params, level), level - words,
                          _rescaled_scale(a.scale * b.scale, params, level, words))


def ct_plain_mac(cts: list, pt_monts: list, const_ntt, params: CKKSParams, ctx: Context,
                 out_scale: float) -> Ciphertext:
    """sum_i pt_i * ct_i, rescaled scale_words times, plus an optional constant.

    Reference ct_plain_mac / _plain_mac_core (ct.py:312-389). pt_monts are
    NTT-domain Montgomery plaintexts (encoding/encoder.py), all cts are
    2-component and at one level; const_ntt (int64[K', N], K' the level
    after the rescales, NTT domain, canonical) is added to c0. out_scale is
    the product scale before the rescales. One K4 launch forms both
    component sums; one batched transform each way around the rescales.
    """
    level = cts[0].level
    if any(c.level != level or len(c.c) != 2 for c in cts) or len(pt_monts) != len(cts):
        raise ValueError("ct_plain_mac takes 2-component ciphertexts at one level, one "
                         "plaintext each")
    rows = ctx.index(range(level), torch.int32)
    acc = mac(torch.stack([pt[:level] for pt in pt_monts]), torch.stack([c.c[0] for c in cts]),
              torch.stack([c.c[1] for c in cts]), rows, rows, ctx)
    words = params.scale_words
    out = _drop_tail(ntt_inv(acc, ctx, limbs=range(level)), params, level, words, ctx)
    if const_ntt is not None:
        out[0] = add_mod(out[0], const_ntt, ctx.col("q", range(level - words)))
    return Ciphertext(out, level - words, _rescaled_scale(out_scale, params, level, words))


def ct_mul_plain(ct: Ciphertext, pt_mont: torch.Tensor, pt_scale: float,
                 ctx: Context) -> Ciphertext:
    """Multiply by an NTT-domain Montgomery plaintext (encoding/encoder.py):
    c_k * pt for every component (mul_plain_core)."""
    return Ciphertext(mul_plain_core(ct.c, pt_mont, ctx, ct.level), ct.level,
                      ct.scale * pt_scale)


def ct_key_switch(ct: Ciphertext, params: CKKSParams, ctx: Context,
                  ksk: DeviceKSKey) -> Ciphertext:
    """Re-encrypt under the secret that ksk switches to (reference
    ct_key_switch; the sparse-secret encapsulation's to_eph / from_eph)."""
    if len(ct.c) != 2:
        raise ValueError("ct_key_switch takes a 2-component ciphertext")
    ksc = make_ks_context(params, ct.level, device=ctx.device)
    ks0, ks1 = key_switch_core(ct.c[1], params, ct.level, ctx, ksc, ksk)
    q = ctx.col("q", range(ct.level))
    return Ciphertext([add_mod(ct.c[0], ks0, q), ks1], ct.level, ct.scale)


def galois_perm(g: int, ctx: Context, dtype=torch.int64) -> torch.Tensor:
    """The eval-domain permutation of X -> X^g on the context's device (cached)."""
    key = ("galois_perm", g, dtype)
    if key not in ctx.cache:
        perm = gckks.automorphism_perm_eval(g, ctx.n)
        ctx.cache[key] = torch.from_numpy(perm).to(device=ctx.device, dtype=dtype)
    return ctx.cache[key]


def _galois(ct: Ciphertext, g: int, params: CKKSParams, ctx: Context,
            key: DeviceKSKey) -> Ciphertext:
    """Automorphism gather of both components, then the key switch of c1
    (reference _galois_core)."""
    if len(ct.c) != 2:
        raise ValueError("a Galois automorphism takes a 2-component ciphertext")
    ksc = make_ks_context(params, ct.level, device=ctx.device)
    return Ciphertext(list(galois_core(ct.c, g, ctx, ksc, key, params, ct.level)), ct.level,
                      ct.scale)


def ct_rotate(ct: Ciphertext, steps: int, params: CKKSParams, ctx: Context,
              gk: DeviceKSKey) -> Ciphertext:
    """Rotate the slots left by `steps`: Galois automorphism + key switch."""
    return _galois(ct, gckks.galois_exponent(steps, params.n), params, ctx, gk)


def ct_conjugate(ct: Ciphertext, params: CKKSParams, ctx: Context,
                 ck: DeviceKSKey) -> Ciphertext:
    """Complex-conjugate the slots: the automorphism g = 2N - 1 + key switch."""
    return _galois(ct, 2 * params.n - 1, params, ctx, ck)


def ct_rotate_hoisted(ct: Ciphertext, steps_list, params: CKKSParams, ctx: Context,
                      gks: dict) -> list:
    """Rotate by many step counts, sharing one decomposition (reference
    ct_rotate_hoisted, ct.py:500-582): one iNTT + ModUp + NTT of c1 for all
    steps; per step one K4 launch reads the raised digits through the
    step's automorphism and the key, then iNTT, ModDown, NTT, plus the
    gathered c0. gks maps steps -> DeviceKSKey.
    """
    if len(ct.c) != 2:
        raise ValueError("ct_rotate_hoisted takes a 2-component ciphertext")
    level = ct.level
    ksc = make_ks_context(params, level, device=ctx.device)
    raised = hoist(ct.c[1], params, level, ctx, ksc)
    return [Ciphertext(list(hoisted_galois_core(raised, ct.c[0],
                                                gckks.galois_exponent(steps, params.n), ctx,
                                                ksc, gks[steps], params, level)),
                       level, ct.scale)
            for steps in steps_list]


class PlainGroup(NamedTuple):
    """One giant group of a BSGS product (ct_baby_sums): its encoded
    diagonals int64[D, K, N] (NTT domain, Montgomery form) at one scale, and
    the rotations they multiply, rows first .. first + D - 1 of the stack of
    rotations, or the rows `index` (int64[D]) where those are not one run."""

    pts: torch.Tensor
    scale: float
    first: int
    index: torch.Tensor | None


def _galois_perms(steps: tuple, params: CKKSParams, ctx: Context) -> torch.Tensor:
    """The eval-domain permutations of the steps' automorphisms, one after
    another: int64[len(steps) * N] (cached)."""
    key = ("galois_perms", steps)
    if key not in ctx.cache:
        ctx.cache[key] = torch.cat([galois_perm(gckks.galois_exponent(s, params.n), ctx)
                                    for s in steps])
    return ctx.cache[key]


def ct_baby_sums(ct: Ciphertext, steps, groups, params: CKKSParams, ctx: Context,
                 gks: dict) -> list:
    """The inner sums of a BSGS product (linalg.BsgsPlan): for each
    PlainGroup, sum_d pts[d] * rot_d(ct), not rescaled, where rot_d is a row
    of the stack [ct, rot_{steps[0]}(ct), rot_{steps[1]}(ct), ...].

    The rotations share one ModUp (hoist) and are batched: K4 launches back
    to back, one a step, read the raised digits through its automorphism and
    key into one int64[2, len(steps), K+alpha, N] stack (gadget_macs), then
    one iNTT, ModDown and NTT, one gather of c0 and one add serve every step
    (span `galois`). Each group is then one K4 launch over its rows of the
    stack. Equal limb for
    limb to ct_rotate_hoisted, then ct_mul_plain and ct_add term by term."""
    if len(ct.c) != 2:
        raise ValueError("ct_baby_sums takes a 2-component ciphertext")
    level = ct.level
    c0, c1 = ct.c
    ys0, ys1 = c0[None], c1[None]
    if steps:
        steps = tuple(steps)
        ksc = make_ks_context(params, level, device=ctx.device)
        raised = hoist(c1, params, level, ctx, ksc)
        with stage("galois"):
            acc = torch.empty((2, len(steps)) + tuple(raised.shape[1:]), dtype=torch.int64,
                              device=raised.device)
            perms = [galois_perm(gckks.galois_exponent(s, params.n), ctx, torch.int32)
                     for s in steps]
            gadget_macs(raised, params, level, ctx, [gks[s] for s in steps], perms, acc)
            ks = ks_finish(acc, params, level, ctx, ksc)
            del acc
            c0g = c0.index_select(1, _galois_perms(steps, params, ctx))
            c0g = c0g.view(level, len(steps), ctx.n).transpose(0, 1)
            ys0 = torch.cat([ys0, add_mod(c0g, ks[0], ctx.col("q", range(level)))])
            ys1 = torch.cat([ys1, ks[1]])
    rows = ctx.index(range(level), torch.int32)
    out = []
    for grp in groups:
        if grp.index is None:
            y0, y1 = ys0[grp.first:], ys1[grp.first:]
        else:
            y0, y1 = ys0.index_select(0, grp.index), ys1.index_select(0, grp.index)
        s = mac(grp.pts, y0, y1, rows, rows, ctx)
        out.append(Ciphertext([s[0], s[1]], level, ct.scale * grp.scale))
    return out


# ---------------------------------------------------------------------------
# The fused diagonal fan ("double hoisting"): reference ct_diag_fan and
# _diag_fan_core (ct.py:596-772), the stage behind fftboot.DiagPlan
# ---------------------------------------------------------------------------


def ct_diag_fan(
    ct: Ciphertext,
    offsets: tuple,
    pt_stacks: tuple,
    pt0s: tuple,
    pt_scale: float,
    params: CKKSParams,
    ctx: Context,
    gks: dict,
) -> list:
    """One grouped diagonal stage: for each output set s,

        rescale^scale_words( sum_j pt_s[j] * rot_{offsets[j]}(ct) + pt0_s * ct )

    with one hoisted decomposition for every rotation and one ModDown per
    output. offsets: the sorted nonzero rotation steps (R of them);
    pt_stacks: per set, int64[R, K+alpha, N] NTT-domain Montgomery
    plaintext diagonals over the active Q+P basis (missing offsets zero);
    pt0s: per set, the zero-offset diagonal int64[K+alpha, N] or None; all
    at scale pt_scale. gks maps steps -> DeviceKSKey (stored at any level
    >= the ciphertext's). Returns one Ciphertext per set, limb-equal to the
    reference's.

    Every inner product is a K4 launch: per offset, the raised digits (read
    through the offset's automorphism) against its Galois key, both
    components written into one [2, R, K+alpha, N] stack; per set, the
    plaintext stack against that stack (R digits, two outputs); per set,
    the gathered c0 stack against the plaintext stack's q rows (one
    output); and per set with a zero-offset diagonal, c0 and c1 times it.
    Those products' coefficient-domain sum is added in the set's ModDown.
    Span `fan`.
    """
    if len(ct.c) != 2:
        raise ValueError("ct_diag_fan takes a 2-component ciphertext")
    with stage("fan"):
        level, words = ct.level, params.scale_words
        r_count = len(offsets)
        qp = qp_indices(params, level)
        ksc = make_ks_context(params, level, device=ctx.device)
        raised = hoist(ct.c[1], params, level, ctx, ksc)
        exps = [gckks.galois_exponent(s, params.n) for s in offsets]
        t = torch.empty((2, r_count, len(qp), params.n), dtype=torch.int64, device=ctx.device)
        for j, (s, g) in enumerate(zip(offsets, exps)):
            gadget_mac(raised, params, level, ctx, gks[s], perm=galois_perm(g, ctx, torch.int32),
                       out=t[:, j])
        c0, c1 = ct.c[0].contiguous(), ct.c[1].contiguous()
        c0g = torch.stack([c0[:, galois_perm(g, ctx)] for g in exps])
        rows_qp = ctx.index(range(len(qp)), torch.int32)
        chain_qp = ctx.index(qp, torch.int32)
        rows_q = ctx.index(range(level), torch.int32)
        q = ctx.col("q", range(level))
        outs = []
        for pts, pt0 in zip(pt_stacks, pt0s):
            acc = mac(pts, t[0], t[1], rows_qp, chain_qp, ctx)
            e = [mac(c0g, pts, None, rows_q, rows_q, ctx)[0]]
            if pt0 is not None:
                p0 = mac(pt0[:level][None], c0[None], c1[None], rows_q, rows_q, ctx)
                e = [add_mod(e[0], p0[0], q), p0[1]]
            e_coeff = ntt_inv(torch.stack(e), ctx, limbs=range(level))
            outs.append(Ciphertext(
                _drop_tail(ks_finish(acc, params, level, ctx, ksc, eval_out=False,
                                     addend=e_coeff), params, level, words, ctx),
                level - words, _rescaled_scale(ct.scale * pt_scale, params, level, words)))
        return outs


# ---------------------------------------------------------------------------
# ModRaise (bootstrapping step 0): reference ct_mod_raise and ct_mod_raise2
# (ct.py:774-873)
# ---------------------------------------------------------------------------


def _const_col(ctx: Context, values: list[int]) -> torch.Tensor:
    """A cached int64[L, 1] column of per-prime constants on ctx's device."""
    key = ("const_col", tuple(values))
    if key not in ctx.cache:
        ctx.cache[key] = torch.tensor(values, dtype=torch.int64, device=ctx.device)[:, None]
    return ctx.cache[key]


def ct_mod_raise(ct: Ciphertext, params: CKKSParams, ctx: Context) -> Ciphertext:
    """Re-embed an exhausted level-1 ciphertext into the full chain: the
    centred lift of its coefficients mod q0 reduced into every prime. The
    output encrypts m + q0 I for a small integer polynomial I, which the
    bootstrap's EvalMod removes."""
    if ct.level != 1 or len(ct.c) != 2:
        raise ValueError("ct_mod_raise takes a 2-component ciphertext at level 1")
    level = params.num_limbs
    q0 = params.q_primes[0]
    q = ctx.col("q", range(level))
    q0_mod = _const_col(ctx, [q0 % p for p in params.q_primes])
    coeff = ntt_inv(torch.stack(ct.c), ctx, limbs=[0])  # int64[2, 1, N] mod q0
    r = torch.remainder(coeff, q)  # int64[2, L, N]
    lifted = torch.where(coeff > q0 // 2, sub_mod(r, q0_mod, q), r)
    return Ciphertext(list(ntt_fwd(lifted, ctx, limbs=range(level))), level, ct.scale)


def ct_mod_raise2(ct: Ciphertext, params: CKKSParams, ctx: Context) -> Ciphertext:
    """Double-word ModRaise: the centred CRT lift from the composite base
    Q0 = q0 q1 into the full chain. With x0, x1 the residues mod q0, q1 and
    t = (x1 - x0) q0^-1 mod q1, the value is v = x0 + q0 t in [0, Q0), and
    v > Q0 // 2 exactly when t > half1 or (t == half1 and x0 > rem), where
    Q0 // 2 = half1 q0 + rem (the reference's rule); such v lift to v - Q0."""
    if ct.level != 2 or len(ct.c) != 2:
        raise ValueError("ct_mod_raise2 takes a 2-component ciphertext at level 2")
    level = params.num_limbs
    q0, q1 = params.q_primes[0], params.q_primes[1]
    big = q0 * q1
    half1, rem = divmod(big // 2, q0)
    q = ctx.col("q", range(level))
    q0_mod = _const_col(ctx, [q0 % p for p in params.q_primes])
    big_mod = _const_col(ctx, [big % p for p in params.q_primes])
    x = ntt_inv(torch.stack(ct.c), ctx, limbs=[0, 1])  # int64[2, 2, N]
    x0, x1 = x[:, 0:1], x[:, 1:2]
    t = torch.remainder(sub_mod(x1, torch.remainder(x0, q1), q1) * pow(q0, -1, q1), q1)
    negative = (t > half1) | ((t == half1) & (x0 > rem))
    v = add_mod(torch.remainder(x0, q), torch.remainder(torch.remainder(t, q) * q0_mod, q), q)
    v = torch.where(negative, sub_mod(v, big_mod, q), v)
    return Ciphertext(list(ntt_fwd(v, ctx, limbs=range(level))), level, ct.scale)
