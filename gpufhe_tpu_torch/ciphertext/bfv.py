"""RNS-BFV ciphertext operations: scale-invariant exact integers mod t.

Counterpart of gpufhe_tpu/ciphertext/bfv.py, limb for limb. BFV keys are
CKKS keys, and its key switch is the CKKS hybrid switch with the plain
ModDown by P: every key switch here reads the tables of
make_ks_context(_ckks_view(params)), never the t-corrected BGV ones.

The scheme's own part is the scale-invariant multiply (BEHZ family,
`_tensor_coeff`): iNTT over Q, approximate conversion to the auxiliary basis
B and m_sk (kernel K3), NTT and tensor over both bases, the t/Q scaling as
an exact division over the aux basis, the Shenoy-Kumaresan exact conversion
back to Q (K3 from B to m_sk and from B to Q), and the relinearisation
added in the coefficient domain, so each output component is transformed
once. Every conversion term is reduced as the reference's golden model
reduces it, so the limbs are the reference's.

Scheme switching (bgv_to_bfv, bfv_to_bgv) is one scalar multiply per limb.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from gpufhe_tpu_torch.ciphertext import ct as dct
from gpufhe_tpu_torch.ciphertext import bgv as dbgv
from gpufhe_tpu_torch.ciphertext.bgv import BGVCiphertext
from gpufhe_tpu_torch.golden import bfv as gbfv
from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.keys import keys as dkeys
from gpufhe_tpu_torch.keys.keys import DeviceKSKey, DevicePublicKey, DeviceSecretKey
from gpufhe_tpu_torch.ops.context import Context, make_context
from gpufhe_tpu_torch.ops.convert_cuda import ConvertTables, base_convert, make_convert_tables
from gpufhe_tpu_torch.ops.modops import add_mod, mul_mod, sub_mod
from gpufhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
from gpufhe_tpu_torch.params.params import CKKSParams
from gpufhe_tpu_torch.primitives.keyswitch import hoist, key_switch_core
from gpufhe_tpu_torch.primitives.rns import KSContext, make_ks_context
from gpufhe_tpu_torch.utils.profiling import stage


@dataclasses.dataclass
class BFVCiphertext:
    c: list  # int64[K, N] components, NTT domain
    level: int

    def primes(self, params: CKKSParams) -> tuple[int, ...]:
        return params.q_primes[: self.level]


class BFVKeyChest(dkeys.IntegerKeyChest):
    """Reference ciphertext/bfv.py BFVKeyChest, field for field."""


def keygen(params: CKKSParams, rng: np.random.Generator, rotations: tuple[int, ...] = (), *,
           ctx: Context | None = None) -> BFVKeyChest:
    """The BFV key chest (CKKS keys): sk, pk, rlk and one Galois key per
    step, in the reference's draw order (keys.integer_chest_fields; ctx defaults to the
    parameters' context on the card)."""
    ctx = dkeys.default_context(params, ctx)
    return BFVKeyChest(**dkeys.integer_chest_fields(params, rng, rotations, ctx, 1))


def _ckks_ksc(params: CKKSParams, level: int, device) -> KSContext:
    """The plain ModDown's tables: BFV's key switch is the CKKS one."""
    return make_ks_context(gbfv._ckks_view(params), level, device=device)


# ---------------------------------------------------------------------------
# The auxiliary basis' tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BFVMulTables:
    """What the scale-invariant multiply reads at one (params, level): the
    three conversions' tables and canonical int64 constants ([K] or [A]
    columns; A = len(aux), m_sk the last aux prime)."""

    q2aux: ConvertTables  # Q -> B and m_sk
    b2q: ConvertTables  # B -> Q
    b2msk: ConvertTables  # B -> m_sk
    t_q: torch.Tensor  # [K, 1]  t mod q_i
    t_aux: torch.Tensor  # [A, 1]  t mod p
    qinv_aux: torch.Tensor  # [A, 1]  [Q^-1]_p
    msk_mod_q: torch.Tensor  # [K, 1]  m_sk mod q_i
    b_mod_q: torch.Tensor  # [K, 1]  B mod q_i
    binv_msk: int  # [B^-1]_{m_sk}
    m_sk: int


@functools.lru_cache(maxsize=None)
def make_bfv_mul_context(params: CKKSParams, level: int, *, device="cuda"):
    """(aux params, aux Context, BFVMulTables) for one (params, level)."""
    auxp = gbfv.bfv_aux_params(params, level)
    aux = auxp.q_primes
    qs = params.q_primes[:level]
    t = params.plain_modulus
    b_primes, m_sk = aux[:-1], aux[-1]
    big_q, big_b = math.prod(qs), math.prod(b_primes)

    def col(values):
        return torch.tensor(values, dtype=torch.int64, device=device)[:, None]

    tables = BFVMulTables(
        q2aux=make_convert_tables(qs, aux, device),
        b2q=make_convert_tables(b_primes, qs, device),
        b2msk=make_convert_tables(b_primes, (m_sk,), device),
        t_q=col([t % q for q in qs]),
        t_aux=col([t % p for p in aux]),
        qinv_aux=col([pow(big_q % p, -1, p) for p in aux]),
        msk_mod_q=col([m_sk % q for q in qs]),
        b_mod_q=col([big_b % q for q in qs]),
        binv_msk=pow(big_b % m_sk, -1, m_sk),
        m_sk=m_sk,
    )
    return auxp, make_context(auxp, device=device), tables


# ---------------------------------------------------------------------------
# Encrypt / decrypt and the linear ops
# ---------------------------------------------------------------------------


def _delta_m(pt_coeff: np.ndarray, params: CKKSParams, level: int) -> np.ndarray:
    """Delta m mod each q_i, int64[level, N] (host)."""
    m = np.asarray(pt_coeff, dtype=np.int64) % params.plain_modulus
    q_col = np.asarray(params.q_primes[:level], dtype=np.int64)[:, None]
    return gbfv.delta_rns(params, level) * m[None, :] % q_col


def encrypt(pt_coeff: np.ndarray, params: CKKSParams, pk: DevicePublicKey, ctx: Context,
            rng: np.random.Generator, level: int | None = None) -> BFVCiphertext:
    """Public-key encrypt plaintext coefficients int64[N] mod t as Delta m,
    Delta = floor(Q/t); v, e0, e1 drawn on the host in the reference's order."""
    level = level if level is not None else params.num_limbs
    primes = params.q_primes[:level]
    n = params.n
    v = gckks.small_to_rns(gckks.sample_ternary(rng, n), primes)
    e0 = gckks.small_to_rns(gckks.sample_gauss(rng, n, params.sigma), primes)
    e1 = gckks.small_to_rns(gckks.sample_gauss(rng, n, params.sigma), primes)
    pt_pe0 = (_delta_m(pt_coeff, params, level) + e0) % np.asarray(primes, np.int64)[:, None]
    return BFVCiphertext(list(dct.encrypt_core(pt_pe0, v, e1, pk, ctx, level)), level)


def decrypt(ct: BFVCiphertext, params: CKKSParams, sk: DeviceSecretKey,
            ctx: Context) -> np.ndarray:
    """Plaintext coefficients int64[N] mod t: round(t x / Q) mod t."""
    coeff = dct.decrypt_core(ct.c, sk, ctx, ct.level).cpu().numpy()
    primes = ct.primes(params)
    return gbfv.round_decode_coeff(gckks.crt_compose_centered(coeff, primes),
                                   params.plain_modulus, math.prod(primes))


def decrypt_decode(ct: BFVCiphertext, params: CKKSParams, sk: DeviceSecretKey,
                   ctx: Context) -> np.ndarray:
    return gbfv.decode(decrypt(ct, params, sk, ctx), params)


def ct_add(a: BFVCiphertext, b: BFVCiphertext, ctx: Context) -> BFVCiphertext:
    if a.level != b.level or len(a.c) != len(b.c):
        raise ValueError("BFV ciphertexts differ in level or size")
    return BFVCiphertext(dct.add_core(a.c, b.c, ctx, a.level), a.level)


def ct_sub(a: BFVCiphertext, b: BFVCiphertext, ctx: Context) -> BFVCiphertext:
    if a.level != b.level or len(a.c) != len(b.c):
        raise ValueError("BFV ciphertexts differ in level or size")
    return BFVCiphertext(dct.sub_core(a.c, b.c, ctx, a.level), a.level)


def plaintext_to_device(pt_coeff: np.ndarray, params, ctx, level: int) -> torch.Tensor:
    """Integer plaintext coefficients int64[N] -> NTT-domain Montgomery
    int64[level, N], packed as BGV's (ciphertext/bgv.py plaintext_to_device)."""
    return dbgv.plaintext_to_device(pt_coeff, params, ctx, level)


def ct_mul_plain(ct: BFVCiphertext, pt_mont: torch.Tensor, ctx: Context) -> BFVCiphertext:
    """Multiply by an unscaled integer plaintext (plaintext_to_device):
    Delta m m2 stays on Delta."""
    return BFVCiphertext(dct.mul_plain_core(ct.c, pt_mont, ctx, ct.level), ct.level)


def ct_add_plain(ct: BFVCiphertext, pt_coeff: np.ndarray, params: CKKSParams,
                 ctx: Context) -> BFVCiphertext:
    """c0 += NTT(Delta m2)."""
    dm = torch.from_numpy(_delta_m(pt_coeff, params, ct.level)).to(ctx.device)
    c0 = add_mod(ct.c[0], ntt_fwd(dm, ctx, limbs=range(ct.level)), ctx.col("q", range(ct.level)))
    return BFVCiphertext([c0] + list(ct.c[1:]), ct.level)


# ---------------------------------------------------------------------------
# The scale-invariant multiply
# ---------------------------------------------------------------------------


def _tensor_coeff(ca, cb, params: CKKSParams, ctx: Context, level: int) -> torch.Tensor:
    """The BEHZ tensor (reference _bfv_tensor_core, out_mode "coeff"):
    round(t/Q (a x b)) over Q, all three components in the coefficient
    domain, int64[3, K, N].

    Transforms are batched over the components (one K1 launch per basis and
    direction); each conversion is one K3 launch per component: Q -> aux for
    the four inputs and for [t d]_Q, B -> m_sk and B -> Q per output. Span
    `tensor` (tensor_core's two nest inside it)."""
    with stage("tensor"):
        auxp, aux_ctx, tabs = make_bfv_mul_context(params, level, device=ctx.device)
        a_dim = len(auxp.q_primes)
        q_rows, a_rows = range(level), range(a_dim)
        q, aq = ctx.col("q", q_rows), aux_ctx.col("q", a_rows)

        # 1. extend both inputs to the aux basis (approximate conversion)
        coeff = ntt_inv(torch.stack([*ca, *cb]), ctx, limbs=q_rows)
        ext = ntt_fwd(torch.stack([base_convert(x, tabs.q2aux) for x in coeff]), aux_ctx,
                      limbs=a_rows)
        # 2. tensor over both bases
        d_q = dct.tensor_core(ca, cb, ctx, level)
        d_aux = dct.tensor_core(ext[:2], ext[2:], aux_ctx, a_dim)
        dq = ntt_inv(d_q, ctx, limbs=q_rows)
        daux = ntt_inv(d_aux, aux_ctx, limbs=a_rows)
        # 3. y = (t d - [t d]_Q) / Q over aux: an exact division
        r = mul_mod(dq, tabs.t_q, q)
        r_aux = torch.stack([base_convert(x, tabs.q2aux) for x in r])
        y = mul_mod(sub_mod(mul_mod(daux, tabs.t_aux, aq), r_aux, aq), tabs.qinv_aux, aq)
        # 4. back to Q, exactly
        return torch.stack([sk_convert_to_q(yc, tabs, q) for yc in y])


def sk_convert_to_q(y: torch.Tensor, tabs: BFVMulTables, q: torch.Tensor) -> torch.Tensor:
    """Shenoy-Kumaresan exact conversion of int64[A, N] over B and m_sk to
    the Q basis (q: the [K, 1] primes), valid for |y| < prod(B) / 2: the
    redundant m_sk recovers the approximate B -> Q conversion's overflow
    count alpha, centred (alpha > m_sk // 2 lifts to alpha - m_sk), which is
    subtracted times B (reference golden/bfv.py _sk_convert_to_q)."""
    m_sk = tabs.m_sk
    yb = y[:-1]
    conv_sk = base_convert(yb, tabs.b2msk)[0]
    alpha = mul_mod(sub_mod(conv_sk, y[-1], m_sk), tabs.binv_msk, m_sk)
    ra = torch.remainder(alpha, q)
    lifted = torch.where(alpha > m_sk // 2, sub_mod(ra, tabs.msk_mod_q, q), ra)
    return sub_mod(base_convert(yb, tabs.b2q), mul_mod(lifted, tabs.b_mod_q, q), q)


def ct_tensor(a: BFVCiphertext, b: BFVCiphertext, params: CKKSParams,
              ctx: Context) -> BFVCiphertext:
    """The scale-invariant tensor, three components in the NTT domain."""
    if a.level != b.level or len(a.c) != 2 or len(b.c) != 2:
        raise ValueError("ct_tensor takes two 2-component ciphertexts at one level")
    d = _tensor_coeff(a.c, b.c, params, ctx, a.level)
    return BFVCiphertext(list(ntt_fwd(d, ctx, limbs=range(a.level))), a.level)


def ct_relinearize(ct: BFVCiphertext, params: CKKSParams, ctx: Context,
                   rlk: DeviceKSKey) -> BFVCiphertext:
    if len(ct.c) != 3:
        raise ValueError("ct_relinearize takes a 3-component ciphertext")
    ksc = _ckks_ksc(params, ct.level, ctx.device)
    return BFVCiphertext(list(dct.relin_core(ct.c, ctx, ksc, rlk, params, ct.level)),
                         ct.level)


def _relin_coeff(d: torch.Tensor, params: CKKSParams, ctx: Context, level: int,
                 rlk: DeviceKSKey) -> list:
    """Relinearise a coefficient-domain tensor int64[3, K, N] (reference
    _bfv_relin_coeff): the key switch of d2 takes and returns the
    coefficient domain, the sums with d0, d1 are formed in its ModDown, and
    one batched NTT brings both components back."""
    ksc = _ckks_ksc(params, level, ctx.device)
    cc = key_switch_core(d[2], params, level, ctx, ksc, rlk, eval_out=False, eval_in=False,
                         addend=d[:2])
    return list(ntt_fwd(cc, ctx, limbs=range(level)))


def ct_mul(a: BFVCiphertext, b: BFVCiphertext, params: CKKSParams, ctx: Context,
           rlk: DeviceKSKey) -> BFVCiphertext:
    """Tensor and relinearise with the boundary transforms cancelled: limbs
    equal ct_relinearize(ct_tensor(a, b)) (NTT linearity). The level stays.
    Span `bfv.mul`."""
    if a.level != b.level or len(a.c) != 2 or len(b.c) != 2:
        raise ValueError("ct_mul takes two 2-component ciphertexts at one level")
    with stage("bfv.mul"):
        d = _tensor_coeff(a.c, b.c, params, ctx, a.level)
        return BFVCiphertext(_relin_coeff(d, params, ctx, a.level, rlk), a.level)


def ct_mod_reduce(ct: BFVCiphertext, params: CKKSParams, ctx: Context) -> BFVCiphertext:
    """Drop q_last by the CKKS rescale's centred exact division: Delta
    shrinks to floor(Q'/t) and the plaintext stays."""
    return BFVCiphertext(dct.rescale_core(ct.c, ctx, params, ct.level), ct.level - 1)


# ---------------------------------------------------------------------------
# Scheme switching BGV <-> BFV: BGV holds m + t e, BFV Delta m + e; a scalar
# maps one to the other, and the message factor it leaves is tracked (BGV's
# pt_factor, or returned for BFV) instead of corrected in the ciphertext.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _switch_constants(params: CKKSParams, level: int) -> tuple:
    """([t^-1]_Q mod q_i, t mod q_i, k = (t t^-1 - 1) / Q mod t,
    (-Q mod t)^-1 mod t) at one level."""
    t = params.plain_modulus
    primes = params.q_primes[:level]
    big_q = math.prod(primes)
    tinv = pow(t, -1, big_q)
    return (tuple(tinv % q for q in primes), tuple(t % q for q in primes),
            (t * tinv - 1) // big_q % t, pow(-(big_q % t) % t, -1, t))


def _scalar_mul(cs, values: tuple, ctx: Context, level: int) -> list:
    col = torch.tensor(values, dtype=torch.int64, device=ctx.device)[:, None]
    q = ctx.col("q", range(level))
    return [mul_mod(c, col, q) for c in cs]


def bgv_to_bfv(ct: BGVCiphertext, params: CKKSParams, ctx: Context) -> tuple:
    """BGV -> (BFV ciphertext, message factor): every component times [t^-1]_Q.
    The BFV decryption is factor times the BGV message, mod t."""
    tinv, _, k, _ = _switch_constants(params, ct.level)
    t = params.plain_modulus
    return (BFVCiphertext(_scalar_mul(ct.c, tinv, ctx, ct.level), ct.level),
            k * pow(int(ct.pt_factor), -1, t) % t)


def bfv_to_bgv(ct: BFVCiphertext, params: CKKSParams, ctx: Context) -> BGVCiphertext:
    """BFV -> BGV: every component times t, the message factor -Q^-1 mod t
    folded into pt_factor, so BGV's decryption is the BFV message."""
    _, t_vals, _, neg_r_inv = _switch_constants(params, ct.level)
    return BGVCiphertext(_scalar_mul(ct.c, t_vals, ctx, ct.level), ct.level, neg_r_inv)


# ---------------------------------------------------------------------------
# Rotations: the CKKS Galois machinery with the plain ModDown
# ---------------------------------------------------------------------------


def ct_rotate(ct: BFVCiphertext, steps: int, params: CKKSParams, ctx: Context,
              gk: DeviceKSKey) -> BFVCiphertext:
    if len(ct.c) != 2:
        raise ValueError("ct_rotate takes a 2-component ciphertext")
    ksc = _ckks_ksc(params, ct.level, ctx.device)
    g = gckks.galois_exponent(steps, params.n)
    return BFVCiphertext(list(dct.galois_core(ct.c, g, ctx, ksc, gk, params, ct.level)),
                         ct.level)


def ct_rotate_hoisted(ct: BFVCiphertext, steps_list, params: CKKSParams, ctx: Context,
                      gks: dict) -> list:
    """Many rotations sharing one decomposition of c1. gks maps steps ->
    DeviceKSKey."""
    if len(ct.c) != 2:
        raise ValueError("ct_rotate_hoisted takes a 2-component ciphertext")
    level = ct.level
    ksc = _ckks_ksc(params, level, ctx.device)
    raised = hoist(ct.c[1], params, level, ctx, ksc)
    return [BFVCiphertext(list(dct.hoisted_galois_core(
                raised, ct.c[0], gckks.galois_exponent(s, params.n), ctx, ksc, gks[s], params,
                level)), level)
            for s in steps_list]
