"""RNS-BGV ciphertext operations: exact integer slots mod t.

Counterpart of gpufhe_tpu/ciphertext/bgv.py, limb for limb. BGV runs on the
CKKS machinery (ciphertext/ct.py's cores, primitives/keyswitch.py): for BGV
parameters make_ks_context folds the t-correction of the ModDown by P into
its conversion tables, so the same key switch, and kernel K3, divide by P
correctly for BGV. ModSwitch, the rescale's counterpart, is the rescale
kernel's BGV mode (ct.py rescale_core and _mul_core with bgv).

Errors enter times t (c0 + c1 s = m + t e mod Q) and decryption reduces the
centred value mod t. A ciphertext tracks `pt_factor`, the product of the
dropped q_last mod t (and the message factor of a scheme switch), which
decryption multiplies out.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpufhe_tpu_torch.ciphertext import ct as dct
from gpufhe_tpu_torch.golden import bgv as gbgv
from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.keys import keys as dkeys
from gpufhe_tpu_torch.keys.keys import DeviceKSKey, DevicePublicKey, DeviceSecretKey
from gpufhe_tpu_torch.ops.context import Context
from gpufhe_tpu_torch.ops.ntt import ntt_fwd
from gpufhe_tpu_torch.params.params import CKKSParams
from gpufhe_tpu_torch.primitives.keyswitch import hoist
from gpufhe_tpu_torch.primitives.rns import make_ks_context
from gpufhe_tpu_torch.utils.profiling import stage


@dataclasses.dataclass
class BGVCiphertext:
    c: list  # int64[K, N] components, NTT domain
    level: int
    pt_factor: int  # the message is the decryption of c times pt_factor, mod t

    def primes(self, params: CKKSParams) -> tuple[int, ...]:
        return params.q_primes[: self.level]


class BGVKeyChest(dkeys.IntegerKeyChest):
    """Reference ciphertext/bgv.py BGVKeyChest, field for field."""


def keygen(params: CKKSParams, rng: np.random.Generator, rotations: tuple[int, ...] = (), *,
           ctx: Context | None = None) -> BGVKeyChest:
    """The BGV key chest: sk, pk, rlk and one Galois key per step, every
    error times t, in the reference's draw order (keys.integer_chest_fields; ctx defaults
    to the parameters' context on the card)."""
    ctx = dkeys.default_context(params, ctx)
    return BGVKeyChest(**dkeys.integer_chest_fields(params, rng, rotations, ctx, params.plain_modulus))


def encrypt(pt_coeff: np.ndarray, params: CKKSParams, pk: DevicePublicKey, ctx: Context,
            rng: np.random.Generator, level: int | None = None) -> BGVCiphertext:
    """Public-key encrypt plaintext coefficients int64[N] mod t (encode's
    output); v, t e0, t e1 drawn on the host in the reference's order."""
    t = params.plain_modulus
    level = level if level is not None else params.num_limbs
    primes = params.q_primes[:level]
    n = params.n
    v = gckks.small_to_rns(gckks.sample_ternary(rng, n), primes)
    e0 = gckks.small_to_rns(t * gckks.sample_gauss(rng, n, params.sigma), primes)
    e1 = gckks.small_to_rns(t * gckks.sample_gauss(rng, n, params.sigma), primes)
    q_col = np.asarray(primes, dtype=np.int64)[:, None]
    pt_pe0 = (np.asarray(pt_coeff, dtype=np.int64)[None, :] % q_col + e0) % q_col
    return BGVCiphertext(list(dct.encrypt_core(pt_pe0, v, e1, pk, ctx, level)), level, 1)


def decrypt(ct: BGVCiphertext, params: CKKSParams, sk: DeviceSecretKey,
            ctx: Context) -> np.ndarray:
    """Plaintext coefficients int64[N] mod t, pt_factor multiplied out."""
    t = params.plain_modulus
    coeff = dct.decrypt_core(ct.c, sk, ctx, ct.level).cpu().numpy()
    centered = gckks.crt_compose_centered(coeff, ct.primes(params))
    return (centered % t * ct.pt_factor % t).astype(np.int64)


def decrypt_decode(ct: BGVCiphertext, params: CKKSParams, sk: DeviceSecretKey,
                   ctx: Context) -> np.ndarray:
    return gbgv.decode(decrypt(ct, params, sk, ctx), params)


def _check_pair(a: BGVCiphertext, b: BGVCiphertext) -> None:
    if a.level != b.level or a.pt_factor != b.pt_factor or len(a.c) != len(b.c):
        raise ValueError("BGV ciphertexts differ in level, pt_factor or size")


def ct_add(a: BGVCiphertext, b: BGVCiphertext, ctx: Context) -> BGVCiphertext:
    _check_pair(a, b)
    return BGVCiphertext(dct.add_core(a.c, b.c, ctx, a.level), a.level, a.pt_factor)


def ct_sub(a: BGVCiphertext, b: BGVCiphertext, ctx: Context) -> BGVCiphertext:
    _check_pair(a, b)
    return BGVCiphertext(dct.sub_core(a.c, b.c, ctx, a.level), a.level, a.pt_factor)


def plaintext_to_device(pt_coeff: np.ndarray, params: CKKSParams, ctx: Context,
                        level: int) -> torch.Tensor:
    """Integer plaintext coefficients int64[N] -> NTT-domain Montgomery
    int64[level, N] (BGV and BFV pack plaintexts alike)."""
    q_col = np.asarray(params.q_primes[:level], dtype=np.int64)[:, None]
    m_rns = torch.from_numpy(np.asarray(pt_coeff, dtype=np.int64)[None, :] % q_col)
    return dkeys.mont_form(ntt_fwd(m_rns.to(ctx.device), ctx, limbs=range(level)), ctx)


def ct_mul_plain(ct: BGVCiphertext, pt_mont: torch.Tensor, ctx: Context) -> BGVCiphertext:
    return BGVCiphertext(dct.mul_plain_core(ct.c, pt_mont, ctx, ct.level), ct.level,
                         ct.pt_factor)


def ct_tensor(a: BGVCiphertext, b: BGVCiphertext, params: CKKSParams,
              ctx: Context) -> BGVCiphertext:
    if a.level != b.level or len(a.c) != 2 or len(b.c) != 2:
        raise ValueError("ct_tensor takes two 2-component ciphertexts at one level")
    return BGVCiphertext(list(dct.tensor_core(a.c, b.c, ctx, a.level)), a.level,
                         a.pt_factor * b.pt_factor % params.plain_modulus)


def ct_relinearize(ct: BGVCiphertext, params: CKKSParams, ctx: Context,
                   rlk: DeviceKSKey) -> BGVCiphertext:
    if len(ct.c) != 3:
        raise ValueError("ct_relinearize takes a 3-component ciphertext")
    ksc = make_ks_context(params, ct.level, device=ctx.device)  # t-corrected ModDown
    return BGVCiphertext(list(dct.relin_core(ct.c, ctx, ksc, rlk, params, ct.level)),
                         ct.level, ct.pt_factor)


def _modswitched_factor(pt_factor: int, params: CKKSParams, level: int) -> int:
    """ModSwitch from `level` scales the message by q_last: pt_factor tracks it."""
    t = params.plain_modulus
    return pt_factor * (params.q_primes[level - 1] % t) % t


def ct_modswitch(ct: BGVCiphertext, params: CKKSParams, ctx: Context) -> BGVCiphertext:
    """Drop q_last (level K -> K-1), the t-corrected division; one batched
    transform each way. Span `rescale`."""
    level = ct.level
    return BGVCiphertext(dct.rescale_core(ct.c, ctx, params, level, bgv=True), level - 1,
                         _modswitched_factor(ct.pt_factor, params, level))


def ct_mul(a: BGVCiphertext, b: BGVCiphertext, params: CKKSParams, ctx: Context,
           rlk: DeviceKSKey) -> BGVCiphertext:
    """Tensor, relinearise and ModSwitch fused (reference bgv.py:181-230;
    ct.py _mul_core with bgv): by NTT linearity the limbs equal
    ct_modswitch(ct_relinearize(ct_tensor)). Output at level - 1, pt_factor
    the factors' product times q_last mod t. Span `bgv.mul`, the ModSwitch
    inside it `rescale`."""
    if a.level != b.level or len(a.c) != 2 or len(b.c) != 2:
        raise ValueError("ct_mul takes two 2-component ciphertexts at one level")
    level = a.level
    with stage("bgv.mul"):
        down = dct._mul_core(a.c, b.c, ctx, rlk, params, level, bgv=True)
    t = params.plain_modulus
    return BGVCiphertext(down, level - 1,
                         _modswitched_factor(a.pt_factor * b.pt_factor % t, params, level))


def ct_rotate(ct: BGVCiphertext, steps: int, params: CKKSParams, ctx: Context,
              gk: DeviceKSKey) -> BGVCiphertext:
    """Rotate the slots by the 5^steps automorphism (slot_rotation_perm)."""
    if len(ct.c) != 2:
        raise ValueError("ct_rotate takes a 2-component ciphertext")
    ksc = make_ks_context(params, ct.level, device=ctx.device)
    g = gckks.galois_exponent(steps, params.n)
    return BGVCiphertext(list(dct.galois_core(ct.c, g, ctx, ksc, gk, params, ct.level)),
                         ct.level, ct.pt_factor)


def ct_rotate_hoisted(ct: BGVCiphertext, steps_list, params: CKKSParams, ctx: Context,
                      gks: dict) -> list:
    """Rotate by many step counts sharing one decomposition of c1 (the CKKS
    hoist, the t-corrected ModDown). gks maps steps -> DeviceKSKey."""
    if len(ct.c) != 2:
        raise ValueError("ct_rotate_hoisted takes a 2-component ciphertext")
    level = ct.level
    ksc = make_ks_context(params, level, device=ctx.device)
    raised = hoist(ct.c[1], params, level, ctx, ksc)
    return [BGVCiphertext(list(dct.hoisted_galois_core(
                raised, ct.c[0], gckks.galois_exponent(s, params.n), ctx, ksc, gks[s], params,
                level)), level, ct.pt_factor)
            for s in steps_list]
