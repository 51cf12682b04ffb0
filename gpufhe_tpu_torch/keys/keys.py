"""Device key material (Montgomery form, NTT domain) and the key chest.

Counterpart of gpufhe_tpu/keys/keys.py, with its signatures: keygen(params,
rng, rotations, conjugation) and upload_*(key, params). Keys are generated by
the port's golden layer from an explicit numpy Generator (the reference's
draws) and stored as x * 2^32 mod q, so each use inside an inner product is
one ops/modops.mont_mul, and the values equal the reference's device keys.
Every entry point takes the context as the keyword `ctx`; without it the
parameters' context on the card is used (default_context).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.ops.context import Context, make_context
from gpufhe_tpu_torch.ops.modops import mont_mul
from gpufhe_tpu_torch.params.params import CKKSParams

R = 1 << 32  # the Montgomery radix


def _mont_np(x: np.ndarray, primes, lead_axes: int = 0) -> torch.Tensor:
    """Host canonical int64[..., L, N] -> its Montgomery form x * 2^32 mod q
    as an int64 tensor on the host (the reference's helper of this name,
    whose result is a device array: callers move this one to their device)."""
    q = np.asarray(primes, dtype=np.int64).reshape((1,) * lead_axes + (-1, 1))
    x = np.asarray(x, dtype=np.int64)
    return torch.from_numpy(x * ((1 << 32) % q) % q)


class DevicePublicKey(NamedTuple):
    b_mont: torch.Tensor  # int64[L, N] NTT domain, Montgomery
    a_mont: torch.Tensor  # int64[L, N]


class DeviceKSKey(NamedTuple):
    """Hybrid key-switch key: dnum gadget rows over the full Q+P chain."""

    b_mont: torch.Tensor  # int64[dnum, L+alpha, N] NTT domain, Montgomery
    a_mont: torch.Tensor  # int64[dnum, L+alpha, N]


class DeviceSecretKey(NamedTuple):
    s_mont: torch.Tensor  # int64[L+alpha, N] NTT domain over the full chain, Montgomery


def default_context(params: CKKSParams, ctx: Context | None) -> Context:
    """ctx, or when it is None the parameters' context on the card (cached):
    an entry point runs on the card unless its caller passes a CPU context."""
    return make_context(params) if ctx is None else ctx


def mont_form(x: torch.Tensor, ctx: Context) -> torch.Tensor:
    """Canonical int64[..., L, N] over the chain prefix (on any device: the
    chest keeps canonical keys on the host) -> x * 2^32 mod q on ctx's
    device."""
    rows = range(x.shape[-2])
    return mont_mul(x.to(ctx.device), ctx.col("r2", rows), ctx.col("q", rows),
                    ctx.col("qinv_neg", rows))


def upload_public_key(pk: gckks.PublicKey, params: CKKSParams, *,
                      ctx: Context | None = None) -> DevicePublicKey:
    ctx = default_context(params, ctx)
    return DevicePublicKey(b_mont=mont_form(pk.b, ctx), a_mont=mont_form(pk.a, ctx))


def upload_ks_key(ksk: gckks.KSKey, params: CKKSParams, *,
                  ctx: Context | None = None) -> DeviceKSKey:
    ctx = default_context(params, ctx)
    return DeviceKSKey(b_mont=mont_form(ksk.b, ctx), a_mont=mont_form(ksk.a, ctx))


def host(ksk: gckks.KSKey) -> gckks.KSKey:
    """The canonical key on the host, where the chest keeps it."""
    return gckks.KSKey(b=ksk.b.cpu(), a=ksk.a.cpu())


def upload_secret_key(sk: gckks.SecretKey, params: CKKSParams, *,
                      ctx: Context | None = None) -> DeviceSecretKey:
    ctx = default_context(params, ctx)
    qp = params.q_primes + params.p_primes
    return DeviceSecretKey(s_mont=mont_form(gckks.ntt_small(sk.s, qp, ctx), ctx))


@dataclasses.dataclass
class IntegerKeyChest:
    """The key material every scheme's chest holds, in the reference's field
    order: host secret + device keys. The integer schemes' chests
    (ciphertext/bgv.py BGVKeyChest, bfv.py BFVKeyChest) are exactly these
    fields; KeyChest adds the conjugation and encapsulation keys."""

    params: CKKSParams
    sk: gckks.SecretKey  # host only
    pk: gckks.PublicKey
    rlk: gckks.KSKey
    device_sk: DeviceSecretKey
    device_pk: DevicePublicKey
    device_rlk: DeviceKSKey
    # Every switching key is kept twice: its canonical KSKey on the host and
    # its Montgomery device form, which is what the ops read.
    galois: dict  # steps -> (KSKey, DeviceKSKey)

    def galois_key(self, steps: int) -> DeviceKSKey:
        return self.galois[steps][1]


@dataclasses.dataclass
class KeyChest(IntegerKeyChest):
    """The key material of a CKKS workload."""

    conj: tuple | None = None  # (KSKey, DeviceKSKey)
    # sparse-secret encapsulation (params.eph_hamming_weight > 0):
    # {"s_eph": int64[N], "to_eph": (KSKey, DeviceKSKey), "from_eph": (...)}
    eph: dict | None = None

    def golden_galois_key(self, steps: int) -> gckks.KSKey:
        """The canonical Galois key (on the host), which the golden model reads."""
        return self.galois[steps][0]

    def conj_key(self) -> DeviceKSKey:
        if self.conj is None:
            raise KeyError("no conjugation key was generated")
        return self.conj[1]


def _pair(key: gckks.KSKey, params: CKKSParams, ctx: Context) -> tuple:
    return host(key), upload_ks_key(key, params, ctx=ctx)


def integer_chest_fields(params: CKKSParams, rng: np.random.Generator,
                         rotations: tuple[int, ...], ctx: Context, err_factor: int) -> dict:
    """The IntegerKeyChest fields, drawn from rng in the reference's order:
    sk and pk, the relinearisation key, one Galois key per rotation step (in
    the given order), every error times err_factor."""
    if err_factor != 1 and (params.hamming_weight or params.eph_hamming_weight):
        # the reference's BGV keygen draws a dense ternary secret and nothing more
        raise ValueError("BGV keys take a dense ternary secret and no encapsulation keys")
    sk, pk = gckks.keygen(params, rng, ctx=ctx, err_factor=err_factor)
    rlk = gckks.make_relin_key(params, sk, rng, ctx=ctx, err_factor=err_factor)
    galois = {s: _pair(gckks.make_galois_key(params, s, sk, rng, ctx=ctx, err_factor=err_factor),
                       params, ctx)
              for s in rotations}
    return dict(params=params, sk=sk, pk=pk, rlk=host(rlk),
                device_sk=upload_secret_key(sk, params, ctx=ctx),
                device_pk=upload_public_key(pk, params, ctx=ctx),
                device_rlk=upload_ks_key(rlk, params, ctx=ctx), galois=galois)


def keygen(params: CKKSParams, rng: np.random.Generator, rotations: tuple[int, ...] = (),
           conjugation: bool = False, *, ctx: Context | None = None,
           err_factor: int = 1) -> KeyChest:
    """The key chest, deterministic in rng, in the reference's draw order:
    sk and pk, the relinearisation key, one Galois key per rotation step (in
    the given order), the conjugation key, then the ephemeral sparse secret
    and its two switching keys when params.eph_hamming_weight > 0. Every
    error is drawn times err_factor (t for BGV, ciphertext/bgv.py keygen).

    The canonical form of every switching key (rlk, Galois, conj, eph) is
    moved to the host: the ops read only the device form, and at N=2^16
    with dnum=5 a canonical copy on the card would be another 304 MB per
    key."""
    if err_factor != 1 and conjugation:
        raise ValueError("BGV keys take no conjugation key")
    ctx = default_context(params, ctx)
    fields = integer_chest_fields(params, rng, rotations, ctx, err_factor)
    sk = fields["sk"]
    conj = (_pair(gckks.make_conj_key(params, sk, rng, ctx=ctx), params, ctx) if conjugation
            else None)
    eph = None
    if params.eph_hamming_weight:
        s_eph = gckks.sample_sparse_ternary(rng, params.n, params.eph_hamming_weight)
        sk_eph = gckks.SecretKey(s_eph)

        def target(secret):
            return lambda primes: gckks.ntt_small(secret, primes, ctx)

        eph = {
            "s_eph": s_eph,
            # decrypts under s_eph what decrypted under s, and back
            "to_eph": _pair(gckks.make_kskey(params, target(sk.s), sk_eph, rng, ctx=ctx), params,
                            ctx),
            "from_eph": _pair(gckks.make_kskey(params, target(s_eph), sk, rng, ctx=ctx), params,
                              ctx),
        }
    return KeyChest(**fields, conj=conj, eph=eph)


def truncate_galois_device(chest: KeyChest, step_levels: dict, conj_level: int | None,
                           params: CKKSParams) -> None:
    """Shrink device Galois keys to the highest level each step is used at
    (reference keys.py:109-140).

    A gadget key stored over the full chain has num_limbs + alpha rows; a
    rotation used only up to level L needs L + alpha. Row selection only:
    K4 reads a key stored above the level in use through its row index
    (primitives/keyswitch.py key_row_index), so every result stays equal.
    step_levels maps steps -> level (Bootstrapper.galois_step_levels).
    """
    alpha = len(params.p_primes)
    full = params.num_limbs

    def trunc(key: DeviceKSKey, lvl: int) -> DeviceKSKey:
        idx = torch.cat([torch.arange(lvl), torch.arange(full, full + alpha)]).to(
            key.b_mont.device)
        return DeviceKSKey(b_mont=key.b_mont.index_select(1, idx),
                           a_mont=key.a_mont.index_select(1, idx))

    for step, lvl in step_levels.items():
        if step not in chest.galois or lvl >= full:
            continue
        golden, key = chest.galois[step]
        if key.b_mont.shape[1] <= lvl + alpha:
            continue
        chest.galois[step] = (golden, trunc(key, lvl))
    if conj_level is not None and chest.conj is not None and conj_level < full:
        golden, key = chest.conj
        if key.b_mont.shape[1] > conj_level + alpha:
            chest.conj = (golden, trunc(key, conj_level))
