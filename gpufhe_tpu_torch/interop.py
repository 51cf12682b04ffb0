"""Carry gpufhe_tpu state into this package.

The functions take the reference package's state as numpy arrays (uint32
or int64, e.g. `np.asarray(jax_array)`) and return the port's objects on the
chosen device. Key material stays in Montgomery form, as both packages store
it, so the values carry over unchanged. No jax import is needed: the caller
converts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpufhe_tpu_torch.ciphertext.bfv import BFVCiphertext
from gpufhe_tpu_torch.ciphertext.bgv import BGVCiphertext
from gpufhe_tpu_torch.ciphertext.ct import Ciphertext
from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.keys.keys import (DeviceKSKey, DevicePublicKey, DeviceSecretKey,
                                        KeyChest)
from gpufhe_tpu_torch.params.params import CKKSParams


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)


def ks_key_from_numpy(b_mont, a_mont, device="cuda") -> DeviceKSKey:
    """Reference DeviceKSKey.b_mont / a_mont [dnum, L+alpha, N] -> DeviceKSKey."""
    return DeviceKSKey(b_mont=_tensor(b_mont, device), a_mont=_tensor(a_mont, device))


def public_key_from_numpy(b_mont, a_mont, device="cuda") -> DevicePublicKey:
    """Reference DevicePublicKey.b_mont / a_mont [L, N] -> DevicePublicKey."""
    return DevicePublicKey(b_mont=_tensor(b_mont, device), a_mont=_tensor(a_mont, device))


def secret_key_from_numpy(s_mont, device="cuda") -> DeviceSecretKey:
    """Reference DeviceSecretKey.s_mont [L+alpha, N] -> DeviceSecretKey."""
    return DeviceSecretKey(s_mont=_tensor(s_mont, device))


def ciphertext_from_numpy(components, level: int, scale: float, device="cuda") -> Ciphertext:
    """Reference Ciphertext limbs (one [K, N] array per component) -> Ciphertext."""
    comps = [_tensor(c, device) for c in components]
    if any(c.shape[0] != level for c in comps):
        raise ValueError(f"components do not hold {level} limbs")
    return Ciphertext(comps, level, float(scale))


def ciphertext_to_numpy(ct: Ciphertext) -> tuple[list[np.ndarray], int, float]:
    """Port Ciphertext -> (int64 limb arrays, level, scale) for the reference."""
    return [c.cpu().numpy() for c in ct.c], ct.level, ct.scale


def integer_ciphertext_from_numpy(components, level: int, pt_factor: int | None = None,
                                  device="cuda"):
    """Reference BGVCiphertext (pt_factor given) or BFVCiphertext limbs ->
    the port's BGVCiphertext or BFVCiphertext."""
    comps = [_tensor(c, device) for c in components]
    if any(c.shape[0] != level for c in comps):
        raise ValueError(f"components do not hold {level} limbs")
    if pt_factor is None:
        return BFVCiphertext(comps, level)
    return BGVCiphertext(comps, level, int(pt_factor))


def params_from_reference(ref_params) -> CKKSParams:
    """The port's CKKSParams with the reference's values for its fields."""
    return CKKSParams(**{f.name: getattr(ref_params, f.name)
                         for f in dataclasses.fields(CKKSParams)})


def chest_from_reference(ref_chest, device="cuda") -> KeyChest:
    """A reference KeyChest as the port's: sk, pk, rlk, every Galois key, the
    conjugation key and the encapsulation keys, host and device halves,
    carried as numpy arrays (np.asarray of the reference's arrays). A
    reference BGVKeyChest or BFVKeyChest (no conj, no eph) gives the port's
    chest of that scheme, params with their plain_modulus."""

    def ks(golden, dev) -> tuple:  # the canonical half on the host, as keygen keeps it
        return (gckks.KSKey(b=_tensor(golden.b, "cpu"), a=_tensor(golden.a, "cpu")),
                ks_key_from_numpy(np.asarray(dev.b_mont), np.asarray(dev.a_mont), device))

    eph, conj = getattr(ref_chest, "eph", None), getattr(ref_chest, "conj", None)
    if eph is not None:
        eph = {"s_eph": np.asarray(eph["s_eph"]).astype(np.int64),
               **{k: ks(*eph[k]) for k in ("to_eph", "from_eph")}}
    pk, dpk = ref_chest.pk, ref_chest.device_pk
    return KeyChest(
        params=params_from_reference(ref_chest.params),
        sk=gckks.SecretKey(np.asarray(ref_chest.sk.s).astype(np.int64)),
        pk=gckks.PublicKey(b=_tensor(pk.b, device), a=_tensor(pk.a, device)),
        rlk=ks(ref_chest.rlk, ref_chest.device_rlk)[0],
        device_sk=secret_key_from_numpy(np.asarray(ref_chest.device_sk.s_mont), device),
        device_pk=public_key_from_numpy(np.asarray(dpk.b_mont), np.asarray(dpk.a_mont), device),
        device_rlk=ks(ref_chest.rlk, ref_chest.device_rlk)[1],
        galois={s: ks(*pair) for s, pair in ref_chest.galois.items()},
        conj=None if conj is None else ks(*conj),
        eph=eph,
    )
