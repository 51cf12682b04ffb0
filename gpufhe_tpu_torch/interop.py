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

from gpufhe_tpu_torch.ciphertext.batch import CiphertextBatch
from gpufhe_tpu_torch.ciphertext.bfv import BFVCiphertext, BFVKeyChest
from gpufhe_tpu_torch.ciphertext.bgv import BGVCiphertext, BGVKeyChest
from gpufhe_tpu_torch.ciphertext.ct import Ciphertext
from gpufhe_tpu_torch.ciphertext.threshold import PartyShare
from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.keys.device_keygen import DeviceKeyChest
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


def batch_from_numpy(components, level: int, scale: float, device="cuda") -> CiphertextBatch:
    """Reference CiphertextBatch limbs (one [B, K, N] array per component) ->
    CiphertextBatch."""
    comps = [_tensor(c, device) for c in components]
    if any(c.dim() != 3 or c.shape[1] != level for c in comps):
        raise ValueError(f"components are not [B, {level}, N] stacks")
    return CiphertextBatch(comps, level, float(scale))


def party_share_from_reference(share) -> PartyShare:
    """A reference threshold PartyShare (numpy s and b) as the port's."""
    return PartyShare(s=np.asarray(share.s).astype(np.int64),
                      b=np.asarray(share.b).astype(np.int64))


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


def chest_from_reference(ref_chest, device="cuda"):
    """A reference key chest as the port's chest of the same name (KeyChest,
    BGVKeyChest, BFVKeyChest or DeviceKeyChest), carried as numpy arrays
    (np.asarray of the reference's arrays), field by field: secret keys and
    public keys, every switching key with its canonical half on the host
    (None where the reference has None: a DeviceKeyChest has no canonical
    halves, and an `a` dropped by drop_galois_a stays dropped), the
    encapsulation keys, and a DeviceKeyChest's seeds."""
    cls = {c.__name__: c for c in (KeyChest, BGVKeyChest, BFVKeyChest,
                                   DeviceKeyChest)}[type(ref_chest).__name__]

    def dev_ks(key) -> DeviceKSKey:
        a = None if key.a_mont is None else _tensor(np.asarray(key.a_mont), device)
        return DeviceKSKey(b_mont=_tensor(np.asarray(key.b_mont), device), a_mont=a)

    def host_ks(key) -> gckks.KSKey | None:  # the canonical half, where keygen keeps it
        return None if key is None else gckks.KSKey(b=_tensor(key.b, "cpu"),
                                                     a=_tensor(key.a, "cpu"))

    def ks(pair) -> tuple | None:
        return None if pair is None else (host_ks(pair[0]), dev_ks(pair[1]))

    def eph(e) -> dict | None:
        return None if e is None else {"s_eph": np.asarray(e["s_eph"]).astype(np.int64),
                                       **{k: ks(e[k]) for k in ("to_eph", "from_eph")}}

    carry = {
        "params": params_from_reference,
        "sk": lambda sk: gckks.SecretKey(np.asarray(sk.s).astype(np.int64)),
        "pk": lambda pk: gckks.PublicKey(b=_tensor(pk.b, device), a=_tensor(pk.a, device)),
        "rlk": host_ks,
        "device_sk": lambda k: secret_key_from_numpy(np.asarray(k.s_mont), device),
        "device_pk": lambda k: public_key_from_numpy(np.asarray(k.b_mont),
                                                     np.asarray(k.a_mont), device),
        "device_rlk": dev_ks,
        "galois": lambda g: {s: ks(pair) for s, pair in g.items()},
        "conj": ks,
        "eph": eph,
        "seeds": lambda seeds: None if seeds is None else {
            name: torch.from_numpy(np.asarray(v).astype(np.int64)) for name, v in seeds.items()},
    }
    return cls(**{f.name: carry[f.name](getattr(ref_chest, f.name))
                  for f in dataclasses.fields(cls)})


def mesh_from_reference(shape, devices):
    """A reference Mesh's ('limb', 'coeff') shape (its `mesh.shape`, or a
    (limb, coeff) pair) as the port's FheMesh over `devices` (e.g.
    ["cpu"] * 8, or ["cuda:0"] * 8 on one card)."""
    from gpufhe_tpu_torch.parallel.sharded import make_fhe_mesh

    n_limb, n_coeff = (shape["limb"], shape["coeff"]) if hasattr(shape, "keys") else shape
    return make_fhe_mesh(int(n_limb), int(n_coeff), devices=list(devices))


def sharded_ct_from_numpy(blocks, level: int, scale: float, mesh):
    """A reference ShardedCiphertext's components (np.asarray of each eval3d
    array [K, n1, n2]) -> the port's ShardedCiphertext on `mesh`, each
    component cut over coeff onto the shards' devices."""
    from gpufhe_tpu_torch.parallel.backend import ShardedCiphertext

    comps = []
    for x in blocks:
        e3 = torch.from_numpy(np.asarray(x).astype(np.int64))
        if e3.dim() != 3 or e3.shape[0] != level:
            raise ValueError(f"component {tuple(e3.shape)} is not [{level}, n1, n2]")
        b = e3.shape[1] // mesh.shape["coeff"]
        comps.append(mesh.put(lambda l, c, dev, e3=e3: e3[:, c * b:(c + 1) * b].to(dev)
                              .contiguous()))
    return ShardedCiphertext(comps, level, float(scale))
