"""Checkpoint / serialization: params, key chests and ciphertexts as npz.

Counterpart of gpufhe_tpu/utils/serialization.py, in its file format, both
ways: a file written by either package loads in the other to equal arrays.

State model: (CKKSParams, key material, PRNG seeds) determine every derived
table (contexts and KSContexts are deterministic host precomputes), so a
checkpoint stores params + keys + ciphertext limb arrays as compressed npz,
with the JSON `__meta__` the reference writes, key for key. Canonical key
material (the golden halves: secret, public key, switching keys) is stored
as int64, as the reference's numpy keys are; device material (Montgomery
keys, ciphertext limbs, the threefry key words) as uint32, as the
reference's device arrays are. The port holds int64 tensors, and its
loaders accept either dtype.

Loaders rebuild the device mirrors on the context's device: `ctx=` (the
parameters' context on the card when omitted).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.params.params import CKKSParams


def params_to_dict(params: CKKSParams) -> dict:
    return dataclasses.asdict(params)


def params_from_dict(d: dict) -> CKKSParams:
    d = dict(d)
    d["q_primes"] = tuple(d["q_primes"])
    d["p_primes"] = tuple(d["p_primes"])
    return CKKSParams(**d)


def _device(x) -> np.ndarray:
    """Device material (residues, key words below 2^32) as the reference's
    uint32; canonical key material is written as int64 (gckks.host_limbs)."""
    return gckks.host_limbs(x).astype(np.uint32)


def _tensor(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)


def _meta(z) -> dict:
    return json.loads(bytes(z["__meta__"]).decode())


def _context(params: CKKSParams, ctx):
    from gpufhe_tpu_torch.keys.keys import default_context

    ctx = default_context(params, ctx)
    if ctx.primes != tuple(params.q_primes + params.p_primes):
        raise ValueError("ctx is not the context of the file's parameters")
    return ctx


def _write(path, meta: dict, arrays: dict) -> None:
    np.savez_compressed(pathlib.Path(path), __meta__=np.bytes_(json.dumps(meta).encode()),
                        **arrays)


def save_keychest(path, chest, scheme: str = "ckks") -> None:
    """Persist params + canonical key material (device mirrors are re-uploaded).

    Scheme-aware: the CKKS KeyChest (with the conjugation key and the
    sparse-secret encapsulation pair) and the BGV/BFV chests."""
    assert chest.sk is not None, (
        "chest holds no secret key (threshold session?) — nothing to persist"
    )
    arrays = {
        "sk_s": gckks.host_limbs(chest.sk.s),
        "pk_b": gckks.host_limbs(chest.pk.b),
        "pk_a": gckks.host_limbs(chest.pk.a),
        "rlk_b": gckks.host_limbs(chest.rlk.b),
        "rlk_a": gckks.host_limbs(chest.rlk.a),
    }
    for steps, (gk, _) in chest.galois.items():
        arrays[f"gk{steps}_b"] = gckks.host_limbs(gk.b)
        arrays[f"gk{steps}_a"] = gckks.host_limbs(gk.a)
    conj = getattr(chest, "conj", None)
    if conj is not None:
        arrays["conj_b"] = gckks.host_limbs(conj[0].b)
        arrays["conj_a"] = gckks.host_limbs(conj[0].a)
    eph = getattr(chest, "eph", None)
    if eph is not None:
        arrays["eph_s"] = gckks.host_limbs(eph["s_eph"])
        arrays["to_eph_b"] = gckks.host_limbs(eph["to_eph"][0].b)
        arrays["to_eph_a"] = gckks.host_limbs(eph["to_eph"][0].a)
        arrays["from_eph_b"] = gckks.host_limbs(eph["from_eph"][0].b)
        arrays["from_eph_a"] = gckks.host_limbs(eph["from_eph"][0].a)
    meta = {
        "params": params_to_dict(chest.params),
        "rotations": sorted(chest.galois.keys()),
        "has_conj": conj is not None,
        "has_eph": eph is not None,
        "scheme": scheme,
    }
    _write(path, meta, arrays)


def load_keychest(path, with_scheme: bool = False, *, ctx=None):
    """Restore a key chest, its device mirrors uploaded to ctx's device.

    Returns the scheme's chest class; with_scheme=True returns (scheme,
    chest). Files written before the scheme field load as ckks."""
    from gpufhe_tpu_torch.keys import keys as dkeys

    z = np.load(pathlib.Path(path))
    meta = _meta(z)
    scheme = meta.get("scheme", "ckks")
    params = params_from_dict(meta["params"])
    ctx = _context(params, ctx)

    def ks(name: str) -> tuple:  # canonical half on the host, as keygen keeps it
        key = gckks.KSKey(b=_tensor(z[f"{name}_b"], "cpu"), a=_tensor(z[f"{name}_a"], "cpu"))
        return key, dkeys.upload_ks_key(key, params, ctx=ctx)

    sk = gckks.SecretKey(s=np.asarray(z["sk_s"]).astype(np.int64))
    pk = gckks.PublicKey(b=_tensor(z["pk_b"], ctx.device), a=_tensor(z["pk_a"], ctx.device))
    rlk, device_rlk = ks("rlk")
    common = dict(
        params=params,
        sk=sk,
        pk=pk,
        rlk=rlk,
        device_sk=dkeys.upload_secret_key(sk, params, ctx=ctx),
        device_pk=dkeys.upload_public_key(pk, params, ctx=ctx),
        device_rlk=device_rlk,
        galois={steps: ks(f"gk{steps}") for steps in meta["rotations"]},
    )
    if scheme == "bgv":
        from gpufhe_tpu_torch.ciphertext.bgv import BGVKeyChest

        chest = BGVKeyChest(**common)
    elif scheme == "bfv":
        from gpufhe_tpu_torch.ciphertext.bfv import BFVKeyChest

        chest = BFVKeyChest(**common)
    else:
        conj = ks("conj") if meta["has_conj"] else None
        eph = None
        if meta.get("has_eph"):
            eph = {
                "s_eph": np.asarray(z["eph_s"]).astype(np.int64),
                "to_eph": ks("to_eph"),
                "from_eph": ks("from_eph"),
            }
        chest = dkeys.KeyChest(conj=conj, eph=eph, **common)
    return (scheme, chest) if with_scheme else chest


def save_device_keychest(path, chest, seeded: bool = True) -> None:
    """Persist a DeviceKeyChest (keys/device_keygen.py).

    seeded=True stores, for every key-switch key whose threefry key the chest
    recorded, only the b_mont rows plus the key's two 32-bit words (the
    reference's 64-bit key_data): the uniform a_mont rows are drawn again on
    load (keys/prng.py gives the reference's rows on any device), halving
    the dominant (a, b) payload. Keys without a recorded seed store both
    halves.
    """
    seeds = (chest.seeds or {}) if seeded else {}
    arrays = {"sk_s": gckks.host_limbs(chest.sk.s)}

    def put_ks(name: str, key) -> None:
        arrays[f"{name}_b"] = _device(key.b_mont)
        if name in seeds:
            arrays[f"{name}_seed"] = _device(seeds[name])
        else:
            arrays[f"{name}_a"] = _device(key.a_mont)

    put_ks("rlk", chest.device_rlk)
    for steps, (_, gk) in chest.galois.items():
        put_ks(f"gk{steps}", gk)
    if chest.conj is not None:
        put_ks("conj", chest.conj[1])
    has_eph = chest.eph is not None
    if has_eph:
        arrays["eph_s"] = gckks.host_limbs(chest.eph["s_eph"])
        put_ks("to_eph", chest.eph["to_eph"][1])
        put_ks("from_eph", chest.eph["from_eph"][1])
    arrays["pk_b"] = _device(chest.device_pk.b_mont)
    if "pk" in seeds:
        arrays["pk_seed"] = _device(seeds["pk"])
    else:
        arrays["pk_a"] = _device(chest.device_pk.a_mont)
    meta = {
        "params": params_to_dict(chest.params),
        "rotations": sorted(chest.galois.keys()),
        "has_conj": chest.conj is not None,
        "has_eph": has_eph,
    }
    _write(path, meta, arrays)


def load_device_keychest(path, *, ctx=None):
    """Restore a DeviceKeyChest on ctx's device, drawing the seeded a_mont
    rows again there (regen_ks_a / regen_pk_a)."""
    from gpufhe_tpu_torch.keys import keys as dkeys
    from gpufhe_tpu_torch.keys.device_keygen import DeviceKeyChest, regen_ks_a, regen_pk_a
    from gpufhe_tpu_torch.keys.keys import DeviceKSKey, DevicePublicKey

    z = np.load(pathlib.Path(path))
    meta = _meta(z)
    params = params_from_dict(meta["params"])
    ctx = _context(params, ctx)
    seeds = {}

    def seed(name: str) -> torch.Tensor:  # the port's form: int64[2] on the host
        seeds[name] = _tensor(z[f"{name}_seed"], "cpu")
        return seeds[name]

    def get_ks(name: str) -> DeviceKSKey:
        b = _tensor(z[f"{name}_b"], ctx.device)
        if f"{name}_seed" in z:
            return DeviceKSKey(b_mont=b, a_mont=regen_ks_a(params, ctx, seed(name)))
        return DeviceKSKey(b_mont=b, a_mont=_tensor(z[f"{name}_a"], ctx.device))

    sk = gckks.SecretKey(s=np.asarray(z["sk_s"]).astype(np.int64))
    if "pk_seed" in z:
        pk_a = regen_pk_a(params, ctx, seed("pk"))
    else:
        pk_a = _tensor(z["pk_a"], ctx.device)
    pk = DevicePublicKey(b_mont=_tensor(z["pk_b"], ctx.device), a_mont=pk_a)
    galois = {s: (None, get_ks(f"gk{s}")) for s in meta["rotations"]}
    conj = (None, get_ks("conj")) if meta["has_conj"] else None
    eph = None
    if meta.get("has_eph"):
        eph = {
            "s_eph": np.asarray(z["eph_s"]).astype(np.int64),
            "to_eph": (None, get_ks("to_eph")),
            "from_eph": (None, get_ks("from_eph")),
        }
    return DeviceKeyChest(
        params=params,
        sk=sk,
        device_sk=dkeys.upload_secret_key(sk, params, ctx=ctx),
        device_pk=pk,
        device_rlk=get_ks("rlk"),
        galois=galois,
        conj=conj,
        eph=eph,
        seeds=seeds or None,
    )


def save_ciphertext(path, ct) -> None:
    """Scheme-aware: CKKS (scale), BGV (pt_factor) and BFV ciphertexts."""
    arrays = {f"c{i}": _device(comp) for i, comp in enumerate(ct.c)}
    meta = {"level": ct.level, "n_components": len(ct.c)}
    if hasattr(ct, "scale"):
        meta["scheme"] = "ckks"
        meta["scale"] = ct.scale
    elif hasattr(ct, "pt_factor"):
        meta["scheme"] = "bgv"
        meta["pt_factor"] = int(ct.pt_factor)
    else:
        meta["scheme"] = "bfv"
    _write(path, meta, arrays)


def load_ciphertext(path, device: bool = True, *, ctx=None):
    """The ciphertext, its components int64 tensors on ctx's device (the card
    when ctx is omitted), or on the host with device=False."""
    z = np.load(pathlib.Path(path))
    meta = _meta(z)
    where = "cpu" if not device else (ctx.device if ctx is not None else "cuda")
    comps = [_tensor(z[f"c{i}"], where) for i in range(meta["n_components"])]
    scheme = meta.get("scheme", "ckks")
    if scheme == "bgv":
        from gpufhe_tpu_torch.ciphertext.bgv import BGVCiphertext

        return BGVCiphertext(comps, meta["level"], meta["pt_factor"])
    if scheme == "bfv":
        from gpufhe_tpu_torch.ciphertext.bfv import BFVCiphertext

        return BFVCiphertext(comps, meta["level"])
    from gpufhe_tpu_torch.ciphertext.ct import Ciphertext

    return Ciphertext(comps, meta["level"], meta["scale"])
