"""Carry gpufhe_tpu state into this package.

The functions take the reference package's state as numpy arrays (uint32
or int64, e.g. `np.asarray(jax_array)`) and return the port's objects on the
chosen device. Key material stays in Montgomery form, as both packages store
it, so the values carry over unchanged. No jax import is needed: the caller
converts.
"""

from __future__ import annotations

import numpy as np
import torch

from gpufhe_tpu_torch.ciphertext.ct import Ciphertext
from gpufhe_tpu_torch.keys.keys import DeviceKSKey, DevicePublicKey, DeviceSecretKey


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
