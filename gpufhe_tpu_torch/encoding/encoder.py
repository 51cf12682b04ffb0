"""CKKS encoder: host canonical embedding + plaintext upload.

Counterpart of gpufhe_tpu/encoding/encoder.py. Encoding runs on the host in
float64 with the reference's own FFT code path, so plaintexts round the same
way and the limb-trace contract holds; device helpers give NTT-domain,
Montgomery-form plaintexts for ciphertext-plaintext products.
"""

from __future__ import annotations

import numpy as np
import torch

from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.keys.keys import mont_form
from gpufhe_tpu_torch.ops.context import Context
from gpufhe_tpu_torch.ops.ntt import ntt_fwd
from gpufhe_tpu_torch.params.params import CKKSParams


def encode(z: np.ndarray, params: CKKSParams, scale: float | None = None) -> np.ndarray:
    """complex[slots] -> coefficient-domain plaintext int64[L, N] (host)."""
    scale = scale if scale is not None else params.scale
    return gckks.encode(z, scale, params.q_primes, params.n)


def decode(pt_coeff: np.ndarray, params: CKKSParams, scale: float, level: int) -> np.ndarray:
    """Coefficient-domain plaintext int64[K, N] -> complex[slots]."""
    return gckks.decode(pt_coeff, scale, params.q_primes[:level], params.n)


def plaintext_to_device(pt_coeff: np.ndarray, params: CKKSParams, ctx: Context) -> torch.Tensor:
    """Host coefficient-domain plaintext -> NTT-domain Montgomery int64[L, N].

    `params` is the reference's parameter, unused: `ctx` holds the tables.
    """
    lvl = pt_coeff.shape[0]
    x = torch.from_numpy(np.asarray(pt_coeff, dtype=np.int64)).to(ctx.device)
    return mont_form(ntt_fwd(x, ctx, limbs=range(lvl)), ctx)


def encode_to_device(z: np.ndarray, params: CKKSParams, ctx: Context,
                     scale: float | None = None) -> torch.Tensor:
    return plaintext_to_device(encode(z, params, scale), params, ctx)
