"""Batched ciphertext operations: independent ciphertexts over a leading axis.

Counterpart of gpufhe_tpu/ciphertext/batch.py, whose multiply maps the
tensor, relinearisation and rescale cores over the batch with jax.vmap. The
port has no vmap: ct_mul_batched multiplies the B pairs one after another
through the same kernels, so each element of the result equals the single
multiply of its pair limb for limb (tests/test_torch_batch.py), and a batch
launches B times what one multiply does.

A batch is stored struct-of-arrays: int64[B, K, N] per component.
"""

from __future__ import annotations

import dataclasses

import torch

from gpufhe_tpu_torch.ciphertext import ct as dct
from gpufhe_tpu_torch.keys.keys import DeviceKSKey
from gpufhe_tpu_torch.ops.context import Context
from gpufhe_tpu_torch.params.params import CKKSParams


@dataclasses.dataclass
class CiphertextBatch:
    c: list  # each int64[B, K, N]
    level: int
    scale: float

    @property
    def batch(self) -> int:
        return self.c[0].shape[0]


def stack(cts: list[dct.Ciphertext]) -> CiphertextBatch:
    lvl, scale = cts[0].level, cts[0].scale
    assert all(c.level == lvl and c.scale == scale for c in cts)
    return CiphertextBatch(
        [torch.stack([ct.c[i] for ct in cts]) for i in range(len(cts[0].c))], lvl, scale
    )


def unstack(cb: CiphertextBatch) -> list[dct.Ciphertext]:
    return [
        dct.Ciphertext([comp[i] for comp in cb.c], cb.level, cb.scale)
        for i in range(cb.batch)
    ]


def ct_mul_batched(
    a: CiphertextBatch, b: CiphertextBatch, params: CKKSParams, ctx: Context,
    rlk: DeviceKSKey,
) -> CiphertextBatch:
    """Homomorphic multiply of B independent ciphertext pairs: tensor,
    relinearisation and ONE rescale each, as the reference's batched core
    does (at a single-word scale that is ct_mul_full, which the pairs take;
    a double-word preset takes ct_mul, whose single rescale matches)."""
    assert a.level == b.level and a.batch == b.batch
    mul = dct.ct_mul_full if params.scale_words == 1 else dct.ct_mul
    outs = [mul(x, y, params, ctx, rlk) for x, y in zip(unstack(a), unstack(b))]
    return stack(outs)
