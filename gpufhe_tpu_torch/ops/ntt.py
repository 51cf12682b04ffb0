"""Negacyclic NTT over the last axis of int64[..., L, N] limb stacks.

Counterpart of gpufhe_tpu/ops/ntt.py ntt_fwd / ntt_inv (ntt.py:275-330).
`limbs` selects which rows of the context's full prime chain the L axis
holds (a level-truncated ciphertext, the p-chain, an arbitrary list). Output
is natural order and canonical, equal to gpufhe_tpu's limb for limb.

Leading batch axes are flattened into one call: a CPU tensor runs the plain
four-step (ops/ntt_cuda.fourstep_plain); a CUDA tensor launches kernel K1
once for the whole batch.
"""

from __future__ import annotations

import torch

from gpufhe_tpu_torch.ops.context import Context
from gpufhe_tpu_torch.ops.ntt_cuda import fourstep


def _transform(x: torch.Tensor, ctx: Context, limbs, inverse: bool) -> torch.Tensor:
    idx = ctx.index(limbs, torch.int32)
    *lead, L, n = x.shape
    if L != idx.numel():
        raise ValueError(f"{L} limbs given, {idx.numel()} selected")
    out = fourstep(x.reshape(-1, n).contiguous(), idx, ctx, inverse)
    return out.view(*lead, L, n)


def ntt_fwd(x: torch.Tensor, ctx: Context, limbs=slice(None)) -> torch.Tensor:
    """Forward negacyclic NTT of int64[..., L, N] canonical residues."""
    return _transform(x, ctx, limbs, inverse=False)


def ntt_inv(x: torch.Tensor, ctx: Context, limbs=slice(None)) -> torch.Tensor:
    """Inverse negacyclic NTT of int64[..., L, N] (1/N folded in)."""
    return _transform(x, ctx, limbs, inverse=True)
