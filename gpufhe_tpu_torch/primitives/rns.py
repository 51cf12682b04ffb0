"""RNS primitives: ModUp, ModDown by P, and rescale.

Counterpart of gpufhe_tpu/primitives/rns.py. Every result is the canonical
value the reference computes, limb for limb: the approximate base conversion
is reduced per term (ops/convert_cuda.py, kernel K3 on the card whatever the
source count), and the rescale uses the same centered lift of the dropped
limb. Polynomials are int64[K, N] in the coefficient domain; rescale also
takes leading batch axes.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from gpufhe_tpu_torch.ops.context import Context
from gpufhe_tpu_torch.ops.convert_cuda import ConvertTables, base_convert, make_convert_tables
from gpufhe_tpu_torch.ops.modops import sub_mod
from gpufhe_tpu_torch.params.params import CKKSParams


def ks_groups(params: CKKSParams, level: int) -> list[tuple[int, int]]:
    """(start, stop) limb ranges of the active key-switch decomposition groups."""
    alpha = params.alpha
    return [(d, min(d + alpha, level)) for d in range(0, level, alpha)]


@dataclasses.dataclass(frozen=True)
class KSContext:
    """Per-(params, level) device tables for key switching and rescale."""

    # ModUp, one per decomposition group: the group's limbs -> the FULL
    # active Q+P chain. The rows of the group's own limbs are the identity
    # (q_j divides Qhat_i for i != j), so no reassembly is needed.
    modup: tuple[ConvertTables, ...]
    p2q: ConvertTables  # ModDown: P basis -> active Q basis
    pinv: torch.Tensor  # int64[K]   [P^-1]_{q_i}
    qlast_mod: torch.Tensor  # int64[K-1] q_last mod q_i
    qlast_inv: torch.Tensor  # int64[K-1] [q_last^-1]_{q_i}


@functools.lru_cache(maxsize=None)
def make_ks_context(params: CKKSParams, level: int, device: str = "cuda") -> KSContext:
    """Host-side table build (exact python ints), one upload."""
    qs = params.q_primes[:level]
    ps = params.p_primes
    big_p = math.prod(ps)
    q_last = qs[-1]

    def dev(v):
        return torch.tensor(v, dtype=torch.int64, device=device)

    return KSContext(
        modup=tuple(
            make_convert_tables(qs[d0:d1], qs + ps, device) for d0, d1 in ks_groups(params, level)
        ),
        p2q=make_convert_tables(ps, qs, device),
        pinv=dev([pow(big_p, -1, q) for q in qs]),
        qlast_mod=dev([q_last % q for q in qs[:-1]]),
        qlast_inv=dev([pow(q_last, -1, q) for q in qs[:-1]]),
    )


def mod_up(x_coeff: torch.Tensor, params: CKKSParams, level: int, ctx: Context,
           ksc: KSContext) -> list[torch.Tensor]:
    """ModUp every decomposition group of int64[K, N] to the active Q+P basis.

    Returns one int64[K + alpha, N] coefficient-domain tensor per group, limb
    order = active q-chain then p-chain.
    """
    return [
        base_convert(x_coeff[d0:d1], ksc.modup[g])
        for g, (d0, d1) in enumerate(ks_groups(params, level))
    ]


def mod_down(x_coeff: torch.Tensor, params: CKKSParams, level: int, ctx: Context,
             ksc: KSContext) -> torch.Tensor:
    """Division by P: int64[K + alpha, N] -> int64[K, N] (coefficient domain)."""
    k = level
    q = ctx.col("q", range(k))
    p_part = base_convert(x_coeff[k:], ksc.p2q)
    diff = sub_mod(x_coeff[:k], p_part, q)
    return torch.remainder(diff * ksc.pinv[:, None], q)


def rescale(x_coeff: torch.Tensor, params: CKKSParams, level: int, ctx: Context,
            ksc: KSContext) -> torch.Tensor:
    """Drop the last active limb: int64[..., K, N] -> int64[..., K-1, N].

    (x - centered([x]_{q_last})) / q_last on every remaining limb.
    """
    k = level
    q_last = params.q_primes[k - 1]
    q = ctx.col("q", range(k - 1))
    last = x_coeff[..., k - 1 : k, :]
    r = torch.remainder(last, q)  # [x]_{q_last} mod q_i
    lifted = torch.where(last > q_last // 2, sub_mod(r, ksc.qlast_mod[:, None], q), r)
    diff = sub_mod(x_coeff[..., : k - 1, :], lifted, q)
    return torch.remainder(diff * ksc.qlast_inv[:, None], q)
