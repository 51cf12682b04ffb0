"""RNS primitives: ModUp, ModDown by P, rescale and the BGV ModSwitch.

Counterpart of gpufhe_tpu/primitives/rns.py. Every result is the canonical
value the reference computes, limb for limb: the approximate base conversion
is reduced per term (ops/convert_cuda.py, kernel K3 on the card whatever the
source count, which mod_up and mod_down launch: mod_up once per group into
one stack, mod_down once for every component, its subtraction, P^-1 product
and the caller's addend in the kernel's epilogue), and the rescale and
ModSwitch use the same centered lift of the dropped limb. base_convert is the
reference's public conversion from its Montgomery tables, on the plain
modular ops. Polynomials are int64[K, N] in the coefficient domain;
rescale, rescale_words and bgv_modswitch also take leading batch axes, and
call the rescale kernel's entry (ops/rescale_cuda.py drop_limbs) once,
whatever the number of limbs they drop. Each kernel's entry in ops/ runs its
plain int64 version on a CPU tensor.

For BGV parameters (plain_modulus t > 0) the key switch's ModDown must
divide by P with a correction that is 0 mod t. make_ks_context folds it into
the ModDown's conversion tables, t^-1 into the P-side Qhat inverses and t
into the conversion rows (reference rns.py:138-148), so the same mod_down and
the same kernel compute it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from gpufhe_tpu_torch.golden import rns as grns
from gpufhe_tpu_torch.ops.context import Context
from gpufhe_tpu_torch.ops import convert_cuda, rescale_cuda
from gpufhe_tpu_torch.ops.convert_cuda import ConvertTables, make_convert_tables
from gpufhe_tpu_torch.ops.modops import add_mod, mont_mul
from gpufhe_tpu_torch.params.params import CKKSParams

R = 1 << 32  # the Montgomery radix


def ks_groups(params: CKKSParams, level: int) -> list[tuple[int, int]]:
    """(start, stop) limb ranges of the active key-switch decomposition groups."""
    alpha = params.alpha
    return [(d, min(d + alpha, level)) for d in range(0, level, alpha)]


@dataclasses.dataclass(frozen=True)
class KSContext:
    """Per-(params, level) device tables for key switching."""

    # ModUp, one per decomposition group: the group's limbs -> the FULL
    # active Q+P chain. The rows of the group's own limbs are the identity
    # (q_j divides Qhat_i for i != j), so no reassembly is needed.
    modup: tuple[ConvertTables, ...]
    p2q: ConvertTables  # ModDown: P basis -> active Q basis
    # ModDown's epilogue in K3, [P^-1]_{q_i} first (ops/convert_cuda.py
    # make_mod_down_table; the plain version reads it there too)
    p2q_epilogue: torch.Tensor


@functools.lru_cache(maxsize=None)
def make_ks_context(params: CKKSParams, level: int, *, device: str = "cuda") -> KSContext:
    """Host-side table build (exact python ints), one upload. Cached on
    (params, level, device): plain_modulus is part of params, so a BGV chain
    and its CKKS view (BFV's key switch) get separate tables."""
    qs = params.q_primes[:level]
    ps = params.p_primes
    t = params.plain_modulus
    if t:  # BGV: the t-corrected division by P, delta = t [x t^-1]_P
        p_arr = np.asarray(ps, dtype=np.int64)
        qhinv = grns.qhat_inv(ps) * np.asarray([pow(t, -1, p) for p in ps]) % p_arr
        conv = grns.conv_matrix(ps, qs) * t % np.asarray(qs, dtype=np.int64)[:, None]
        p2q = make_convert_tables(ps, qs, device, qhinv=qhinv, conv=conv)
    else:
        p2q = make_convert_tables(ps, qs, device)
    return KSContext(
        modup=tuple(
            make_convert_tables(qs[d0:d1], qs + ps, device) for d0, d1 in ks_groups(params, level)
        ),
        p2q=p2q,
        p2q_epilogue=convert_cuda.make_mod_down_table(ps, qs, device),
    )


def base_convert(x: torch.Tensor, src_q: torch.Tensor, src_qinv: torch.Tensor,
                 qhatinv_mont: torch.Tensor, conv_mont: torch.Tensor, dst_q: torch.Tensor,
                 dst_qinv: torch.Tensor) -> torch.Tensor:
    """The approximate fast base conversion from the reference's Montgomery
    tables, on the port's plain modular ops (ops/modops.py mont_mul and
    add_mod): int64[S, N] residues mod the source primes -> int64[T, N]
    mod the destination primes, congruent to x + u * prod(src) for a small
    |u| (golden/rns.py base_convert). The value K3 computes from its own
    tables; mod_up and mod_down launch K3.
    """
    v = mont_mul(x, qhatinv_mont[:, None], src_q[:, None], src_qinv[:, None])
    acc = None
    for i in range(x.shape[0]):
        term = mont_mul(v[i][None, :], conv_mont[:, i, None], dst_q[:, None], dst_qinv[:, None])
        acc = term if acc is None else add_mod(acc, term, dst_q[:, None])
    return acc


def mod_up(x_coeff: torch.Tensor, params: CKKSParams, level: int, ctx: Context,
           ksc: KSContext) -> torch.Tensor:
    """ModUp every decomposition group of int64[K, N] to the active Q+P basis.

    Returns int64[D, K + alpha, N] (coefficient domain, limb order = active
    q-chain then p-chain), each group's conversion written into its row.
    """
    groups = ks_groups(params, level)
    out = torch.empty((len(groups), ksc.modup[0].dq.numel(), x_coeff.shape[-1]),
                      dtype=torch.int64, device=x_coeff.device)
    for g, (d0, d1) in enumerate(groups):
        convert_cuda.base_convert(x_coeff[d0:d1], ksc.modup[g], out=out[g])
    return out


def mod_down(x_coeff: torch.Tensor, params: CKKSParams, level: int, ctx: Context,
             ksc: KSContext, *, addend: torch.Tensor | None = None) -> torch.Tensor:
    """Division by P: int64[..., K + alpha, N] -> int64[..., K, N] (coefficient
    domain), plus `addend` (int64[K, N] or int64[B', K, N]: one row for each
    of the first B' components; coefficient domain). One K3 launch on the
    card for every component (ops/convert_cuda.py mod_down)."""
    *lead, rows, n = x_coeff.shape
    out = convert_cuda.mod_down(x_coeff.reshape(-1, rows, n), ksc.p2q, ksc.p2q_epilogue,
                                None if addend is None else addend.reshape(-1, level, n))
    return out.view(*lead, level, n)


def rescale(x_coeff: torch.Tensor, params: CKKSParams, level: int, ctx: Context,
            ksc: KSContext) -> torch.Tensor:
    """Drop the last active limb: int64[..., K, N] -> int64[..., K-1, N].

    (x - centered([x]_{q_last})) / q_last on every remaining limb. `ksc`, the
    reference's parameter, is not read: the drop has tables of its own.
    """
    return rescale_words(x_coeff, params, level, 1, ctx)


def rescale_words(x_coeff: torch.Tensor, params: CKKSParams, level: int, words: int,
                  ctx: Context) -> torch.Tensor:
    """`words` rescales back to back (a double-word scale drops a limb pair):
    int64[..., K, N] -> int64[..., K-words, N], equal to `words` calls of
    rescale."""
    return rescale_cuda.drop_limbs(
        x_coeff, level, rescale_cuda.drop_tables(params.q_primes[:level], words, 0,
                                                 x_coeff.device), bgv=False)


def bgv_modswitch(x_coeff: torch.Tensor, params: CKKSParams, level: int, ctx: Context,
                  ksc: KSContext) -> torch.Tensor:
    """BGV ModSwitch: drop q_last with a correction delta = 0 (mod t),
    int64[..., K, N] -> int64[..., K-1, N] (reference rns.py:328-351).

    out = (x + t * centered([-x t^-1]_{q_last})) / q_last on every remaining
    limb, the centered lift by the rescale's rule (u > q_last // 2 lifts to
    u - q_last). `ksc` is not read, as in rescale.
    """
    return rescale_cuda.drop_limbs(
        x_coeff, level, rescale_cuda.drop_tables(params.q_primes[:level], 1,
                                                 params.plain_modulus, x_coeff.device),
        bgv=True)
