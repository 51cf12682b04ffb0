"""Hybrid key switching: ModUp -> inner product with the key -> ModDown.

Counterpart of gpufhe_tpu/primitives/keyswitch.py (keyswitch.py:96-227),
stage for stage, so every output limb equals the reference's:

  1. iNTT the switched polynomial to the coefficient domain (unless eval_in
     is False and it already is);
  2. ModUp each of the dnum decomposition groups to the active Q+P basis,
     each group's K3 launch writing its row of one [D, K+alpha, N] stack;
  3. NTT all raised groups (one batched transform) and take the inner
     product with the gadget key rows (keys in Montgomery form): one launch
     of kernel K4 (ops/mac_cuda.py) for both key components, reading the
     key's active rows in place;
  4. iNTT both accumulators (one batched transform), ModDown by P of both
     in one K3 launch (primitives/rns.py mod_down), a caller's
     coefficient-domain addend summed in the same launch, and NTT back
     unless eval_out is False.
"""

from __future__ import annotations

import torch

from gpufhe_tpu_torch.keys.keys import DeviceKSKey
from gpufhe_tpu_torch.ops.context import Context
from gpufhe_tpu_torch.ops.mac_cuda import mac, mac_each
from gpufhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
from gpufhe_tpu_torch.params.params import CKKSParams
from gpufhe_tpu_torch.primitives.rns import KSContext, mod_down, mod_up
from gpufhe_tpu_torch.utils.profiling import stage


def qp_indices(params: CKKSParams, level: int) -> list[int]:
    """Context-chain indices of the active Q-prefix + P-chain limbs."""
    alpha = len(params.p_primes)
    return list(range(level)) + list(range(params.num_limbs, params.num_limbs + alpha))


def key_row_index(params: CKKSParams, level: int, stored_rows: int) -> list[int]:
    """Rows of a gadget-key component stored with `stored_rows` rows
    (L_stored + alpha) that hold the active Q+P limbs at `level`."""
    alpha = len(params.p_primes)
    stored_l = stored_rows - alpha
    if stored_l < level:
        raise ValueError(f"key stored for level {stored_l}, used at {level}")
    return list(range(level)) + list(range(stored_l, stored_rows))


def gadget_mac(raised: torch.Tensor, params: CKKSParams, level: int, ctx: Context,
               ksk: DeviceKSKey, perm: torch.Tensor | None = None,
               out: torch.Tensor | None = None):
    """Inner products of the raised digits int64[D, K+alpha, N] (NTT domain)
    with both components of the gadget key: one K4 launch, int64[2, K+alpha,
    N] (written into `out` when given). `perm` gathers the digits'
    coefficients first (a hoisted rotation's automorphism). Span `ks.inner`:
    one key applied."""
    with stage("ks.inner"):
        rows = ctx.index(key_row_index(params, level, ksk.b_mont.shape[1]), torch.int32)
        chain = ctx.index(qp_indices(params, level), torch.int32)
        return mac(raised, ksk.b_mont, ksk.a_mont, rows, chain, ctx, perm, out)


def gadget_macs(raised: torch.Tensor, params: CKKSParams, level: int, ctx: Context, keys,
                perms, out: torch.Tensor) -> torch.Tensor:
    """gadget_mac for each key over the same raised digits, each through its
    perm: out[:, i] (int64[2, len(keys), K+alpha, N]) the i-th key's pair,
    one K4 launch a key (ops/mac_cuda.py mac_each). Span `ks.inner` around
    all of them."""
    with stage("ks.inner"):
        by_rows = {k.b_mont.shape[1] for k in keys}
        by_rows = {r: ctx.index(key_row_index(params, level, r), torch.int32) for r in by_rows}
        rows = [by_rows[k.b_mont.shape[1]] for k in keys]
        chain = ctx.index(qp_indices(params, level), torch.int32)
        return mac_each(raised, [(k.b_mont, k.a_mont) for k in keys], rows, chain, ctx, perms,
                        out)


def hoist(d2: torch.Tensor, params: CKKSParams, level: int, ctx: Context, ksc: KSContext,
          eval_in: bool = True) -> torch.Tensor:
    """Stages 1-2 and the NTT of 3: the raised digits int64[D, K+alpha, N]
    (NTT domain over the active Q+P basis) of one polynomial int64[K, N].
    A hoisted rotation computes them once for every step. Span `ks.mod_up`."""
    with stage("ks.mod_up"):
        d2_coeff = ntt_inv(d2, ctx, limbs=range(level)) if eval_in else d2
        raised = mod_up(d2_coeff, params, level, ctx, ksc)
        return ntt_fwd(raised, ctx, limbs=qp_indices(params, level))


def ks_finish(acc: torch.Tensor, params: CKKSParams, level: int, ctx: Context,
              ksc: KSContext, eval_out: bool = True, *,
              addend: torch.Tensor | None = None) -> torch.Tensor:
    """Stage 4: iNTT both accumulators int64[2, K+alpha, N] (one batched
    transform), ModDown by P plus `addend` (coefficient domain, int64[B', K,
    N] for the first B' components; mod_down), and NTT back (one batched
    transform) unless eval_out is False. Returns int64[2, K, N]. Span
    `ks.mod_down`."""
    with stage("ks.mod_down"):
        coeff = ntt_inv(acc, ctx, limbs=qp_indices(params, level))
        down = mod_down(coeff, params, level, ctx, ksc, addend=addend)
        return ntt_fwd(down, ctx, limbs=range(level)) if eval_out else down


def key_switch_core(
    d2: torch.Tensor,
    params: CKKSParams,
    level: int,
    ctx: Context,
    ksc: KSContext,
    ksk: DeviceKSKey,
    eval_out: bool = True,
    eval_in: bool = True,
    *,
    addend: torch.Tensor | None = None,
) -> torch.Tensor:
    """Switch one polynomial int64[K, N] to the key's target secret.

    Returns int64[2, K, N] holding (ks0, ks1), NTT domain (coefficient domain
    when eval_out is False), each plus its row of `addend` (coefficient
    domain, ks_finish) where given. With eval_in False, d2 arrives in the
    coefficient domain.
    """
    raised = hoist(d2, params, level, ctx, ksc, eval_in)
    return ks_finish(gadget_mac(raised, params, level, ctx, ksk), params, level, ctx, ksc,
                     eval_out, addend=addend)
