"""Hybrid key switching: ModUp -> inner product with the key -> ModDown.

Counterpart of gpufhe_tpu/primitives/keyswitch.py (keyswitch.py:96-227),
stage for stage, so every output limb equals the reference's:

  1. iNTT the switched polynomial to the coefficient domain (unless eval_in
     is False and it already is);
  2. ModUp each of the dnum decomposition groups to the active Q+P basis;
  3. NTT all raised groups (one batched transform) and take the inner
     product with the gadget key rows (keys in Montgomery form, mont_mac);
  4. iNTT both accumulators (one batched transform), ModDown by P, and NTT
     back unless eval_out is False.
"""

from __future__ import annotations

import torch

from gpufhe_tpu_torch.keys.keys import DeviceKSKey
from gpufhe_tpu_torch.ops.context import Context
from gpufhe_tpu_torch.ops.modops import mont_mac
from gpufhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
from gpufhe_tpu_torch.params.params import CKKSParams
from gpufhe_tpu_torch.primitives.rns import KSContext, mod_down, mod_up


def qp_indices(params: CKKSParams, level: int) -> list[int]:
    """Context-chain indices of the active Q-prefix + P-chain limbs."""
    alpha = len(params.p_primes)
    return list(range(level)) + list(range(params.num_limbs, params.num_limbs + alpha))


def key_rows(comp: torch.Tensor, params: CKKSParams, level: int) -> torch.Tensor:
    """Active Q+P rows of one gadget-key component [L_stored + alpha, N].

    A key stored at exactly this level needs no row selection.
    """
    alpha = len(params.p_primes)
    stored_l = comp.shape[0] - alpha
    if stored_l < level:
        raise ValueError(f"key stored for level {stored_l}, used at {level}")
    if stored_l == level:
        return comp
    return torch.cat([comp[:level], comp[stored_l:]])


def key_switch_core(
    d2: torch.Tensor,
    params: CKKSParams,
    level: int,
    ctx: Context,
    ksc: KSContext,
    ksk: DeviceKSKey,
    eval_out: bool = True,
    eval_in: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Switch one polynomial int64[K, N] to the key's target secret.

    Returns (ks0, ks1) int64[K, N], NTT domain (coefficient domain when
    eval_out is False). With eval_in False, d2 arrives in the coefficient
    domain.
    """
    qp_idx = qp_indices(params, level)
    q_idx = range(level)
    d2_coeff = ntt_inv(d2, ctx, limbs=q_idx) if eval_in else d2
    raised = ntt_fwd(torch.stack(mod_up(d2_coeff, params, level, ctx, ksc)), ctx, limbs=qp_idx)
    q, qinv = ctx.col("q", qp_idx), ctx.col("qinv_neg", qp_idx)
    accs = [
        mont_mac([(r, key_rows(key[d], params, level)) for d, r in enumerate(raised)], q, qinv)
        for key in (ksk.b_mont, ksk.a_mont)
    ]
    coeff = ntt_inv(torch.stack(accs), ctx, limbs=qp_idx)
    down = torch.stack([mod_down(c, params, level, ctx, ksc) for c in coeff])
    out = ntt_fwd(down, ctx, limbs=q_idx) if eval_out else down
    return out[0], out[1]
