"""Sharded BFV scale-invariant multiply over the ('limb', 'coeff') mesh.

Counterpart of gpufhe_tpu/parallel/bfv_sharded.py. Ciphertext components
ride the mesh coeff-sharded (eval3d blocks, as the CKKS / BGV multiply in
parallel/sharded.py); the limb axis shares out the relinearisation's
key-switch groups. The BEHZ machinery over the auxiliary basis (the base
conversions, t/Q scaling, the Shenoy-Kumaresan return, ciphertext/bfv.py)
is per coefficient, so it needs no new collective: each conversion is
kernel K3 on a shard's [S, n1/C * n2] block, and the only communication is
the four-step's all_to_alls (Q and aux transforms alike) and the key
switch's exact allreduce. Composed as bfv.ct_mul (the tensor and the
relinearisation meet in the coefficient domain), so every limb equals it.
"""

from __future__ import annotations

import functools

import torch

from gpufhe_tpu_torch.ciphertext.bfv import make_bfv_mul_context, sk_convert_to_q
from gpufhe_tpu_torch.ciphertext.ct import tensor_core
from gpufhe_tpu_torch.golden import bfv as gbfv
from gpufhe_tpu_torch.keys.keys import DeviceKSKey
from gpufhe_tpu_torch.ops.convert_cuda import base_convert
from gpufhe_tpu_torch.ops.modops import add_mod, mul_mod, sub_mod
from gpufhe_tpu_torch.params.params import CKKSParams
from gpufhe_tpu_torch.parallel import sharded as sh
from gpufhe_tpu_torch.parallel.mesh import FheMesh
from gpufhe_tpu_torch.primitives.keyswitch import qp_indices


def _bfv_mult_body(mesh: FheMesh, a0, a1, b0, b1, params: CKKSParams, t_q, t_aux, t_qp,
                   tabs: dict, ks, level: int, gmax: int):
    """tensor over Q and the aux basis -> t/Q scale -> S-K return ->
    relinearize, on eval3d blocks (tabs: device -> BFVMulTables)."""
    n2 = a0[0][0].shape[-1]
    a_dim = len(t_aux.rows)
    flat = sh._flat

    # 1. extend the four inputs to the aux basis (K3 per component)
    coeff = sh.ntt_inv_body(mesh.map(lambda *c: torch.stack(c), a0, a1, b0, b1), t_q)
    ext = [[sh._e3(torch.stack([base_convert(flat(x).contiguous(), tabs[dev].q2aux)
                                for x in blk]), n2)
            for blk, dev in zip(*cells)] for cells in zip(coeff, mesh.devices)]
    ext = sh.ntt_fwd_body(ext, t_aux)

    # 2. tensor over both bases, 3. y = (t d - [t d]_Q) / Q over aux
    def scale_in(i, c):
        dev = mesh.devices[i][c]
        ctx, aux, tb = t_q.ctx(dev), t_aux.ctx(dev), tabs[dev]
        ca = [flat(a0[i][c]), flat(a1[i][c])]
        cb = [flat(b0[i][c]), flat(b1[i][c])]
        e = flat(ext[i][c])
        return (sh._e3(tensor_core(ca, cb, ctx, level), n2),
                sh._e3(tensor_core(e[:2], e[2:], aux, a_dim), n2))

    d = [[scale_in(i, c) for c in range(len(row))] for i, row in enumerate(a0)]
    dq = sh.ntt_inv_body(mesh.map(lambda x: x[0], d), t_q)
    daux = sh.ntt_inv_body(mesh.map(lambda x: x[1], d), t_aux)

    def to_q(i, c):  # 4. back to Q exactly: int64[3, K, M] coefficient domain
        dev = mesh.devices[i][c]
        tb, q, aq = tabs[dev], t_q.col(dev), t_aux.col(dev)
        r = mul_mod(flat(dq[i][c]), tb.t_q, q)
        r_aux = torch.stack([base_convert(x.contiguous(), tb.q2aux) for x in r])
        y = mul_mod(sub_mod(mul_mod(flat(daux[i][c]), tb.t_aux, aq), r_aux, aq), tb.qinv_aux,
                    aq)
        return sh._e3(torch.stack([sk_convert_to_q(yc, tb, q) for yc in y]), n2)

    dc = [[to_q(i, c) for c in range(len(row))] for i, row in enumerate(a0)]
    ks01 = sh._keyswitch_body(mesh, mesh.map(lambda x: x[2], dc), params, t_q, t_qp, ks, level,
                              gmax, eval_in=False, eval_out=False)
    cc = [[sh._e3(add_mod(flat(x[:2]), flat(k), t_q.col(dev)), n2)
           for x, k, dev in zip(*cells)] for cells in zip(dc, ks01, mesh.devices)]
    out = sh.ntt_fwd_body(cc, t_q)
    return mesh.map(lambda x: x[0], out), mesh.map(lambda x: x[1], out)


@functools.lru_cache(maxsize=None)
def make_sharded_bfv_mult(params: CKKSParams, level: int, mesh: FheMesh):
    """The sharded BFV tensor + relinearize step for a mesh.

    Returns (run, prepare): prepare(rlk) builds the key bundle;
    run(a0, a1, b0, b1, bundle) maps eval3d-sharded components [K, n1, n2]
    -> two [K, n1, n2] components (the level stays)."""
    n_limb = mesh.shape["limb"]
    cv = gbfv._ckks_view(params)  # BFV's key switch is the CKKS one
    per_dev = {d: make_bfv_mul_context(params, level, device=d) for d in mesh.distinct_devices}
    n_aux = len(next(iter(per_dev.values()))[0].q_primes)
    t_q, t_qp = sh._tables(params, mesh, range(level), qp_indices(params, level))
    t_aux = sh._ntt_tables_for({d: v[1] for d, v in per_dev.items()}, range(n_aux), mesh)
    tabs = {d: v[2] for d, v in per_dev.items()}

    def prepare(ksk: DeviceKSKey):
        return sh.make_sharded_ks(cv, level, ksk, n_limb, mesh=mesh)

    def run(a0, a1, b0, b1, bundle):
        ks, gmax = bundle
        return _bfv_mult_body(mesh, a0, a1, b0, b1, cv, t_q, t_aux, t_qp, tabs, ks, level, gmax)

    return run, prepare


# ---------------------------------------------------------------------------
# BFV rotations on the mesh: the CKKS sharded Galois and hoisted-fan programs
# with the plain (not t-corrected) ModDown, _ckks_view; the level stays
# ---------------------------------------------------------------------------


def make_sharded_bfv_rotation(params: CKKSParams, level: int, mesh: FheMesh, steps: int):
    """(run, prepare) for one BFV rotation on the ('limb', 'coeff') mesh."""
    return sh.make_sharded_rotation(gbfv._ckks_view(params), level, mesh, steps)


def make_sharded_bfv_hoisted_fan(params: CKKSParams, level: int, mesh: FheMesh, n_offsets: int):
    """(run, prepare) for a hoisted BFV rotation fan (ONE decomposition for
    the whole fan)."""
    return sh.make_sharded_hoisted_fan(gbfv._ckks_view(params), level, mesh, n_offsets)
