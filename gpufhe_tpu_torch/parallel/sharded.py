"""Multi-device SPMD pipeline over the ('limb', 'coeff') mesh (parallel/mesh.py).

Counterpart of gpufhe_tpu/parallel/sharded.py, with its layout and its
programs:

* ``coeff`` shards polynomial coefficients. At rest a limb is the four-step
  matrix [n1, n2] cut over its rows, n1/C rows per shard. A forward or
  inverse transform is kernel K1's two passes run one at a time on each
  shard's block (ops/ntt_cuda.fourstep_pass: pass A over a block of
  columns with its global column offset, pass B over a block of rows),
  joined by two all_to_all exchanges: the distributed four-step.
  Eval-domain data lives in the [k1, k2] matrix ("eval3d", natural index
  k = k2*n1 + k1), which is what pass B writes row by row.
* ``limb`` shards the gadget decomposition groups of the hybrid key switch:
  limb row l converts (K3), transforms and multiplies against the key (K4)
  its own gmax = ceil(groups / n_limb) groups, and the partial inner
  products are summed across the axis exactly mod q (an all_gather and
  add_mod in order, mesh.modular_allreduce).

Ciphertext components are replicated over limb and cut over coeff: a
sharded component is a grid (a list per limb row of n_coeff blocks) of
int64[K, n1/C, n2] eval3d blocks. Each make_* returns (run, prepare) as the
reference's does: prepare(key) builds the key bundle on the shards' devices,
once per key; run takes and returns grids. Inside a program the body runs
shard by shard, eagerly, with the port's own ops on each block (K3 through
primitives/rns, K4 through ops/mac_cuda.mac), the same ops in the same
order as the single-device path (ciphertext/ct.py), so every output limb
equals it.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.keys.keys import DeviceKSKey
from gpufhe_tpu_torch.ops.context import Context, fourstep_split, make_context
from gpufhe_tpu_torch.ops.convert_cuda import base_convert
from gpufhe_tpu_torch.ops.mac_cuda import mac
from gpufhe_tpu_torch.ops.modops import add_mod
from gpufhe_tpu_torch.ops.ntt_cuda import FWD_A, FWD_B, INV_A, INV_B, fourstep_pass
from gpufhe_tpu_torch.params.params import CKKSParams
from gpufhe_tpu_torch.parallel.mesh import FheMesh
from gpufhe_tpu_torch.primitives.keyswitch import key_row_index, qp_indices
from gpufhe_tpu_torch.primitives.rns import (bgv_modswitch, ks_groups, make_ks_context, mod_down,
                                             rescale, rescale_words)


def make_fhe_mesh(n_limb: int, n_coeff: int, devices=None) -> FheMesh:
    """The standard ('limb', 'coeff') mesh. With devices=None it takes the
    first n_limb * n_coeff CUDA devices and raises where there are fewer; it
    never repeats a device and never falls back to the CPU. Logical shards
    on one card: devices=["cuda:0"] * 8; on the CPU: ["cpu"] * 8."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n_limb * n_coeff:
            raise RuntimeError(f"a {n_limb} x {n_coeff} mesh needs {n_limb * n_coeff} CUDA "
                               f"devices, {count} found; name the devices to repeat one")
        devices = [f"cuda:{i}" for i in range(n_limb * n_coeff)]
    return FheMesh(n_limb, n_coeff, devices)


# ---------------------------------------------------------------------------
# Layout converters
# ---------------------------------------------------------------------------


def natural_to_eval3d(x: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """Natural-order eval vector [..., N] -> [k1, k2] matrix [..., n1, n2].

    Natural index k = k2*n1 + k1, so the natural vector is the [k2, k1]
    matrix flattened; the sharded layout is its transpose.
    """
    *lead, n = x.shape
    return x.reshape(*lead, n2, n1).transpose(-1, -2)


def eval3d_to_natural(x: torch.Tensor) -> torch.Tensor:
    *lead, n1, n2 = x.shape
    return x.transpose(-1, -2).reshape(*lead, n1 * n2)


def coeff_to_3d(x: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """Coefficient-order vector [..., N] -> [j1, j2] matrix (j = j1*n2 + j2)."""
    *lead, n = x.shape
    return x.reshape(*lead, n1, n2)


def _flat(b: torch.Tensor) -> torch.Tensor:
    """[..., B, n2] block -> [..., B * n2] (pointwise ops, K3 and K4)."""
    return b.reshape(*b.shape[:-2], b.shape[-2] * b.shape[-1])


def _e3(b: torch.Tensor, n2: int) -> torch.Tensor:
    """[..., B * n2] -> [..., B, n2]."""
    return b.reshape(*b.shape[:-1], b.shape[-1] // n2, n2)


# ---------------------------------------------------------------------------
# Sharded NTT tables: K1's tables and a limb index, one set per device
# ---------------------------------------------------------------------------


class ShardedNTT(NamedTuple):
    """The transform tables of a limb selection: per device the context
    whose full-chain K1 tables every shard on that device shares, the chain
    rows of the limb axis (the reference's digit matrices and per-limb
    constants become K1's tables and its limb index), and the mesh whose
    shards hold them (the reference's bodies find theirs in shard_map)."""

    ctxs: dict  # torch.device -> Context
    rows: tuple  # chain rows
    mesh: FheMesh

    def ctx(self, dev) -> Context:
        return self.ctxs[torch.device(dev)]

    def idx(self, dev) -> torch.Tensor:
        return self.ctx(dev).index(self.rows, torch.int32)

    def col(self, dev, name: str = "q") -> torch.Tensor:
        """Per-limb constant [L, 1] on dev (against flattened blocks)."""
        return self.ctx(dev).col(name, self.rows)


def mesh_contexts(params: CKKSParams, mesh: FheMesh) -> dict:
    """The context of `params` on each distinct device of the mesh."""
    return {d: make_context(params, device=d) for d in mesh.distinct_devices}


@functools.lru_cache(maxsize=8)
def full_ntt_tables(params: CKKSParams, *, mesh: FheMesh) -> ShardedNTT:
    """ONE full-chain table set per parameter set and mesh, shared by every
    program; gather_ntt_tables selects a level's rows."""
    ctxs = mesh_contexts(params, mesh)
    return ShardedNTT(ctxs, tuple(range(len(params.q_primes) + len(params.p_primes))), mesh)


def gather_ntt_tables(t_full: ShardedNTT, idx) -> ShardedNTT:
    """A limb selection of the shared full-chain set (chain rows idx)."""
    return t_full._replace(rows=tuple(int(i) for i in idx))


def _ntt_tables_for(ctx, limbs, mesh: FheMesh) -> ShardedNTT:
    """Tables of `limbs` of a chain: ctx is a dict device -> Context."""
    return ShardedNTT(dict(ctx), tuple(int(i) for i in limbs), mesh)


# -- the distributed four-step ------------------------------------------------


def _passes(mesh: FheMesh, blocks, t: ShardedNTT, kind: int, axis: str):
    """K1's pass `kind` on each shard's block [R, a, b] (pass A at its
    global column offset along `axis`)."""
    out = [list(r) for r in blocks]
    for i, row in enumerate(blocks):
        for c, b in enumerate(row):
            dev = mesh.devices[i][c]
            pos = c if axis == "coeff" else mesh.rows[i]
            col0 = pos * b.shape[2] if kind in (FWD_A, INV_A) else 0
            if b.numel() == 0:  # a limb row that owns no gadget group
                dtype = torch.int32 if kind in (FWD_A, INV_B) else torch.int64
                out[i][c] = torch.empty(b.shape, dtype=dtype, device=dev)
                continue
            out[i][c] = fourstep_pass(b.contiguous(), t.idx(dev), t.ctx(dev), kind, col0)
    return out


def _transform(x, t: ShardedNTT, axis: str, inverse: bool):
    mesh = t.mesh
    flat = mesh.map(lambda b: b.reshape(-1, *b.shape[-2:]), x)
    if not inverse:
        cols = mesh.all_to_all(flat, axis, split_axis=2, concat_axis=1)  # [R, n1, n2/C]
        rows = mesh.all_to_all(_passes(mesh, cols, t, FWD_A, axis), axis,
                               split_axis=1, concat_axis=2)  # [R, n1/C (k1), n2 (j2)]
        out = _passes(mesh, rows, t, FWD_B, axis)
    else:
        cols = mesh.all_to_all(_passes(mesh, flat, t, INV_B, axis), axis,
                               split_axis=2, concat_axis=1)  # [R, n1 (k1), n2/C (j2)]
        out = mesh.all_to_all(_passes(mesh, cols, t, INV_A, axis), axis,
                              split_axis=1, concat_axis=2)
    return mesh.map(lambda b, o: o.reshape(b.shape), x, out)


def ntt_fwd_body(x, t: ShardedNTT, axis: str = "coeff"):
    """Coeff rows [..., L, n1/C, n2] -> eval [..., L, n1/C (k1), n2 (k2)]:
    an all_to_all to columns, K1's pass A at the block's column offset, an
    all_to_all back to rows, K1's pass B."""
    return _transform(x, t, axis, inverse=False)


def ntt_inv_body(e, t: ShardedNTT, axis: str = "coeff"):
    """Eval [..., L, n1/C (k1), n2 (k2)] -> coeff rows [..., L, n1/C (j1),
    n2]: K1's inverse pass B, an all_to_all to columns, inverse pass A at
    the block's column offset, an all_to_all back."""
    return _transform(e, t, axis, inverse=True)


def _modular_allreduce(mesh: FheMesh, x, t: ShardedNTT, axis: str = "limb"):
    """Exact sum mod q across a mesh axis of blocks [..., L, M] (q of t's rows)."""
    return mesh.modular_allreduce(x, lambda dev: t.col(dev), axis)


# ---------------------------------------------------------------------------
# Sharded key-switch bundle: the gadget groups shared out over the limb axis
# ---------------------------------------------------------------------------


class ShardedKS(NamedTuple):
    """Key-switch tables and key blocks of one key at one level.

    groups[i]: the gadget groups limb row i (a local row) owns, l*gmax to
    (l+1)*gmax - 1 of the level's groups; ksc: the ModUp / ModDown /
    rescale tables per device (primitives/rns.make_ks_context; for BGV the
    t-corrected ones); key_b / key_a: per shard int64[len(groups[i]), K +
    alpha, n1/C * n2], the groups' key rows at the level's Q+P limbs in the
    eval3d layout, Montgomery form (None for a program that reads its keys
    from per-rotation stacks)."""

    groups: tuple
    ksc: dict
    key_b: list | None
    key_a: list | None


def _row_groups(params: CKKSParams, level: int, n_limb: int, rows) -> tuple[int, tuple]:
    """(gmax, the groups of each given limb row)."""
    dnum = len(ks_groups(params, level))
    gmax = math.ceil(dnum / n_limb)
    return gmax, tuple(tuple(range(l * gmax, min((l + 1) * gmax, dnum))) for l in rows)


def _key_blocks(ksk: DeviceKSKey, params: CKKSParams, level: int, mesh: FheMesh, groups):
    """Each shard's block of its groups' key rows: two grids of
    int64[g, K + alpha, n1/C * n2] (eval3d, Montgomery)."""
    n1, n2 = fourstep_split(params.n)
    rows = key_row_index(params, level, ksk.b_mont.shape[1])
    b_rows = n1 // mesh.shape["coeff"]

    def blocks(key):
        out = []
        for i, devs in enumerate(mesh.devices):
            sel = list(groups[i])
            e3 = natural_to_eval3d(key[sel][:, rows], n1, n2)  # [g, K+alpha, n1, n2]
            out.append([_flat(e3[..., c * b_rows:(c + 1) * b_rows, :]).to(dev).contiguous()
                        for c, dev in enumerate(devs)])
        return out

    return blocks(ksk.b_mont), blocks(ksk.a_mont)


def make_sharded_ks(params: CKKSParams, level: int, ksk: DeviceKSKey, n_limb: int, *,
                    mesh: FheMesh) -> tuple[ShardedKS, int]:
    """Build the ShardedKS bundle (on the mesh's devices) for a key at a level."""
    if n_limb != mesh.shape["limb"]:
        raise ValueError(f"n_limb {n_limb} is not the mesh's {mesh.shape['limb']}")
    gmax, groups = _row_groups(params, level, n_limb, mesh.rows)
    ksc = {d: make_ks_context(params, level, device=d) for d in mesh.distinct_devices}
    kb, ka = (None, None) if ksk is None else _key_blocks(ksk, params, level, mesh, groups)
    return ShardedKS(groups, ksc, kb, ka), gmax


# ---------------------------------------------------------------------------
# The sharded key switch and multiply
# ---------------------------------------------------------------------------


def _raise(mesh: FheMesh, x_coeff, params: CKKSParams, level: int, ks: ShardedKS,
           t_qp: ShardedNTT):
    """ModUp of each shard's own groups of coefficient blocks [K, B, n2]
    (one K3 launch per group, on [S, B * n2]), NTT over Q+P: the raised
    digits [g, K + alpha, B, n2], eval3d."""
    spans = ks_groups(params, level)
    n2 = x_coeff[0][0].shape[-1]
    qp = len(t_qp.rows)

    def up(i, c, x):
        ksc = ks.ksc[mesh.devices[i][c]]
        flat = _flat(x)
        got = [base_convert(flat[spans[g][0]:spans[g][1]].contiguous(), ksc.modup[g])
               for g in ks.groups[i]]
        if not got:
            return torch.empty((0, qp, x.shape[-2], n2), dtype=torch.int64, device=x.device)
        return _e3(torch.stack(got), n2)

    raised = [[up(i, c, x) for c, x in enumerate(row)] for i, row in enumerate(x_coeff)]
    return ntt_fwd_body(raised, t_qp)


def _gadget_mac(mesh: FheMesh, raised, key_b, key_a, params: CKKSParams, level: int,
                t_qp: ShardedNTT):
    """Each shard's partial inner product of its raised digits
    [g, K + alpha, B * n2] with its key blocks: one K4 launch for both
    components, int64[2, K + alpha, B * n2] (zeros on a row with no group)."""
    qp = len(t_qp.rows)

    def one(i, c, r, kb, ka):
        dev = mesh.devices[i][c]
        ctx = t_qp.ctx(dev)
        if r.shape[0] == 0:
            return torch.zeros((2, qp, r.shape[-1]), dtype=torch.int64, device=dev)
        return mac(r.contiguous(), kb, ka, ctx.index(range(qp), torch.int32), t_qp.idx(dev), ctx)

    return [[one(i, c, r, kb, ka) for c, (r, kb, ka) in enumerate(zip(*cells))]
            for i, cells in enumerate(zip(raised, key_b, key_a))]


def _ks_finish(mesh: FheMesh, acc, params: CKKSParams, level: int, ks: ShardedKS,
               t_q: ShardedNTT, t_qp: ShardedNTT, n2: int, eval_out: bool):
    """Sum the partial products over the limb axis exactly, iNTT, ModDown by
    P (K3 on each block), and NTT back unless eval_out is False:
    int64[2, K, B, n2] per shard."""
    acc = _modular_allreduce(mesh, acc, t_qp)
    coeff = ntt_inv_body(mesh.map(lambda a: _e3(a, n2), acc), t_qp)

    def down(i, c, x):
        dev = mesh.devices[i][c]
        return _e3(mod_down(_flat(x), params, level, t_qp.ctx(dev), ks.ksc[dev]), n2)

    out = [[down(i, c, x) for c, x in enumerate(row)] for i, row in enumerate(coeff)]
    return ntt_fwd_body(out, t_q) if eval_out else out


def _keyswitch_body(mesh: FheMesh, d2, params: CKKSParams, t_q: ShardedNTT, t_qp: ShardedNTT,
                    ks: ShardedKS, level: int, gmax: int, eval_in: bool = True,
                    eval_out: bool = True):
    """Group-parallel hybrid key switch of d2 [K, B, n2] blocks: each limb
    row ModUps (K3), transforms and multiplies against the key (K4) its
    own groups, the partial products are summed exactly over the limb axis,
    then ModDown (K3). Returns a grid of int64[2, K, B, n2] (ks0, ks1)."""
    n2 = d2[0][0].shape[-1]
    d2_coeff = ntt_inv_body(d2, t_q) if eval_in else d2
    raised = _raise(mesh, d2_coeff, params, level, ks, t_qp)
    acc = _gadget_mac(mesh, mesh.map(_flat, raised), ks.key_b, ks.key_a, params, level, t_qp)
    return _ks_finish(mesh, acc, params, level, ks, t_q, t_qp, n2, eval_out)


def _tables(params: CKKSParams, mesh: FheMesh, *rows_list):
    t_full = full_ntt_tables(params, mesh=mesh)
    return [gather_ntt_tables(t_full, rows) for rows in rows_list]


def _mult_body(mesh: FheMesh, a0, a1, b0, b1, params: CKKSParams, t_q, t_qp, t_qm1,
               ks: ShardedKS, level: int, gmax: int, bgv: bool = False):
    """tensor -> relinearize -> rescale (bgv: the t-corrected ModSwitch) on
    eval3d blocks, composed as ct_mul_full (bgv.ct_mul): the key switch
    stays in the coefficient domain, d0 and d1 join it there, one rescale,
    one NTT back."""
    from gpufhe_tpu_torch.ciphertext.ct import tensor_core

    n2 = a0[0][0].shape[-1]

    def tensor(i, c, *comps):
        ctx = t_q.ctx(mesh.devices[i][c])
        d = tensor_core([_flat(x) for x in comps[:2]], [_flat(x) for x in comps[2:]], ctx,
                        level)
        return _e3(d, n2)

    d = [[tensor(i, c, *cells) for c, cells in enumerate(zip(*rows))]
         for i, rows in enumerate(zip(a0, a1, b0, b1))]
    d01 = mesh.map(lambda x: x[:2], d)
    d2 = mesh.map(lambda x: x[2], d)
    ks01 = _keyswitch_body(mesh, d2, params, t_q, t_qp, ks, level, gmax, eval_out=False)
    coeff = ntt_inv_body(d01, t_q)

    def finish(i, c, x, k):
        dev = mesh.devices[i][c]
        ctx, ksc = t_q.ctx(dev), ks.ksc[dev]
        cc = add_mod(_flat(x), _flat(k), t_q.col(dev))
        down = (bgv_modswitch if bgv else rescale)(cc, params, level, ctx, ksc)
        return _e3(down, n2)

    down = [[finish(i, c, x, k) for c, (x, k) in enumerate(zip(*rows))]
            for i, rows in enumerate(zip(coeff, ks01))]
    out = ntt_fwd_body(down, t_qm1)
    return mesh.map(lambda x: x[0], out), mesh.map(lambda x: x[1], out)


@functools.lru_cache(maxsize=None)
def make_sharded_mult(params: CKKSParams, level: int, mesh: FheMesh):
    """The sharded tensor + relinearize + rescale step for a mesh.

    Returns (run, prepare): prepare(rlk) builds the key bundle on the
    mesh's devices; run(a0, a1, b0, b1, bundle) maps eval3d-sharded
    components [K, n1, n2] -> two [K-1, n1, n2] components (one rescale; a
    BGV chain's t-corrected ModSwitch)."""
    n_limb = mesh.shape["limb"]
    t_q, t_qp, t_qm1 = _tables(params, mesh, range(level), qp_indices(params, level),
                               range(level - 1))
    bgv = bool(params.plain_modulus)

    def prepare(ksk: DeviceKSKey):
        return make_sharded_ks(params, level, ksk, n_limb, mesh=mesh)

    def run(a0, a1, b0, b1, bundle):
        ks, gmax = bundle
        return _mult_body(mesh, a0, a1, b0, b1, params, t_q, t_qp, t_qm1, ks, level, gmax, bgv)

    return run, prepare


# ---------------------------------------------------------------------------
# Moving single-device ciphertexts onto the mesh
# ---------------------------------------------------------------------------


def shard_ct_component(x: torch.Tensor, params: CKKSParams, mesh: FheMesh):
    """Natural-order eval [K, N] -> eval3d [K, n1, n2] cut over coeff (rows
    of n1/C) on each shard's device, replicated over limb: a grid."""
    n1, n2 = fourstep_split(params.n)
    e3 = natural_to_eval3d(x, n1, n2)
    b = n1 // mesh.shape["coeff"]
    return mesh.put(lambda l, c, dev: e3[..., c * b:(c + 1) * b, :].to(dev).contiguous())


def unshard_ct_component(x) -> torch.Tensor:
    """A grid of eval3d blocks -> natural-order eval [K, N] on the host."""
    return eval3d_to_natural(torch.cat([b.cpu() for b in x[0]], dim=-2))


# ---------------------------------------------------------------------------
# Sharded Galois automorphism: eval-domain permutation + the key switch
# ---------------------------------------------------------------------------


def _perm_lin_e3(g: int, n1: int, n2: int) -> np.ndarray:
    """Row-major linear gather indices realizing the eval-domain automorphism
    in the [k1, k2] layout: out.flat[q] = in.flat[lin[q]]."""
    n = n1 * n2
    perm = gckks.automorphism_perm_eval(g, n)  # natural order: out[k] = in[perm[k]]
    k1o, k2o = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
    src = perm[k2o * n1 + k1o]  # natural eval index feeding out[k1o, k2o]
    return ((src % n1) * n2 + src // n1).astype(np.int64)  # [n1, n2] row-major


def _lin_blocks(lin: np.ndarray, mesh: FheMesh):
    """A [..., n1, n2] gather map cut over coeff onto each shard: a grid."""
    b = lin.shape[-2] // mesh.shape["coeff"]
    t = torch.from_numpy(np.ascontiguousarray(lin))
    return mesh.put(lambda l, c, dev: t[..., c * b:(c + 1) * b, :].to(dev).contiguous())


def _permute_body(mesh: FheMesh, x, lin_local):
    """Apply the automorphism to eval3d blocks [L, n1/C, n2] (v1): an
    all_gather over coeff (the permutation is global), then each shard
    gathers its own output rows. C x the ciphertext's traffic, the right
    choice for a fan of R > C rotations sharing one gather; a single
    rotation routes (v2, _permute_body_v2)."""
    full = mesh.all_gather(x, "coeff", dim=1)  # [L, n1, n2]

    def take(f, lin):
        return f.reshape(f.shape[0], -1)[:, lin.reshape(-1)].reshape(f.shape[0], *lin.shape)

    return mesh.map(take, full, lin_local)


def _perm_route_tables(g: int, n1: int, n2: int, n_coeff: int):
    """Host routing tables for the 1x-traffic automorphism (v2).

    In the eval3d layout the odd-exponent automorphism is ROW-PURE: output
    row k1o reads exactly one input row. Each source shard sends, per
    destination shard, the <= n1/C rows that land there; one all_to_all
    moves exactly 1x the ciphertext, and the destination picks its p-th
    output row from the source shard that owns it.

    Returns (send_idx [C, C, B], src_of [C, B], col_idx [n1, n2]):
    send_idx[s, d, p] = source-local row index shard s places in the slot
    destination d reads for output row p; src_of[d, p] = which source shard
    that is; col_idx = the within-row column gather.
    """
    lin = _perm_lin_e3(g, n1, n2)
    row_src = lin[:, 0] // n2
    assert (lin // n2 == row_src[:, None]).all(), "automorphism not row-pure in eval3d layout"
    col_idx = (lin % n2).astype(np.int64)
    b = n1 // n_coeff
    send_idx = np.zeros((n_coeff, n_coeff, b), dtype=np.int64)
    src_of = np.zeros((n_coeff, b), dtype=np.int64)
    for r_out in range(n1):
        r_in = int(row_src[r_out])
        s, d, p = r_in // b, r_out // b, r_out % b
        send_idx[s, d, p] = r_in % b
        src_of[d, p] = s
    return send_idx, src_of, col_idx


def _route_blocks(g: int, n1: int, n2: int, mesh: FheMesh):
    """The v2 routing tables cut onto each shard: a grid of (send_idx [C, B],
    src_of [B], col_idx [B, n2])."""
    c_dim = mesh.shape["coeff"]
    send_idx, src_of, col_idx = (torch.from_numpy(a) for a in
                                 _perm_route_tables(g, n1, n2, c_dim))
    b = n1 // c_dim
    return mesh.put(lambda l, c, dev: (send_idx[c].to(dev), src_of[c].to(dev),
                                       col_idx[c * b:(c + 1) * b].to(dev)))


def _permute_body_v2(mesh: FheMesh, x, route):
    """1x-traffic automorphism on eval3d blocks [L, B, n2] (see
    _perm_route_tables); route: _route_blocks's grid."""
    def stage(b, r):  # rows for every destination: [L, C, B, n2]
        send_idx = r[0]
        return b[:, send_idx.reshape(-1)].reshape(b.shape[0], *send_idx.shape, b.shape[2])

    buf = mesh.all_to_all(mesh.map(stage, x, route), "coeff", split_axis=1,
                          concat_axis=1)  # [L, C (source), B, n2]

    def pick(f, r):
        _, src_of, col_idx = r
        rows = f[:, src_of, torch.arange(src_of.numel(), device=f.device)]  # [L, B, n2]
        return torch.gather(rows, 2, col_idx.expand(f.shape[0], *col_idx.shape))

    return mesh.map(pick, buf, route)


# ---------------------------------------------------------------------------
# The fused sharded diagonal fan ("double hoisting"), the mesh mirror of
# ct_diag_fan: one ModUp + NTT for the whole fan, the raised digits and c0
# all_gathered over coeff ONCE (R rotations then gather locally), K4 at both
# MAC levels, ONE exact limb allreduce and ONE ModDown per output set,
# rescale fused in.
# ---------------------------------------------------------------------------


def _key_stack_e3(ksk: DeviceKSKey, params: CKKSParams, level: int, n_limb: int, *,
                  mesh: FheMesh):
    """A Galois / relin key's rows -> per-shard blocks of its limb row's
    groups: (key_b grid, key_a grid)."""
    _, groups = _row_groups(params, level, n_limb, mesh.rows)
    return _key_blocks(ksk, params, level, mesh, groups)


def _hoist_gather(mesh: FheMesh, c0, c1, params: CKKSParams, level: int, ks: ShardedKS,
                  t_q: ShardedNTT, t_qp: ShardedNTT):
    """The fan's shared operands: each shard's raised digits and c0, each
    all_gathered over coeff to [g, K+alpha, N] and [K, N]."""
    raised = _raise(mesh, ntt_inv_body(c1, t_q), params, level, ks, t_qp)
    full_r = mesh.all_gather(raised, "coeff", dim=2)  # [g, K+alpha, n1, n2]
    full_c0 = mesh.all_gather(c0, "coeff", dim=1)  # [K, n1, n2]
    return (mesh.map(lambda r: r.reshape(*r.shape[:2], -1), full_r),
            mesh.map(lambda x: x.reshape(x.shape[0], -1), full_c0))


def _gathered(mesh: FheMesh, full, lins, j: int):
    """Each shard's rows of a gathered operand [..., N] through offset j's
    map: [..., B * n2]."""
    return mesh.map(lambda f, lin: f[..., lin[j].reshape(-1)].contiguous(), full, lins)


@functools.lru_cache(maxsize=None)
def make_sharded_fan(params: CKKSParams, level: int, mesh: FheMesh, n_offsets: int, nsets: int,
                     pt0_mask: tuple):
    """The fused diagonal-fan stage for a mesh.

    Returns (run, prepare): prepare(list_of_galois_keys, any_key) -> bundle;
    run(c0, c1, lins, bundle, pt_stacks, pt0s) -> list of (c0', c1')
    eval3d grids at level - scale_words. `lins` is a grid of each shard's
    rows of the [R, n1, n2] automorphism gather maps (_perm_lin_e3);
    pt_stacks per set a grid of [R, K + alpha, n1/C, n2] Montgomery
    plaintexts; pt0s per set such a grid of [K + alpha, n1/C, n2] or None."""
    n_limb = mesh.shape["limb"]
    k = level
    qp = qp_indices(params, level)
    t_q, t_qp = _tables(params, mesh, range(k), qp)
    words = params.scale_words

    def prepare(gk_list, any_key):
        shared, _ = make_sharded_ks(params, level, None, n_limb, mesh=mesh)
        stacks = tuple(_key_stack_e3(gk, params, level, n_limb, mesh=mesh) for gk in gk_list)
        return shared, stacks

    def run(c0, c1, lins, bundle, pt_stacks, pt0s):
        ks, stacks = bundle
        n2 = c0[0][0].shape[-1]
        full_r, full_c0 = _hoist_gather(mesh, c0, c1, params, level, ks, t_q, t_qp)
        # per offset: both components' partial inner products, [R, 2, K+alpha, M]
        t01 = [_gadget_mac(mesh, _gathered(mesh, full_r, lins, j), kb, ka, params, level, t_qp)
               for j, (kb, ka) in enumerate(stacks)]
        t01 = [[torch.stack([t[i][c] for t in t01], dim=1) for c in range(len(row))]
               for i, row in enumerate(c0)]
        c0g = [[torch.stack([g[i][c] for g in (_gathered(mesh, full_c0, lins, j)
                                                  for j in range(n_offsets))])
                for c in range(len(row))] for i, row in enumerate(c0)]
        outs = []
        for s in range(nsets):
            def macs(i, c):
                dev = mesh.devices[i][c]
                ctx = t_q.ctx(dev)
                pts = _flat(pt_stacks[s][i][c])
                rows_q = ctx.index(range(k), torch.int32)
                acc = mac(pts, t01[i][c][0].contiguous(), t01[i][c][1].contiguous(),
                          ctx.index(range(len(qp)), torch.int32), t_qp.idx(dev), ctx)
                e = [mac(c0g[i][c], pts, None, rows_q, rows_q, ctx)[0]]
                if pt0_mask[s]:
                    p0 = mac(_flat(pt0s[s][i][c])[:k][None].contiguous(),
                             _flat(c0[i][c])[None].contiguous(),
                             _flat(c1[i][c])[None].contiguous(), rows_q, rows_q, ctx)
                    e = [add_mod(e[0], p0[0], t_q.col(dev)), p0[1]]
                return acc, e

            got = [[macs(i, c) for c in range(len(row))] for i, row in enumerate(c0)]
            down = _ks_finish(mesh, [[a for a, _ in r] for r in got], params, level, ks, t_q,
                              t_qp, n2, eval_out=False)
            e_coeff = ntt_inv_body([[_e3(torch.stack(e), n2) for _, e in r] for r in got],
                                   t_q)

            def finish(i, c):
                dev = mesh.devices[i][c]
                q = t_q.col(dev)
                e, dn = _flat(e_coeff[i][c]), _flat(down[i][c])
                cc = torch.stack([add_mod(dn[j], e[j], q) if j < len(e) else dn[j]
                                  for j in range(2)])
                return _e3(rescale_words(cc, params, level, words, t_q.ctx(dev)), n2)

            cc = [[finish(i, c) for c in range(len(row))] for i, row in enumerate(c0)]
            t_out, = _tables(params, mesh, range(level - words))
            out = ntt_fwd_body(cc, t_out)
            outs.append((mesh.map(lambda x: x[0], out), mesh.map(lambda x: x[1], out)))
        return outs

    return run, prepare


@functools.lru_cache(maxsize=None)
def make_sharded_hoisted_fan(params: CKKSParams, level: int, mesh: FheMesh, n_offsets: int):
    """Hoisted rotation fan: MANY rotations of one ciphertext, ONE program.

    The mesh mirror of ct_rotate_hoisted: decompose + ModUp + NTT of c1
    ONCE for the whole fan, the raised digits and c0 all_gathered over
    coeff ONCE, then each rotation is a local gather, a K4 MAC, its own
    exact limb allreduce and ModDown. Outputs stay at `level`.

    Returns (run, prepare): prepare(gk_list) -> bundle;
    run(c0, c1, lins, bundle) -> list of (c0', c1') eval3d grids.
    """
    n_limb = mesh.shape["limb"]
    t_q, t_qp = _tables(params, mesh, range(level), qp_indices(params, level))

    def prepare(gk_list):
        shared, _ = make_sharded_ks(params, level, None, n_limb, mesh=mesh)
        stacks = tuple(_key_stack_e3(gk, params, level, n_limb, mesh=mesh) for gk in gk_list)
        return shared, stacks

    def run(c0, c1, lins, bundle):
        ks, stacks = bundle
        n2 = c0[0][0].shape[-1]
        full_r, full_c0 = _hoist_gather(mesh, c0, c1, params, level, ks, t_q, t_qp)
        outs = []
        for j, (kb, ka) in enumerate(stacks):
            acc = _gadget_mac(mesh, _gathered(mesh, full_r, lins, j), kb, ka, params, level,
                              t_qp)
            down = _ks_finish(mesh, acc, params, level, ks, t_q, t_qp, n2, eval_out=True)
            c0g = _gathered(mesh, full_c0, lins, j)
            out0 = [[_e3(add_mod(g, _flat(d[0]), t_q.col(dev)), n2)
                     for g, d, dev in zip(*cells)]
                    for cells in zip(c0g, down, mesh.devices)]
            outs.append((out0, mesh.map(lambda d: d[1], down)))
        return outs

    return run, prepare


def make_sharded_rotation(params: CKKSParams, level: int, mesh: FheMesh, steps: int):
    """The sharded rotate-by-`steps` (automorphism + key switch).

    Returns (run, prepare): prepare(galois_key) builds the bundle;
    run(c0, c1, bundle) on eval3d grids. Limb-equal to ct_rotate.
    """
    return _make_sharded_galois(params, level, mesh, gckks.galois_exponent(steps, params.n))


def make_sharded_conjugation(params: CKKSParams, level: int, mesh: FheMesh):
    """Sharded complex conjugation (the 2N-1 automorphism + key switch)."""
    return _make_sharded_galois(params, level, mesh, 2 * params.n - 1)


@functools.lru_cache(maxsize=None)
def _make_sharded_galois(params: CKKSParams, level: int, mesh: FheMesh, g: int):
    n_limb = mesh.shape["limb"]
    n1, n2 = fourstep_split(params.n)
    t_q, t_qp = _tables(params, mesh, range(level), qp_indices(params, level))
    # the identity (g = 1, the encapsulation key switch) moves nothing
    route = None if g == 1 else _route_blocks(g, n1, n2, mesh)

    def prepare(gk: DeviceKSKey):
        return make_sharded_ks(params, level, gk, n_limb, mesh=mesh)

    def run(c0, c1, bundle):
        ks, gmax = bundle
        if route is not None:  # 1x-traffic routed automorphism (v2)
            c0, c1 = _permute_body_v2(mesh, c0, route), _permute_body_v2(mesh, c1, route)
        ks01 = _keyswitch_body(mesh, c1, params, t_q, t_qp, ks, level, gmax)
        out0 = [[_e3(add_mod(_flat(x), _flat(k[0]), t_q.col(dev)), n2)
                 for x, k, dev in zip(*cells)] for cells in zip(c0, ks01, mesh.devices)]
        return out0, mesh.map(lambda k: k[1], ks01)

    return run, prepare
