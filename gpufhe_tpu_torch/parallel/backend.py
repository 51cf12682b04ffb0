"""ShardedBackend: the DeviceBackend op surface over mesh-sharded ciphertexts.

Counterpart of gpufhe_tpu/parallel/backend.py. Every key-switching op is a
program of parallel/sharded.py over the ('limb', 'coeff') mesh; because
bootstrap.py, linalg.py, fftboot.py and polyeval.py are written against the
backend surface, composing them on this backend gives the SHARDED
bootstrap with no change to the orchestration code.

A ShardedCiphertext holds eval3d component grids (int64[K, n1/C, n2]
blocks per shard, replicated over limb); key bundles and encoded constants
are cached per (level, key). A multi-step rotate_hoisted runs the
shared-hoist fan program (one ModUp + NTT + all_gather for the whole fan);
a single step runs the routed rotation program. Pointwise ops run on each
shard with its device's tables; plaintext products are K4 launches of one
term, as on one device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from gpufhe_tpu_torch.ciphertext import ct as dct
from gpufhe_tpu_torch.encoding import encoder
from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.ops.context import fourstep_split, make_context
from gpufhe_tpu_torch.ops.modops import add_mod, from_mont, sub_mod, to_mont
from gpufhe_tpu_torch.ops.ntt import ntt_fwd
from gpufhe_tpu_torch.params.params import CKKSParams
from gpufhe_tpu_torch.parallel import sharded as sh
from gpufhe_tpu_torch.parallel.mesh import FheMesh
from gpufhe_tpu_torch.primitives.keyswitch import qp_indices
from gpufhe_tpu_torch.primitives.rns import make_ks_context, rescale


@dataclasses.dataclass
class ShardedCiphertext:
    c: list  # eval3d component grids: int64[K, n1/C, n2] blocks per shard
    level: int
    scale: float


class ShardedBackend:
    """Duck-types ciphertext/backend.py's DeviceBackend over a device mesh.

    Host-side work (encoding, to_single and decryption) uses the context on
    the mesh's first device."""

    def __init__(self, params: CKKSParams, mesh: FheMesh, chest):
        self.params = params
        self.mesh = mesh
        self.chest = chest
        self.ctx = make_context(params, device=mesh.devices[0][0])
        self.n1, self.n2 = fourstep_split(params.n)
        self._n_limb = mesh.shape["limb"]
        self._t_full = sh.full_ntt_tables(params, mesh=mesh)
        # uniform-constant encode caches, as DeviceBackend's: the polynomial
        # evaluators re-encode the same constants every call
        self._const_cache = {}  # (value, scale, level) -> sharded eval3d pt
        self._addp_cache = {}  # (value, scale, level) -> canonical eval3d pt
        self.encode_misses = 0  # host encodes actually performed

    # -- plumbing -----------------------------------------------------------
    def from_single(self, ct) -> ShardedCiphertext:
        return ShardedCiphertext(
            [sh.shard_ct_component(c, self.params, self.mesh) for c in ct.c],
            ct.level, ct.scale,
        )

    def to_single(self, ct: ShardedCiphertext):
        return dct.Ciphertext(
            [sh.unshard_ct_component(c).to(self.ctx.device) for c in ct.c],
            ct.level, ct.scale,
        )

    def level(self, ct):
        return ct.level

    def drop_to_level(self, ct, level: int):
        assert level <= ct.level
        return ShardedCiphertext([self.mesh.map(lambda b: b[:level], c) for c in ct.c], level,
                                 ct.scale)

    def _align(self, a, b):
        lvl = min(a.level, b.level)
        return self.drop_to_level(a, lvl), self.drop_to_level(b, lvl)

    def _q(self, dev, level):
        return sh.gather_ntt_tables(self._t_full, range(level)).col(dev)

    def _pointwise(self, fn, level, *grids):
        """fn(*flattened blocks, q) on each shard, back to eval3d blocks."""
        return [[sh._e3(fn(*(sh._flat(b) for b in blocks), self._q(dev, level)), self.n2)
                 for dev, *blocks in zip(devs, *rows)]
                for devs, *rows in zip(self.mesh.devices, *grids)]

    # -- pointwise ops (no communication) ------------------------------------
    def add(self, a, b):
        a, b = self._align(a, b)
        return ShardedCiphertext(
            [self._pointwise(add_mod, a.level, x, y) for x, y in zip(a.c, b.c)],
            a.level, a.scale)

    def sub(self, a, b):
        a, b = self._align(a, b)
        return ShardedCiphertext(
            [self._pointwise(sub_mod, a.level, x, y) for x, y in zip(a.c, b.c)],
            a.level, a.scale)

    @staticmethod
    def _uniform_key(z, scale: float, level: int):
        """Cache key for uniform-constant vectors, else None."""
        z = np.asarray(z)
        if z.ndim == 0 or (z.ndim == 1 and z.size and (z == z.flat[0]).all()):
            return (complex(z.flat[0] if z.ndim else z), float(scale), level)
        return None

    def _encode_e3(self, z, scale, level):
        """Host encode -> NTT-domain Montgomery eval3d grid. Uniform-constant
        vectors are cached keyed on (value, scale, level): steady-state
        bootstrap calls perform ZERO host encodes."""
        key = self._uniform_key(z, scale, level)
        if key is not None:
            hit = self._const_cache.get(key)
            if hit is not None:
                return hit
            z = np.broadcast_to(np.complex128(key[0]), (self.params.slots,))
        self.encode_misses += 1
        pt = gckks.encode(np.asarray(z, dtype=np.complex128), scale,
                          self.params.q_primes[:level], self.params.n)
        nat = encoder.plaintext_to_device(pt, self.params, self.ctx)  # [level, N] natural
        out = sh.shard_ct_component(nat, self.params, self.mesh)
        if key is not None:
            self._const_cache[key] = out
        return out

    def encode_slots(self, z, scale: float, level: int):
        return self._encode_e3(z, scale, level), scale

    def mul_plain(self, ct, pt_handle):
        pt, scale = pt_handle

        def one(dev, pt_b, *comps):
            ctx = self._t_full.ctx(dev)
            return dct.mul_plain_core([sh._flat(c) for c in comps],
                                      sh._flat(pt_b[:ct.level]).contiguous(), ctx, ct.level)

        prods = [[one(dev, p, *comps) for dev, p, *comps in zip(devs, prow, *rows)]
                 for devs, prow, *rows in zip(self.mesh.devices, pt, *ct.c)]
        comps = [[[sh._e3(cell[k], self.n2) for cell in row] for row in prods]
                 for k in range(len(ct.c))]
        return ShardedCiphertext(comps, ct.level, ct.scale * scale)

    def add_plain(self, ct, z):
        key = self._uniform_key(z, float(ct.scale), ct.level)
        pt = self._addp_cache.get(key) if key is not None else None
        if pt is None:
            pt_mont = self._encode_e3(
                np.broadcast_to(np.asarray(z, dtype=np.complex128), (self.params.slots,)),
                ct.scale, ct.level)

            def canon(dev, b):
                t = sh.gather_ntt_tables(self._t_full, range(ct.level))
                return sh._e3(from_mont(sh._flat(b), t.col(dev), t.col(dev, "qinv_neg")),
                              self.n2)

            pt = [[canon(dev, b) for dev, b in zip(devs, row)]
                  for devs, row in zip(self.mesh.devices, pt_mont)]
            if key is not None:
                self._addp_cache[key] = pt
        c = list(ct.c)
        c[0] = self._pointwise(add_mod, ct.level, c[0], pt)
        return ShardedCiphertext(c, ct.level, ct.scale)

    # -- mesh programs ------------------------------------------------------
    def mul(self, a, b):
        a, b = self._align(a, b)
        run, _ = sh.make_sharded_mult(self.params, a.level, self.mesh)
        c0, c1 = run(a.c[0], a.c[1], b.c[0], b.c[1], self._mult_bundle(a.level))
        # make_sharded_mult rescales ONCE ([K] -> [K-1]); at dw
        # (scale_words = 2) chain the remaining rescale like DeviceBackend.mul's
        # fused double rescale (the NTT round trip between them cancels)
        lvl = a.level - 1
        scale = a.scale * b.scale / self.params.q_primes[a.level - 1]
        cs = [c0, c1]
        for _ in range(self.params.scale_words - 1):
            f = self._rescale_fn(lvl)
            cs = [f(c) for c in cs]
            scale /= self.params.q_primes[lvl - 1]
            lvl -= 1
        return ShardedCiphertext(cs, lvl, scale)

    @functools.lru_cache(maxsize=None)
    def _mult_bundle(self, level):
        _, prepare = sh.make_sharded_mult(self.params, level, self.mesh)
        return prepare(self.chest.device_rlk)

    @functools.lru_cache(maxsize=None)
    def _rescale_fn(self, level):
        """One limb dropped from a component grid: iNTT, rescale, NTT."""
        params, mesh, k = self.params, self.mesh, level
        t_q = sh.gather_ntt_tables(self._t_full, range(k))
        t_qm1 = sh.gather_ntt_tables(self._t_full, range(k - 1))

        def body(comp):
            coeff = sh.ntt_inv_body(comp, t_q)
            down = [[sh._e3(rescale(sh._flat(x), params, k, t_q.ctx(dev),
                                    make_ks_context(params, k, device=dev)), self.n2)
                     for x, dev in zip(row, devs)] for row, devs in zip(coeff, mesh.devices)]
            return sh.ntt_fwd_body(down, t_qm1)

        return body

    def rescale(self, ct):
        # scale_words chained single-limb rescales (a dw rescale divides by
        # the limb PAIR)
        for _ in range(self.params.scale_words):
            f = self._rescale_fn(ct.level)
            ct = ShardedCiphertext([f(c) for c in ct.c], ct.level - 1,
                                   ct.scale / self.params.q_primes[ct.level - 1])
        return ct

    def rescale_prod(self, level: int) -> float:
        """Product of the primes a rescale from `level` divides by."""
        w = self.params.scale_words
        out = 1.0
        for i in range(w):
            out *= self.params.q_primes[level - 1 - i]
        return out

    def _rotation_run(self, level, steps):
        return sh.make_sharded_rotation(self.params, level, self.mesh, steps)

    @functools.lru_cache(maxsize=None)
    def _rot_bundle(self, level, steps):
        _, prepare = sh.make_sharded_rotation(self.params, level, self.mesh, steps)
        key = self.chest.conj_key() if steps == "conj" else self.chest.galois_key(steps)
        return prepare(key)

    def _lins(self, steps_tuple):
        return sh._lin_blocks(np.stack([
            sh._perm_lin_e3(gckks.galois_exponent(s, self.params.n), self.n1, self.n2)
            for s in steps_tuple]), self.mesh)

    @functools.lru_cache(maxsize=None)
    def _hoisted_fan_plan(self, level, steps_tuple):
        run, prepare = sh.make_sharded_hoisted_fan(self.params, level, self.mesh,
                                                   len(steps_tuple))
        bundle = prepare([self.chest.galois_key(s) for s in steps_tuple])
        return run, self._lins(steps_tuple), bundle

    def rotate_hoisted(self, ct, steps_list):
        steps_tuple = tuple(steps_list)
        if len(steps_tuple) == 1:
            steps = steps_tuple[0]
            run, _ = self._rotation_run(ct.level, steps)
            c0, c1 = run(ct.c[0], ct.c[1], self._rot_bundle(ct.level, steps))
            return {steps: ShardedCiphertext([c0, c1], ct.level, ct.scale)}
        # shared-hoist fan: one ModUp + NTT + all_gather for the whole list
        run, lins, bundle = self._hoisted_fan_plan(ct.level, steps_tuple)
        outs = run(ct.c[0], ct.c[1], lins, bundle)
        return {s: ShardedCiphertext([c0, c1], ct.level, ct.scale)
                for s, (c0, c1) in zip(steps_tuple, outs)}

    def conjugate(self, ct):
        run, _ = sh.make_sharded_conjugation(self.params, ct.level, self.mesh)
        c0, c1 = run(ct.c[0], ct.c[1], self._conj_bundle(ct.level))
        return ShardedCiphertext([c0, c1], ct.level, ct.scale)

    @functools.lru_cache(maxsize=None)
    def _conj_bundle(self, level):
        _, prepare = sh.make_sharded_conjugation(self.params, level, self.mesh)
        return prepare(self.chest.conj_key())

    # -- fused diagonal-fan stages (the mesh mirror of ct_diag_fan) ---------
    def _encode_qp_e3(self, z, scale, level):
        """Host encode over the QP basis -> Montgomery NTT-domain eval3d grid."""
        self.encode_misses += 1
        qp_primes = self.params.q_primes[:level] + self.params.p_primes
        pt = gckks.encode(np.asarray(z, dtype=np.complex128), scale, qp_primes, self.params.n)
        qp = qp_indices(self.params, level)
        c = self.ctx
        x_ntt = ntt_fwd(torch.from_numpy(pt).to(c.device), c, limbs=qp)
        mont = to_mont(x_ntt, c.col("q", qp), c.col("qinv_neg", qp), c.col("r2", qp))
        return sh.shard_ct_component(mont, self.params, self.mesh)

    def make_fan_plan(self, diag_sets, level: int, scale: float | None = None):
        scale = self.params.scale if scale is None else scale
        offsets = tuple(sorted({r for d in diag_sets for r in d if r != 0}))
        zeros = np.zeros(self.params.slots, dtype=np.complex128)
        pt_stacks, pt0s, pt0_mask = [], [], []
        for dset in diag_sets:
            assert any(r != 0 for r in dset), "each set needs a nonzero offset"
            encoded = [self._encode_qp_e3(dset.get(r, zeros), scale, level) for r in offsets]
            pt_stacks.append(self.mesh.map(lambda *b: torch.stack(b), *encoded))
            has0 = 0 in dset
            pt0_mask.append(has0)
            pt0s.append(self._encode_qp_e3(dset[0], scale, level) if has0 else None)
        run, prepare = sh.make_sharded_fan(self.params, level, self.mesh, len(offsets),
                                           len(diag_sets), tuple(pt0_mask))
        gk_list = [self.chest.galois_key(s) for s in offsets]
        bundle = prepare(gk_list, gk_list[0])
        return (level, scale, run, self._lins(offsets), bundle, tuple(pt_stacks), tuple(pt0s))

    def apply_fan(self, ct, plan):
        level, pt_scale, run, lins, bundle, pt_stacks, pt0s = plan
        assert ct.level == level, (ct.level, level)
        outs = run(ct.c[0], ct.c[1], lins, bundle, pt_stacks, pt0s)
        scale = ct.scale * pt_scale
        lvl = level
        for _ in range(self.params.scale_words):
            scale = scale / self.params.q_primes[lvl - 1]
            lvl -= 1
        return [ShardedCiphertext([c0, c1], lvl, scale) for c0, c1 in outs]

    def key_switch(self, ct, which: str):
        """Re-encrypt under the encapsulation key `which` ('to_eph' /
        'from_eph'): the sharded Galois program with the identity
        automorphism (g = 1): c0 + ks0(c1), ks1."""
        run, _ = sh._make_sharded_galois(self.params, ct.level, self.mesh, 1)
        c0, c1 = run(ct.c[0], ct.c[1], self._eph_bundle(ct.level, which))
        return ShardedCiphertext([c0, c1], ct.level, ct.scale)

    @functools.lru_cache(maxsize=None)
    def _eph_bundle(self, level, which: str):
        ksk = self.chest.eph[which][1]
        return sh.make_sharded_ks(self.params, level, ksk, self._n_limb, mesh=self.mesh)

    def mod_raise(self, ct):
        if self.params.scale_words == 2:
            assert ct.level == 2
            f = self._mod_raise2_fn()
        else:
            assert ct.level == 1
            f = self._mod_raise_fn()
        return ShardedCiphertext([f(c) for c in ct.c], self.params.num_limbs, ct.scale)

    def _lift_fn(self, low: int, lift):
        """iNTT of the `low` lowest limbs, lift(x [low, M], ctx) -> the full
        chain [L, M] on each shard, NTT over the full chain."""
        mesh, level = self.mesh, self.params.num_limbs
        t_low = sh.gather_ntt_tables(self._t_full, range(low))
        t_all = sh.gather_ntt_tables(self._t_full, range(level))

        def body(comp):
            coeff = sh.ntt_inv_body(comp, t_low)
            up = [[sh._e3(lift(sh._flat(x), t_all.ctx(dev)), self.n2)
                   for x, dev in zip(row, devs)] for row, devs in zip(coeff, mesh.devices)]
            return sh.ntt_fwd_body(up, t_all)

        return body

    @functools.lru_cache(maxsize=None)
    def _mod_raise2_fn(self):
        """Sharded double-word ModRaise: ct_mod_raise2's centred CRT lift
        from Q0 = q0 q1 into the full chain, on each shard's block."""
        p = self.params
        level = p.num_limbs
        q0, q1 = p.q_primes[0], p.q_primes[1]
        big = q0 * q1
        half1, rem = divmod(big // 2, q0)

        def lift(x, ctx):
            q = ctx.col("q", range(level))
            q0_mod = dct._const_col(ctx, [q0 % r for r in p.q_primes])
            big_mod = dct._const_col(ctx, [big % r for r in p.q_primes])
            x0, x1 = x[0:1], x[1:2]
            t = torch.remainder(sub_mod(x1, torch.remainder(x0, q1), q1) * pow(q0, -1, q1), q1)
            negative = (t > half1) | ((t == half1) & (x0 > rem))
            v = add_mod(torch.remainder(x0, q),
                        torch.remainder(torch.remainder(t, q) * q0_mod, q), q)
            return torch.where(negative, sub_mod(v, big_mod, q), v)

        return self._lift_fn(2, lift)

    @functools.lru_cache(maxsize=None)
    def _mod_raise_fn(self):
        """Sharded single-word ModRaise (ct_mod_raise's centred lift mod q0)."""
        p = self.params
        level, q0 = p.num_limbs, p.q_primes[0]

        def lift(x, ctx):
            q = ctx.col("q", range(level))
            q0_mod = dct._const_col(ctx, [q0 % r for r in p.q_primes])
            r = torch.remainder(x, q)
            return torch.where(x > q0 // 2, sub_mod(r, q0_mod, q), r)

        return self._lift_fn(1, lift)

    def decrypt_decode(self, ct):
        return dct.decrypt_decode(self.to_single(ct), self.params, self.chest.device_sk,
                                  self.ctx)
