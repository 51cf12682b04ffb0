"""The BFV backends: exact integer slots, scale-invariant.

Counterpart of gpufhe_tpu/ciphertext/bfv_backend.py: `BFVDeviceBackend` on
ciphertext/bfv.py and `BFVGoldenBackend` on the numpy golden model
(golden/bfv.py), the oracle. linalg.py's op surface with exact semantics mod
t, the scale-invariant counterpart of ciphertext/bgv_backend.py. There is
no pt_factor (Delta = floor(Q/t) is local to the level), and `rescale` is
BFV's modulus reduction (ct_mod_reduce), which drops a limb and keeps the
plaintext. Slots are in BGV's orbit order. Every method equals the
reference's limb for limb.
"""

from __future__ import annotations

from gpufhe_tpu_torch.ciphertext import bfv as dbfv
from gpufhe_tpu_torch.ciphertext.bgv_backend import _orbit_to_raw
from gpufhe_tpu_torch.golden import bfv as gbfv
from gpufhe_tpu_torch.params.params import CKKSParams


class BFVGoldenBackend:
    """linalg's op surface over the golden BFV pipeline (golden/bfv.py): the
    oracle, on a chest of canonical keys."""

    def __init__(self, params: CKKSParams, chest):
        self.params = params
        self.chest = chest
        self.rings = gbfv.slot_orbit_rings(params)
        self.t = params.plain_modulus

    def encode_slots(self, d, scale, level: int):
        return gbfv.encode(_orbit_to_raw(d, self.rings, self.t, self.params.n), self.params)

    def mul_plain(self, ct, pt_coeff):
        return gbfv.ct_mul_plain(ct, pt_coeff, self.params)

    def add(self, a, b):
        return gbfv.ct_add(a, b, self.params)

    def sub(self, a, b):
        return gbfv.ct_sub(a, b, self.params)

    def mul(self, a, b):
        return gbfv.ct_mul(a, b, self.params, self.chest.rlk)

    def rotate(self, ct, steps: int):
        return gbfv.ct_rotate(ct, steps, self.params, self.chest.galois[steps][0])

    def rotate_hoisted(self, ct, steps_list):
        gks = {s: self.chest.galois[s][0] for s in steps_list}
        return dict(zip(steps_list, gbfv.ct_rotate_hoisted(ct, steps_list, self.params, gks)))

    def rescale(self, ct):
        """BFV's level-consuming step: modulus reduction (plaintext intact)."""
        return gbfv.ct_mod_reduce(ct, self.params)

    def add_plain(self, ct, d):
        raw = _orbit_to_raw(d, self.rings, self.t, self.params.n)
        return gbfv.ct_add_plain(ct, gbfv.encode(raw, self.params), self.params)

    def level(self, ct):
        return ct.level

    def decrypt_decode(self, ct):
        """-> int64[2, N/2] orbit-ordered slot rings."""
        return gbfv.decrypt_decode(ct, self.params, self.chest.sk)[self.rings]


class BFVDeviceBackend:
    """linalg's op surface over ciphertext/bfv.py, on ctx's device."""

    def __init__(self, params: CKKSParams, ctx, chest):
        self.params = params
        self.ctx = ctx
        self.chest = chest
        self.rings = gbfv.slot_orbit_rings(params)
        self.t = params.plain_modulus

    def encode_slots(self, d, scale, level: int):
        raw = _orbit_to_raw(d, self.rings, self.t, self.params.n)
        return dbfv.plaintext_to_device(gbfv.encode(raw, self.params), self.params, self.ctx,
                                        level)

    def mul_plain(self, ct, pt_mont):
        return dbfv.ct_mul_plain(ct, pt_mont, self.ctx)

    def add(self, a, b):
        return dbfv.ct_add(a, b, self.ctx)

    def sub(self, a, b):
        return dbfv.ct_sub(a, b, self.ctx)

    def mul(self, a, b):
        return dbfv.ct_mul(a, b, self.params, self.ctx, self.chest.device_rlk)

    def rotate(self, ct, steps: int):
        return dbfv.ct_rotate(ct, steps, self.params, self.ctx, self.chest.galois_key(steps))

    def rotate_hoisted(self, ct, steps_list):
        gks = {s: self.chest.galois_key(s) for s in steps_list}
        return dict(zip(steps_list,
                        dbfv.ct_rotate_hoisted(ct, steps_list, self.params, self.ctx, gks)))

    def rescale(self, ct):
        """BFV's level-consuming step: modulus reduction (plaintext intact)."""
        return dbfv.ct_mod_reduce(ct, self.params, self.ctx)

    def add_plain(self, ct, d):
        raw = _orbit_to_raw(d, self.rings, self.t, self.params.n)
        return dbfv.ct_add_plain(ct, gbfv.encode(raw, self.params), self.params, self.ctx)

    def level(self, ct):
        return ct.level

    def decrypt_decode(self, ct):
        """-> int64[2, N/2] orbit-ordered slot rings."""
        return dbfv.decrypt_decode(ct, self.params, self.chest.device_sk, self.ctx)[self.rings]
