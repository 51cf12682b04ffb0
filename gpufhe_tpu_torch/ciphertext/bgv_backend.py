"""The BGV backends: exact integer slots for the linear-algebra layer.

Counterpart of gpufhe_tpu/ciphertext/bgv_backend.py: `BGVDeviceBackend` on
ciphertext/bgv.py, and `BGVGoldenBackend` on the numpy golden model
(golden/bgv.py), the oracle. They offer the part of the backend surface that
linalg.py reads (encode_slots, mul_plain, add, sub, mul, rotate,
rotate_hoisted, rescale, add_plain, level, decrypt_decode) with exact
semantics mod t, so `linalg.matmul_plain(be, ct, A)` computes A @ v mod t
without error. Every method equals the reference's limb for limb.

Slot model: the N integer slots form two rings of N/2 under the rotation
automorphism (golden/bgv.py slot_orbit_rings). The backends work in orbit
order, where `rotate(ct, s)` left-rotates both rings by s, as linalg's BSGS
decomposition assumes; a matrix-vector product acts on both rings at once.
`params.slots` (N/2) is the ring length. The scale arguments of
encode_slots are linalg's and ignored.
"""

from __future__ import annotations

import numpy as np
import torch

from gpufhe_tpu_torch.ciphertext import bgv as dbgv
from gpufhe_tpu_torch.golden import bgv as gbgv
from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.ops.modops import add_mod
from gpufhe_tpu_torch.ops.ntt import ntt_fwd
from gpufhe_tpu_torch.params.params import CKKSParams


def _orbit_to_raw(d: np.ndarray, rings: np.ndarray, t: int, n: int) -> np.ndarray:
    """Orbit-ordered values int[N/2] (the same on both rings) or int[2, N/2]
    -> the raw slot vector int64[N] mod t."""
    d = np.asarray(d, dtype=np.int64) % t
    raw = np.empty(n, dtype=np.int64)
    raw[rings[0]] = d if d.ndim == 1 else d[0]
    raw[rings[1]] = d if d.ndim == 1 else d[1]
    return raw


class BGVGoldenBackend:
    """linalg's op surface over the golden BGV pipeline (golden/bgv.py): the
    oracle. `chest` holds canonical keys (the port's chest from
    ciphertext/bgv.py keygen, or the reference's)."""

    def __init__(self, params: CKKSParams, chest):
        self.params = params
        self.chest = chest
        self.rings = gbgv.slot_orbit_rings(params)
        self.t = params.plain_modulus

    def encode_slots(self, d, scale, level: int):
        return gbgv.encode(_orbit_to_raw(d, self.rings, self.t, self.params.n), self.params)

    def mul_plain(self, ct, pt_coeff):
        return gbgv.ct_mul_plain(ct, pt_coeff, self.params)

    def add(self, a, b):
        return gbgv.ct_add(a, b, self.params)

    def sub(self, a, b):
        return gbgv.ct_sub(a, b, self.params)

    def mul(self, a, b):
        return gbgv.ct_mul(a, b, self.params, self.chest.rlk)

    def rotate(self, ct, steps: int):
        return gbgv.ct_rotate(ct, steps, self.params, self.chest.galois[steps][0])

    def rotate_hoisted(self, ct, steps_list):
        gks = {s: self.chest.galois[s][0] for s in steps_list}
        return dict(zip(steps_list, gbgv.ct_rotate_hoisted(ct, steps_list, self.params, gks)))

    def rescale(self, ct):
        """BGV's level-consuming step is ModSwitch (exact, t-corrected)."""
        return gbgv.ct_modswitch(ct, self.params)

    def add_plain(self, ct, d):
        """Add integer slots d (orbit order) to the message, exactly (the
        plaintext times pt_factor^-1 mod t, as BGVDeviceBackend's)."""
        raw = _orbit_to_raw(d, self.rings, self.t, self.params.n)
        pt = gbgv.encode(raw * pow(int(ct.pt_factor), -1, self.t) % self.t, self.params)
        primes = ct.primes(self.params)
        pt_ntt = gckks.ntt_limbs(np.stack([pt % q for q in primes]), self.params, primes)
        c = list(ct.c)
        c[0] = gckks.poly_add(c[0], pt_ntt, primes)
        return gbgv.BGVCiphertext(c, ct.level, ct.pt_factor)

    def level(self, ct):
        return ct.level

    def decrypt_decode(self, ct):
        """-> int64[2, N/2] orbit-ordered slot rings."""
        return gbgv.decrypt_decode(ct, self.params, self.chest.sk)[self.rings]


class BGVDeviceBackend:
    """linalg's op surface over ciphertext/bgv.py, on ctx's device."""

    def __init__(self, params: CKKSParams, ctx, chest):
        self.params = params
        self.ctx = ctx
        self.chest = chest
        self.rings = gbgv.slot_orbit_rings(params)
        self.t = params.plain_modulus

    def encode_slots(self, d, scale, level: int):
        raw = _orbit_to_raw(d, self.rings, self.t, self.params.n)
        return dbgv.plaintext_to_device(gbgv.encode(raw, self.params), self.params, self.ctx,
                                        level)

    def mul_plain(self, ct, pt_mont):
        return dbgv.ct_mul_plain(ct, pt_mont, self.ctx)

    def add(self, a, b):
        return dbgv.ct_add(a, b, self.ctx)

    def sub(self, a, b):
        return dbgv.ct_sub(a, b, self.ctx)

    def mul(self, a, b):
        return dbgv.ct_mul(a, b, self.params, self.ctx, self.chest.device_rlk)

    def rotate(self, ct, steps: int):
        return dbgv.ct_rotate(ct, steps, self.params, self.ctx, self.chest.galois_key(steps))

    def rotate_hoisted(self, ct, steps_list):
        gks = {s: self.chest.galois_key(s) for s in steps_list}
        return dict(zip(steps_list,
                        dbgv.ct_rotate_hoisted(ct, steps_list, self.params, self.ctx, gks)))

    def rescale(self, ct):
        """BGV's level-consuming step is ModSwitch (exact, t-corrected)."""
        return dbgv.ct_modswitch(ct, self.params, self.ctx)

    def add_plain(self, ct, d):
        """Add integer slots d (orbit order) to the message, exactly: the
        plaintext is multiplied by pt_factor^-1 mod t first, since the
        ciphertext holds the message divided by pt_factor."""
        raw = _orbit_to_raw(d, self.rings, self.t, self.params.n)
        corr = raw * pow(int(ct.pt_factor), -1, self.t) % self.t
        pt = gbgv.encode(corr, self.params)
        q_col = np.asarray(self.params.q_primes[: ct.level], dtype=np.int64)[:, None]
        m = torch.from_numpy(pt[None, :] % q_col).to(self.ctx.device)
        rows = range(ct.level)
        c0 = add_mod(ct.c[0], ntt_fwd(m, self.ctx, limbs=rows), self.ctx.col("q", rows))
        return dbgv.BGVCiphertext([c0] + list(ct.c[1:]), ct.level, ct.pt_factor)

    def level(self, ct):
        return ct.level

    def decrypt_decode(self, ct):
        """-> int64[2, N/2] orbit-ordered slot rings."""
        return dbgv.decrypt_decode(ct, self.params, self.chest.device_sk, self.ctx)[self.rings]
