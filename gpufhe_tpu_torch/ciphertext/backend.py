"""Uniform op surface over the port's ciphertext operations.

Counterpart of gpufhe_tpu/ciphertext/backend.py: `DeviceBackend` (the same
name and methods, on ciphertext/ct.py), the fan plan `FanPlan`, the
golden model's backend `GoldenBackend` and its `GoldenFanPlan` (on
golden/ckks.py, numpy on the host: the oracle any composition on the card
is held against), and the data-free level/scale simulator `GhostBackend`.
Bootstrapping and the homomorphic linear algebra (linalg.py, fftboot.py,
polyeval.py, bootstrap.py) are written once against this surface. Every
method equals the reference backends' limb for limb, so any composition
does too. The reference's `FusedPipeline` (XLA program fusion) is not
ported: PyTorch runs eagerly.

Scale management: adds require (approximately) matching scales; encoded
plaintexts are generated at exactly the scale the consuming op needs. The
float bookkeeping copies the reference's expressions in their order: at
Delta = 2^56 an encode rounds values above 2^53, so a reordered product
would change an encoded limb.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gpufhe_tpu_torch.ciphertext import ct as dct
from gpufhe_tpu_torch.encoding import encoder
from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.ops.modops import add_mod, to_mont
from gpufhe_tpu_torch.ops.ntt import ntt_fwd
from gpufhe_tpu_torch.params.params import CKKSParams
from gpufhe_tpu_torch.primitives.keyswitch import qp_indices


class FanPlan(NamedTuple):
    """Precomputed device material for one fused diagonal-fan stage."""

    level: int
    pt_scale: float
    offsets: tuple  # sorted nonzero rotation steps
    pt_stacks: tuple  # per set: int64[R, K+alpha, N] Montgomery NTT QP-basis
    pt0s: tuple  # per set: int64[K+alpha, N] or None (zero-offset diagonal)


class GoldenFanPlan(NamedTuple):
    level: int
    pt_scale: float
    sets: tuple  # per set: dict offset -> int64[K+alpha, N] NTT QP-basis


def _check_scales(a_scale: float, b_scale: float):
    assert abs(a_scale / b_scale - 1.0) < 1e-2, (
        f"scale mismatch: {a_scale} vs {b_scale}"
    )


# non-uniform vectors whose add_plain encodings a DeviceBackend keeps (the
# oldest goes first): a 784-128-128-10 MLP's three biases at each entry level
_ADDV_KEPT = 16


def _uniform(z: np.ndarray) -> bool:
    return z.ndim == 0 or (z.ndim == 1 and z.size and (z == z.flat[0]).all())


class DeviceBackend:
    """Ops on the port's pipeline (ciphertext/ct.py), on ctx's device."""

    def __init__(self, params: CKKSParams, ctx, chest):
        self.params = params
        self.ctx = ctx
        self.chest = chest
        self._ct = dct
        self._const_cache = {}  # (value, scale, level) -> encoded plaintext
        self._addp_cache = {}  # (value, scale, level) -> NTT-domain plaintext
        self._addv_cache = {}  # (id, scale, level) -> (vector, NTT-domain plaintext)
        self.encode_misses = 0  # host encodes actually performed (cache misses)

    # -- plaintext handling -------------------------------------------------
    def encode_slots(self, z, scale: float, level: int):
        """complex[slots] -> (NTT-domain Montgomery plaintext int64[level, N],
        scale). Uniform-constant vectors are cached: the polynomial
        evaluators re-encode the same constants every call, and each encode
        is a host FFT and an upload."""
        z = np.asarray(z)
        if _uniform(z):
            key = (complex(z.flat[0] if z.ndim else z), float(scale), level)
            hit = self._const_cache.get(key)
            if hit is None:
                zz = np.broadcast_to(np.complex128(key[0]), (self.params.slots,))
                hit = self._const_cache[key] = self._encode_uncached(zz, scale, level)
            return hit
        return self._encode_uncached(z, scale, level)

    def _encode_uncached(self, z, scale: float, level: int):
        self.encode_misses += 1
        pt = gckks.encode(
            np.asarray(z, dtype=np.complex128),
            scale,
            self.params.q_primes[:level],
            self.params.n,
        )
        return encoder.plaintext_to_device(pt, self.params, self.ctx), scale

    def mul_plain(self, ct, pt_handle):
        pt, scale = pt_handle
        return self._ct.ct_mul_plain(ct, pt, scale, self.ctx)

    def add_plain(self, ct, z):
        """Add a complex constant vector (encoded at ct.scale) to the message.
        Uniform constants are cached keyed on (value, scale, level)."""
        pt_ntt = self._addp_pt(z, float(ct.scale), ct.level)
        c = list(ct.c)
        c[0] = add_mod(c[0], pt_ntt, self.ctx.col("q", range(ct.level)))
        return self._ct.Ciphertext(c, ct.level, ct.scale)

    def _addp_pt(self, z, scale: float, level: int):
        """NTT-domain (non-Montgomery) plaintext, cached for a uniform constant
        and, for the last few vectors, by the array (a model's biases): a hit
        holds a copy of the vector it encoded and is taken only while the
        array still equals it."""
        z = np.asarray(z)
        key = None
        if _uniform(z):
            key = (complex(z.flat[0] if z.ndim else z), scale, level)
            hit = self._addp_cache.get(key)
            if hit is not None:
                return hit
        else:
            vkey = (id(z), scale, level)
            hit = self._addv_cache.get(vkey)
            if hit is not None and np.array_equal(hit[0], z):
                return hit[1]
        self.encode_misses += 1
        pt = gckks.encode(
            np.broadcast_to(np.asarray(z, dtype=np.complex128), (self.params.slots,)),
            scale,
            self.params.q_primes[:level],
            self.params.n,
        )
        pt_ntt = ntt_fwd(torch.from_numpy(pt).to(self.ctx.device), self.ctx,
                         limbs=range(level))
        if key is not None:
            self._addp_cache[key] = pt_ntt
        else:
            if len(self._addv_cache) >= _ADDV_KEPT:
                self._addv_cache.pop(next(iter(self._addv_cache)))
            self._addv_cache[vkey] = (z.copy(), pt_ntt)
        return pt_ntt

    def plain_mac(self, terms, const=None):
        """sum_i pt_i * ct_i -> rescale -> (+ const) in one ct_plain_mac.

        terms: list of (ct, pt_handle) at one common level with (approx)
        matching product scales. Equal to the generic composition (mul_plain
        per term, add, rescale, add_plain)."""
        cts = [t[0] for t in terms]
        pts = [t[1][0] for t in terms]
        out_scale = float(cts[0].scale) * float(terms[0][1][1])
        for ct, (pt, s) in terms[1:]:
            _check_scales(float(ct.scale) * float(s), out_scale)
        const_ntt = None
        if const is not None:
            level, words = cts[0].level, self.params.scale_words
            const_ntt = self._addp_pt(
                const, self._ct._rescaled_scale(out_scale, self.params, level, words),
                level - words)
        return self._ct.ct_plain_mac(
            cts, pts, const_ntt, self.params, self.ctx, out_scale
        )

    # -- fused diagonal-fan stages (fftboot.DiagPlan hot path) --------------
    def _encode_qp(self, z, scale: float, level: int):
        """complex[slots] -> Montgomery NTT-domain int64[K+alpha, N] over the
        active QP basis (the q-prefix rows double as the Q-basis plaintext)."""
        self.encode_misses += 1
        qp_primes = self.params.q_primes[:level] + self.params.p_primes
        pt = gckks.encode(
            np.asarray(z, dtype=np.complex128), scale, qp_primes, self.params.n
        )
        qp = qp_indices(self.params, level)
        x_ntt = ntt_fwd(torch.from_numpy(pt).to(self.ctx.device), self.ctx, limbs=qp)
        c = self.ctx
        return to_mont(x_ntt, c.col("q", qp), c.col("qinv_neg", qp), c.col("r2", qp))

    def make_fan_plan(self, diag_sets, level: int, scale: float | None = None):
        """Encode the diagonals of a grouped sparse stage for ct_diag_fan.

        diag_sets: list of dicts offset -> complex[slots]. Offsets missing
        from one set but present in another are zero-padded (exact)."""
        scale = self.params.scale if scale is None else scale
        offsets = tuple(sorted({r for d in diag_sets for r in d if r != 0}))
        zeros = np.zeros(self.params.slots, dtype=np.complex128)
        pt_stacks, pt0s = [], []
        for dset in diag_sets:
            assert any(r != 0 for r in dset), "each set needs a nonzero offset"
            pt_stacks.append(
                torch.stack([self._encode_qp(dset.get(r, zeros), scale, level)
                             for r in offsets])
            )
            pt0s.append(
                self._encode_qp(dset[0], scale, level) if 0 in dset else None
            )
        return FanPlan(level, scale, offsets, tuple(pt_stacks), tuple(pt0s))

    def apply_fan(self, ct, plan: FanPlan):
        assert ct.level == plan.level, (ct.level, plan.level)
        gks = {s: self.chest.galois_key(s) for s in plan.offsets}
        return self._ct.ct_diag_fan(
            ct, plan.offsets, plan.pt_stacks, plan.pt0s, plan.pt_scale,
            self.params, self.ctx, gks,
        )

    # -- ciphertext ops (levels auto-aligned by limb truncation) ------------
    def _align(self, a, b):
        lvl = min(a.level, b.level)
        return self.drop_to_level(a, lvl), self.drop_to_level(b, lvl)

    def add(self, a, b):
        _check_scales(a.scale, b.scale)
        a, b = self._align(a, b)
        b = self._ct.Ciphertext(b.c, b.level, a.scale)
        return self._ct.ct_add(a, b, self.ctx)

    def sub(self, a, b):
        _check_scales(a.scale, b.scale)
        a, b = self._align(a, b)
        b = self._ct.Ciphertext(b.c, b.level, a.scale)
        return self._ct.ct_sub(a, b, self.ctx)

    def mul(self, a, b):
        a, b = self._align(a, b)
        return self._ct.ct_mul_full(a, b, self.params, self.ctx, self.chest.device_rlk)

    def mod_raise(self, ct):
        if self.params.scale_words == 2:
            return self._ct.ct_mod_raise2(ct, self.params, self.ctx)
        return self._ct.ct_mod_raise(ct, self.params, self.ctx)

    def rescale(self, ct):
        """Drop scale_words limbs: one transform each way, one drop (ct.py
        rescale_core)."""
        return self._ct._rescale(ct, self.params, self.ctx, self.params.scale_words)

    def rescale_prod(self, level: int) -> float:
        """Product of the primes a rescale from `level` divides by."""
        w = self.params.scale_words
        out = 1.0
        for i in range(w):
            out *= self.params.q_primes[level - 1 - i]
        return out

    def rotate_hoisted(self, ct, steps_list):
        gks = {s: self.chest.galois_key(s) for s in steps_list}
        outs = self._ct.ct_rotate_hoisted(ct, steps_list, self.params, self.ctx, gks)
        return dict(zip(steps_list, outs))

    # -- BSGS inner sums (linalg.BsgsPlan) ------------------------------------
    def plain_group(self, handles, positions):
        """One giant group of a BSGS plan for baby_sums: the encoded
        diagonals (encode_slots handles at one scale and level) stacked into
        one int64[D, K, N], each to multiply the rotation at its position
        (0 the input, i + 1 baby_sums' steps[i]). Returns the group and the
        handles re-pointed into its stack, which then holds the only copy."""
        scale = handles[0][1]
        assert all(h[1] == scale for h in handles), "one scale a group"
        pts = torch.stack([h[0] for h in handles])
        first = positions[0]
        index = None
        if list(positions) != list(range(first, first + len(positions))):
            index = torch.tensor(positions, dtype=torch.int64, device=pts.device)
        group = self._ct.PlainGroup(pts, scale, first, index)
        return group, [(pts[d], scale) for d in range(len(handles))]

    def baby_sums(self, ct, steps, groups):
        """sum_d pt_d * rot_d(ct) for each plain_group, not rescaled: the
        rotations by `steps` hoisted and batched, each group one K4 launch
        (ct.py ct_baby_sums)."""
        gks = {s: self.chest.galois_key(s) for s in steps}
        return self._ct.ct_baby_sums(ct, steps, groups, self.params, self.ctx, gks)

    def conjugate(self, ct):
        return self._ct.ct_conjugate(ct, self.params, self.ctx, self.chest.conj_key())

    def key_switch(self, ct, which: str):
        """Re-encrypt under the encapsulation key `which` ('to_eph' /
        'from_eph')."""
        ksk = self.chest.eph[which][1]
        return self._ct.ct_key_switch(ct, self.params, self.ctx, ksk)

    def drop_to_level(self, ct, level: int):
        """Mod-switch down by truncating RNS limbs (exact, no scaling)."""
        assert level <= ct.level
        return self._ct.Ciphertext([c[:level] for c in ct.c], level, ct.scale)

    def decrypt_decode(self, ct):
        return self._ct.decrypt_decode(ct, self.params, self.chest.device_sk, self.ctx)

    def level(self, ct):
        return ct.level



class GoldenBackend:
    """Ops on the numpy golden pipeline (golden/ckks.py). `chest` is the
    port's KeyChest (keys.keygen) or the reference's: the golden ops read
    its canonical keys on the host."""

    def __init__(self, params: CKKSParams, chest):
        self.params = params
        self.chest = chest

    def encode_slots(self, z, scale: float, level: int):
        primes = self.params.q_primes[:level]
        pt = gckks.encode(np.asarray(z, dtype=np.complex128), scale, primes, self.params.n)
        return gckks.ntt_limbs(pt, self.params, primes), scale

    def mul_plain(self, ct, pt_handle):
        pt_ntt, scale = pt_handle
        return gckks.ct_mul_plain(ct, pt_ntt, scale, self.params)

    def add_plain(self, ct, z):
        primes = ct.primes(self.params)
        pt = gckks.encode(
            np.broadcast_to(np.asarray(z, dtype=np.complex128), (self.params.slots,)),
            ct.scale, primes, self.params.n)
        c = list(ct.c)
        c[0] = gckks.poly_add(c[0], gckks.ntt_limbs(pt, self.params, primes), primes)
        return gckks.Ciphertext(c, ct.level, ct.scale)

    # -- fused diagonal-fan stages (mirror of DeviceBackend.make_fan_plan) --
    def _encode_qp(self, z, scale: float, level: int):
        qp_primes = self.params.q_primes[:level] + self.params.p_primes
        pt = gckks.encode(np.asarray(z, dtype=np.complex128), scale, qp_primes, self.params.n)
        return gckks.ntt_limbs(pt, self.params, qp_primes)

    def make_fan_plan(self, diag_sets, level: int, scale: float | None = None):
        scale = self.params.scale if scale is None else scale
        for dset in diag_sets:
            if not any(r != 0 for r in dset):
                raise ValueError("each set needs a nonzero offset")
        sets = tuple({r: self._encode_qp(z, scale, level) for r, z in dset.items()}
                     for dset in diag_sets)
        return GoldenFanPlan(level, scale, sets)

    def apply_fan(self, ct, plan: GoldenFanPlan):
        if ct.level != plan.level:
            raise ValueError(f"the plan is at level {plan.level}, the ciphertext at {ct.level}")
        offsets = sorted({r for d in plan.sets for r in d if r != 0})
        gks = {s: self.chest.golden_galois_key(s) for s in offsets}
        return gckks.ct_diag_fan(ct, list(plan.sets), plan.pt_scale, self.params, gks)

    def _align(self, a, b):
        lvl = min(a.level, b.level)
        return self.drop_to_level(a, lvl), self.drop_to_level(b, lvl)

    def add(self, a, b):
        _check_scales(a.scale, b.scale)
        a, b = self._align(a, b)
        return gckks.ct_add(a, gckks.Ciphertext(b.c, b.level, a.scale), self.params)

    def sub(self, a, b):
        _check_scales(a.scale, b.scale)
        a, b = self._align(a, b)
        return gckks.ct_sub(a, gckks.Ciphertext(b.c, b.level, a.scale), self.params)

    def mul(self, a, b):
        a, b = self._align(a, b)
        r = gckks.ct_relinearize(gckks.ct_tensor(a, b, self.params), self.params, self.chest.rlk)
        return self.rescale(r)

    def mod_raise(self, ct):
        return gckks.ct_mod_raise(ct, self.params)

    def rescale(self, ct):
        for _ in range(self.params.scale_words):
            ct = gckks.ct_rescale(ct, self.params)
        return ct

    def rescale_prod(self, level: int) -> float:
        out = 1.0
        for i in range(self.params.scale_words):
            out *= self.params.q_primes[level - 1 - i]
        return out

    def rotate_hoisted(self, ct, steps_list):
        gks = {s: self.chest.golden_galois_key(s) for s in steps_list}
        return dict(zip(steps_list, gckks.ct_rotate_hoisted(ct, steps_list, self.params, gks)))

    def conjugate(self, ct):
        return gckks.ct_conjugate(ct, self.params, self.chest.conj[0])

    def key_switch(self, ct, which: str):
        return gckks.ct_key_switch(ct, self.params, self.chest.eph[which][0])

    def drop_to_level(self, ct, level: int):
        if level > ct.level:
            raise ValueError(f"cannot drop a ciphertext at level {ct.level} to {level}")
        return gckks.Ciphertext([c[:level] for c in ct.c], level, ct.scale)

    def decrypt_decode(self, ct):
        return gckks.decrypt_decode(ct, self.params, self.chest.sk)

    def level(self, ct):
        return ct.level


class GhostCiphertext(NamedTuple):
    level: int
    scale: float


class GhostBackend:
    """Level/scale simulator: runs orchestration code (polyeval, EvalMod)
    with no data, to plan parameter budgets ahead of time — e.g. the exact
    level the Chebyshev EvalMod output lands on, so SlotToCoeff plans and
    per-step Galois key truncation (keys/keys.py truncate_galois_device) can
    be decided before anything touches the device."""

    def __init__(self, params: CKKSParams):
        self.params = params

    def level(self, ct):
        return ct.level

    def drop_to_level(self, ct, level):
        assert level <= ct.level
        return GhostCiphertext(level, ct.scale)

    def encode_slots(self, z, scale, level):
        return None, float(scale)

    def mul_plain(self, ct, handle):
        return GhostCiphertext(ct.level, ct.scale * handle[1])

    def add_plain(self, ct, z):
        return ct

    def add(self, a, b):
        lvl = min(a.level, b.level)
        return GhostCiphertext(lvl, a.scale)

    def sub(self, a, b):
        lvl = min(a.level, b.level)
        return GhostCiphertext(lvl, a.scale)

    def rescale_prod(self, level: int) -> float:
        w = self.params.scale_words
        out = 1.0
        for i in range(w):
            out *= self.params.q_primes[level - 1 - i]
        return out

    def rescale(self, ct):
        lvl, s = ct.level, ct.scale
        for _ in range(self.params.scale_words):
            s = s / self.params.q_primes[lvl - 1]
            lvl -= 1
        return GhostCiphertext(lvl, s)

    def mul(self, a, b):
        lvl = min(a.level, b.level)
        return self.rescale(GhostCiphertext(lvl, a.scale * b.scale))
