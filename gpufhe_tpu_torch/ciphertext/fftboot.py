"""Factored-FFT CoeffToSlot / SlotToCoeff: log-depth, O(log n) rotations.

The dense BSGS transforms (bootstrap.py) need O(slots) rotations — fine at CI
scale, impossible at N=2^16 (32768 diagonals). This module factors the
decoding map into Cooley-Tukey butterfly stages over the Galois subgroup <5>:

    decode(m) = F (m_lo + i m_hi),   F[j,k] = omega_M^(5^j k),  M = 4*slots
    F = Stage_{log s} ... Stage_1 . BitRev

Each stage is a 3-diagonal matrix (offsets {0, +-h}, h doubling), so a
grouped radix-2^g stage has <= 3^g diagonals and costs one level + one
hoisted rotation fan. The bit reversal is NEVER applied homomorphically:
EvalMod is slot-wise and therefore slot-order-agnostic, so CoeffToSlot simply
*delivers* coefficients in bit-reversed slot order and SlotToCoeff consumes
the same order (the permutation lives in bookkeeping only).

Real/imag unpacking (CtS) and repacking (StC) reuse the boundary stage twice
with different constant folds (c/2 and -i*c/2), trading one plaintext-mult
level for one extra sparse-stage application.

A copy of gpufhe_tpu/ciphertext/fftboot.py, which imports only numpy: the
port keeps its own so that it imports nothing of gpufhe_tpu. On the port's
DeviceBackend every DiagPlan stage runs as one ct_diag_fan (ciphertext/ct.py).
"""

from __future__ import annotations

import math

import numpy as np


def bit_rev_perm(n: int) -> np.ndarray:
    bits = int(math.log2(n))
    out = np.zeros(n, dtype=np.int64)
    for i in range(n):
        r = 0
        for b in range(bits):
            r |= ((i >> b) & 1) << (bits - 1 - b)
        out[i] = r
    return out


def _stage_twiddles(n_s: int) -> list[tuple[int, np.ndarray]]:
    """Per stage (h, w[h]) with w[j'] = omega_{4*st}^(5^j'), st = 2h."""
    stages = []
    st = 2
    while st <= n_s:
        h = st // 2
        mp = 4 * st
        w = np.empty(h, dtype=np.complex128)
        e = 1
        for j in range(h):
            w[j] = np.exp(2j * np.pi * e / mp)
            e = e * 5 % mp
        stages.append((h, w))
        st *= 2
    return stages


def _merge(*dicts) -> dict:
    """Sum diagonal dicts (at h = n_s/2 the +h and -h offsets coincide)."""
    out: dict[int, np.ndarray] = {}
    for d in dicts:
        for r, v in d.items():
            out[r] = out[r] + v if r in out else v.copy()
    return out


def _fwd_stage_diags(n_s: int, h: int, w: np.ndarray) -> dict[int, np.ndarray]:
    """Butterfly out_top = top + w*bot, out_bot = top - w*bot as rot-diagonals.

    diag_r[j] multiplies rot_r(x)[j] = x[(j+r) % n_s] (linalg.py convention).
    """
    st = 2 * h
    p = np.arange(n_s)
    top = (p % st) < h
    wfull = np.tile(np.concatenate([w, w]), n_s // st)
    d0 = np.where(top, 1.0 + 0j, -wfull)
    dp = np.where(top, wfull, 0j)  # reads x[p + h] (top rows)
    dm = np.where(top, 0j, 1.0 + 0j)  # reads x[p - h] (bottom rows)
    return _merge({0: d0}, {h % n_s: dp}, {(n_s - h) % n_s: dm})


def _inv_stage_diags(n_s: int, h: int, w: np.ndarray) -> dict[int, np.ndarray]:
    """Inverse butterfly: top' = (top + bot)/2, bot' = (top - bot)/(2 w)."""
    st = 2 * h
    p = np.arange(n_s)
    top = (p % st) < h
    winv = np.tile(np.concatenate([1.0 / w, 1.0 / w]), n_s // st)
    d0 = np.where(top, 0.5 + 0j, -0.5 * winv)
    dp = np.where(top, 0.5 + 0j, 0j)
    dm = np.where(top, 0j, 0.5 * winv)
    return _merge({0: d0}, {h % n_s: dp}, {(n_s - h) % n_s: dm})


def diag_product(a: dict, b: dict, n_s: int) -> dict:
    """Rotation-diagonal representation of the matrix product A @ B."""
    out: dict[int, np.ndarray] = {}
    for ra, da in a.items():
        for rb, db in b.items():
            r = (ra + rb) % n_s
            term = da * np.roll(db, -ra)  # rot_ra(db)[j] = db[(j+ra) % n_s]
            if r in out:
                out[r] = out[r] + term
            else:
                out[r] = term.copy()
    return {r: d for r, d in out.items() if np.abs(d).max() > 1e-14}


def group_stages(diag_list: list[dict], n_s: int, radix_log: int) -> list[dict]:
    """Fuse runs of `radix_log` consecutive stages into single diagonal maps.

    diag_list is in application order (first applied first); each group is the
    matrix product of its stages (later stage on the left).
    """
    groups = []
    for i in range(0, len(diag_list), radix_log):
        run = diag_list[i : i + radix_log]
        acc = run[0]
        for nxt in run[1:]:
            acc = diag_product(nxt, acc, n_s)
        groups.append(acc)
    return groups


def scale_diags(d: dict, c: complex) -> dict:
    return {r: v * c for r, v in d.items()}


class DiagPlan:
    """One grouped sparse stage (possibly with several output sets sharing
    the same rotation fan), encoded at a level. The whole stage (hoist,
    rotation fan, plaintext MACs, delayed ModDown, rescale) runs as one
    ct_diag_fan ("double hoisting") through the backend's
    make_fan_plan/apply_fan."""

    def __init__(self, be, diags, level: int):
        self.be = be
        self.level = level
        self.sets = [diags] if isinstance(diags, dict) else list(diags)
        self.fan = be.make_fan_plan(self.sets, level)
        self.offsets = sorted(self.sets[0].keys())

    def apply_multi(self, ct) -> list:
        assert self.be.level(ct) == self.level, (self.be.level(ct), self.level)
        return self.be.apply_fan(ct, self.fan)

    def apply(self, ct):
        return self.apply_multi(ct)[0]


def all_offsets(groups: list[dict]) -> list[int]:
    s = set()
    for g in groups:
        s.update(r for r in g.keys() if r != 0)
    return sorted(s)


class FactoredCtS:
    """CoeffToSlot: slots(z) -> two real ciphertexts holding the coefficient
    values in BIT-REVERSED slot order, scaled by `factor`.

    Structure: shared inverse stages (reverse order), then the final inverse
    stage applied twice with folds (factor/2) and (-i*factor/2); realification
    x + conj(x) finishes each branch. Levels used: number of grouped stages.
    """

    def __init__(self, be, level: int, radix_log: int = 3, factor: complex = 1.0):
        n_s = be.params.slots
        fwd = [
            _inv_stage_diags(n_s, h, w) for h, w in reversed(_stage_twiddles(n_s))
        ]  # inverse transform applies stages largest-h first
        groups = group_stages(fwd, n_s, radix_log)
        # spread |factor| geometrically over ALL stages: tiny factors folded
        # into one stage make its entries quantize badly at scale Delta
        # (dominant CtS noise at N=2^16); per-stage O(1) entries fix it
        mag = abs(factor) ** (1.0 / len(groups))
        phase = factor / abs(factor) if factor != 0 else 1.0
        w = be.params.scale_words
        self.shared = [
            DiagPlan(be, scale_diags(g, mag), level - i * w)
            for i, g in enumerate(groups[:-1])
        ]
        last_level = level - (len(groups) - 1) * w
        # both boundary folds share one rotation fan (two output sets)
        self.last = DiagPlan(
            be,
            [
                scale_diags(groups[-1], mag * phase / 2),
                scale_diags(groups[-1], -1j * mag * phase / 2),
            ],
            last_level,
        )
        self.be = be
        self.levels_used = len(groups) * w

    def __call__(self, ct):
        be = self.be
        for plan in self.shared:
            ct = plan.apply(ct)
        u_re, u_im = self.last.apply_multi(ct)
        ct_lo = be.add(u_re, be.conjugate(u_re))  # 2 Re((c/2) u) = c m_lo
        ct_hi = be.add(u_im, be.conjugate(u_im))  # 2 Re((-ic/2) u) = c m_hi
        return ct_lo, ct_hi


class FactoredStC:
    """SlotToCoeff: two real ciphertexts (bit-reversed coefficient slots) ->
    slots(z), scaled by `factor`. First forward stage applied twice (folds 1
    and i) to repack u = y_lo + i y_hi, then the remaining stages once."""

    def __init__(self, be, level: int, radix_log: int = 3, factor: complex = 1.0):
        n_s = be.params.slots
        fwd = [_fwd_stage_diags(n_s, h, w) for h, w in _stage_twiddles(n_s)]
        groups = group_stages(fwd, n_s, radix_log)
        mag = abs(factor) ** (1.0 / len(groups))
        phase = factor / abs(factor) if factor != 0 else 1.0
        w = be.params.scale_words
        self.first_lo = DiagPlan(be, scale_diags(groups[0], mag * phase), level)
        self.first_hi = DiagPlan(be, scale_diags(groups[0], 1j * mag * phase), level)
        self.rest = [
            DiagPlan(be, scale_diags(g, mag), level - (1 + i) * w)
            for i, g in enumerate(groups[1:])
        ]
        self.be = be
        self.levels_used = len(groups) * w

    def __call__(self, ct_lo, ct_hi):
        be = self.be
        ct = be.add(self.first_lo.apply(ct_lo), self.first_hi.apply(ct_hi))
        for plan in self.rest:
            ct = plan.apply(ct)
        return ct


def factored_rotations(slots: int, radix_log: int = 3) -> list[int]:
    """All rotation steps the factored transforms need (for keygen)."""
    n_s = slots
    fwd = [_fwd_stage_diags(n_s, h, w) for h, w in _stage_twiddles(n_s)]
    inv = [_inv_stage_diags(n_s, h, w) for h, w in reversed(_stage_twiddles(n_s))]
    offs = set(all_offsets(group_stages(fwd, n_s, radix_log)))
    offs |= set(all_offsets(group_stages(inv, n_s, radix_log)))
    return sorted(offs)
