"""CKKS bootstrapping: ModRaise -> CoeffToSlot -> EvalMod -> SlotToCoeff.

Counterpart of gpufhe_tpu/ciphertext/bootstrap.py: `Bootstrapper`,
`bootstrap_rotations`, `galois_step_levels`, `__call__` and `timed_call`,
with the reference's constructor signature. Backend-generic
(ciphertext/backend.py DeviceBackend), so the orchestration and its float
bookkeeping are the reference's, operation for operation, and every phase
output equals the reference's limb for limb (tests/test_torch_bootstrap.py).
The reference's fused EvalMod (one XLA program per Chebyshev evaluation)
has no counterpart: the port runs the EvalMod eagerly.

Pipeline (slots = n/2, q0 = first prime, Delta = 2^scale_bits):

1. **ModRaise** — re-embed the exhausted level-1 ciphertext into the full
   chain; plaintext becomes u = m + q0*I with small integer polynomial I.
2. **CoeffToSlot** — two BSGS matmuls (linalg.py) with A = (1/n) E^dagger
   where E[j,k] = zeta^(5^j k), zeta = e^(i pi/n) (the decoding matrix of
   encoding/encoder.py): slot vectors become the real coefficient values
   u_k / Delta (k < n/2 and k >= n/2 in two ciphertexts, realified via the
   conjugate part A z + conj(A) conj(z)). The EvalMod input scaling
   2 pi Delta / (q0 2^r) is folded into the matrices.
3. **EvalMod** — remove q0*I: with x = (2 pi u / q0 - pi/2) / 2^r, evaluate
   cos(x) by an even Taylor polynomial (Horner in z = x^2), then r
   double-angle steps cos(2t) = 2 cos^2 t - 1 give cos(2^r x) =
   sin(2 pi u / q0) ~= 2 pi m / q0.
4. **SlotToCoeff** — BSGS matmuls with E (times q0 / (2 pi Delta), folded
   in) map slot values back to coefficients; the two halves are summed.

Levels consumed: 1 (CtS) + taylor_m + 1 + r (EvalMod) + 1 (StC).

The direct dense CtS/StC matrices are O(slots) rotations — right for
CI-scale rings; production N = 2^16 uses the factored-FFT variant
(fftboot.py) with the Chebyshev EvalMod (polyeval.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpufhe_tpu_torch.ciphertext.fftboot import FactoredCtS, FactoredStC, factored_rotations
from gpufhe_tpu_torch.ciphertext.linalg import BsgsPlan, bsgs_rotations
from gpufhe_tpu_torch.params.params import CKKSParams
from gpufhe_tpu_torch.utils.profiling import stage


def bootstrap_rotations(
    params: CKKSParams, transform: str = "dense", radix_log: int = 3
) -> list[int]:
    """All Galois rotation steps bootstrapping needs (keygen input)."""
    if transform == "factored":
        return factored_rotations(params.slots, radix_log)
    return bsgs_rotations(params.slots)


def _embedding_matrix(n: int) -> np.ndarray:
    """E[j, k] = zeta^(5^j k): slots(m) = E @ coeffs(m) (see golden encode)."""
    slots = n // 2
    exps = np.empty(slots, dtype=np.int64)
    g = 1
    for j in range(slots):
        exps[j] = g
        g = g * 5 % (2 * n)
    k = np.arange(n)
    ang = (exps[:, None] * k[None, :]) % (2 * n)
    return np.exp(1j * np.pi * ang / n)


class Bootstrapper:
    """Precomputes the linear-transform plans and drives the pipeline."""

    def __init__(self, be, r: int = 5, taylor_m: int = 4, transform: str = "dense",
                 radix_log: int = 3, evalmod: str = "cos", k_bound: float = 12.0,
                 cheb_baby_log: int = 3, fuse_evalmod: bool | None = None,
                 lean_keys: bool = False, normalize_scale: bool = True):
        """evalmod="cos": Taylor cos + r double-angle steps (amplifies input
        noise by 2^r — fine at CI scale). evalmod="cheb": direct Chebyshev
        sine evaluation (polyeval.py) — no noise amplification; the
        production choice. k_bound bounds |u|/q0 (the ModRaise overflow).
        fuse_evalmod is the reference's parameter and does nothing here: the
        reference fuses each Chebyshev evaluation into one XLA program, the
        port runs it eagerly. lean_keys: on the first Chebyshev call, drop
        every Galois key's `a` half after CoeffToSlot (half the chest's
        rotation keys) and draw them again from the recorded seeds before
        SlotToCoeff (keys/device_keygen.py regen_galois_a, bit for bit), so
        the EvalMod runs with that memory free; later calls keep every key.
        It needs a seeded chest (device_keygen's DeviceKeyChest) and does
        nothing for a KeyChest, as in the reference."""
        self.be = be
        params: CKKSParams = be.params
        self.params = params
        self.normalize_scale = normalize_scale
        self.r = r
        self.taylor_m = taylor_m
        self.transform = transform
        self.evalmod = evalmod
        self.k_bound = k_bound
        self.cheb_baby_log = cheb_baby_log
        chest = getattr(be, "chest", None)
        self._lean_pending = bool(lean_keys and hasattr(chest, "drop_galois_a")
                                  and getattr(chest, "seeds", None))
        n = params.n
        slots = params.slots
        # composite base modulus for scale_words > 1 (double-word scale)
        q0 = math.prod(params.q_primes[: params.scale_words])
        delta = params.scale
        full = params.num_limbs
        self._radix_log = radix_log
        self._stc_factor = q0 / (2.0 * math.pi * delta)

        if evalmod == "cheb":
            # slots after CtS = u / (q0 k_bound) in [-1, 1]
            cts_factor = delta / (q0 * k_bound)
            assert transform == "factored", "cheb EvalMod pairs with factored CtS"
            self.f_cts = FactoredCtS(be, level=full, radix_log=radix_log,
                                     factor=cts_factor)
            from gpufhe_tpu_torch.ciphertext.polyeval import ChebyshevEvaluator, sine_coeffs

            self._cheb = ChebyshevEvaluator(
                be, sine_coeffs(k_bound), baby_log=cheb_baby_log
            )
            # plan the EvalMod output level with a data-free ghost run so the
            # StC plan exists up front (enables per-step Galois key
            # truncation before anything runs — galois_step_levels())
            from gpufhe_tpu_torch.ciphertext.backend import GhostBackend, GhostCiphertext

            ghost = ChebyshevEvaluator(
                GhostBackend(params), sine_coeffs(k_bound), baby_log=cheb_baby_log
            )
            gy = ghost(GhostCiphertext(full - self.f_cts.levels_used, delta))
            self.f_stc = FactoredStC(
                be, level=gy.level, radix_log=radix_log, factor=self._stc_factor
            )
            self.taylor = []
            return

        cts_factor = 2.0 * math.pi * delta / (q0 * 2.0**self.r)
        stc_factor = q0 / (2.0 * math.pi * delta)

        if transform == "factored":
            # log-depth sparse-stage transforms (fftboot.py); coefficient
            # slots travel in bit-reversed order, invisible to EvalMod
            self.f_cts = FactoredCtS(be, level=full, radix_log=radix_log,
                                     factor=cts_factor)
            cts_levels = self.f_cts.levels_used
            stc_level = full - cts_levels - (self.taylor_m + 1 + self.r)
            assert stc_level - self.f_cts.levels_used >= 1, "not enough levels"
            self.f_stc = FactoredStC(be, level=stc_level, radix_log=radix_log,
                                     factor=stc_factor)
        else:
            e = _embedding_matrix(n)
            a = (1.0 / n) * e.conj().T  # [n, slots]
            a0 = a[:slots] * cts_factor
            a1 = a[slots:] * cts_factor

            # CtS runs at the full level (right after ModRaise)
            self.cts0 = BsgsPlan(be, a0, a0.conj(), level=full)
            self.cts1 = BsgsPlan(be, a1, a1.conj(), level=full)

            stc_level = full - 1 - (self.taylor_m + 1 + self.r)
            assert stc_level >= 2, (
                f"not enough levels for bootstrap: need >= {self.taylor_m + self.r + 4}"
            )
            self.stc0 = BsgsPlan(be, e[:, :slots] * stc_factor, None, level=stc_level)
            self.stc1 = BsgsPlan(be, e[:, slots:] * stc_factor, None, level=stc_level)

        # even Taylor coefficients of cos: sum_j (-1)^j z^j / (2j)!, z = x^2
        self.taylor = [
            (-1.0) ** j / math.factorial(2 * j) for j in range(self.taylor_m + 1)
        ]

    def galois_step_levels(self):
        """Highest level each rotation step is used at, plus the conjugation
        level — the input to keys.truncate_galois_device (factored path)."""
        if self.transform != "factored":
            return {}, None
        plans = list(self.f_cts.shared) + [self.f_cts.last]
        if self.f_stc is not None:
            plans += [self.f_stc.first_lo, self.f_stc.first_hi]
            plans += list(self.f_stc.rest)
        out = {}
        for p in plans:
            for r in p.offsets:
                if r:
                    out[r] = max(out.get(r, 0), p.level)
        conj_level = self.f_cts.last.level - self.params.scale_words
        return out, conj_level

    # -- EvalMod ------------------------------------------------------------
    def _mul_const(self, ct, c: float):
        be = self.be
        pt = be.encode_slots(
            np.full(self.params.slots, c, dtype=np.complex128),
            self.params.scale,
            be.level(ct),
        )
        return be.rescale(be.mul_plain(ct, pt))

    def _evalmod(self, x):
        """cos Taylor in z = x^2 (Horner) + r double-angle steps."""
        be = self.be
        c = self.taylor
        z = be.mul(x, x)
        w = self._mul_const(z, c[-1])
        w = be.add_plain(w, c[-2])
        for j in range(self.taylor_m - 2, -1, -1):
            w = be.mul(w, z)
            w = be.add_plain(w, c[j])
        y = w
        for _ in range(self.r):
            y2 = be.mul(y, y)
            y = be.add_plain(be.add(y2, y2), -1.0)
        return y

    # -- full pipeline ------------------------------------------------------
    def _normalize(self, ct):
        """Land the refreshed ciphertext at EXACTLY scale Delta.

        The transform-factor bookkeeping leaves the StC output at
        in_scale * prod(pt scales) / prod(rescale primes) — ~2^78 at the
        N=2^16 dw flagship, NOT Delta. Decrypt-right-after never notices
        (decode divides by the tracked scale), but any COMPUTE chained after
        the refresh compounds the excess: each squaring doubles the
        log-excess, and a few refreshes between squarings drive the tracked
        scale to float inf. One
        uniform-constant multiply + rescale (polyeval._align_to — the
        constant encode is exact, no structural quantization) costs one
        mult level and restores the production invariant: bootstrap output
        scale == Delta."""
        if not self.normalize_scale:
            return ct
        w = self.params.scale_words
        from gpufhe_tpu_torch.ciphertext.polyeval import _align_to

        return _align_to(self.be, ct, self.params.scale,
                         self.be.level(ct) - w)

    def _mod_raise(self, ct):
        """Align the input to Delta where it has the spare limbs, drop it to
        scale_words limbs and raise it to the full chain (under the ephemeral
        sparse secret where the chest has one)."""
        be = self.be
        w = self.params.scale_words
        delta = self.params.scale
        # EvalMod's domain mapping assumes the input scale is EXACTLY Delta:
        # a relative scale error eps multiplies the ModRaise overflow term
        # inside the sine argument (error ~ 2*pi*eps*I radians, I up to
        # k_bound), so a drift of a few percent from a preceding compute
        # chain decodes garbage. Align to Delta here when the input carries
        # the w spare limbs that costs (callers that chain compute before a
        # refresh reserve them).
        if (self.normalize_scale and abs(ct.scale / delta - 1.0) > 1e-6
                and be.level(ct) >= 2 * w):
            from gpufhe_tpu_torch.ciphertext.polyeval import _align_to

            ct = _align_to(be, ct, delta, be.level(ct) - w)
        drift = abs(ct.scale / delta - 1.0)
        if 1e-6 < drift < 1e-4:
            # proceeding unaligned (no spare limbs): error ~2*pi*drift*I
            # radians in the EvalMod sine argument — small but should be
            # visible near the assertion threshold
            import warnings

            warnings.warn(
                f"bootstrap input scale drifts {drift:.2e} from Delta with "
                f"no spare limbs to align; EvalMod error grows by "
                f"~2*pi*{drift:.1e}*I rad — reserve scale_words limbs for "
                f"exact alignment", RuntimeWarning, stacklevel=3)
        assert drift < 1e-4, (
            f"bootstrap input scale {ct.scale:.6g} != Delta {delta:.6g} and "
            f"no spare limbs to align (level {be.level(ct)}); EvalMod would "
            f"decode garbage — reserve scale_words limbs before the refresh"
        )
        if be.level(ct) > w:
            ct = be.drop_to_level(ct, w)
        if be.chest.eph is not None:
            # sparse-secret encapsulation: ModRaise under the ephemeral
            # sparse key (small overflow I), full chain stays under the
            # dense base secret
            ct = be.key_switch(ct, "to_eph")
            raised = be.mod_raise(ct)
            return be.key_switch(raised, "from_eph")
        return be.mod_raise(ct)

    def __call__(self, ct, _phase=None):
        """_phase: optional callable(name, outs) fired as each pipeline
        phase's outputs are produced, outs a tuple of its ciphertexts:
        mod_raise (raised,), coeff_to_slot (t0, t1), evalmod (y0, y1) and
        slot_to_coeff (out,). timed_call uses it to sync and attribute wall
        time per phase; the reference's hook receives the last of them.
        Span `boot`, and inside it one span a phase over the stretch that
        phase's mark ends: `boot.mod_raise`, `boot.coeff_to_slot`,
        `boot.evalmod`, `boot.slot_to_coeff`."""
        mark = _phase if _phase is not None else (lambda name, outs: None)
        with stage("boot"):
            be = self.be
            with stage("boot.mod_raise"):
                raised = self._mod_raise(ct)
            mark("mod_raise", (raised,))

            if self.evalmod == "cheb":
                with stage("boot.coeff_to_slot"):
                    t0, t1 = self.f_cts(raised)
                mark("coeff_to_slot", (t0, t1))
                with stage("boot.evalmod"):
                    if self._lean_pending:
                        be.chest.drop_galois_a()
                    y0 = self._cheb(t0)
                    y1 = self._cheb(t1)
                    if self._lean_pending:
                        be.chest.regen_galois_a(be.ctx)
                        self._lean_pending = False
                mark("evalmod", (y0, y1))
                with stage("boot.slot_to_coeff"):
                    lvl = self.f_stc.first_lo.level  # ghost-planned == actual level
                    out = self.f_stc(be.drop_to_level(y0, lvl), be.drop_to_level(y1, lvl))
                    out = self._normalize(out)
                mark("slot_to_coeff", (out,))
                return out

            with stage("boot.coeff_to_slot"):
                if self.transform == "factored":
                    t0, t1 = self.f_cts(raised)
                else:
                    t0 = self.cts0.apply(raised)
                    t1 = self.cts1.apply(raised)
                shift = -math.pi / 2.0 ** (self.r + 1)
                t0 = be.add_plain(t0, shift)
                t1 = be.add_plain(t1, shift)
            mark("coeff_to_slot", (t0, t1))

            with stage("boot.evalmod"):
                y0 = self._evalmod(t0)
                y1 = self._evalmod(t1)
            mark("evalmod", (y0, y1))

            with stage("boot.slot_to_coeff"):
                if self.transform == "factored":
                    lvl = self.f_stc.first_lo.level
                    out = self.f_stc(be.drop_to_level(y0, lvl), be.drop_to_level(y1, lvl))
                else:
                    y0 = be.drop_to_level(y0, self.stc0.level)
                    y1 = be.drop_to_level(y1, self.stc1.level)
                    out = be.add(self.stc0.apply(y0), self.stc1.apply(y1))
                out = self._normalize(out)
            mark("slot_to_coeff", (out,))
            return out

    def timed_call(self, ct):
        """(out, {phase: seconds}): wall time per phase, with the device
        synchronised (torch.cuda.synchronize) at each phase's end, so each
        phase's time includes its device work. On the CPU nothing is
        queued and no sync is needed."""
        import time as _time

        times: dict[str, float] = {}
        state = {"t": _time.perf_counter()}

        def mark(name, outs):
            c = outs[-1].c[0]
            if c.is_cuda:
                torch.cuda.synchronize(c.device)
            now = _time.perf_counter()
            times[name] = now - state["t"]
            state["t"] = now

        out = self(ct, _phase=mark)
        return out, times
