"""Encrypted logistic-regression TRAINING (gradient descent under CKKS).

Everything the optimizer touches is encrypted: the dataset (feature columns
AND labels) and the evolving weights. Each gradient-descent iteration is
five ciphertext multiplications deep; with `refresh=` (a
ciphertext.bootstrap.Bootstrapper) the weights are bootstrapped whenever the
next iteration would not fit the remaining level budget, so the number of
iterations is unbounded — the composition (models + comparison-free
polynomial sigmoid + bootstrapping over the backend protocol) that a
production FHE framework exists to support. The model, depth, keys and
cleartext mirror of gpufhe_tpu/models/logreg_train.py, evaluated in another
order (below), which keeps the gradient's precision where the reference's
order loses it.

Packing (slots = N/2, m = n_samples <= slots):
  x_cts[j]  — feature column j, one sample per slot (zero-padded past m)
  y_ct      — labels in {0, 1}, one per slot
  w_cts[j]  — weight j broadcast across all slots

Iteration (the classic SIMD-packed scheme of Han et al., IDASH'18, over the
backend surface):
  z      = sum_j w_j * x_j                                (1 mult level)
  p      = 0.5 + c1 z + c3 z^3     degree-3 sigmoid       (2 levels:
           z^2 beside c3 z, their product; c1 z brought to it)
  r      = p - y
  g_j    = SlotSum(r * xm_j)       xm_j = K * mask * x_j, precomputed
                                                          (1 level)
  w_j   <- w_j - (lr/(m K)) g_j    one fused plaintext MAC (1 level)
The padding-slot garbage (p = 0.5 there) is annihilated by xm_j, whose mask
zeroes slots >= m. lr/m multiplies the sum, not the summands: folded into
xm_j (the reference's order) it makes every summand about m/lr times
smaller against noise that does not shrink with it (each rescale's, about
1e-4 a slot at N = 2^16 and Delta = 2^28, and each rotation's, more), and
the SlotSum adds that noise over every slot: at 1579 samples there the
weights came out wrong by about 1.4. The summands are carried K times
larger instead (`sum_gain`): each rotation's key switch adds noise of a
fixed size (ModDown's rounding, biased by about -alpha/2 a coefficient),
which the later doublings add up to slots/2 times over. K is the largest
power of two, at most slots, that leaves the update's constant
lr/(m K) 2^12 or more at Delta: 2^5 at m = 1579, lr = 1, Delta = 2^28, where
it takes the update's error from about 1e-4 to 1e-5 on an H100. The update
lands the weights at exactly the parameters' scale, so iterations keep it.
SlotSum is log2(slots) hoisted rotate-and-accumulate steps (0 levels).
"""

from __future__ import annotations

import numpy as np

from gpufhe_tpu_torch.ciphertext.polyeval import _align_to, _mac_to

# Taylor sigmoid around 0: sigma(t) ~= 1/2 + t/4 - t^3/48 (good on |t| <~ 4;
# the training loop keeps z there for lr ~ O(1) on unit-scale features)
SIG_C1 = 0.25
SIG_C3 = -1.0 / 48.0


def train_rotations(slots: int) -> list[int]:
    """Rotation steps SlotSum needs (keygen input): powers of two."""
    out, s = [], 1
    while s < slots:
        out.append(s)
        s *= 2
    return out


def _sum_gain(lr_over_m: float, scale: float, slots: int) -> int:
    """The largest power of two K <= slots with lr_over_m * scale / K >= 2^12
    (at least 1): the factor the SlotSum's summands carry (module note)."""
    k = 1
    while 2 * k <= slots and lr_over_m * scale / (2 * k) >= 2.0**12:
        k *= 2
    return k


def sigmoid_poly(t):
    """The cleartext mirror of the encrypted degree-3 sigmoid."""
    t = np.asarray(t, dtype=np.float64)
    return 0.5 + SIG_C1 * t + SIG_C3 * t**3


class EncryptedLogRegTrainer:
    """Gradient descent on encrypted data with encrypted weights.

    be: any ciphertext backend (device / golden / sharded).
    refresh: optional callable(ct) -> ct (a Bootstrapper) applied to each
    weight ciphertext when the next iteration would underflow the levels.
    """

    def __init__(self, be, n_samples: int, lr: float = 1.0, refresh=None):
        self.be = be
        self.m = n_samples
        self.lr = lr
        self.refresh = refresh
        self.refreshes = 0  # weight bootstraps across fit()
        slots = be.params.slots
        assert n_samples <= slots, (n_samples, slots)
        # per-iteration cost in limbs: 5 mult levels
        self._need = 5 * be.params.scale_words
        self.sum_gain = _sum_gain(lr / n_samples, be.params.scale, slots)

    # -- packing helpers ----------------------------------------------------
    def slot_vec(self, col: np.ndarray) -> np.ndarray:
        """Zero-pad a per-sample column into the slot vector."""
        v = np.zeros(self.be.params.slots, dtype=np.complex128)
        v[: len(col)] = col
        return v

    def prepare(self, x_cts: list):
        """Fold the sample mask, times sum_gain, into each encrypted feature
        column — ONE level, paid once, amortized over every iteration."""
        be = self.be
        mask = np.zeros(be.params.slots, dtype=np.complex128)
        mask[: self.m] = self.sum_gain
        out = []
        for x in x_cts:
            h = be.encode_slots(mask, be.params.scale, be.level(x))
            out.append(be.rescale(be.mul_plain(x, h)))
        return out

    # -- one GD iteration ---------------------------------------------------
    def step(self, w_cts: list, x_cts: list, xm_cts: list, y_ct):
        be = self.be
        floor = be.params.scale_words
        lvl = min(be.level(w) for w in w_cts)
        # reserve scale_words limbs beyond the iteration's need so the
        # refresh can align its INPUT scale to exactly Delta first
        # (bootstrap.py: EvalMod decodes garbage from a drifted scale);
        # without a refresh callable there is nothing to reserve FOR
        reserve = floor if self.refresh is not None else 0
        if lvl - self._need < floor + reserve:
            assert self.refresh is not None, (
                f"iteration needs {self._need} limbs above the floor {floor}; "
                f"weights at {lvl} (pass refresh= to bootstrap mid-training)"
            )
            # bootstrap normalizes its output to exactly Delta
            # (Bootstrapper._normalize); the explicit re-align only fires
            # for a non-normalizing refresh callable
            fresh = []
            for w in w_cts:
                w = self.refresh(w)
                if abs(w.scale / be.params.scale - 1.0) > 1e-9:
                    w = _align_to(be, w, be.params.scale,
                                  be.level(w) - floor)
                fresh.append(w)
            w_cts = fresh
            self.refreshes += len(w_cts)
            lvl = min(be.level(w) for w in w_cts)
            assert lvl - self._need >= floor, (
                f"refresh restored level {lvl} < {self._need + floor}"
            )

        # z = <w, x> per slot (x aligns down to w's level inside mul)
        z = be.mul(w_cts[0], x_cts[0])
        for w, x in zip(w_cts[1:], x_cts[1:]):
            z = be.add(z, be.mul(w, x))

        # p = 0.5 + c1 z + c3 z^3: z^2 and c3 z side by side, then their
        # product, with c1 z brought to its level and scale
        t2 = be.mul(z, z)
        h = be.encode_slots(
            np.full(be.params.slots, SIG_C3, dtype=np.complex128),
            be.params.scale, be.level(z),
        )
        z3 = be.mul(t2, be.rescale(be.mul_plain(z, h)))
        p = be.add_plain(be.add(z3, _mac_to(be, [(z, SIG_C1)], z3.scale, be.level(z3))), 0.5)

        # land y EXACTLY on p's (level, scale): the ct-ct mult chain drifts
        # p.scale off Delta (prime-chain drift + bootstrap output scale)
        r = be.sub(p, _align_to(be, y_ct, p.scale, be.level(p)))

        # w - (lr/(m K)) g at exactly Delta, one rescale below g: both
        # products of one plaintext MAC (w's spare levels dropped first)
        a = -self.lr / (self.m * self.sum_gain)
        out = []
        for w, xm in zip(w_cts, xm_cts):
            g = self._slot_sum(be.mul(r, xm))
            out.append(_mac_to(be, [(w, 1.0), (g, a)], be.params.scale,
                               be.level(g) - be.params.scale_words))
        return out

    def _slot_sum(self, ct):
        """Sum over all slots, result broadcast to every slot: log2(slots)
        hoisted rotate-and-add doublings (padding slots hold exact zeros)."""
        be = self.be
        s = 1
        while s < be.params.slots:
            ct = be.add(ct, be.rotate_hoisted(ct, [s])[s])
            s *= 2
        return ct

    # -- full fit -----------------------------------------------------------
    def fit(self, w_cts: list, x_cts: list, y_ct, iters: int):
        """Run `iters` GD steps; returns the final encrypted weights."""
        xm_cts = self.prepare(x_cts)
        for _ in range(iters):
            w_cts = self.step(w_cts, x_cts, xm_cts, y_ct)
        return w_cts

    # -- cleartext mirror ---------------------------------------------------
    def reference(self, w0: np.ndarray, x: np.ndarray, y: np.ndarray,
                  iters: int) -> np.ndarray:
        """Same circuit on cleartext: x is (m, f), y (m,), w0 (f,)."""
        w = np.asarray(w0, dtype=np.float64).copy()
        for _ in range(iters):
            p = sigmoid_poly(x @ w)
            w = w - (self.lr / self.m) * (x.T @ (p - y))
        return w

