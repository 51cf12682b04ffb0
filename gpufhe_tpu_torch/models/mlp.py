"""Encrypted MLP inference (CryptoNets-style square activations).

Evaluates a cleartext multi-layer perceptron on an encrypted input vector
under CKKS: each layer is a BSGS plaintext-matrix x ciphertext product
(ciphertext/linalg.py — hoisted baby rotations, zero diagonals skipped, so a
rectangular (out_dim x in_dim) block embedded in the slots x slots identity
frame costs ~(in+out) diagonals, not slots) followed by a bias add and, on
hidden layers, an activation: the HE-friendly square x -> x^2
(Gilad-Bachrach et al., CryptoNets — 1 level) by default, or any callable
such as the TRUE composite-polynomial ReLU from ciphertext/compare.py
(13 levels per hidden layer at the default composition).

Levels consumed: len(layers) + n_hidden * act_levels. Networks deeper than
the level budget pass `refresh=` (a ciphertext.bootstrap.Bootstrapper): the
forward pass bootstraps mid-inference whenever the next layer would not fit,
so depth is unbounded — the composition the whole framework exists for.

Backend-generic (ciphertext/backend.py). A copy of gpufhe_tpu/models/mlp.py
but for two things. Each layer's plan is built from its (out, in) block
(linalg.BsgsPlan._from_block), not from the slots x slots embedding, which
at N=2^15 is 4.3 GB of host memory per layer and at N=2^16 17.2 GB; the
encoded diagonals are the same. And a square network without a refresh,
entered with a limb to spare, carries its activations `lift` times larger
(`_lift_of`): each baby rotation's key switch ends in a ModDown that rounds
down, about -alpha/2 a coefficient (the reference's too), which the secret
spreads into a fixed error of (alpha/2) (2N/pi) sqrt(2N/3) integer units at
slot 0, 4.6e6 at N = 2^15 and alpha = 3: 1.7e-2 of a slot at Delta = 2^28,
carried into every product by its row of weights and doubled by each square
(logits off by up to 4e-2 on an H100). So the input is multiplied by the
integer `lift` (a plaintext product with no rescale: no level) and each
layer's diagonals are encoded at Delta / sqrt(lift): a layer's input is at
lift Delta, its output at sqrt(lift) Delta, and the square brings it back to
lift Delta. The products, adds, squares and levels are the reference's; the
output equals the same composition of the reference's backend limb for limb
(tests/test_torch_models.py), and the reference's own output where the lift
is 1.
"""

from __future__ import annotations

import math

import numpy as np

from gpufhe_tpu_torch.ciphertext.linalg import BsgsPlan, bsgs_rotations


def mlp_rotations(slots: int) -> list[int]:
    """All Galois rotation steps EncryptedMLP needs (BSGS babies + giants)."""
    return bsgs_rotations(slots)


def mlp_rotations_for(layers, slots: int) -> list[int]:
    """The EXACT rotation steps a specific layer stack uses (linalg
    bsgs_steps over each embedded weight): corner-embedded layers keep only
    ~(in+out)/G of the giants, and every dropped step is a Galois key the
    chest never holds — at N=2^15 the dense set is 254 keys (~4 GB), an
    MNIST-shaped stack ~140."""
    from gpufhe_tpu_torch.ciphertext.linalg import bsgs_steps_from_diags

    steps: set[int] = set()
    for w, _ in layers:
        # nonzero diagonals of the corner embedding, straight from the
        # (out, in) block — never materializes the dense slots x slots map
        # (4.3 GB of host RAM per layer at N=2^15)
        w = np.asarray(w)
        i, j = np.nonzero(w)
        diags = set(((j - i) % slots).tolist())
        steps.update(bsgs_steps_from_diags(diags, slots))
    return sorted(steps)


# the scale a lifted layer's input is carried at, at least: there the slot-0
# error of a baby rotation at N = 2^15 (above) is 6.6e-5 of a slot, and the
# diagonals, at Delta / sqrt(lift) = 2^24 for Delta = 2^28, keep 24 bits
_LIFT_BITS = 36


def _lift_of(scale: float, level: int, levels_used: int) -> int:
    """The lift of a square network without a refresh that uses levels_used
    levels, entered at `level`: the smallest power of four that takes
    `scale` to 2^_LIFT_BITS or more (1 from there on), so that its square
    root, the diagonals' divisor, is a power of two. Each product then holds
    sqrt(lift) times what it holds unlifted. Entered at levels_used + 1, the
    lowest level the forward takes, the last product lies on the two lowest
    limbs (2^58 at N = 2^15, which hold 2^56 |h| unlifted), and a lift would
    take log2 sqrt(lift) bits of that margin: there the lift is 1. One level
    higher, the margin gains a limb's bits."""
    if level <= levels_used + 1:
        return 1
    lift = 1
    while scale * lift < 2.0**_LIFT_BITS:
        lift *= 4
    return lift


def _embed(w: np.ndarray, slots: int) -> np.ndarray:
    """Zero-pad an (out_dim, in_dim) weight block into a slots x slots map
    (the dense route, which the plans no longer take)."""
    out_d, in_d = w.shape
    assert out_d <= slots and in_d <= slots, (w.shape, slots)
    m = np.zeros((slots, slots), dtype=np.complex128)
    m[:out_d, :in_d] = w
    return m


class EncryptedMLP:
    """Cleartext weights, encrypted activations.

    layers: [(W_1, b_1), ..., (W_k, b_k)] with W_i of shape (out_i, in_i),
    in_{i+1} == out_i, all dims <= slots. Input ciphertext packs the feature
    vector in slots [0, in_1) (remaining slots zero). Hidden activations are
    squared; the final layer returns raw affine outputs (logits) in slots
    [0, out_k).
    """

    def __init__(self, be, layers: list[tuple[np.ndarray, np.ndarray]],
                 activation="square", act_levels: int | None = None,
                 refresh=None):
        """activation: "square" (x->x^2, 1 level), or any callable
        (be, ct) -> ct — e.g. a functools.partial over
        ciphertext.compare.relu for true ReLU networks (13 levels with the
        default n_g=1/n_f=2 composition; pass act_levels to match).

        refresh: optional callable(ct) -> ct that restores levels (a
        Bootstrapper). When set, the forward pass refreshes at any layer
        boundary where the remaining budget cannot fit the next
        matmul(+activation), enabling arbitrarily deep circuits."""
        self.be = be
        self.refresh = refresh
        slots = be.params.slots
        dims = None
        self.layers = []
        for w, b in layers:
            w = np.asarray(w, dtype=np.float64)
            b = np.asarray(b, dtype=np.float64)
            assert w.ndim == 2 and b.shape == (w.shape[0],), (w.shape, b.shape)
            if dims is not None:
                assert w.shape[1] == dims, "layer dims must chain"
            dims = w.shape[0]
            bz = np.zeros(slots, dtype=np.complex128)
            bz[: b.size] = b
            self.layers.append((w, bz))
        # a square brings a lifted layer's output back to its input's scale;
        # a refresh takes its input at Delta
        self._lifts = activation == "square" and refresh is None
        self.lift = 1  # the last forward's (_lift_of)
        if activation == "square":
            self.act = lambda be, ct: be.mul(ct, ct)
            self.act_ref = lambda h: h * h
            self.act_levels = 1
        else:
            assert callable(activation) and act_levels is not None
            self.act = activation
            self.act_ref = None  # caller compares against its own reference
            self.act_levels = act_levels
        n_hidden = len(self.layers) - 1
        # limb budget of the whole forward pass: each mult (matmul or
        # activation step) consumes scale_words limbs
        self.levels_used = be.params.scale_words * (
            len(self.layers) + n_hidden * self.act_levels
        )
        self.refreshes = 0  # mid-inference bootstraps in the last forward
        # (layer, level): the level fixes the entry level, and so the lift
        self._plans: dict[tuple[int, int], BsgsPlan] = {}

    def _plan(self, i: int, level: int) -> BsgsPlan:
        plan = self._plans.get((i, level))
        if plan is None:
            plan = BsgsPlan._from_block(self.be, self.layers[i][0], level,
                                        self.be.params.scale / math.sqrt(self.lift))
            self._plans[(i, level)] = plan
        return plan

    def __call__(self, ct_x):
        be = self.be
        floor = be.params.scale_words  # minimum usable level
        if self.refresh is None:
            lvl = be.level(ct_x)
            assert lvl > self.levels_used, (
                f"MLP consumes {self.levels_used} levels; need level > that, "
                f"got {lvl} (pass refresh= to bootstrap mid-inference)"
            )
        self.refreshes = 0
        self.lift = 1
        if self._lifts:
            self.lift = _lift_of(be.params.scale, be.level(ct_x), self.levels_used)
        ct = ct_x
        if self.lift > 1:  # the input times lift, at lift times its scale
            ones = np.ones(be.params.slots, dtype=np.complex128)
            ct = be.mul_plain(ct, be.encode_slots(ones, float(self.lift), be.level(ct)))
        last = len(self.layers) - 1
        for i, (_, bz) in enumerate(self.layers):
            # limb budget for this layer: matmul + activation MULTS, each
            # consuming scale_words limbs (dw: 2 per mult); reserve
            # scale_words MORE so the refresh can align its input scale to
            # exactly Delta first (bootstrap.py: EvalMod decodes garbage
            # from a drifted input scale)
            w = be.params.scale_words
            needed = w * (1 + (self.act_levels if i < last else 0))
            lvl = be.level(ct)
            if lvl - needed < floor + w and self.refresh is not None:
                ct = self.refresh(ct)  # bootstrap: restore the level budget
                self.refreshes += 1
                lvl = be.level(ct)
                assert lvl - needed >= floor, (
                    f"refresh restored level {lvl}, but layer {i} needs "
                    f"{needed} above the floor {floor}"
                )
            ct = self._plan(i, lvl).apply(ct)  # W x, one level
            ct = be.add_plain(ct, bz)
            if i < last:
                ct = self.act(be, ct)
        return ct

    def reference(self, x: np.ndarray, act=None) -> np.ndarray:
        """Cleartext forward of the same circuit. For non-square activations
        pass `act` (e.g. lambda h: np.maximum(h, 0) for ReLU)."""
        act = act if act is not None else self.act_ref
        assert act is not None, "pass act= for a callable activation"
        h = np.asarray(x, dtype=np.float64)
        for i, (w, bz) in enumerate(self.layers):
            h = w @ h + np.real(bz[: w.shape[0]])
            if i < len(self.layers) - 1:
                h = act(h)
        return h
