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
but for one thing: each layer's plan is built from its (out, in) block
(linalg.BsgsPlan._from_block), not from the slots x slots embedding, which
at N=2^15 is 4.3 GB of host memory per layer and at N=2^16 17.2 GB. The
encoded diagonals are the same, so every output equals the reference's limb
for limb (tests/test_torch_models.py).
"""

from __future__ import annotations

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
        self._plans: dict[tuple[int, int], BsgsPlan] = {}  # (layer, level)

    def _plan(self, i: int, level: int) -> BsgsPlan:
        plan = self._plans.get((i, level))
        if plan is None:
            plan = BsgsPlan._from_block(self.be, self.layers[i][0], level)
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
        ct = ct_x
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
