"""Encrypted transformer block (decode-step form) under CKKS.

Composes the framework's encrypted-ML layers into the canonical transformer
unit for the query token: single-query attention read-out
(models/attention.py), residual adds, block LayerNorm
(ciphertext/approx.py layer_norm), and a square-activation feed-forward
network over BSGS corner matrices (ciphertext/linalg.py):

    h   = LayerNorm(x_0 + Attention(x))          # post-norm convention
    out = LayerNorm(h + W2 (W1 h + b1)^2 + b2)

Packing matches EncryptedAttention: token t's d features in slots
[t*d, (t+1)*d). The attention output projection Wo zeroes every slot
outside block 0 exactly (corner BSGS matrix), so the residual and both
LayerNorms act on the query block; other blocks stay bounded (tokens,
then per-block-normalized values) — the all-slots boundedness invariant
encrypted CKKS circuits require.

Level budget (defaults): ~21 (attention) + 1 (residual align) +
layer_norm_levels(ln_iters) twice + 3 (FFN) ≈ 55 — deep-chain presets
(ci_xf) or a bootstrap-refresh wrapper. Backend-generic. A copy of
gpufhe_tpu/models/transformer.py (dense plans, as attention.py).
"""

from __future__ import annotations

import numpy as np

from gpufhe_tpu_torch.ciphertext import approx
from gpufhe_tpu_torch.ciphertext.linalg import BsgsPlan
from gpufhe_tpu_torch.ciphertext.polyeval import _align_to
from gpufhe_tpu_torch.models.attention import (
    EncryptedAttention,
    attention_reference,
    attention_rotations,
)


def transformer_rotations(slots: int, d: int) -> list[int]:
    """All Galois steps the block needs (attention's set covers LN + FFN)."""
    steps = set(attention_rotations(slots, d))
    steps.update(approx.rotations_for_layernorm(slots, d))
    return sorted(steps)


def _rect(w: np.ndarray, slots: int) -> np.ndarray:
    """Embed a rectangular (out_d, in_d) block at the top-left corner."""
    out_d, in_d = w.shape
    m = np.zeros((slots, slots), dtype=np.complex128)
    m[:out_d, :in_d] = w
    return m


class EncryptedTransformerBlock:
    """One post-norm transformer block for the query token (block 0).

    Cleartext parameters: attention head (wq, wk, wv, wo) of shape (d, d);
    FFN (w1 (hidden, d), b1, w2 (d, hidden), b2); LayerNorm affine
    (gamma1, beta1, gamma2, beta2) length-d. Activation is the HE-native
    square. `ln_var_bound` bounds Var + eps for the rsqrt (size it from
    cleartext calibration data, like `half_range` for the scores).
    """

    def __init__(self, be, attn_weights, ffn_weights, ln_weights=None,
                 seq_len: int = 8, half_range: float = 1.0,
                 degree: int = 7, inv_iters: int = 5, baby_log: int = 2,
                 ln_eps: float = 5e-2, ln_iters: int = 6,
                 ln_var_bound: float = 2.0):
        wq, wk, wv, wo = attn_weights
        w1, b1, w2, b2 = ffn_weights
        d = wq.shape[0]
        hidden = w1.shape[0]
        slots = be.params.slots
        assert w1.shape == (hidden, d) and w2.shape == (d, hidden)
        assert hidden <= slots
        self.be = be
        self.d = d
        self.head = EncryptedAttention(
            be, wq, wk, wv, wo=wo, seq_len=seq_len, half_range=half_range,
            degree=degree, inv_iters=inv_iters, baby_log=baby_log,
        )
        self.w1 = np.asarray(w1, dtype=np.float64)
        self.w2 = np.asarray(w2, dtype=np.float64)
        self.b1 = np.asarray(b1, dtype=np.float64)
        self.b2 = np.asarray(b2, dtype=np.float64)
        if ln_weights is None:
            ln_weights = (np.ones(d), np.zeros(d), np.ones(d), np.zeros(d))
        self.g1, self.be1, self.g2, self.be2 = (
            np.asarray(v, dtype=np.float64) for v in ln_weights)
        self.ln_eps = ln_eps
        self.ln_iters = ln_iters
        self.ln_var_bound = ln_var_bound
        self._plans: dict[tuple[str, int], BsgsPlan] = {}

    def _plan(self, name: str, w: np.ndarray, level: int) -> BsgsPlan:
        plan = self._plans.get((name, level))
        if plan is None:
            plan = BsgsPlan(self.be, _rect(w, self.be.params.slots), None,
                            level)
            self._plans[(name, level)] = plan
        return plan

    def _pad_block(self, v: np.ndarray) -> np.ndarray:
        z = np.zeros(self.be.params.slots, dtype=np.complex128)
        z[: v.size] = v
        return z

    def _ln(self, ct, gamma, beta):
        return approx.layer_norm(
            self.be, ct, self.d, eps=self.ln_eps, gamma=gamma, beta=beta,
            var_bound=self.ln_var_bound, iters=self.ln_iters,
        )

    def __call__(self, ct_x):
        be = self.be
        y = self.head(ct_x)                       # block 0; rest exactly 0
        x0 = _align_to(be, ct_x, y.scale, y.level)
        h = self._ln(be.add(x0, y), self.g1, self.be1)

        f = self._plan("w1", self.w1, be.level(h)).apply(h)
        f = be.add_plain(f, self._pad_block(self.b1))
        f = be.mul(f, f)                          # square activation
        f = self._plan("w2", self.w2, be.level(f)).apply(f)
        f = be.add_plain(f, self._pad_block(self.b2))

        h2 = be.add(_align_to(be, h, f.scale, f.level), f)
        return self._ln(h2, self.g2, self.be2)

    def reference(self, x: np.ndarray) -> np.ndarray:
        """Cleartext oracle for the query token's d outputs. Note: mirrors
        the circuit's packing — non-block-0 blocks of the first residual are
        other tokens, which the corner FFN matrices ignore, so token 0's
        path is exactly this d-vector computation."""
        d = self.d
        attn = attention_reference(
            x, self.head.wq * np.sqrt(d), self.head.wk, self.head.wv,
            wo=self.head.wo,
        )
        h = _ln_ref(x[0] + attn, self.g1, self.be1, self.ln_eps)
        f = self.w2 @ (self.w1 @ h + self.b1) ** 2 + self.b2
        return _ln_ref(h + f, self.g2, self.be2, self.ln_eps)


def _ln_ref(v: np.ndarray, gamma, beta, eps: float) -> np.ndarray:
    mean = v.mean()
    var = ((v - mean) ** 2).mean()
    return gamma * (v - mean) / np.sqrt(var + eps) + beta
