"""Encrypted single-query attention (attention pooling) under CKKS.

The flagship consumer of the function-approximation toolkit
(ciphertext/approx.py): a full attention read-out — projections, scaled
dot-product scores, softmax, weighted value sum — over an ENCRYPTED token
sequence with cleartext head weights. This is the decode-step / pooling form
of attention (one query attends over all T keys); the full T x T self-
attention is T of these with rotated queries.

Packing: token t's d features live in slots [t*d, (t+1)*d) ("blocks"),
T*d <= slots, d and T powers of two. All cross-slot movement is hoisted
Galois rotations; all plaintext matrices are block-structured so their BSGS
diagonal count stays O(d), not O(slots) (same trick as models/cnn.py).

Pipeline (levels, with the defaults):
  1. K = blockdiag(Wk) x, V = blockdiag(Wv) x, q = Wq x_0 / sqrt(d)   [1]
  2. replicate q's block across the vector (log2(slots/d) rotate-adds) [0]
  3. u = q (x) K; intra-block rotate-add tree -> s_t at block starts   [1]
  4. mask to the T used block starts                                   [1]
  5. exp (Chebyshev, degree 7)                                         [~5]
  6. re-mask (exp(0)=1 elsewhere)                                      [1]
  7. stride-d rotate-add tree -> sum_t exp(s_t) in every class-0 slot  [0]
  8. Goldschmidt reciprocal (bound T*e^half_range)                     [2i-1]
  9. w = exp (x) inv; fill each block with its w_t (rotate-add tree)   [1+0]
 10. out = w (x) V; stride-d tree -> attention output in block 0      [1+0]

Every slot stays bounded at every stage by construction (masks before and
after exp; the reciprocal of the zero slots is the bounded Goldschmidt
fixed point 2^iters) — unbounded garbage in ANY slot would corrupt every
slot through the canonical embedding, so this is a correctness invariant,
not a hygiene preference.

Backend-generic (ciphertext/backend.py). A copy of gpufhe_tpu/models/
attention.py; its plans keep the dense slots x slots route, which it runs
at small ring degrees only.
"""

from __future__ import annotations

import numpy as np

from gpufhe_tpu_torch.ciphertext import approx
from gpufhe_tpu_torch.ciphertext.linalg import BsgsPlan, bsgs_rotations
from gpufhe_tpu_torch.ciphertext.polyeval import _align_to


def attention_rotations(slots: int, d: int) -> list[int]:
    """All Galois steps EncryptedAttention needs (union, positive steps)."""
    steps = set(bsgs_rotations(slots))
    blocks = slots // d
    for j in range(int(np.log2(d))):
        steps.add(1 << j)                 # intra-block score sum
        steps.add(slots - (1 << j))       # weight fill (negative)
    for j in range(int(np.log2(blocks))):
        steps.add(d * (1 << j))           # stride-d sums (denominator, out)
        steps.add(slots - d * (1 << j))   # query replication (negative)
    steps.discard(0)
    return sorted(steps)


def _tree(be, ct, steps):
    """ct <- ct + rot(ct, s) for each step (log-depth accumulation)."""
    for s in steps:
        ct = be.add(ct, be.rotate_hoisted(ct, [s])[s])
    return ct


def _blockdiag(w: np.ndarray, slots: int) -> np.ndarray:
    """Tile a (d, d) block down the diagonal of a slots x slots matrix."""
    d = w.shape[0]
    m = np.zeros((slots, slots), dtype=np.complex128)
    for t in range(slots // d):
        m[t * d:(t + 1) * d, t * d:(t + 1) * d] = w
    return m


def _corner(w: np.ndarray, slots: int) -> np.ndarray:
    """Embed a (d, d) block at the top-left of a zero slots x slots matrix."""
    d = w.shape[0]
    m = np.zeros((slots, slots), dtype=np.complex128)
    m[:d, :d] = w
    return m


class EncryptedAttention:
    """One attention head: cleartext (Wq, Wk, Wv[, Wo]) of shape (d, d),
    encrypted sequence of T tokens packed d-per-block. Scores q.k/sqrt(d)
    must land in [-half_range, half_range] (caller's weight/input scaling).
    Output: attention read-out for the query token in slots [0, d)."""

    def __init__(self, be, wq, wk, wv, wo=None, seq_len: int = 8,
                 half_range: float = 1.0, degree: int = 7,
                 inv_iters: int = 5, baby_log: int = 2):
        d = wq.shape[0]
        slots = be.params.slots
        assert wq.shape == wk.shape == wv.shape == (d, d)
        assert d & (d - 1) == 0 and seq_len & (seq_len - 1) == 0
        assert seq_len * d <= slots
        self.be = be
        self.d = d
        self.seq_len = seq_len
        self.half_range = half_range
        self.degree = degree
        self.inv_iters = inv_iters
        self.baby_log = baby_log
        self.wq = np.asarray(wq, dtype=np.float64) / np.sqrt(d)
        self.wk = np.asarray(wk, dtype=np.float64)
        self.wv = np.asarray(wv, dtype=np.float64)
        self.wo = None if wo is None else np.asarray(wo, dtype=np.float64)

        blocks = slots // d
        self.fill_steps = [slots - (1 << j) for j in range(int(np.log2(d)))]
        self.intra_steps = [1 << j for j in range(int(np.log2(d)))]
        self.stride_steps = [d * (1 << j) for j in range(int(np.log2(blocks)))]
        self.qrep_steps = [slots - d * (1 << j)
                           for j in range(int(np.log2(blocks)))]
        starts = np.zeros(slots, dtype=np.complex128)
        starts[np.arange(seq_len) * d] = 1.0
        self._starts = starts

    def _mask_starts(self, ct):
        be = self.be
        pt = be.encode_slots(self._starts, be.params.scale, be.level(ct))
        return be.rescale(be.mul_plain(ct, pt))

    def __call__(self, ct_x):
        be = self.be
        lvl = be.level(ct_x)
        slots = be.params.slots

        k = BsgsPlan(be, _blockdiag(self.wk, slots), None, lvl).apply(ct_x)
        v = BsgsPlan(be, _blockdiag(self.wv, slots), None, lvl).apply(ct_x)
        q = BsgsPlan(be, _corner(self.wq, slots), None, lvl).apply(ct_x)
        q = _tree(be, q, self.qrep_steps)           # q in every block

        u = be.mul(q, k)                            # q_j * k_{t,j} per slot
        s = _tree(be, u, self.intra_steps)          # block starts: q.k_t
        s = self._mask_starts(s)                    # zero everything else

        e = approx.exp(be, s, half_range=self.half_range,
                       degree=self.degree, baby_log=self.baby_log)
        e = self._mask_starts(e)                    # exp(0)=1 garbage -> 0
        denom = _tree(be, e, self.stride_steps)     # sum_t exp(s_t), class 0
        inv = approx.inverse(
            be, denom,
            bound=self.seq_len * float(np.exp(self.half_range)),
            iters=self.inv_iters,
        )
        w = be.mul(_align_to(be, e, inv.scale, inv.level), inv)
        w = _tree(be, w, self.fill_steps)           # block t filled with w_t

        out = be.mul(_align_to(be, v, w.scale, w.level), w)
        out = _tree(be, out, self.stride_steps)     # block 0: sum_t w_t v_t
        if self.wo is not None:
            out = BsgsPlan(
                be, _corner(self.wo, slots), None, be.level(out)
            ).apply(out)
        return out


def attention_reference(x: np.ndarray, wq, wk, wv, wo=None) -> np.ndarray:
    """Cleartext oracle: single-query (token 0) attention read-out."""
    d = x.shape[1]
    q = (wq @ x[0]) / np.sqrt(d)
    scores = (wk @ x.T).T @ q
    w = np.exp(scores) / np.exp(scores).sum()
    out = (wv @ x.T) @ w
    return out if wo is None else wo @ out
