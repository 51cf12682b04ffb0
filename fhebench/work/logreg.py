"""The work of one step of encrypted logistic-regression training
(circuits/logreg_step.py), counted from the configuration and the circuit
as work/__init__.py counts the multiply: its key switches (ModUp, inner
product, ModDown) and its rescales' transforms. Plaintext products and
additions are elementwise work, which is not counted.

One step from level L (w = scale_words, f features, S = log2(slots)):
- z = sum_j w_j x_j: f multiplies at L;
- z^2 at L - w, beside c3 z (a plaintext product and its rescale at
  L - w); c3 z^3 = z^2 (c3 z) at L - 2w;
- c1 z and y brought to L - 3w: a plaintext product and its rescale each
  at L - 2w;
- r xm_j: f multiplies at L - 3w;
- each SlotSum at L - 4w: S rotations, each a whole key switch (one step
  a hoist, so the ModUp is not shared);
- each update w_j - (lr/m) g_j: one plaintext MAC and its rescale at L - 4w.
"""

from __future__ import annotations

import dataclasses

from fhebench.work import Work


@dataclasses.dataclass
class PoolWork(Work):
    """The counted operations of a cycle through the pool, read per request:
    the least times are the cycle's over its number of requests."""

    requests: int = 1

    def least_s(self) -> dict:
        return {k: (s / self.requests, bound) for k, (s, bound) in super().least_s().items()}


def logreg_step(w: Work, level: int, alpha: int, words: int, features: int,
                rotations: int) -> None:
    """Add one step from `level` to w."""
    for _ in range(features):
        w.key_switch(level, alpha, drop=words, add_pair=True)
    w.key_switch(level - words, alpha, drop=words, add_pair=True)
    w.rescale(level - words, words)
    w.key_switch(level - 2 * words, alpha, drop=words, add_pair=True)
    w.rescale(level - 2 * words, words)
    w.rescale(level - 2 * words, words)
    for _ in range(features):
        w.key_switch(level - 3 * words, alpha, drop=words, add_pair=True)
    for _ in range(features * rotations):
        w.key_switch(level - 4 * words, alpha)
    for _ in range(features):
        w.rescale(level - 4 * words, words)


def logreg_pool(n: int, levels: list, alpha: int, words: int, features: int,
                rotations: int) -> PoolWork:
    """One step from each of the pool's entry levels, read per request."""
    w = PoolWork(n, requests=len(levels))
    for level in levels:
        logreg_step(w, level, alpha, words, features, rotations)
    return w
