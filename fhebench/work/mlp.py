"""The work of one encrypted MNIST inference (circuits/mlp_forward.py),
counted from the configuration and the circuit as work/__init__.py counts
the multiply.

Each layer is one BSGS product of its (out, in) block embedded at the top
left of the slots x slots matrix (G = isqrt(slots) baby steps; only the
nonzero diagonals r = (k - i) mod slots of the block are formed, and only
the babies and giants they use run, as ciphertext/linalg.py BsgsPlan
prunes them):
- one ModUp of the input for the hoist;
- per baby, one inner product and ModDown (the automorphism is a gather);
- per nonzero diagonal, one plaintext product, and one add into its giant
  group's sum (and one add a group into the output);
- per giant, one whole key switch of the group's sum;
- one rescale of the output.
Each hidden layer's square is a tensor, a relinearisation and a rescale.

Besides the kernels' least times, `least_s()` gives a `"linear"` least time:
what the `linear` spans hold (the three products) and nothing else: their
transforms, conversions and inner products (keys read) as work/__init__.py
counts them, and each plaintext product (the encoded diagonal, the two
components read and written, two modular products a residue) and add (two
pairs read, one written) at 4 B a residue.
"""

from __future__ import annotations

import dataclasses
import math

from fhebench.work import (BYTES_PER_RESIDUE, HBM_BYTES_PER_S, INT_OPS_PER_S,
                           MULADDS_PER_MODMUL, Work)


@dataclasses.dataclass(frozen=True)
class Product:
    """The BSGS product of one corner-embedded (out, in) block."""

    diagonals: int  # nonzero diagonals: plaintext products
    babies: tuple  # hoisted baby steps (nonzero, below G)
    giants: tuple  # giant steps (nonzero multiples of G)
    groups: int  # giant groups with a nonzero diagonal, group 0 included


def product(out_dim: int, in_dim: int, slots: int) -> Product:
    """The pruned plan's counts for a dense (out_dim, in_dim) block."""
    g = max(1, math.isqrt(slots))
    diags = {(k - i) % slots for i in range(out_dim) for k in range(in_dim)}
    babies = sorted({r % g for r in diags} - {0})
    groups = sorted({r // g for r in diags})
    return Product(len(diags), tuple(babies), tuple(gi * g for gi in groups if gi),
                   len(groups))


def products(dims: list, slots: int) -> list[Product]:
    return [product(d_out, d_in, slots) for d_in, d_out in zip(dims, dims[1:])]


@dataclasses.dataclass
class MlpWork(Work):
    """The forward's counted operations; `linear` holds those inside the
    `linear` spans, `plain` their plaintext products and adds as
    (residues read and written, modular products)."""

    linear: Work | None = None
    plain: list = dataclasses.field(default_factory=list)

    def least_s(self) -> dict:
        out = super().least_s()
        kernels = self.linear.least_s()
        total = sum(s for s, _ in kernels.values())
        by_bytes = sum(s for s, bound in kernels.values() if bound == "bytes")
        for residues, modmuls in self.plain:
            t_b = residues * BYTES_PER_RESIDUE / HBM_BYTES_PER_S
            t = max(t_b, 2 * modmuls * MULADDS_PER_MODMUL / INT_OPS_PER_S)
            total += t
            by_bytes += t if t == t_b else 0.0
        out["linear"] = (total, "bytes" if by_bytes >= total / 2 else "products")
        return out


def bsgs(w: Work, p: Product, level: int, alpha: int, words: int) -> None:
    """Add one BSGS product's key switches and rescale at `level` to w."""
    w.mod_up(level, alpha)
    for _ in p.babies:
        w.inner_product(level, alpha)
        w.mod_down_drop(level, alpha, 0, add_pair=False)
    for _ in p.giants:
        w.key_switch(level, alpha)
    w.rescale(level, words)


def plain_ops(p: Product, level: int, n: int) -> list:
    """(residues read and written, modular products) of one BSGS product's
    plaintext products (the diagonal and a pair read, a pair written) and
    adds (two pairs read, one written): one add fewer than products, the
    group sums and the output's sum of the groups together."""
    return ([(5 * level * n, 2 * level * n)] * p.diagonals
            + [(6 * level * n, 0)] * (p.diagonals - 1))


def mlp_forward(n: int, dims: list, level: int, alpha: int, words: int) -> MlpWork:
    """One forward of the network dims from `level`."""
    whole, linear, plain = MlpWork(n), Work(n), []
    layers = products(dims, n // 2)
    for i, p in enumerate(layers):
        for w in (whole, linear):
            bsgs(w, p, level, alpha, words)
        plain += plain_ops(p, level, n)
        level -= words
        if i < len(layers) - 1:
            whole.key_switch(level, alpha, drop=words, add_pair=True)
            level -= words
    whole.linear, whole.plain = linear, plain
    return whole
