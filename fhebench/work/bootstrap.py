"""The bootstrap's work, from the plan's parameters: the factored-FFT
CoeffToSlot and SlotToCoeff (Han, Hhan, Cheon, CT-RSA 2019; grouped
radix-2^r stages), each stage one double-hoisted rotation fan (Bossuat,
Mouchet, Troncoso-Pastoriza and Hubaux, Eurocrypt 2021), the Chebyshev
EvalMod (baby-step giant-step, Paterson-Stockmeyer style), and the
sparse-secret encapsulation's two key switches around ModRaise (Bossuat,
Troncoso-Pastoriza and Hubaux, ACNS 2022).

Counted per refresh, as a lower bound where the plan leaves a choice:
- ModRaise: the pair to the coefficient domain at the input level, and back
  over the full chain;
- each stage: one ModUp of the input, one inner product per nonzero
  rotation offset (offset 0 needs none), and per output set one ModDown
  with the stage's rescale (CtS's last stage has two output sets);
- CtS's realification: two conjugations (key switches);
- EvalMod, per ciphertext: the Chebyshev basis's products (babies T_2..T_G,
  giants T_2G, T_4G, ... while half of one is below the degree) at the
  levels their depth gives, and one product per internal node of the
  recursion f = q T_m + r, counted at the lowest level one can run (the
  SlotToCoeff input level plus one rescale); the plaintext products, the
  scale alignments and the constant adds are not counted;
- the closing normalisation's rescale.

A stage's rotation offsets are the sums of its butterflies' offsets
{0, +h, -h} mod slots: computed here from slots and radix_log alone.
"""

from __future__ import annotations

import itertools
import math

from fhebench.work import Work


def stage_groups(slots: int, radix_log: int, inverse: bool) -> list[list[int]]:
    """The butterfly half-widths h of each grouped stage, in application
    order: SlotToCoeff's forward stages h = 1, 2, ..., slots/2; CoeffToSlot's
    inverse stages the other way round."""
    hs = [1 << i for i in range(int(math.log2(slots)))]
    if inverse:
        hs = hs[::-1]
    return [hs[i:i + radix_log] for i in range(0, len(hs), radix_log)]


def group_offsets(slots: int, hs: list[int]) -> set[int]:
    return {sum(e * h for e, h in zip(signs, hs)) % slots
            for signs in itertools.product((-1, 0, 1), repeat=len(hs))}


def cheb_products(degree: int, baby_log: int) -> tuple[dict[int, int], int]:
    """(depth of each basis product T_j -> its count, internal recursion
    nodes): T_j = 2 T_a T_b - T_(a-b) with a = ceil(j/2), b = floor(j/2)."""
    g = 1 << baby_log
    depth = {1: 0}

    def get(j):
        if j not in depth:
            depth[j] = max(get((j + 1) // 2), get(j // 2)) + 1
        return depth[j]

    for j in range(2, g + 1):
        get(j)
    m = 2 * g
    while m // 2 < degree:
        get(m)
        m *= 2
    by_depth: dict[int, int] = {}
    for j, dpt in depth.items():
        if j > 1:
            by_depth[dpt - 1] = by_depth.get(dpt - 1, 0) + 1  # runs at its inputs' depth

    def internal(d):
        if d <= g:
            return 0
        m = g
        while 2 * m <= d:
            m *= 2
        return 1 + internal(d - m) + internal(m - 1)

    return by_depth, internal(degree)


def bootstrap(n: int, full: int, alpha: int, words: int, in_level: int, out_level: int,
              radix_log: int, cheb_degree: int, cheb_baby_log: int,
              encapsulation: bool) -> Work:
    w = Work(n)
    slots = n // 2
    if encapsulation:
        w.key_switch(in_level, alpha)  # to the ephemeral sparse secret
    w.ntt(2 * in_level + 2 * full)  # ModRaise
    if encapsulation:
        w.key_switch(full, alpha)  # back to the dense secret

    def fan(level, offsets, sets):
        w.mod_up(level, alpha)
        w.inner_product(level, alpha, times=len(offsets - {0}))
        for _ in range(sets):
            w.mod_down_drop(level, alpha, words, add_pair=False)

    level = full
    cts = stage_groups(slots, radix_log, inverse=True)
    for i, hs in enumerate(cts):
        fan(level, group_offsets(slots, hs), 2 if i == len(cts) - 1 else 1)
        level -= words
    for _ in range(2):  # the conjugations of the realification
        w.key_switch(level, alpha)
    stc = stage_groups(slots, radix_log, inverse=False)
    stc_in = out_level + words + len(stc) * words
    by_depth, internal = cheb_products(cheb_degree, cheb_baby_log)
    for _ in range(2):  # both halves of the coefficients
        for dpt, count in by_depth.items():
            for _ in range(count):
                w.key_switch(level - dpt * words, alpha, drop=words, add_pair=True)
        for _ in range(internal):
            w.key_switch(stc_in + words, alpha, drop=words, add_pair=True)
    fan(stc_in, group_offsets(slots, stc[0]), 1)  # the lo and hi halves
    fan(stc_in, group_offsets(slots, stc[0]), 1)
    level = stc_in - words
    for hs in stc[1:]:
        fan(level, group_offsets(slots, hs), 1)
        level -= words
    w.rescale(out_level + words, words)  # the normalisation to Delta
    return w
