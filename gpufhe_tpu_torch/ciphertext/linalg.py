"""Homomorphic linear algebra: BSGS plaintext-matrix x ciphertext products.

The slot-space matrix product (Mz)[j] = sum_r diag_r(M)[j] * rot_r(z)[j] is
evaluated baby-step/giant-step: G baby rotations of the input (hoisted — ONE
decomposition for all of them, ciphertext/ct.py ct_rotate_hoisted) and
ceil(slots/G) giant rotations of partial sums:

    M z = sum_g rot_{gG}( sum_b rot_{-gG}(diag_{gG+b}(M)) * rot_b(z) )

Matrices with a conjugate part (out = A z + B conj(z), as in CoeffToSlot)
share the baby rotations of conj(z). Consumes one level (the final rescale).

On a backend with baby_sums (the port's DeviceBackend) each giant group's
inner sum is one pass over its stacked diagonals, and the babies' key
switches finish in one batch (ct.py ct_baby_sums); on the others it is one
mul_plain and one add a diagonal. Both give the same limbs.

Backend-generic (ciphertext/backend.py). A copy of gpufhe_tpu/ciphertext/
linalg.py, which imports only numpy: the port keeps its own so that it
imports nothing of gpufhe_tpu. The port's DeviceBackend runs it on the card
(or on the CPU), limb-equal to the reference's backends
(tests/test_torch_fan.py).
"""

from __future__ import annotations

import math

import numpy as np

from gpufhe_tpu_torch.utils.profiling import stage


def bsgs_rotations(slots: int) -> list[int]:
    """All rotation steps a dense BSGS matmul needs (babies + giants)."""
    g = max(1, math.isqrt(slots))
    babies = list(range(1, g))
    giants = [k * g for k in range(1, math.ceil(slots / g))]
    return sorted(set(babies + giants))


def nonzero_diags(m: np.ndarray) -> set[int]:
    """The set of r with diag_r(m) not identically zero.

    Entry (i, j) lies on diagonal r = (j - i) mod n, so this is one
    np.nonzero over the matrix — no per-diagonal gathers."""
    i, j = np.nonzero(m)
    return set(((j - i) % m.shape[0]).tolist())


def bsgs_steps_from_diags(diags: set[int], n_s: int) -> list[int]:
    """Rotation steps BsgsPlan.apply uses, from the nonzero-diagonal set.

    Mirrors the plan's pruning exactly (tests/test_models.py asserts the
    equivalence against BsgsPlan.pt): babies are the bi with a nonzero
    diagonal in ANY giant group, giants the gi*G with any nonzero
    diagonal."""
    g = max(1, math.isqrt(n_s))
    babies: set[int] = set()
    giants: set[int] = set()
    for gi in range(math.ceil(n_s / g)):
        any_nz = False
        for bi in range(g):
            r = gi * g + bi
            if r >= n_s:
                break
            if r in diags:
                any_nz = True
                if bi:
                    babies.add(bi)
        if any_nz and gi:
            giants.add(gi * g)
    return sorted(babies | giants)


def bsgs_steps(a: np.ndarray, b: np.ndarray | None = None) -> list[int]:
    """EXACTLY the rotation steps BsgsPlan(a, b).apply will use.

    For block-structured matrices (models/: corner- or block-diagonal-
    embedded layers) this is FAR smaller than the dense bsgs_rotations set —
    an MNIST layer (784 in) keeps ~8 of 127 giants, and every dropped step
    is a Galois key (2 * dnum * (k+alpha) * N words of device memory) the chest
    never has to hold."""
    n_s = a.shape[0]
    assert a.shape == (n_s, n_s)
    diags = nonzero_diags(a)
    if b is not None:
        diags |= nonzero_diags(b)
    return bsgs_steps_from_diags(diags, n_s)


def pow2_rotations(slots: int) -> list[int]:
    """Power-of-two step set: rotate by ANY amount via rotate_composed with
    only log2(slots) Galois keys (vs one key per distinct step)."""
    out = []
    s = 1
    while s < slots:
        out.append(s)
        s *= 2
    return out


def rotate_composed(be, ct, steps: int):
    """Rotate by an arbitrary step count using only power-of-two keys.

    Binary-decomposes `steps` (mod slots) into at most log2(slots)
    single-key rotations — the standard key-storage/latency trade against
    holding a key per step. Uses the backend's one-shot rotate where it has
    one (the integer backends), as the reference does: a one-shot and a
    hoisted rotation agree only up to multiples of Q in their limbs."""

    def rot1(c, s):
        if hasattr(be, "rotate"):
            return be.rotate(c, s)
        return be.rotate_hoisted(c, [s])[s]

    n_s = be.params.slots
    steps %= n_s
    s = 1
    while steps:
        if steps & 1:
            ct = rot1(ct, s)
        steps >>= 1
        s *= 2
    return ct


def _diag(m: np.ndarray, r: int) -> np.ndarray:
    n = m.shape[0]
    j = np.arange(n)
    return m[j, (j + r) % n]


class BsgsPlan:
    """Precomputed (rotated, encoded) diagonals of A (+ optional conj-part B)."""

    def __init__(self, be, a: np.ndarray, b: np.ndarray | None, level: int,
                 scale: float | None = None):
        n_s = be.params.slots
        assert a.shape == (n_s, n_s)
        self._setup(be, b is not None, level, scale)
        mats = ((a, False), (b, True)) if self.has_conj else ((a, False),)
        self._encode([(lambda r, m=mat: _diag(m, r), is_conj) for mat, is_conj in mats])

    @classmethod
    def _from_block(cls, be, w: np.ndarray, level: int, scale: float | None = None):
        """The plan of an (out, in) block w embedded at the top-left corner of
        a zero slots x slots matrix, built from the block: diagonal r holds
        w[j, (j + r) mod slots] at the rows j whose column falls inside the
        block, and only the r = (k - i) mod slots of w's nonzero entries are
        formed. No slots x slots matrix is built (at N=2^15 it would be 4.3 GB
        of host memory per layer); the encoded diagonals are the dense
        route's, handle for handle."""
        n_s = be.params.slots
        w = np.asarray(w, dtype=np.complex128)
        out_d, in_d = w.shape
        assert out_d <= n_s and in_d <= n_s, (w.shape, n_s)
        plan = cls.__new__(cls)
        plan._setup(be, False, level, scale)
        i, k = np.nonzero(w)
        diags = set(((k - i) % n_s).tolist())
        rows = np.arange(out_d)

        def diag(r):
            if r not in diags:
                return None
            cols = (rows + r) % n_s
            inside = cols < in_d
            d = np.zeros(n_s, dtype=np.complex128)
            d[rows[inside]] = w[rows[inside], cols[inside]]
            return d

        plan._encode([(diag, False)])
        return plan

    def _setup(self, be, has_conj: bool, level: int, scale: float | None):
        self.be = be
        n_s = be.params.slots
        self.g = max(1, math.isqrt(n_s))
        self.n_giant = math.ceil(n_s / self.g)
        self.has_conj = has_conj
        self.level = level
        self.scale = scale if scale is not None else be.params.scale

    def _encode(self, diag_fns):
        """Encode rot_{-gG}(diag_r) for every nonzero diagonal r = gG + b of
        each (diag_fn, is_conj): diag_fn(r) is diagonal r, or None where it
        is known to be zero."""
        n_s = self.be.params.slots
        j = np.arange(n_s)
        self.pt = {}  # (g_idx, b_idx, is_conj) -> encoded diagonal
        for gi in range(self.n_giant):
            for bi in range(self.g):
                r = gi * self.g + bi
                if r >= n_s:
                    break
                for diag_fn, is_conj in diag_fns:
                    dr = diag_fn(r)
                    if dr is None:
                        continue
                    d = dr[(j - gi * self.g) % n_s]  # rot_{-gG}(diag_r)
                    if np.abs(d).max() == 0.0:
                        continue
                    self.pt[(gi, bi, is_conj)] = self.be.encode_slots(d, self.scale, self.level)
        self._group()

    def _group(self):
        """Where the backend sums a giant group's products in one pass
        (DeviceBackend.plain_group and baby_sums), stack each group's
        diagonals once: self.groups[is_conj] = (babies, [(g_idx, group)]).
        Other backends take the products one by one (self.groups None)."""
        self.groups = None
        if not hasattr(self.be, "baby_sums"):
            return
        self.groups = {}
        for is_conj in (False, True) if self.has_conj else (False,):
            babies = sorted({bi for (_, bi, c) in self.pt if c == is_conj} - {0})
            pos = {b: i for i, b in enumerate([0] + babies)}
            groups = []
            for gi in range(self.n_giant):
                keys = [k for k in ((gi, bi, is_conj) for bi in range(self.g)) if k in self.pt]
                if keys:
                    grp, views = self.be.plain_group([self.pt[k] for k in keys],
                                                     [pos[k[1]] for k in keys])
                    self.pt.update(zip(keys, views))
                    groups.append((gi, grp))
            if groups:
                self.groups[is_conj] = (babies, groups)

    def apply(self, ct):
        """M z at the plan's level, rescaled once. Span `linear` around the
        whole product: the hoists, the plaintext products and adds, the giant
        rotations and the rescale (their `galois`, `ks.*` and `rescale` spans
        nest inside)."""
        with stage("linear"):
            return self._apply(ct)

    def _apply(self, ct):
        be = self.be
        assert be.level(ct) == self.level, (be.level(ct), self.level)
        sums = self._products(ct) if self.groups is None else self._group_sums(ct)
        out = None
        for gi, acc in sums:
            if gi > 0:
                acc = be.rotate_hoisted(acc, [gi * self.g])[gi * self.g]
            out = acc if out is None else be.add(out, acc)
        return be.rescale(out)

    def _group_sums(self, ct):
        """[(g_idx, sum_b diag * rot_b(z))]: each group's products in one
        pass of the backend (baby_sums), the conjugate part's added."""
        be = self.be
        sums = {}
        for is_conj, (babies, groups) in self.groups.items():
            src = be.conjugate(ct) if is_conj else ct
            for (gi, _), s in zip(groups, be.baby_sums(src, babies, [g for _, g in groups])):
                sums[gi] = s if gi not in sums else be.add(sums[gi], s)
        return sorted(sums.items())

    def _products(self, ct):
        """The same sums, one plaintext product and one add a diagonal."""
        be = self.be
        # hoist only the babies a nonzero diagonal actually uses: block-
        # structured matrices (models/mlp.py, cnn.py, attention.py) keep
        # O(block) of the slots diagonals, so this is the difference between
        # O(block) and O(sqrt(slots)) rotations per product
        babies = sorted({bi for (_, bi, _) in self.pt} - {0})
        rots = {0: ct}
        if babies:
            rots.update(be.rotate_hoisted(ct, babies))
        rots_c = None
        if self.has_conj:
            babies_c = sorted({bi for (_, bi, c) in self.pt if c} - {0})
            ctc = be.conjugate(ct)
            rots_c = {0: ctc}
            if babies_c:
                rots_c.update(be.rotate_hoisted(ctc, babies_c))

        sums = []
        for gi in range(self.n_giant):
            acc = None
            for bi in range(self.g):
                for is_conj in (False, True) if self.has_conj else (False,):
                    pt = self.pt.get((gi, bi, is_conj))
                    if pt is None:
                        continue
                    src = rots_c[bi] if is_conj else rots[bi]
                    term = be.mul_plain(src, pt)
                    acc = term if acc is None else be.add(acc, term)
            if acc is not None:
                sums.append((gi, acc))
        return sums


def matmul_plain(be, ct, a: np.ndarray, b: np.ndarray | None = None,
                 scale: float | None = None):
    """One-shot BSGS product (builds the plan at ct's level and applies it)."""
    return BsgsPlan(be, a, b, be.level(ct), scale).apply(ct)


# -- encrypted x encrypted matrix multiplication (JKLS) ----------------------
#
# Jiang-Kim-Lauter-Song (CCS 2018) slot-packed matrix product:
#     A @ B = sum_{k=0}^{d-1} phi^k(sigma(A)) (*) psi^k(tau(B))
# with sigma(A)[i,j] = A[i, i+j], tau(B)[i,j] = B[i+j, j], phi^k a column
# shift (two masked slot rotations), psi^k a row shift (one slot rotation
# by d*k). O(d) rotations + d ct-ct multiplies, 3 levels deep — vs the
# naive d^2 inner products. Both operands ENCRYPTED (BsgsPlan handles the
# cleartext-weight case). Matrices are packed row-major in d^2 slots and
# TILED slots/d^2 times so every slot rotation acts cyclically within each
# tile (`pack_matrix`). The reference has no linear algebra of any kind
# (SURVEY.md §2.4).


def _perm_matrix(d: int, out_idx) -> np.ndarray:
    """d^2 x d^2 permutation: out[p] = in[out_idx(i, j)] for p = i*d + j."""
    n = d * d
    u = np.zeros((n, n), dtype=np.complex128)
    for i in range(d):
        for j in range(d):
            u[i * d + j, out_idx(i, j)] = 1.0
    return u


def _tile_blockdiag(u: np.ndarray, slots: int) -> np.ndarray:
    """Tile a d^2 x d^2 block down the diagonal of a slots x slots matrix."""
    n = u.shape[0]
    m = np.zeros((slots, slots), dtype=np.complex128)
    for t in range(slots // n):
        m[t * n:(t + 1) * n, t * n:(t + 1) * n] = u
    return m


def pack_matrix(a: np.ndarray, slots: int) -> np.ndarray:
    """Row-major d^2 packing of a (d, d) matrix, tiled to fill the slots."""
    d = a.shape[0]
    assert a.shape == (d, d) and slots % (d * d) == 0
    return np.tile(np.asarray(a, dtype=np.complex128).reshape(-1),
                   slots // (d * d))


def ct_matmul_rotations(slots: int, d: int) -> list[int]:
    """All Galois steps ct_matmul needs (sigma/tau BSGS babies + shifts)."""
    steps = set(bsgs_rotations(slots))
    for k in range(1, d):
        steps.add(k)                    # phi^k right part
        steps.add(slots - (d - k))      # phi^k wrap part (negative d-k)
        steps.add(d * k)                # psi^k
    return sorted(steps)


class CtMatmulPlan:
    """Precomputed sigma/tau BSGS plans + phi masks for d x d ct-ct products
    at a fixed input level. Consumes 3 levels (sigma/tau, masks, multiply)."""

    def __init__(self, be, d: int, level: int):
        slots = be.params.slots
        assert slots % (d * d) == 0, (slots, d)
        self.be = be
        self.d = d
        self.level = level
        sigma = _perm_matrix(d, lambda i, j: i * d + (i + j) % d)
        tau = _perm_matrix(d, lambda i, j: ((i + j) % d) * d + j)
        self.p_sigma = BsgsPlan(be, _tile_blockdiag(sigma, slots), None, level)
        self.p_tau = BsgsPlan(be, _tile_blockdiag(tau, slots), None, level)
        # phi^k masks on the packed layout: slot p takes rot_k when its
        # column j = p mod d is < d - k, else rot_{k-d} (cyclic wrap).
        # Encoded lazily at sigma's OUTPUT level (rescale width varies with
        # scale_words); the backend const cache makes repeats free.
        j = np.arange(slots) % d
        self._hi = {k: (j < d - k).astype(np.complex128) for k in range(1, d)}

    def __call__(self, ct_a, ct_b):
        be, d = self.be, self.d
        slots = be.params.slots
        from gpufhe_tpu_torch.ciphertext.polyeval import _align_to

        a0 = self.p_sigma.apply(ct_a)
        b0 = self.p_tau.apply(ct_b)

        # one hoisted fan each for ALL shifts of a0 and b0
        a_steps = sorted({s for k in range(1, d)
                          for s in (k, slots - (d - k))})
        b_steps = [d * k for k in range(1, d)]
        rot_a = be.rotate_hoisted(a0, a_steps) if a_steps else {}
        rot_b = be.rotate_hoisted(b0, b_steps) if b_steps else {}

        acc = None
        lvl0 = be.level(a0)
        ones = be.encode_slots(np.ones(slots, dtype=np.complex128),
                               be.params.scale, lvl0)
        for k in range(d):
            if k == 0:
                ak = be.rescale(be.mul_plain(a0, ones))
            else:
                hi = be.encode_slots(self._hi[k], be.params.scale, lvl0)
                lo = be.encode_slots(1.0 - self._hi[k], be.params.scale, lvl0)
                ak = be.rescale(be.add(
                    be.mul_plain(rot_a[k], hi),
                    be.mul_plain(rot_a[slots - (d - k)], lo),
                ))
            bk = b0 if k == 0 else rot_b[d * k]
            term = be.mul(_align_to(be, bk, ak.scale, ak.level), ak)
            acc = term if acc is None else be.add(acc, term)
        return acc


def ct_matmul(be, ct_a, ct_b, d: int):
    """One-shot encrypted (d, d) @ (d, d) product (plan built at the cts'
    level). Inputs packed with pack_matrix; output in the same layout."""
    lvl = min(be.level(ct_a), be.level(ct_b))
    return CtMatmulPlan(be, d, lvl)(
        be.drop_to_level(ct_a, lvl), be.drop_to_level(ct_b, lvl))
