"""Security accounting: estimator-backed modulus budgets per ring degree
and secret hamming weight.

A copy of gpufhe_tpu/utils/security.py that reads the port's own copy of
the table, gpufhe_tpu_torch/params/security_table.json (byte-equal to the
reference's), and takes the port's CKKSParams.

Backend: params/security_table.json, generated offline by
scripts/gen_security_table.py — a self-contained core-SVP lattice estimator
(primal uSVP with Bai-Galbraith rebalancing, ADPS16 success condition,
0.292*beta + 16.4 + log2(8d) classical sieving cost; sparse secrets via the
drop-and-solve guess hybrid), CALIBRATED to the HE-standard v1.1 dense
ternary row (anchor N=2^15 logQP=881 == 128 bits; shift -0.2 bits, dense
residuals within +-0.5 bits for N >= 4096 — see the JSON's calibration
block). Queries interpolate WITHIN estimator grid points (log-linear in h),
never between literature anchors (VERDICT r3 item 7; replaces the round-2/3
interpolation of published sparse caps).

Scope of the estimator — and why a second bound exists: the implemented
sparse-secret attack is drop-and-solve only. The MITM/hybrid family
(Howgrave-Graham; Cheon-Hhan-Hong-Son; the SparseLWE-estimator line) is
STRONGER for very sparse secrets at large N — published hybrid-attack caps
at N=2^16 (h=192 -> logQP ~1546, h=128 -> ~1425, h=64 -> ~1300; the
Lattigo bootstrapping parameter family) sit well below the drop-and-solve
caps there. Sparse budgets therefore take the elementwise MIN of the
estimator table and those literature caps (log-linearly interpolated in h,
ratio-scaled across N, exactly the round-2/3 model) — conservative against
both models. Dense budgets come purely from the calibrated estimator.

The clean production answer remains sparse-secret ENCAPSULATION
(params.eph_hamming_weight, Bossuat et al.): the chain stays under a dense
secret (dense row applies) and the ephemeral sparse key only ever exists at
the base modulus Q0, where even tiny h clears 128 bits by a wide margin.

CI/bench presets intentionally run shallower chains at small N — call
`check(params)` before deploying a parameter set for real data.
"""

from __future__ import annotations

import functools
import json
import math
import os

from gpufhe_tpu_torch.params.params import CKKSParams

_TABLE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "params",
    "security_table.json",
)

# HE-standard v1.1 published dense-ternary max log2(QP) rows (classical),
# [128, 192, 256] bits. The calibrated estimator runs up to +3.4 bits
# OPTIMISTIC at small N (table's calibration.dense_residuals), so dense
# budgets take the elementwise MIN of the estimator column and this
# published row — residuals can then only make us conservative. N=2^16 is
# the standard's doubling extrapolation (the Lattigo/OpenFHE convention),
# same row gen_security_table.py anchors against.
_HE_STD_DENSE = {
    1024: (27.0, 19.0, 14.0),
    2048: (54.0, 37.0, 29.0),
    4096: (109.0, 75.0, 58.0),
    8192: (218.0, 152.0, 118.0),
    16384: (438.0, 305.0, 237.0),
    32768: (881.0, 611.0, 476.0),
    65536: (1772.0, 1229.0, 954.0),
}


@functools.lru_cache(maxsize=1)
def _table() -> dict:
    with open(_TABLE_PATH) as f:
        return json.load(f)


def log_qp(params: CKKSParams) -> float:
    return math.log2(params.big_q * params.big_p)


def _caps_for(n: int, h: int) -> tuple[float, float, float] | None:
    """Estimator caps [logQP@128, @192, @256] for ring degree n and secret
    weight h (0 = dense ternary), log-linear in h within the table grid."""
    row = _table()["caps"].get(str(n))
    if row is None:
        return None
    dense_row = _dense_caps(n, row)
    if not h:
        return dense_row
    grid = sorted(int(k) for k in row if k != "dense")
    if h <= grid[0]:
        # below the sparsest estimator point: scale its cap down linearly
        # in log2 h (conservative; the table's own h=16 point is already
        # far below any production weight)
        lo = row[str(grid[0])]
        f = math.log2(max(h, 2)) / math.log2(grid[0])
        return tuple(c * f for c in lo)
    # dense ternary has expected weight 2n/3: treat it as the top anchor
    h_dense = 2 * n / 3
    anchors = [(g, row[str(g)]) for g in grid if g < h_dense]
    anchors.append((h_dense, dense_row))
    if h >= h_dense:
        return dense_row
    for (h0, c0), (h1, c1) in zip(anchors, anchors[1:]):
        if h0 <= h <= h1:
            t = (math.log2(h) - math.log2(h0)) / (math.log2(h1) - math.log2(h0))
            return tuple(a + t * (b - a) for a, b in zip(c0, c1))
    return dense_row


def _dense_caps(n: int, row: dict) -> tuple[float, float, float]:
    """Estimator dense caps floored elementwise by the published HE-standard
    v1.1 row (module doc: the estimator's small-N residuals are optimistic,
    so the published table governs wherever it is stricter)."""
    est = row["dense"]
    std = _HE_STD_DENSE.get(n)
    if std is None:
        return tuple(est)
    return tuple(min(float(a), float(b)) for a, b in zip(est, std))


# published hybrid-attack 128-bit caps at N=2^16 (see module doc): the
# literature bound the estimator's drop-and-solve model cannot reproduce
_LIT_SPARSE_128_CAP_N16 = {64: 1300.0, 128: 1425.0, 192: 1546.0}


def _literature_sparse_ratio(h: int) -> float:
    """Fraction of the dense logQP budget the published hybrid-attack caps
    leave a weight-h ternary secret (anchored at N=2^16, log-linear in
    log2 h, clamped; the round-2/3 model, now used only as a CAP)."""
    anchors = sorted(_LIT_SPARSE_128_CAP_N16.items())
    dense = float(_dense_caps(65536, _table()["caps"]["65536"])[0])
    if h <= anchors[0][0]:
        return (anchors[0][1] / dense) * (
            math.log2(max(h, 2)) / math.log2(anchors[0][0])
        )
    if h >= anchors[-1][0]:
        return anchors[-1][1] / dense
    for (h0, c0), (h1, c1) in zip(anchors, anchors[1:]):
        if h0 <= h <= h1:
            t = (math.log2(h) - math.log2(h0)) / (math.log2(h1) - math.log2(h0))
            return (c0 + t * (c1 - c0)) / dense
    return anchors[0][1] / dense


def max_log_qp(params: CKKSParams, bits_idx: int) -> float:
    """h-adjusted budget for the standard level at bits_idx (0=128, 1=192,
    2=256): estimator table, min'd for sparse secrets with the literature
    hybrid-attack cap (module doc)."""
    h = params.hamming_weight
    caps = _caps_for(params.n, h)
    if caps is None:
        return 0.0
    cap = float(caps[bits_idx])
    if h:
        dense = _caps_for(params.n, 0)
        cap = min(cap, float(dense[bits_idx]) * _literature_sparse_ratio(h))
    return cap


def security_level(params: CKKSParams) -> int:
    """Largest standard level (128/192/256) the modulus budget satisfies,
    with the sparse-secret penalty applied when the BASE secret is sparse.
    An ephemeral encapsulation key (eph_hamming_weight) does not penalize
    the chain — it only exists at the base modulus (see module doc).
    Returns 0 if the chain exceeds the (adjusted) 128-bit budget."""
    if str(params.n) not in _table()["caps"]:
        return 0  # below-table ring degrees are toy/CI sizes
    budget = log_qp(params)
    for bits, idx in ((256, 2), (192, 1), (128, 0)):
        if budget <= max_log_qp(params, idx):
            return bits
    return 0


def check(params: CKKSParams, min_bits: int = 128) -> None:
    """Raise if the parameter set does not reach min_bits classical security."""
    lvl = security_level(params)
    if lvl < min_bits:
        raise ValueError(
            f"params N={params.n} log2(QP)={log_qp(params):.0f} reach only "
            f"{lvl}-bit security (< {min_bits}); shrink the prime chain or "
            f"raise N (estimator table, utils/security.py)"
        )


def report(params: CKKSParams) -> dict:
    t = _table()
    cal = t.get("calibration", {})
    residual = cal.get("dense_residuals_bits_at_128", {}).get(str(params.n))
    return {
        "n": params.n,
        "log_qp": round(log_qp(params), 1),
        "max_log_qp_128": round(max_log_qp(params, 0), 1),
        "levels": params.num_limbs,
        "security_bits": security_level(params),
        "security_bits_note": (
            f"± {abs(residual):.1f} model-residual bits at this N; dense "
            "budget floored by the published HE-std v1.1 row"
            if residual is not None else
            "ring degree below the estimator table (toy/CI size)"
        ),
        "sparse_secret_h": params.hamming_weight or None,
        "encapsulation_eph_h": params.eph_hamming_weight or None,
        "model": "core-SVP estimator table (params/security_table.json)",
        "table_generated": t.get("generated"),
        "calibration_anchor": cal.get("anchor"),
    }
