"""BsgsPlan on the port's DeviceBackend (ciphertext/linalg.py): each giant
group's inner sum in one pass over its stacked diagonals, with the babies'
key switches finished in one batch (ct.py ct_baby_sums), equals limb for
limb the same plan taken one plaintext product and one add a diagonal
(BsgsPlan._products), on the CPU at fft_ci_small (N = 2^7, 64 slots, 8
babies a group): a banded matrix, whose groups are runs of the stack of
rotations; a sparse one, whose groups skip rows of it (PlainGroup.index);
and one with a conjugate part, whose sums add per group."""

import numpy as np
import pytest
import torch

from gpufhe_tpu_torch.ciphertext import ct as dct
from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
from gpufhe_tpu_torch.ciphertext.linalg import BsgsPlan, bsgs_steps
from gpufhe_tpu_torch.encoding import encoder
from gpufhe_tpu_torch.keys import keys as dkeys
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import preset


def _banded(n, rng, width=11):
    r = (np.arange(n)[None, :] - np.arange(n)[:, None]) % n
    keep = (r < width) | (r > n - width)
    return np.where(keep, rng.normal(size=(n, n)) * 0.1, 0.0)


def _sparse(n, rng):
    r = (np.arange(n)[None, :] - np.arange(n)[:, None]) % n
    keep = np.isin(r, [0, 2, 5, 7, 9, 13, 30, 33, 38, 61])
    return np.where(keep, rng.normal(size=(n, n)) * 0.1, 0.0)


CASES = {
    "banded": lambda n, rng: (_banded(n, rng), None),
    "sparse": lambda n, rng: (_sparse(n, rng), None),
    "conjugate": lambda n, rng: (_sparse(n, rng), _banded(n, rng, width=4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_group_sums_equal_the_products_one_by_one(case):
    params = preset("fft_ci_small")
    n = params.slots
    rng = np.random.default_rng(7)
    a, b = CASES[case](n, rng)
    ctx = make_context(params, device="cpu")
    chest = dkeys.keygen(params, np.random.default_rng(3), tuple(bsgs_steps(a, b)),
                         conjugation=b is not None, ctx=ctx)
    be = DeviceBackend(params, ctx, chest)
    level = params.num_limbs
    plan = BsgsPlan(be, a, b, level)
    ct = dct.encrypt(encoder.encode(rng.normal(size=n) * 0.5 + 0j, params), params,
                     chest.device_pk, ctx, np.random.default_rng(5), params.scale)

    groups = [g for _, gs in plan.groups.values() for _, g in gs]
    assert sum(len(g.pts) for g in groups) == len(plan.pt)
    skips = [g.index is not None for g in groups]
    assert any(skips) == (case != "banded")

    grouped = plan.apply(ct)
    plan.groups = None
    one_by_one = plan.apply(ct)
    assert (grouped.level, grouped.scale) == (one_by_one.level, one_by_one.scale)
    assert grouped.level == level - params.scale_words
    for got, want in zip(grouped.c, one_by_one.c, strict=True):
        assert torch.equal(got, want)
