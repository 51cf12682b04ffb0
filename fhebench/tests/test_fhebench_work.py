"""The roofline arithmetic against counts derived by hand, one ct_mul_full at
ci_small and one BFV ct_mul at bfv_ci, and the bootstrap's plan counts
against the library's own plans. Nothing here reads a launch counter."""

from __future__ import annotations

import math

import pytest

from fhebench import work
from fhebench.work import bootstrap as wb

BW, PEAK = 3.35e12, 132 * 64 * 2 * 1.98e9


def test_peaks():
    assert work.HBM_BYTES_PER_S == BW
    assert work.INT_OPS_PER_S == pytest.approx(33.45e12, rel=1e-3)


def test_ckks_multiply_at_ci_small():
    # ci_small: N = 2^10, 6 q-limbs, alpha = 2 -> digits 2, 2, 2; one rescale
    w = work.ckks_square_chain(1024, 6, 2, 1, 1)
    # iNTT d2 (6) + each digit's 6 new limbs (18) + ModDown and rescale in
    # the evaluation domain: iNTT 2 x 2 P-limbs, NTT 2 x 6, then per
    # component 1 iNTT and 5 NTTs (12) = 28; the coefficient-domain order
    # costs 2 x 8 + 2 x 6 + 2 x 5 = 38
    assert w.ntt_limbs == 6 + 18 + 28
    assert sorted(w.convs) == [(2, 6)] * 5  # 3 ModUp digits, 2 ModDowns
    assert w.macs == [(3, 8)]
    least = w.least_s()
    k1_bytes = 2 * 1024 * 52 * 4 / BW
    k1_ops = 2 * 512 * 10 * 3 * 52 / PEAK
    assert least["K1"] == (pytest.approx(max(k1_bytes, k1_ops)), "bytes")
    k4_bytes = (3 * 8 + 2 * 3 * 8 + 2 * 8) * 1024 * 4 / BW
    k4_ops = 2 * 1024 * 2 * 8 * (3 * 2 + 3) / PEAK
    assert least["K4"][0] == pytest.approx(max(k4_bytes, k4_ops))
    k3_one = max(8 * 1024 * 4 / BW, 2 * 1024 * (2 * 3 + 2 * 6 * 2 + 6 * 3) / PEAK)
    assert least["K3"][0] == pytest.approx(5 * k3_one)


def test_bfv_multiply_at_bfv_ci():
    from gpufhe_tpu_torch.params.params import preset

    p = preset("bfv_ci")  # N = 2^10, 6 q-limbs, alpha = 2, t = 61441
    q_bits = sum(math.log2(q) for q in p.q_primes)
    bits = math.log2(p.plain_modulus) + 10 + 2 * math.log2(6) + q_bits + 4
    aux = math.ceil(bits / 30) + 1
    assert work.behz_aux_limbs(p.plain_modulus, 1024, 6, q_bits) == aux
    w = work.bfv_square_chain(1024, 6, 2, aux, 1)
    # 4 x 6 iNTTs, 4 aux NTTs, 3 x (6 + aux) iNTTs of the tensor, every limb
    # of the 3 coefficient-domain digits (3 x 8), 2 x 2 + 4 x 6 for ModDown
    # and the pair
    assert w.ntt_limbs == 24 + 4 * aux + 3 * (6 + aux) + 24 + 4 + 24
    b = aux - 1
    want = [(6, aux)] * 7 + [(b, 1)] * 3 + [(b, 6)] * 3 + [(2, 6)] * 5
    assert sorted(w.convs) == sorted(want)
    assert w.macs == [(3, 8)]


def test_square_chain_levels_fall():
    w = work.ckks_square_chain(1024, 8, 2, 2, 2)
    one = work.ckks_square_chain(1024, 8, 2, 2, 1)
    two = work.ckks_square_chain(1024, 6, 2, 2, 1)
    assert w.ntt_limbs == one.ntt_limbs + two.ntt_limbs


@pytest.mark.parametrize("slots", [2**6, 2**15])
def test_stage_offsets_match_the_library_plans(slots):
    from gpufhe_tpu_torch.ciphertext import fftboot as fb

    tw = fb._stage_twiddles(slots)
    inv = fb.group_stages([fb._inv_stage_diags(slots, h, w) for h, w in reversed(tw)], slots, 3)
    fwd = fb.group_stages([fb._fwd_stage_diags(slots, h, w) for h, w in tw], slots, 3)
    got_inv = [wb.group_offsets(slots, hs) for hs in wb.stage_groups(slots, 3, inverse=True)]
    got_fwd = [wb.group_offsets(slots, hs) for hs in wb.stage_groups(slots, 3, inverse=False)]
    assert got_inv == [set(g) for g in inv]
    assert got_fwd == [set(g) for g in fwd]


def test_cheb_counts():
    by_depth, internal = wb.cheb_products(87, 3)
    # babies T2..T8 (depths 1, 2, 2, 3, 3, 3, 3), giants T16..T128
    assert by_depth == {0: 1, 1: 2, 2: 4, 3: 1, 4: 1, 5: 1, 6: 1}
    assert internal == 10


def test_bootstrap_plan_matches_the_library_at_ci():
    import numpy as np

    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper, bootstrap_rotations
    from gpufhe_tpu_torch.ciphertext.polyeval import sine_coeffs
    from gpufhe_tpu_torch.keys.device_keygen import device_keygen
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.params.params import preset

    assert len(sine_coeffs(10.0)) - 1 == 87  # the N=2^16 cell's cheb_degree
    p = preset("boot_dw_ci_enc")
    ctx = make_context(p, device="cpu")
    rots = bootstrap_rotations(p, transform="factored", radix_log=3)
    chest = device_keygen(p, np.random.default_rng(0), rotations=tuple(rots), conjugation=True,
                          ctx=ctx)
    bs = Bootstrapper(DeviceBackend(p, ctx, chest), transform="factored", radix_log=3,
                      evalmod="cheb", k_bound=5.0, fuse_evalmod=True)
    w, slots = p.scale_words, p.slots
    stc = wb.stage_groups(slots, 3, inverse=False)
    cts = wb.stage_groups(slots, 3, inverse=True)
    assert bs.f_cts.levels_used == len(cts) * w
    # the StC input level the count derives from the output level (2 here):
    # the normalisation's rescale and one rescale per stage above it
    assert bs.f_stc.first_lo.level == 2 + w + len(stc) * w
    assert [pl.level for pl in bs.f_stc.rest] == [bs.f_stc.first_lo.level - w * (1 + i)
                                                  for i in range(len(stc) - 1)]
    assert [set(pl.offsets) for pl in bs.f_cts.shared] == [wb.group_offsets(slots, hs)
                                                          for hs in cts[:-1]]
