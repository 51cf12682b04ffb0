"""The double-word preset boot_dw_ci_enc (N=2^7, 24 q-limbs, alpha=4, dnum=6,
scale_words=2, encapsulation keys) in gpufhe_tpu_torch against gpufhe_tpu,
with the same keys (interop.chest_from_reference) and the same draws, limb
for limb: key_switch_core (six gadget digits through K4's plain version),
ct_mul_full with its two back-to-back rescales, and ct_key_switch to the
ephemeral secret and back.

The oracle is the reference's golden model (gpufhe_tpu.golden.ckks), which
its own tests hold == to its device path; at 24 limbs and dnum = 6 the jnp
path's CPU compiles would take about a minute, and the jnp key switch is
held == the port's at tiny2/ci_small (tests/test_torch_keyswitch.py)."""

import numpy as np
import pytest
import torch

from gpufhe_tpu.golden import ckks as gckks
from gpufhe_tpu.keys import keys as rkeys
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch import interop
from gpufhe_tpu_torch.ciphertext import ct as pct
from gpufhe_tpu_torch.encoding import encoder as penc
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import preset
from gpufhe_tpu_torch.primitives import keyswitch as pks
from gpufhe_tpu_torch.primitives import rns as prns

NAME = "boot_dw_ci_enc"


def _assert_ct_equal(got, want):
    assert got.level == want.level and got.scale == want.scale and len(got.c) == len(want.c)
    for g, w in zip(got.c, want.c):
        assert (g.cpu().numpy() == np.asarray(w)).all()


@pytest.fixture(scope="module")
def stack():
    params, rparams = preset(NAME), ref_preset(NAME)
    assert (params.dnum, params.scale_words, params.eph_hamming_weight) == (6, 2, 16)
    rchest = rkeys.keygen(rparams, np.random.default_rng(23))
    chest = interop.chest_from_reference(rchest, "cpu")
    return params, rparams, make_context(params, device="cpu"), chest, rchest


@pytest.mark.parametrize("drop", [0, 5])
def test_key_switch_core_matches_reference(stack, drop):
    """Full level (6 digits) and five limbs down (5 digits, an uneven last
    group, the key's rows read above the level)."""
    params, rparams, ctx, chest, rchest = stack
    level = params.num_limbs - drop
    rng = np.random.default_rng(level)
    d2 = np.stack([rng.integers(0, q, size=params.n, dtype=np.int64)
                   for q in params.q_primes[:level]])
    got = pks.key_switch_core(torch.from_numpy(d2), params, level, ctx,
                              prns.make_ks_context(params, level, device="cpu"), chest.device_rlk)
    gold = gckks.key_switch_core(d2, rparams, level, rchest.rlk)
    for g, gw in zip(got, gold):
        assert (g.numpy() == gw).all()


def _encrypt_both(stack, z, seed):
    params, rparams, ctx, chest, rchest = stack
    pt = penc.encode(z, params)
    ct = pct.encrypt(pt, params, chest.device_pk, ctx, np.random.default_rng(seed), params.scale)
    gold = gckks.encrypt(pt, rparams, rchest.pk, np.random.default_rng(seed), params.scale)
    _assert_ct_equal(ct, gold)
    return ct, gold


def test_mul_full_matches_reference(stack):
    """ct_mul_full == the golden tensor, relinearisation and two rescales."""
    params, rparams, ctx, chest, rchest = stack
    rng = np.random.default_rng(4)
    zs = [rng.normal(size=params.slots) + 1j * rng.normal(size=params.slots) for _ in range(2)]
    (a, ga), (b, gb) = (_encrypt_both(stack, z, 40 + i) for i, z in enumerate(zs))
    prod = pct.ct_mul_full(a, b, params, ctx, chest.device_rlk)
    assert prod.level == params.num_limbs - 2
    _assert_ct_equal(prod, gckks.ct_rescale(gckks.ct_mul(ga, gb, rparams, rchest.rlk), rparams))
    got = pct.decrypt_decode(prod, params, chest.device_sk, ctx)
    assert np.abs(got - zs[0] * zs[1]).max() < 1e-6


def test_encapsulation_key_switch_round_trip(stack):
    """ct_key_switch with to_eph and from_eph: == the reference at every step,
    and the result decrypts under s again."""
    params, rparams, ctx, chest, rchest = stack
    z = np.random.default_rng(5).normal(size=params.slots) + 0j
    ct, gold = _encrypt_both(stack, z, 50)
    for k in ("to_eph", "from_eph"):
        ct = pct.ct_key_switch(ct, params, ctx, chest.eph[k][1])
        gold = gckks.ct_key_switch(gold, rparams, rchest.eph[k][0])
        _assert_ct_equal(ct, gold)
    assert np.abs(pct.decrypt_decode(ct, params, chest.device_sk, ctx) - z).max() < 1e-6
