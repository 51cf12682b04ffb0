"""gpufhe_tpu_torch.interop: gpufhe_tpu state carried over as numpy arrays drives
the port to the reference's results, limb for limb."""

import numpy as np
import pytest
import torch

from gpufhe_tpu.ciphertext import ct as rct
from gpufhe_tpu.encoding import encoder as renc
from gpufhe_tpu.keys import keys as rkeys
from gpufhe_tpu.ops.context import make_context as ref_context
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch import interop
from gpufhe_tpu_torch.ciphertext import ct as pct
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import preset


@pytest.fixture(scope="module")
def stack():
    params, rparams = preset("tiny2"), ref_preset("tiny2")
    rctx = ref_context(rparams)
    rchest = rkeys.keygen(rparams, np.random.default_rng(12))
    z = np.random.default_rng(13)
    cts = []
    for seed in (21, 22):
        zz = z.normal(size=params.slots) + 1j * z.normal(size=params.slots)
        cts.append(rct.encrypt(renc.encode(zz, rparams), rparams, rchest.device_pk, rctx,
                               np.random.default_rng(seed), rparams.scale))
    return params, rparams, make_context(params, device="cpu"), rctx, rchest, cts


def test_keys_carry_over_unchanged(stack):
    _, _, _, _, rchest, _ = stack
    pk = interop.public_key_from_numpy(np.asarray(rchest.device_pk.b_mont),
                                       np.asarray(rchest.device_pk.a_mont), "cpu")
    sk = interop.secret_key_from_numpy(np.asarray(rchest.device_sk.s_mont), "cpu")
    rlk = interop.ks_key_from_numpy(np.asarray(rchest.device_rlk.b_mont),
                                    np.asarray(rchest.device_rlk.a_mont), "cpu")
    for got, want in ((pk.b_mont, rchest.device_pk.b_mont), (pk.a_mont, rchest.device_pk.a_mont),
                      (sk.s_mont, rchest.device_sk.s_mont), (rlk.b_mont, rchest.device_rlk.b_mont),
                      (rlk.a_mont, rchest.device_rlk.a_mont)):
        assert got.dtype == torch.int64 and (got.numpy() == np.asarray(want).astype(np.int64)).all()


def test_reference_ciphertexts_multiply_to_reference_result(stack):
    params, rparams, ctx, rctx, rchest, (ra, rb) = stack
    rlk = interop.ks_key_from_numpy(np.asarray(rchest.device_rlk.b_mont),
                                    np.asarray(rchest.device_rlk.a_mont), "cpu")
    sk = interop.secret_key_from_numpy(np.asarray(rchest.device_sk.s_mont), "cpu")
    a = interop.ciphertext_from_numpy([np.asarray(c) for c in ra.c], ra.level, ra.scale, "cpu")
    b = interop.ciphertext_from_numpy([np.asarray(c) for c in rb.c], rb.level, rb.scale, "cpu")
    prod = pct.ct_mul_full(a, b, params, ctx, rlk)
    want = rct.ct_mul_full(ra, rb, rparams, rctx, rchest.device_rlk)
    limbs, level, scale = interop.ciphertext_to_numpy(prod)
    assert level == want.level and scale == want.scale
    for g, w in zip(limbs, want.c):
        assert (g == np.asarray(w).astype(np.int64)).all()
    dec = pct.decrypt_to_coeff(prod, params, sk, ctx)
    assert (dec == rct.decrypt_to_coeff(want, rparams, rchest.device_sk, rctx)).all()


def test_ciphertext_level_is_checked():
    with pytest.raises(ValueError):
        interop.ciphertext_from_numpy([np.zeros((3, 8), np.uint32)], 4, 1.0, "cpu")
