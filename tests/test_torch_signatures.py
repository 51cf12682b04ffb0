"""The port's public functions take the reference's parameter lists, so a
caller written against gpufhe_tpu runs unchanged against gpufhe_tpu_torch:
decrypt_to_coeff(ct, params, sk, ctx) and plaintext_to_device(pt_coeff,
params, ctx), each pinned by name and called with `params` at `tiny`."""

import inspect

import numpy as np
import pytest

from gpufhe_tpu.ciphertext import ct as rct
from gpufhe_tpu.encoding import encoder as renc
from gpufhe_tpu.keys import keys as rkeys
from gpufhe_tpu.ops.context import make_context as ref_context
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch.ciphertext import ct as pct
from gpufhe_tpu_torch.encoding import encoder as penc
from gpufhe_tpu_torch.keys import keys as pkeys
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import preset

PAIRS = [
    (pct.decrypt_to_coeff, rct.decrypt_to_coeff),
    (penc.plaintext_to_device, renc.plaintext_to_device),
    (penc.encode_to_device, renc.encode_to_device),
    (pct.decrypt_decode, rct.decrypt_decode),
]


@pytest.mark.parametrize("port,ref", PAIRS, ids=lambda f: f.__name__)
def test_parameter_names_match_the_reference(port, ref):
    assert list(inspect.signature(port).parameters) == list(inspect.signature(ref).parameters)


@pytest.fixture(scope="module")
def tiny():
    params, rparams = preset("tiny"), ref_preset("tiny")
    ctx, rctx = make_context(params, "cpu"), ref_context(rparams)
    chest = pkeys.keygen(params, np.random.default_rng(5), ctx)
    rchest = rkeys.keygen(rparams, np.random.default_rng(5))
    return params, rparams, ctx, rctx, chest, rchest


def test_plaintext_to_device_with_params_equals_reference(tiny):
    params, rparams, ctx, rctx, _, _ = tiny
    rng = np.random.default_rng(6)
    pt = penc.encode(rng.normal(size=params.slots) + 1j * rng.normal(size=params.slots), params)
    got = penc.plaintext_to_device(pt, params, ctx)
    want = renc.plaintext_to_device(pt, rparams, rctx)
    assert (got.numpy() == np.asarray(want).astype(np.int64)).all()


def test_decrypt_to_coeff_with_params_equals_reference(tiny):
    params, rparams, ctx, rctx, chest, rchest = tiny
    rng = np.random.default_rng(7)
    pt = penc.encode(rng.normal(size=params.slots) + 1j * rng.normal(size=params.slots), params)
    ct = pct.encrypt(pt, params, chest.device_pk, ctx, np.random.default_rng(8), params.scale)
    rc = rct.encrypt(pt, rparams, rchest.device_pk, rctx, np.random.default_rng(8), params.scale)
    got = pct.decrypt_to_coeff(ct, params, chest.device_sk, ctx)
    want = rct.decrypt_to_coeff(rc, rparams, rchest.device_sk, rctx)
    assert (got == want).all()
