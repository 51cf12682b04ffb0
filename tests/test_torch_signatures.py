"""The port's public functions take the reference's parameter lists, so a
caller written against gpufhe_tpu runs unchanged against gpufhe_tpu_torch:
decrypt_to_coeff(ct, params, sk, ctx) and plaintext_to_device(pt_coeff,
params, ctx), each pinned by name and called with `params` at `tiny`; the
bootstrap's surface (Bootstrapper, every DeviceBackend method, ct_diag_fan,
both ModRaises, truncate_galois_device) pinned by name."""

import inspect

import numpy as np
import pytest

from gpufhe_tpu.ciphertext import backend as rbackend
from gpufhe_tpu.ciphertext import bootstrap as rboot
from gpufhe_tpu.ciphertext import ct as rct
from gpufhe_tpu.encoding import encoder as renc
from gpufhe_tpu.keys import keys as rkeys
from gpufhe_tpu.ops.context import make_context as ref_context
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch.ciphertext import backend as pbackend
from gpufhe_tpu_torch.ciphertext import bootstrap as pboot
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
    (pct.ct_diag_fan, rct.ct_diag_fan),
    (pct.ct_mod_raise, rct.ct_mod_raise),
    (pct.ct_mod_raise2, rct.ct_mod_raise2),
    (pkeys.truncate_galois_device, rkeys.truncate_galois_device),
    (pboot.Bootstrapper.__init__, rboot.Bootstrapper.__init__),
    (pboot.Bootstrapper.__call__, rboot.Bootstrapper.__call__),
    (pboot.Bootstrapper.timed_call, rboot.Bootstrapper.timed_call),
    (pboot.Bootstrapper.galois_step_levels, rboot.Bootstrapper.galois_step_levels),
    (pboot.bootstrap_rotations, rboot.bootstrap_rotations),
]
# the reference DeviceBackend's surface, minus nothing: every method it has
BACKEND_METHODS = sorted(
    name for name, f in vars(rbackend.DeviceBackend).items()
    if callable(f) and not name.startswith("__"))
GHOST_METHODS = sorted(
    name for name, f in vars(rbackend.GhostBackend).items()
    if callable(f) and not name.startswith("__"))


@pytest.mark.parametrize("port,ref", PAIRS, ids=lambda f: f.__name__)
def test_parameter_names_match_the_reference(port, ref):
    assert list(inspect.signature(port).parameters) == list(inspect.signature(ref).parameters)


@pytest.mark.parametrize("cls,method", [("DeviceBackend", m) for m in BACKEND_METHODS]
                         + [("GhostBackend", m) for m in GHOST_METHODS])
def test_backend_methods_match_the_reference(cls, method):
    port, ref = getattr(getattr(pbackend, cls), method), getattr(getattr(rbackend, cls), method)
    assert list(inspect.signature(port).parameters) == list(inspect.signature(ref).parameters)


def test_bootstrapper_defaults_match_the_reference():
    port = inspect.signature(pboot.Bootstrapper.__init__).parameters
    ref = inspect.signature(rboot.Bootstrapper.__init__).parameters
    assert {k: v.default for k, v in port.items()} == {k: v.default for k, v in ref.items()}


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
