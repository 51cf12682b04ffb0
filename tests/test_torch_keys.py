"""Key generation: the port's keygen from a numpy seed equals gpufhe_tpu's golden
keygen (host keys) and its Montgomery-form device keys, exactly."""

import numpy as np
import pytest

from gpufhe_tpu.golden import ckks as gckks
from gpufhe_tpu.keys import keys as rkeys
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch import interop
from gpufhe_tpu_torch.keys import keys as pkeys
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import CKKSParams, preset


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("name", ["tiny2", "ci_small"])
def test_keygen_matches_reference(name):
    params, rparams = preset(name), ref_preset(name)
    ctx = make_context(params, device="cpu")
    chest = pkeys.keygen(params, np.random.default_rng(5), ctx=ctx)
    ref = rkeys.keygen(rparams, np.random.default_rng(5))
    assert (chest.sk.s == ref.sk.s).all()
    assert (chest.pk.b.numpy() == ref.pk.b).all() and (chest.pk.a.numpy() == ref.pk.a).all()
    assert (chest.rlk.b.numpy() == ref.rlk.b).all() and (chest.rlk.a.numpy() == ref.rlk.a).all()
    assert (chest.device_pk.b_mont.numpy() == _np(ref.device_pk.b_mont)).all()
    assert (chest.device_pk.a_mont.numpy() == _np(ref.device_pk.a_mont)).all()
    assert (chest.device_rlk.b_mont.numpy() == _np(ref.device_rlk.b_mont)).all()
    assert (chest.device_rlk.a_mont.numpy() == _np(ref.device_rlk.a_mont)).all()
    assert (chest.device_sk.s_mont.numpy() == _np(ref.device_sk.s_mont)).all()


def test_sparse_secret_keygen_matches_golden():
    """hamming_weight > 0 draws a sparse ternary secret, in the golden order."""
    import dataclasses

    base = preset("tiny2")
    params = dataclasses.replace(base, hamming_weight=16)
    rparams = dataclasses.replace(ref_preset("tiny2"), hamming_weight=16)
    ctx = make_context(params, device="cpu")
    chest = pkeys.keygen(params, np.random.default_rng(9), ctx=ctx)
    rng = np.random.default_rng(9)
    sk, pk = gckks.keygen(rparams, rng)
    rlk = gckks.make_relin_key(rparams, sk, rng)
    assert (chest.sk.s == sk.s).all() and np.count_nonzero(sk.s) == 16
    assert (chest.pk.b.numpy() == pk.b).all()
    assert (chest.rlk.b.numpy() == rlk.b).all() and (chest.rlk.a.numpy() == rlk.a).all()
    assert isinstance(params, CKKSParams)


def _ks_equal(got, ref_pair):
    """(port KSKey, DeviceKSKey) == the reference's (golden KSKey, DeviceKSKey)."""
    (host, dev), (rhost, rdev) = got, ref_pair
    assert (host.b.numpy() == rhost.b).all() and (host.a.numpy() == rhost.a).all()
    assert (dev.b_mont.numpy() == _np(rdev.b_mont)).all()
    assert (dev.a_mont.numpy() == _np(rdev.a_mont)).all()


@pytest.mark.parametrize("name,eph", [("tiny2", 16), ("boot_dw_ci_enc", 0)])
def test_keygen_with_galois_conj_and_eph_matches_reference(name, eph):
    """Rotations, conjugation and encapsulation keys, drawn in the reference's
    order, equal gpufhe_tpu.keys.keys.keygen limb for limb."""
    import dataclasses

    params, rparams = preset(name), ref_preset(name)
    if eph:
        params = dataclasses.replace(params, eph_hamming_weight=eph)
        rparams = dataclasses.replace(rparams, eph_hamming_weight=eph)
    steps = (1, 3, 5)
    ctx = make_context(params, device="cpu")
    chest = pkeys.keygen(params, np.random.default_rng(21), rotations=steps, conjugation=True,
                         ctx=ctx)
    ref = rkeys.keygen(rparams, np.random.default_rng(21), rotations=steps, conjugation=True)
    assert (chest.sk.s == ref.sk.s).all()
    assert (chest.device_rlk.b_mont.numpy() == _np(ref.device_rlk.b_mont)).all()
    assert list(chest.galois) == list(ref.galois) == list(steps)
    for s in steps:
        _ks_equal(chest.galois[s], ref.galois[s])
        assert chest.galois_key(s) is chest.galois[s][1]
    _ks_equal(chest.conj, ref.conj)
    assert params.eph_hamming_weight > 0 and ref.eph is not None
    assert (chest.eph["s_eph"] == ref.eph["s_eph"]).all()
    assert np.count_nonzero(chest.eph["s_eph"]) == params.eph_hamming_weight
    for k in ("to_eph", "from_eph"):
        _ks_equal(chest.eph[k], ref.eph[k])
    carried = interop.chest_from_reference(ref, "cpu")
    assert carried.params == params
    for k in ("to_eph", "from_eph"):
        _ks_equal(carried.eph[k], ref.eph[k])


def test_keygen_without_extras_has_none():
    params = preset("tiny")
    chest = pkeys.keygen(params, np.random.default_rng(1), ctx=make_context(params, device="cpu"))
    assert chest.galois == {} and chest.conj is None and chest.eph is None
    with pytest.raises(KeyError):
        chest.conj_key()
