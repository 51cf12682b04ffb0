"""Key generation: the port's keygen from a numpy seed equals gpufhe_tpu's golden
keygen (host keys) and its Montgomery-form device keys, exactly."""

import numpy as np
import pytest

from gpufhe_tpu.golden import ckks as gckks
from gpufhe_tpu.keys import keys as rkeys
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch.keys import keys as pkeys
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import CKKSParams, preset


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("name", ["tiny2", "ci_small"])
def test_keygen_matches_reference(name):
    params, rparams = preset(name), ref_preset(name)
    ctx = make_context(params, "cpu")
    chest = pkeys.keygen(params, np.random.default_rng(5), ctx)
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
    ctx = make_context(params, "cpu")
    chest = pkeys.keygen(params, np.random.default_rng(9), ctx)
    rng = np.random.default_rng(9)
    sk, pk = gckks.keygen(rparams, rng)
    rlk = gckks.make_relin_key(rparams, sk, rng)
    assert (chest.sk.s == sk.s).all() and np.count_nonzero(sk.s) == 16
    assert (chest.pk.b.numpy() == pk.b).all()
    assert (chest.rlk.b.numpy() == rlk.b).all() and (chest.rlk.a.numpy() == rlk.a).all()
    assert isinstance(params, CKKSParams)
