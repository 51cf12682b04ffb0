"""gpufhe_tpu_torch.primitives.keyswitch.key_switch_core against gpufhe_tpu's
(jnp path) and the golden key switch, with the same keys, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufhe_tpu.golden import ckks as gckks
from gpufhe_tpu.keys import keys as rkeys
from gpufhe_tpu.ops.context import make_context as ref_context
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu.primitives import keyswitch as rks
from gpufhe_tpu.primitives import rns as rrns
from gpufhe_tpu_torch import interop
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import preset
from gpufhe_tpu_torch.primitives import keyswitch as pks
from gpufhe_tpu_torch.primitives import rns as prns


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.fixture(scope="module", params=["tiny2", "ci_small"])
def stacks(request):
    name = request.param
    params, rparams = preset(name), ref_preset(name)
    ref = rkeys.keygen(rparams, np.random.default_rng(3))
    rlk = interop.ks_key_from_numpy(np.asarray(ref.device_rlk.b_mont),
                                    np.asarray(ref.device_rlk.a_mont), "cpu")
    return params, rparams, make_context(params, "cpu"), ref_context(rparams), ref, rlk


def test_qp_indices_and_key_rows(stacks):
    params, rparams, _, _, _, rlk = stacks
    for level in (params.num_limbs, 2):
        assert pks.qp_indices(params, level) == rks.qp_indices(rparams, level)
        rows = pks.key_rows(rlk.b_mont[0], params, level).numpy()
        assert (rows == rlk.b_mont[0].numpy()[pks.qp_indices(params, level)]).all()


@pytest.mark.parametrize("eval_in,eval_out", [(True, True), (True, False), (False, True)])
def test_key_switch_core_matches_reference(stacks, eval_in, eval_out):
    params, rparams, ctx, rctx, ref, rlk = stacks
    for level in (params.num_limbs, params.num_limbs - 1):
        rng = np.random.default_rng(level)
        d2 = np.stack([rng.integers(0, q, size=params.n, dtype=np.int64)
                       for q in params.q_primes[:level]])
        got = pks.key_switch_core(torch.from_numpy(d2), params, level, ctx,
                                  prns.make_ks_context(params, level, "cpu"), rlk,
                                  eval_out=eval_out, eval_in=eval_in)
        want = rks.key_switch_core(jnp.asarray(d2.astype(np.uint32)), rparams, level, rctx,
                                   rrns.make_ks_context(rparams, level), ref.device_rlk,
                                   eval_out=eval_out, eval_in=eval_in)
        for g, w in zip(got, want):
            assert (g.numpy() == _np(w)).all(), (level, eval_in, eval_out)
        if eval_in and eval_out:
            gold = gckks.key_switch_core(d2, rparams, level, ref.rlk)
            assert all((g.numpy() == w).all() for g, w in zip(got, gold))
