"""gpufhe_tpu_torch.primitives.keyswitch.key_switch_core against gpufhe_tpu's
(jnp path) and the golden key switch, with the same keys, exactly; and the
addend that key_switch_core, ks_finish and mod_down sum in the ModDown
against the reference's key switch and mod_down followed by the addition."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufhe_tpu.golden import ckks as gckks
from gpufhe_tpu.keys import keys as rkeys
from gpufhe_tpu.ops.context import make_context as ref_context
from gpufhe_tpu.ops.ntt import ntt_fwd as ref_ntt_fwd
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
    return params, rparams, make_context(params, device="cpu"), ref_context(rparams), ref, rlk


def test_qp_indices_and_key_rows(stacks):
    params, rparams, _, _, _, rlk = stacks
    for level in (params.num_limbs, 2):
        assert pks.qp_indices(params, level) == rks.qp_indices(rparams, level)
        rows = pks.key_row_index(params, level, rlk.b_mont.shape[1])
        assert rows == rks.qp_indices(rparams, level)  # a full-chain key: the chain rows
        stored = level + len(params.p_primes)  # a key truncated to exactly this level
        assert pks.key_row_index(params, level, stored) == list(range(stored))
        with pytest.raises(ValueError):
            pks.key_row_index(params, level + 1, stored)


@pytest.mark.parametrize("eval_in,eval_out", [(True, True), (True, False), (False, True)])
def test_key_switch_core_matches_reference(stacks, eval_in, eval_out):
    params, rparams, ctx, rctx, ref, rlk = stacks
    for level in (params.num_limbs, params.num_limbs - 1):
        rng = np.random.default_rng(level)
        d2 = np.stack([rng.integers(0, q, size=params.n, dtype=np.int64)
                       for q in params.q_primes[:level]])
        got = pks.key_switch_core(torch.from_numpy(d2), params, level, ctx,
                                  prns.make_ks_context(params, level, device="cpu"), rlk,
                                  eval_out=eval_out, eval_in=eval_in)
        want = rks.key_switch_core(jnp.asarray(d2.astype(np.uint32)), rparams, level, rctx,
                                   rrns.make_ks_context(rparams, level), ref.device_rlk,
                                   eval_out=eval_out, eval_in=eval_in)
        for g, w in zip(got, want):
            assert (g.numpy() == _np(w)).all(), (level, eval_in, eval_out)
        if eval_in and eval_out:
            gold = gckks.key_switch_core(d2, rparams, level, ref.rlk)
            assert all((g.numpy() == w).all() for g, w in zip(got, gold))


def _rows(primes, n, rng):
    return np.stack([rng.integers(0, q, size=n, dtype=np.int64) for q in primes])


# CKKS, BGV (the t-corrected ModDown's folded tables) and BFV's key switch
# (its CKKS view: the plain ModDown on an integer chain)
SCHEMES = {"ckks": ("tiny2", False), "bgv": ("bgv_tiny", False), "bfv_view": ("bfv_tiny", True)}


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("eval_out", [True, False])
def test_addend_matches_reference_key_switch_then_sum(scheme, eval_out):
    """key_switch_core (and so ks_finish) with a coefficient-domain addend of
    one and of two rows, on the plain path, == the reference's key switch
    (jnp) plus the addend (its NTT when eval_out); mod_down with a one-row
    addend == the reference's mod_down plus it. One level below the top, so
    the last decomposition group is short."""
    name, view = SCHEMES[scheme]
    params, rparams = preset(name), ref_preset(name)
    if view:
        params, rparams = (dataclasses.replace(p, plain_modulus=0) for p in (params, rparams))
    level = params.num_limbs - 1
    ctx, rctx = make_context(params, device="cpu"), ref_context(rparams)
    ksc, rksc = prns.make_ks_context(params, level, device="cpu"), rrns.make_ks_context(rparams, level)
    rng = np.random.default_rng(11)
    chain, qs = params.q_primes + params.p_primes, params.q_primes[:level]
    kb, ka = (np.stack([_rows(chain, params.n, rng) for _ in range(params.dnum)])
              for _ in range(2))
    key = interop.ks_key_from_numpy(kb, ka, "cpu")
    rkey = rkeys.DeviceKSKey(jnp.asarray(kb.astype(np.uint32)), jnp.asarray(ka.astype(np.uint32)))
    d2, add = _rows(qs, params.n, rng), np.stack([_rows(qs, params.n, rng) for _ in range(2)])
    q = np.asarray(qs, dtype=np.int64)[:, None]

    want = np.stack([_np(w) for w in rks.key_switch_core(
        jnp.asarray(d2.astype(np.uint32)), rparams, level, rctx, rksc, rkey, eval_out=eval_out)])
    summand = _np(ref_ntt_fwd(jnp.asarray(add.astype(np.uint32)), rctx,
                              limbs=list(range(level)))) if eval_out else add
    for rows in (1, 2):
        got = pks.key_switch_core(torch.from_numpy(d2), params, level, ctx, ksc, key,
                                  eval_out=eval_out, addend=torch.from_numpy(add[:rows]))
        exp = want.copy()
        exp[:rows] = (want[:rows] + summand[:rows]) % q
        assert got.shape == (2, level, params.n) and (got.numpy() == exp).all(), rows

    y = _rows(chain[:level] + params.p_primes, params.n, rng)
    down = _np(rrns.mod_down(jnp.asarray(y.astype(np.uint32)), rparams, level, rctx, rksc))
    got = prns.mod_down(torch.from_numpy(y), params, level, ctx, ksc, addend=torch.from_numpy(add[0]))
    assert (got.numpy() == (down + add[0]) % q).all()
