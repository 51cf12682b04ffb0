"""gpufhe_tpu_torch.primitives.rns (mod_up, mod_down, rescale) against
gpufhe_tpu.primitives.rns and the stored config2_rns vectors, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufhe_tpu.golden import vectors as gv
from gpufhe_tpu.ops.context import make_context as ref_context
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu.primitives import rns as rrns
from gpufhe_tpu_torch.golden import rns as grns
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.ops.convert_cuda import base_convert, make_convert_tables
from gpufhe_tpu_torch.params.params import preset
from gpufhe_tpu_torch.primitives import rns as prns


def _rand(primes, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, size=n, dtype=np.int64) for q in primes])


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.fixture(scope="module", params=["tiny2", "ci_small"])
def stacks(request):
    name = request.param
    params, rparams = preset(name), ref_preset(name)
    return params, rparams, make_context(params, device="cpu"), ref_context(rparams)


@pytest.mark.parametrize("drop", [0, 1, 3])
def test_mod_up_mod_down_rescale_match_reference(stacks, drop):
    params, rparams, ctx, rctx = stacks
    level = params.num_limbs - drop
    alpha = len(params.p_primes)
    ksc = prns.make_ks_context(params, level, device="cpu")
    rksc = rrns.make_ks_context(rparams, level)
    qs = params.q_primes[:level]
    x = _rand(qs, params.n, level)
    xj, xt = jnp.asarray(x.astype(np.uint32)), torch.from_numpy(x)

    got_up = prns.mod_up(xt, params, level, ctx, ksc)
    want_up = rrns.mod_up(xj, rparams, level, rctx, rksc)
    assert len(got_up) == len(want_up) == len(prns.ks_groups(params, level))
    for g, w in zip(got_up, want_up):
        assert (g.numpy() == _np(w)).all()

    y = _rand(qs + params.p_primes, params.n, level + 50)
    got_down = prns.mod_down(torch.from_numpy(y), params, level, ctx, ksc).numpy()
    want_down = _np(rrns.mod_down(jnp.asarray(y.astype(np.uint32)), rparams, level, rctx, rksc))
    assert got_down.shape == (level, params.n) and (got_down == want_down).all()

    if level > 1:
        got_r = prns.rescale(xt, params, level, ctx, ksc).numpy()
        assert (got_r == _np(rrns.rescale(xj, rparams, level, rctx, rksc))).all()
        batched = prns.rescale(torch.stack([xt, xt]), params, level, ctx, ksc).numpy()
        assert (batched[0] == got_r).all() and (batched[1] == got_r).all()
    assert alpha == params.alpha


def test_config2_rns_vectors():
    """The stored N=2^14 vectors: base conversion Q -> P and rescale."""
    want = np.load(gv.VEC_DIR / "config2_rns.npz")
    params = preset("config2_rns")
    assert tuple(want["q_primes"]) == params.q_primes and tuple(want["p_primes"]) == params.p_primes
    a = torch.from_numpy(want["a"])
    tabs = make_convert_tables(params.q_primes, params.p_primes, "cpu")
    assert (base_convert(a, tabs).numpy() == want["base_convert_to_p"]).all()
    ctx = make_context(params, device="cpu")
    ksc = prns.make_ks_context(params, params.num_limbs, device="cpu")
    got = prns.rescale(a, params, params.num_limbs, ctx, ksc).numpy()
    assert (got == want["rescale"]).all()
    assert (grns.base_convert(want["a"][:3], params.q_primes[:3], params.p_primes)
            == base_convert(a[:3], make_convert_tables(params.q_primes[:3], params.p_primes, "cpu")).numpy()).all()
