"""Kernel K1's module: gpufhe_tpu_torch.ops.ntt against gpufhe_tpu.

The port's NTT (plain four-step on the CPU) is held against the reference's
jnp path, its Pallas kernels in interpret mode (fourstep_pallas_v3 = K1,
fourstep_pallas_v2 = K2a, fourstep_pallas = K2b) and the golden transform,
exactly. The CUDA kernel is held against the plain version on the card
(tests/test_torch_kernels_gpu.py, marked `gpu`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufhe_tpu.golden import ntt as gn
from gpufhe_tpu.ops import ntt as rntt
from gpufhe_tpu.ops.context import fourstep_split as ref_split
from gpufhe_tpu.ops.context import make_context as ref_context
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch.ops import ntt_cuda
from gpufhe_tpu_torch.ops.context import fourstep_split, make_context
from gpufhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
from gpufhe_tpu_torch.params.params import CKKSParams, gen_ntt_primes, preset


def _u32(x):
    return jnp.asarray(np.asarray(x, dtype=np.uint32))


def _rand(primes, rows, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, primes[r], size=n, dtype=np.int64) for r in rows])


@pytest.mark.parametrize("name", ["tiny", "tiny2", "ci_small"])
def test_ntt_matches_reference_jnp_path(name):
    params, rparams = preset(name), ref_preset(name)
    ctx, rctx = make_context(params, device="cpu"), ref_context(rparams)
    primes = params.q_primes + params.p_primes
    x = _rand(primes, range(len(primes)), params.n, 1)
    got = ntt_fwd(torch.from_numpy(x), ctx).numpy()
    assert (got == np.asarray(rntt.ntt_fwd(_u32(x), rctx)).astype(np.int64)).all()
    assert (ntt_inv(torch.from_numpy(got), ctx).numpy() == x).all()
    y = _rand(primes, range(len(primes)), params.n, 2)
    got_inv = ntt_inv(torch.from_numpy(y), ctx).numpy()
    assert (got_inv == np.asarray(rntt.ntt_inv(_u32(y), rctx)).astype(np.int64)).all()


@pytest.mark.parametrize("limbs", [[1, 3, 0], [4, 5], slice(1, 3)])
def test_ntt_limb_subsets_match_golden(limbs):
    params = preset("tiny2")
    ctx = make_context(params, device="cpu")
    primes = params.q_primes + params.p_primes
    rows = range(len(primes))[limbs] if isinstance(limbs, slice) else limbs
    x = _rand(primes, rows, params.n, 3)
    got = ntt_fwd(torch.from_numpy(x), ctx, limbs=limbs).numpy()
    want = np.stack([gn.ntt_fwd(x[i], primes[r], params.psi[r]) for i, r in enumerate(rows)])
    assert (got == want).all()
    back = ntt_inv(torch.from_numpy(got), ctx, limbs=limbs).numpy()
    assert (back == x).all()


def test_ntt_leading_batch_dims():
    params = preset("tiny2")
    ctx = make_context(params, device="cpu")
    primes = params.q_primes + params.p_primes
    rows = [0, 2, 5]
    x = np.stack([_rand(primes, rows, params.n, 10 + b) for b in range(6)]).reshape(2, 3, 3, -1)
    got = ntt_fwd(torch.from_numpy(x), ctx, limbs=rows).numpy()
    assert got.shape == x.shape
    for b in np.ndindex(2, 3):
        want = np.stack([gn.ntt_fwd(x[b][i], primes[r], params.psi[r]) for i, r in enumerate(rows)])
        assert (got[b] == want).all()
    assert (ntt_inv(torch.from_numpy(got), ctx, limbs=rows).numpy() == x).all()


@pytest.mark.parametrize("n", [128, 512])
def test_ntt_rectangular_split_matches_golden(n):
    """n1 = 2 * n2 (N = 2^7, 2^9): the two passes run different lengths."""
    qs = tuple(gen_ntt_primes(28, 2 * n, 2))
    params = CKKSParams(n=n, q_primes=qs, p_primes=(), scale_bits=20)
    n1, n2 = fourstep_split(n)
    assert n1 == 2 * n2 and (n1, n2) == ref_split(n)
    ctx = make_context(params, device="cpu")
    x = _rand(qs, range(2), n, 4)
    got = ntt_fwd(torch.from_numpy(x), ctx).numpy()
    for i in range(2):
        assert (got[i] == gn.ntt_fwd(x[i], qs[i], params.psi[i])).all()
    assert (ntt_inv(torch.from_numpy(got), ctx).numpy() == x).all()


@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_ntt_matches_pallas_v3_interpret(direction):
    """K1: the port equals fourstep_pallas_v3 (interpret mode) on a
    non-contiguous limb selection into the full tables."""
    from gpufhe_tpu.ops.ntt_pallas import fourstep_pallas_v3

    params, rparams = preset("tiny2"), ref_preset("tiny2")
    ctx, rctx = make_context(params, device="cpu"), ref_context(rparams)
    primes = params.q_primes + params.p_primes
    n1, n2 = ref_split(params.n)
    sel = [1, 3, 0]
    x = _rand(primes, sel, params.n, 5)
    inv = direction == "inv"
    t = rctx.ntt_inv if inv else rctx.ntt_fwd
    xm = _u32(x).reshape(len(sel), *((n2, n1) if inv else (n1, n2)))
    want = np.asarray(fourstep_pallas_v3(
        xm, jnp.asarray(np.asarray(sel, dtype=np.int32)), t.wl_cat, t.tw, t.tw_shoup,
        t.wr_cat, t.corr_l, t.corr_r, rctx.q, rctx.digit_plain, rctx.digit_shoup,
        interpret=True, approx=True, mode="mono",
    )).reshape(len(sel), -1).astype(np.int64)
    fn = ntt_inv if inv else ntt_fwd
    assert (fn(torch.from_numpy(x), ctx, limbs=sel).numpy() == want).all()


@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_ntt_matches_pallas_v2_interpret(direction):
    """K2a: fourstep_pallas_v2 (tables gathered per call) computes K1's function."""
    from gpufhe_tpu.ops.ntt_pallas import fourstep_pallas_v2

    params, rparams = preset("tiny2"), ref_preset("tiny2")
    ctx, rctx = make_context(params, device="cpu"), ref_context(rparams)
    primes = params.q_primes + params.p_primes
    L, n = len(primes), params.n
    n1, n2 = ref_split(n)
    x = _rand(primes, range(L), n, 6)
    inv = direction == "inv"
    t = rctx.ntt_inv if inv else rctx.ntt_fwd
    xm = _u32(x).reshape(L, *((n2, n1) if inv else (n1, n2)))
    want = np.asarray(fourstep_pallas_v2(
        xm, t.wl_cat, t.tw, t.tw_shoup, t.wr_cat, t.corr_l, t.corr_r,
        rctx.q, rctx.digit_plain, rctx.digit_shoup, interpret=True, approx=True,
    )).reshape(L, n).astype(np.int64)
    fn = ntt_inv if inv else ntt_fwd
    assert (fn(torch.from_numpy(x), ctx).numpy() == want).all()


def test_ntt_matches_pallas_v1_interpret():
    """K2b: the round-2 Montgomery-recombine kernel computes K1's function."""
    from gpufhe_tpu.ops.ntt_pallas import fourstep_pallas

    params, rparams = preset("tiny"), ref_preset("tiny")
    ctx, rctx = make_context(params, device="cpu"), ref_context(rparams)
    primes = params.q_primes + params.p_primes
    L, n = len(primes), params.n
    n1, n2 = ref_split(n)
    x = _rand(primes, range(L), n, 7)
    t = rctx.ntt_fwd
    want = np.asarray(fourstep_pallas(
        _u32(x).reshape(L, n1, n2), t.wl_digits, t.tw_mont, t.wr_digits,
        rctx.q, rctx.qinv_neg, rctx.digit_mont, interpret=True,
    )).reshape(L, n).astype(np.int64)
    assert (ntt_fwd(torch.from_numpy(x), ctx).numpy() == want).all()


def test_cuda_wrapper_rejects_cpu_tensors():
    """The wrapper launches the kernel or raises: no fallback to the plain version."""
    params = preset("tiny2")
    ctx = make_context(params, device="cpu")
    x = torch.zeros((2, params.n), dtype=torch.int64)
    idx = ctx.index(range(2), torch.int32)
    before = ntt_cuda.KERNEL.launches
    with pytest.raises(ValueError):
        ntt_cuda.fourstep_cuda(x, idx, ctx, False)
    assert ntt_cuda.KERNEL.launches == before


def test_ntt_rejects_wrong_limb_count():
    params = preset("tiny2")
    ctx = make_context(params, device="cpu")
    with pytest.raises(ValueError):
        ntt_fwd(torch.zeros((3, params.n), dtype=torch.int64), ctx, limbs=[0, 1])
