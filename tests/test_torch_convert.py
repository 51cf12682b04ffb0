"""Kernel K3's module: gpufhe_tpu_torch.ops.convert_cuda against gpufhe_tpu.

The plain base conversion equals the reference's per-term Shoup formulation
(_base_convert_shoup), its Pallas kernel digit_convert in interpret mode and
the golden conversion, exactly, as tests/test_ops.py:348-441 hold them
against each other. The CUDA kernel is held against the plain version on
the card (tests/test_torch_kernels_gpu.py, marked `gpu`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufhe_tpu.golden import rns as grns
from gpufhe_tpu.ops.convert_pallas import digit_convert, make_digit_convert
from gpufhe_tpu.ops.context import make_context as ref_context
from gpufhe_tpu.ops.modops import shoup_np
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu.primitives import rns as rrns
from gpufhe_tpu_torch.ops import convert_cuda
from gpufhe_tpu_torch.ops.convert_cuda import base_convert, make_convert_tables
from gpufhe_tpu_torch.params.params import gen_ntt_primes, preset
from gpufhe_tpu_torch.primitives import rns as prns

N = 1024


def _rand(primes, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, size=n, dtype=np.int64) for q in primes])


@pytest.mark.parametrize("s_dim,t_dim", [(12, 14), (2, 6), (1, 3)])
def test_convert_matches_shoup_digit_kernel_and_golden(s_dim, t_dim):
    src = tuple(gen_ntt_primes(28, 2 * 128, s_dim))
    dst = tuple(gen_ntt_primes(29, 2 * 128, t_dim))
    x = _rand(src, N, s_dim * 100 + t_dim)
    got = base_convert(torch.from_numpy(x), make_convert_tables(src, dst, "cpu")).numpy()

    qhat_m = rrns._mont_np(grns.qhat_inv(src), np.array(src, dtype=np.int64))
    dst_col = np.array(dst, dtype=np.int64)[:, None]
    conv = grns.conv_matrix(src, dst) % dst_col
    want_shoup = np.asarray(rrns._base_convert_shoup(
        jnp.asarray(x.astype(np.uint32)),
        jnp.asarray(np.array(src, dtype=np.uint32)),
        jnp.asarray(np.array([(-pow(q, -1, 1 << 32)) % (1 << 32) for q in src], dtype=np.uint32)),
        jnp.asarray(qhat_m),
        jnp.asarray(conv.astype(np.uint32)),
        jnp.asarray(shoup_np(conv, dst_col)),
        jnp.asarray(np.array(dst, dtype=np.uint32)),
    )).astype(np.int64)
    assert (got == want_shoup).all()
    assert (got == grns.base_convert(x, src, dst)).all()
    want_digit = np.asarray(digit_convert(
        jnp.asarray(x.astype(np.uint32)), make_digit_convert(src, dst, qhat_m), interpret=True,
    )).astype(np.int64)
    assert (got == want_digit).all()


@pytest.mark.parametrize("name", ["tiny2", "ci_small"])
def test_ks_context_tables_match_reference(name):
    """The port's ModUp / ModDown tables convert exactly as the reference's
    KSContext (Shoup path and digit kernel tables) at every level's groups."""
    params, rparams = preset(name), ref_preset(name)
    rctx = ref_context(rparams)
    alpha = len(params.p_primes)
    for level in (params.num_limbs, params.num_limbs - 1):
        ksc = prns.make_ks_context(params, level, "cpu")
        rksc = rrns.make_ks_context(rparams, level)
        qp_idx = np.asarray(list(range(level)) + list(range(params.num_limbs, params.num_limbs + alpha)))
        x = _rand(params.q_primes + params.p_primes, params.n, level)
        for g, (d0, d1) in enumerate(prns.ks_groups(params, level)):
            src_idx = np.arange(d0, d1)
            want = np.asarray(rrns._base_convert_shoup(
                jnp.asarray(x[d0:d1].astype(np.uint32)), rctx.q[src_idx], rctx.qinv_neg[src_idx],
                rksc.modup_qhatinv[g], rksc.modup_conv_plain[g], rksc.modup_conv_shoup[g],
                rctx.q[qp_idx],
            )).astype(np.int64)
            got = base_convert(torch.from_numpy(x[d0:d1]), ksc.modup[g]).numpy()
            assert (got == want).all(), (level, g)
        p_rows = x[params.num_limbs:]
        want = np.asarray(digit_convert(jnp.asarray(p_rows.astype(np.uint32)), rksc.p2q_dc,
                                        interpret=True)).astype(np.int64)
        assert (base_convert(torch.from_numpy(p_rows), ksc.p2q).numpy() == want).all()


def test_cuda_wrapper_rejects_cpu_tensors():
    tabs = make_convert_tables((97, 193), (257, 353, 449), "cpu")
    before = convert_cuda.KERNEL.launches
    with pytest.raises(ValueError):
        convert_cuda.base_convert_cuda(torch.zeros((2, 8), dtype=torch.int64), tabs)
    assert convert_cuda.KERNEL.launches == before
