"""The tensor layer on the CPU: ops/tensor_cuda.py's plain version (what a
CPU tensor runs) against the port's former add_mod / mul_mod composition
and the reference's _tensor_core, exactly, on the CKKS, BGV and BFV Q chains
and on BFV's auxiliary basis; the kernel's arithmetic (csrc/tensor.cu:
widening products, one 64-bit Barrett reduction an output by the
context's mu) replayed in numpy against them; ct.py tensor_core's one
stack; and the kernel wrapper's refusals. The kernel itself runs only on the card
(tests/test_torch_kernels_gpu.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufhe_tpu.ciphertext import ct as rct
from gpufhe_tpu.golden import bfv as rgbfv
from gpufhe_tpu.ops.context import make_context as ref_context
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch.ciphertext import ct as dct
from gpufhe_tpu_torch.ciphertext.bfv import make_bfv_mul_context
from gpufhe_tpu_torch.ops import tensor_cuda
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.ops.modops import add_mod, mul_mod
from gpufhe_tpu_torch.params.params import preset

# (preset, basis): the Q chain of each scheme at its top level, and BFV's
# auxiliary basis B u {m_sk} at it (N <= 2^10)
CHAINS = [("ci_small", "q"), ("boot_dw_ci", "q"), ("bgv_ci", "q"), ("bfv_ci", "q"),
          ("bfv_ci", "aux")]
EDGES = 3  # residues 0, 1 and q - 1


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=CHAINS, ids=[f"{p}-{b}" for p, b in CHAINS])
def chain(request):
    """(port context, reference context, K) of the basis, both on the CPU."""
    name, basis = request.param
    params, rparams = preset(name), ref_preset(name)
    level = params.num_limbs
    if basis == "aux":
        _, ctx, _ = make_bfv_mul_context(params, level, device="cpu")
        return ctx, ref_context(rgbfv.bfv_aux_params(rparams, level)), len(ctx.primes)
    return make_context(params, device="cpu"), ref_context(rparams), level


def operands(ctx, k_dim, seed):
    """Four canonical int64[K, N] operands, random but for their first 3^4
    columns, which run through every combination of the edge residues 0, 1
    and q - 1 over the four operands."""
    q = np.asarray(ctx.primes[:k_dim], dtype=np.int64)[:, None]
    x = np.random.default_rng(seed).integers(0, q, size=(4, k_dim, ctx.n), dtype=np.int64)
    edge = np.stack([np.zeros_like(q), np.ones_like(q), q - 1])  # [3, K, 1]
    for col in range(min(EDGES**4, ctx.n)):
        for op in range(4):
            x[op, :, col] = edge[col // EDGES**op % EDGES, :, 0]
    return [torch.from_numpy(v) for v in x]


def _umul64hi(a, b):
    """floor(a * b / 2^64) of uint64 arrays, from 32-bit halves (CUDA's
    __umul64hi)."""
    m32, s32 = np.uint64(0xFFFFFFFF), np.uint64(32)
    a_lo, a_hi, b_lo, b_hi = a & m32, a >> s32, b & m32, b >> s32
    mid = (a_lo * b_lo >> s32) + (a_hi * b_lo & m32) + (a_lo * b_hi & m32)
    return a_hi * b_hi + (a_hi * b_lo >> s32) + (a_lo * b_hi >> s32) + (mid >> s32)


def kernel_model(a0, a1, b0, b1, ctx, k_dim) -> np.ndarray:
    """csrc/tensor.cu's arithmetic in numpy: 64-bit products of the 32-bit
    words and modarith.cuh barrett_reduce by mu = floor(2^64 / q)."""
    q = np.asarray(ctx.primes[:k_dim], dtype=np.uint64)[:, None]
    mu = ctx.mu[:k_dim].numpy().astype(np.uint64)[:, None]
    x0, x1, y0, y1 = (v.numpy().astype(np.uint64) for v in (a0, a1, b0, b1))

    def reduce(t):
        r = t - _umul64hi(t, mu) * q
        assert (r < 2 * q).all()
        return np.where(r >= q, r - q, r)

    sum1 = x0 * y1 + x1 * y0
    assert (sum1 < np.uint64(1 << 61)).all()
    return np.stack([reduce(x0 * y0), reduce(sum1), reduce(x1 * y1)]).astype(np.int64)


def test_tensor_plain_matches_former_formula_and_reference(chain):
    ctx, rctx, k_dim = chain
    a0, a1, b0, b1 = operands(ctx, k_dim, k_dim)
    q = ctx.col("q", range(k_dim))
    got = tensor_cuda.tensor((a0, a1), (b0, b1), ctx, k_dim)
    assert got.shape == (3, k_dim, ctx.n) and got.dtype == torch.int64
    assert torch.equal(got, tensor_cuda.tensor_plain(a0, a1, b0, b1, q))
    former = (mul_mod(a0, b0, q), add_mod(mul_mod(a0, b1, q), mul_mod(a1, b0, q), q),
              mul_mod(a1, b1, q))
    for d, want in zip(got, former):
        assert torch.equal(d, want)
    ref = rct._tensor_core(*[tuple(jnp.asarray(v.numpy().astype(np.uint32)) for v in pair)
                             for pair in ((a0, a1), (b0, b1))], rctx, k_dim)
    for d, want in zip(got, ref):
        assert np.array_equal(d.numpy(), np.asarray(want).astype(np.int64))
    assert int(got.min()) >= 0 and bool((got < q).all())
    assert np.array_equal(kernel_model(a0, a1, b0, b1, ctx, k_dim), got.numpy())


def test_tensor_core_slices_share_one_storage(chain):
    """tensor_core returns one [3, K, N] stack: d0, d1, d2 are its rows
    (one storage) and d[:2] is the contiguous view the iNTT reads."""
    ctx, _, k_dim = chain
    a0, a1, b0, b1 = operands(ctx, k_dim, 2 * k_dim)
    d = dct.tensor_core([a0, a1], [b0, b1], ctx, k_dim)
    d0, d1, d2 = d
    assert len({x.untyped_storage().data_ptr() for x in (d0, d1, d2)}) == 1
    assert [x.data_ptr() for x in (d0, d1, d2)] == [
        d.data_ptr() + i * d.stride(0) * d.element_size() for i in range(3)]
    assert d[:2].is_contiguous() and d[:2].data_ptr() == d.data_ptr()
    assert torch.equal(d, tensor_cuda.tensor_plain(a0, a1, b0, b1, ctx.col("q", range(k_dim))))


def _refusal_cases(ctx, k_dim):
    a0, a1, b0, b1 = operands(ctx, k_dim, 3)
    n = ctx.n
    chain = ctx.index(range(k_dim), torch.int32)
    wide = torch.zeros((k_dim, n + 1), dtype=torch.int64)
    flat = torch.zeros(k_dim * n + 1, dtype=torch.int64)
    big = dataclasses.replace(ctx, primes=ctx.primes[:-1] + ((1 << 30) + 3,), cache={})
    return {
        "dtype": ((a0.int(), a1, b0, b1, chain, ctx), "int64"),
        "shape": ((a0[:-1], a1, b0, b1, chain, ctx), "one shape"),
        "rank": ((a0[None], a1, b0, b1, chain, ctx), "one shape"),
        "odd N": ((a0[:, :-1], a1[:, :-1], b0[:, :-1], b1[:, :-1], chain, ctx), "N even"),
        "strided columns": ((a0[:, ::2], a1[:, ::2], b0[:, ::2], b1[:, ::2], chain, ctx),
                            "coefficient stride 1"),
        "odd limb stride": ((wide[:, :n], a1, b0, b1, chain, ctx), "even limb stride"),
        "unaligned": ((flat[1:].view(k_dim, n), a1, b0, b1, chain, ctx), "16-byte aligned"),
        "chain dtype": ((a0, a1, b0, b1, chain.long(), ctx), "int32"),
        "chain length": ((a0, a1, b0, b1, chain[:-1], ctx), "int32"),
        "prime": ((a0, a1, b0, b1, chain, big), "below 2\\^30"),
        "cpu": ((a0, a1, b0, b1, chain, ctx), "CUDA tensors"),
    }


REFUSALS = ["dtype", "shape", "rank", "odd N", "strided columns",
            "odd limb stride", "unaligned", "chain dtype", "chain length", "prime", "cpu"]


@pytest.mark.parametrize("what", REFUSALS)
def test_tensor_cuda_refuses_what_the_kernel_does_not_take(what):
    """Each refusal raises ValueError before any launch; a well-formed CPU
    input is refused last (the kernel has no CPU mode)."""
    params = preset("tiny2")
    ctx = make_context(params, device="cpu")
    args, match = _refusal_cases(ctx, params.num_limbs)[what]
    before = tensor_cuda.KERNEL.launches
    with pytest.raises(ValueError, match=match):
        tensor_cuda.tensor_cuda(*args)
    assert tensor_cuda.KERNEL.launches == before
