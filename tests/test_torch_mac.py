"""Kernel K4's plain version (gpufhe_tpu_torch.ops.mac_cuda.mac_plain) and its
wrapper on the CPU against the reference's key-switch MAC, exactly:

- gpufhe_tpu.ops.modops.mont_mac (the paired-REDC MAC the reference's key
  switch runs);
- the per-term mont_mul + add_mod chain that scripts/dw_mac_probe.py holds
  its Pallas MAC to (xla_mac there; the probe asserts a TPU when imported,
  so its function is written out here from the reference's modops);
- a Python-integer oracle, for the wrapper's row selection and permutation.

The last test checks, on the host, the reduction schedule that csrc/mac.cu
runs (unreduced 64-bit sums of up to 8 products, a 64-bit Barrett step, one
REDC), at the worst-case inputs and up to 16 digits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufhe_tpu.golden import arithmetic as ga
from gpufhe_tpu.ops import modops as ref
from gpufhe_tpu_torch.ops import mac_cuda
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import preset


@pytest.fixture(scope="module")
def ctx():
    # 30-bit base primes, 28-bit limbs and 30-bit special primes, N = 2^7
    return make_context(preset("boot_dw_ci_enc"), device="cpu")


def _operands(ctx, d_dim, rows, seed):
    """x, y0, y1 canonical int64[D, T, N'] over the chain rows `rows`, N' = ctx.n."""
    rng = np.random.default_rng(seed)
    q = np.asarray([ctx.primes[r] for r in rows], dtype=np.int64)[None, :, None]
    shape = (d_dim, len(rows), ctx.n)
    x, y0, y1 = (rng.integers(0, q, size=shape, dtype=np.int64) for _ in range(3))
    x[:, :, :2] = q - 1  # worst-case products in every row
    y0[:, :, :1] = q - 1
    return x, y0, y1


def _oracle(x, y, rows, primes):
    """sum_d x[d] * y[d] * 2^-32 mod q per row, with Python integers."""
    out = np.empty(x.shape[1:], dtype=np.int64)
    for t, r in enumerate(rows):
        q = primes[r]
        rinv = pow(1 << 32, -1, q)
        acc = sum(x[d, t].astype(object) * y[d, t].astype(object) for d in range(x.shape[0]))
        out[t] = (acc * rinv % q).astype(np.int64)
    return out


@pytest.mark.parametrize("d_dim", [1, 2, 3, 4, 5, 6])
def test_mac_plain_matches_reference_mont_mac_and_chain(ctx, d_dim):
    rows = list(range(ctx.num_total))
    x, y0, y1 = _operands(ctx, d_dim, rows, seed=d_dim)
    idx = ctx.index(rows, torch.int32)
    got = mac_cuda.mac_plain(torch.from_numpy(x), torch.from_numpy(y0), torch.from_numpy(y1),
                             idx, idx, ctx)
    q = np.asarray(ctx.primes, dtype=np.uint32)[:, None]
    qinv = np.asarray([ga.mont_constants(p)[0] for p in ctx.primes], dtype=np.uint32)[:, None]
    qj, qinvj = jnp.asarray(q), jnp.asarray(qinv)
    u32 = lambda a: jnp.asarray(a.astype(np.uint32))
    for j, y in enumerate((y0, y1)):
        packed = ref.mont_mac([(u32(x[d]), u32(y[d])) for d in range(d_dim)], qj, qinvj)
        chain = None  # dw_mac_probe.py xla_mac: per-term mont_mul + add_mod
        for d in range(d_dim):
            term = ref.mont_mul(u32(x[d]), u32(y[d]), qj, qinvj)
            chain = term if chain is None else ref.add_mod(chain, term, qj)
        assert (got[j].numpy() == np.asarray(packed).astype(np.int64)).all()
        assert (got[j].numpy() == np.asarray(chain).astype(np.int64)).all()
        assert (got[j].numpy() == _oracle(x, y, rows, ctx.primes)).all()


def test_mac_wrapper_rows_chain_and_perm(ctx):
    """The wrapper on CPU tensors: key rows picked by index (a key stored above
    the level), q by chain row, x gathered through a permutation."""
    stored, alpha, level = ctx.num_total, 4, 20  # a full-chain key used at level 20
    key_rows = list(range(level)) + list(range(stored - alpha, stored))
    chain = key_rows
    d_dim = 6
    x, _, _ = _operands(ctx, d_dim, chain, seed=11)
    _, y0, y1 = _operands(ctx, d_dim + 1, list(range(stored)), seed=12)  # one spare digit
    perm = np.random.default_rng(13).permutation(ctx.n)
    got = mac_cuda.mac(torch.from_numpy(x), torch.from_numpy(y0), torch.from_numpy(y1),
                       ctx.index(key_rows, torch.int32), ctx.index(chain, torch.int32), ctx,
                       perm=torch.from_numpy(perm.astype(np.int32)))
    assert got.shape == (2, len(chain), ctx.n) and got.dtype == torch.int64
    xp = x[:, :, perm]
    for j, y in enumerate((y0, y1)):
        want = _oracle(xp, y[:d_dim, key_rows], chain, ctx.primes)
        assert (got[j].numpy() == want).all()


def test_mac_single_output_is_the_first_of_the_pair(ctx):
    """With y1 None the wrapper forms out_0 alone: int64[1, T, N] == the
    first output of the two-output call."""
    chain = list(range(8))
    x, y0, y1 = _operands(ctx, 1, chain, seed=21)
    idx = ctx.index(chain, torch.int32)
    args = (torch.from_numpy(x), torch.from_numpy(y0))
    one = mac_cuda.mac(*args, None, idx, idx, ctx)
    pair = mac_cuda.mac(*args, torch.from_numpy(y1), idx, idx, ctx)
    assert one.shape == (1, len(chain), ctx.n) and torch.equal(one[0], pair[0])


def _umulhi(a: int, b: int) -> int:
    return (a * b) >> 64


def _barrett(t: int, q: int, mu: int) -> int:
    r = t - _umulhi(t, mu) * q
    assert 0 <= r < 2 * q
    return r - q if r >= q else r


@pytest.mark.parametrize("q", [(1 << 30) - 35, 1073479681, 786433])
@pytest.mark.parametrize("d_dim", [1, 5, 6, 8, 9, 16])
def test_kernel_reduction_schedule_is_exact(q, d_dim):
    """csrc/mac.cu's arithmetic on the host: at the largest residues the
    unreduced sums stay below 2^64, and Barrett + REDC give the canonical
    sum * 2^-32 mod q."""
    mu = (1 << 64) // q
    qinv_neg = ga.mont_constants(q)[0]
    for x, y in ((q - 1, q - 1), (q - 1, 1), (12345 % q, q - 2)):
        acc = 0
        for d in range(d_dim):
            acc += x * y
            assert acc < 1 << 64
            if d % 8 == 7:
                acc = _barrett(acc, q, mu)
        a = _barrett(acc, q, mu)
        m = (a * qinv_neg) & 0xFFFFFFFF
        got = (a + m * q) >> 32
        assert got == d_dim * x * y * pow(1 << 32, -1, q) % q
