"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips where no CUDA device is present;
the file imports neither jax nor gpufhe_tpu, so it also runs on a machine
that has only PyTorch (tests/conftest.py imports jax, hence --noconftest):

    python3 -m pytest -q -p no:cacheprovider --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from gpufhe_tpu_torch.ciphertext import ct as dct
from gpufhe_tpu_torch.encoding import encoder
from gpufhe_tpu_torch.keys import keys as dkeys
from gpufhe_tpu_torch.ops import convert_cuda, ntt_cuda
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.ops.convert_cuda import make_convert_tables
from gpufhe_tpu_torch.params.params import gen_ntt_primes, preset

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rand(primes, rows, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, primes[r], size=n, dtype=np.int64) for r in rows])


@pytest.mark.parametrize("name", ["tiny", "tiny2", "ci_small", "config3_ckks"])
def test_ntt_kernel_matches_plain(cuda_device, name):
    params = preset(name)
    ctx = make_context(params, cuda_device)
    primes = params.q_primes + params.p_primes
    sel = list(range(len(primes)))[::-1]
    idx = ctx.index(sel, torch.int32)
    x = torch.from_numpy(_rand(primes, sel * 2, params.n, 8)).to(cuda_device)  # batch of 2
    before = ntt_cuda.KERNEL.launches
    for inverse in (False, True):
        got = ntt_cuda.fourstep_cuda(x, idx, ctx, inverse)
        assert torch.equal(got, ntt_cuda.fourstep_plain(x, idx, ctx, inverse))
    assert ntt_cuda.KERNEL.launches == before + 2


@pytest.mark.parametrize("s_dim,t_dim", [(15, 45), (15, 30), (2, 6)])
def test_convert_kernel_matches_plain(cuda_device, s_dim, t_dim):
    src = tuple(gen_ntt_primes(30, 2**17, s_dim))
    dst = tuple(gen_ntt_primes(28, 2**17, t_dim))
    x = torch.from_numpy(_rand(src, range(s_dim), 2**16, 9)).to(cuda_device)
    tabs = make_convert_tables(src, dst, cuda_device)
    before = convert_cuda.KERNEL.launches
    got = convert_cuda.base_convert_cuda(x, tabs)
    assert torch.equal(got, convert_cuda.base_convert_plain(x, tabs))
    assert convert_cuda.KERNEL.launches == before + 1


def test_mul_full_on_card_equals_cpu_path(cuda_device):
    """ci_small end to end: the card's limbs equal the CPU path's."""
    params = preset("ci_small")
    z = np.random.default_rng(1)
    za = z.normal(size=params.slots) + 1j * z.normal(size=params.slots)
    outs = []
    for dev in (cuda_device, "cpu"):
        ctx = make_context(params, dev)
        chest = dkeys.keygen(params, np.random.default_rng(2), ctx)
        ca = dct.encrypt(encoder.encode(za, params), params, chest.device_pk, ctx,
                         np.random.default_rng(3), params.scale)
        outs.append(dct.ct_mul_full(ca, ca, params, ctx, chest.device_rlk))
    for g, c in zip(*(o.c for o in outs)):
        assert torch.equal(g.cpu(), c)
