"""The probes' plain versions and host-side pieces (gpufhe_tpu_torch.ops.probes),
on the CPU: the integer-rate chains against a numpy model of
csrc/int_rate.cu, the copy_only ablation's function against its definition,
and the build table of the ablation libraries. The kernels themselves run
only on the card (tests/test_torch_kernels_gpu.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from gpufhe_tpu_torch.ops import cuda_build, probes
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import preset


def _model(mix, threads, depth):
    """csrc/int_rate.cu's chains in Python integers: xor over each thread's 8."""
    out = []
    for i in range(threads):
        acc = 0
        for k in range(probes.CHAINS):
            s = i * probes.CHAINS + k
            v = s & 0xFFFFFFFF if mix == "muladd" else s % probes.Q
            for _ in range(depth):
                v = (v * probes.C0 + probes.C1) & 0xFFFFFFFF if mix == "muladd" else v * probes.W % probes.Q
            acc ^= v
        out.append(acc)
    return np.asarray(out, dtype=np.int64)


@pytest.mark.parametrize("mix", probes.MIXES)
def test_int_rate_plain_matches_model(mix):
    got = probes.int_rate_plain(mix, 1, 5, "cpu")
    assert got.shape == (probes.THREADS,)
    assert (got.numpy()[:64] == _model(mix, 64, 5)).all()


def test_barrett_constants_of_the_modmul_mix():
    assert probes.MU == (1 << 64) // probes.Q and 0 < probes.W < probes.Q < 1 << 30


def _shoup32(a: int, w: int, wp: int, q: int) -> int:
    """csrc/modarith.cuh mul_mod_shoup32 in 32-bit words."""
    m = 0xFFFFFFFF
    r = ((a * w) & m) - ((((a * wp) >> 32) * q) & m)
    r &= m
    assert r < 2 * q
    return r - q if r >= q else r


@pytest.mark.parametrize("q", [probes.Q, 1073479681, 786433, 97])
def test_shoup32_step_is_the_modular_product(q):
    """The shoup32 mix's step equals a * w mod q, so its plain version (and
    the numpy model above) is the modmul mix's, for every canonical a."""
    rng = np.random.default_rng(q)
    for w in (probes.W % q, 1, q - 1, int(rng.integers(0, q))):
        wp = (w << 32) // q
        for a in (0, 1, q - 1, q // 2, *rng.integers(0, q, size=64).tolist()):
            assert _shoup32(a, w, wp, q) == a * w % q
    assert probes.WP == (probes.W << 32) // probes.Q < 1 << 32


def test_copy_only_plain_is_the_bit_reversed_transpose():
    params = preset("tiny2")
    ctx = make_context(params, device="cpu")
    n1, n2 = ctx.n1, ctx.n2
    rev = lambda j, r: int(f"{j:0{r.bit_length() - 1}b}"[::-1], 2)
    x = torch.arange(3 * params.n, dtype=torch.int64).view(3, params.n)
    got = probes.copy_only_plain(x, ctx)
    for k2 in range(n2):
        for k1 in range(n1):
            assert (got[:, k2 * n1 + k1] == x[:, rev(k1, n1) * n2 + rev(k2, n2)]).all()


def test_ablation_libraries_are_ntt_cu_with_a_switch():
    for k, v in enumerate(probes.ABLATIONS, 1):
        source, flags = cuda_build.LIBS[f"ntt_{v}"]
        assert source == "ntt" and flags == (f"-DNTT_ABLATE={k}",)
        assert probes.ABLATION_KERNELS[v].lib == f"ntt_{v}"
    assert cuda_build.LIBS["ntt"] == ("ntt", ())
    paths = {cuda_build.lib_path(name) for name in cuda_build.LIBS}
    assert len(paths) == len(cuda_build.LIBS)  # every build has its own library
