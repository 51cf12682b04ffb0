"""gpufhe_tpu_torch params vs gpufhe_tpu params: the same presets name the same chains."""

import pytest

from gpufhe_tpu.params import params as ref
from gpufhe_tpu_torch.params import params as port

PORTED = ["tiny", "tiny2", "ci_small", "config1_ntt", "config2_rns", "config3_ckks",
          "config4_rotation", "config5_boot"]


@pytest.mark.parametrize("name", PORTED)
def test_preset_primes_and_roots_match_reference(name):
    p, r = port.preset(name), ref.preset(name)
    assert p.n == r.n and p.scale_bits == r.scale_bits and p.sigma == r.sigma
    assert p.q_primes == r.q_primes
    assert p.p_primes == r.p_primes
    assert p.psi == r.psi
    assert (p.alpha, p.dnum, p.slots, p.scale_words) == (r.alpha, r.dnum, r.slots, r.scale_words)
    assert p.hamming_weight == r.hamming_weight


@pytest.mark.parametrize("bits,two_n,count,skip", [(30, 2**17, 15, 1), (28, 2**11, 9, 0), (29, 512, 4, 3)])
def test_gen_ntt_primes_matches_reference(bits, two_n, count, skip):
    assert port.gen_ntt_primes(bits, two_n, count, skip) == ref.gen_ntt_primes(bits, two_n, count, skip)


def test_config5_boot_shape():
    p = port.preset("config5_boot")
    assert (p.n, p.num_limbs, len(p.p_primes), p.alpha, p.dnum) == (2**16, 30, 15, 15, 2)
    assert max(p.q_primes + p.p_primes) < 2**30


def test_bad_params_raise():
    with pytest.raises(ValueError):
        port.CKKSParams(n=96, q_primes=(), p_primes=(), scale_bits=20)
    with pytest.raises(ValueError):
        port.CKKSParams(n=64, q_primes=(97,), p_primes=(), scale_bits=20)  # 97 != 1 mod 128
    with pytest.raises(KeyError):
        port.preset("no_such_preset")
