"""gpufhe_tpu_torch params vs gpufhe_tpu params: every preset names the same chain
with the same fields, the prime helpers draw and order the same primes, and the
integer schemes' presets have the same plaintext moduli and BFV aux bases."""

import dataclasses

import pytest

from gpufhe_tpu.golden import bfv as ref_bfv
from gpufhe_tpu.params import params as ref
from gpufhe_tpu_torch.golden import bfv as port_bfv
from gpufhe_tpu_torch.ops.context import fourstep_split, k1_refusal
from gpufhe_tpu_torch.ops.convert_cuda import make_convert_tables
from gpufhe_tpu_torch.params import params as port

PORTED = ["tiny", "tiny2", "ci_small", "config1_ntt", "config2_rns", "config3_ckks",
          "config4_rotation", "config5_boot", "config5_boot_dw", "boot_dw_ci", "boot_dw_ci_enc",
          "fft_ci_small", "fft_ci", "boot_ci", "boot_ci_f", "boot_ci_cheb", "boot_ci_enc",
          "bgv_ci", "bgv_tiny", "bfv_ci", "bfv_tiny", "bfv_n16", "bfv_eq",
          # the model, mid-scale and N=2^16 bootstrap presets
          "boot_ci_deep", "ci_deep", "ci_attn", "ci_xf", "boot_mid_dw", "boot_mid",
          "config5_boot_s29", "config5_boot_h"]


@pytest.mark.parametrize("name", PORTED)
def test_preset_primes_and_roots_match_reference(name):
    p, r = port.preset(name), ref.preset(name)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)  # every field, in one
    assert p.n == r.n and p.scale_bits == r.scale_bits and p.sigma == r.sigma
    assert p.q_primes == r.q_primes
    assert p.p_primes == r.p_primes
    assert p.psi == r.psi
    assert (p.alpha, p.dnum, p.slots, p.scale_words) == (r.alpha, r.dnum, r.slots, r.scale_words)
    assert p.hamming_weight == r.hamming_weight
    assert p.eph_hamming_weight == r.eph_hamming_weight
    assert p.plain_modulus == r.plain_modulus


@pytest.mark.parametrize("bits,two_n,count,skip", [(30, 2**17, 15, 1), (28, 2**11, 9, 0), (29, 512, 4, 3)])
def test_gen_ntt_primes_matches_reference(bits, two_n, count, skip):
    assert port.gen_ntt_primes(bits, two_n, count, skip) == ref.gen_ntt_primes(bits, two_n, count, skip)


@pytest.mark.parametrize("scale_bits,two_n", [(28, 2**17), (24, 2**12), (20, 2**11)])
def test_balanced_prime_candidates_match_reference(scale_bits, two_n):
    exclude = tuple(ref.gen_ntt_primes(30, two_n, 2))
    assert (port.balanced_prime_candidates(scale_bits, two_n, exclude)
            == ref.balanced_prime_candidates(scale_bits, two_n, exclude))


def test_dw_preset_shapes():
    p = port.preset("config5_boot_dw")
    assert (p.n, p.num_limbs, p.alpha, p.dnum, p.scale_words, p.scale_bits) == (2**16, 48, 10, 5, 2, 56)
    assert p.eph_hamming_weight == 32 and p.hamming_weight == 0
    ci = port.preset("boot_dw_ci_enc")
    assert (ci.n, ci.num_limbs, ci.alpha, ci.dnum, ci.scale_words) == (2**7, 24, 4, 6, 2)


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


def test_integer_preset_shapes():
    p = port.preset("bfv_n16")
    assert (p.n, p.num_limbs, p.alpha, p.dnum, p.plain_modulus) == (2**16, 30, 15, 2, 786433)
    for name in ("bgv_ci", "bgv_tiny", "bfv_ci", "bfv_tiny", "bfv_eq"):
        q = port.preset(name)
        assert q.plain_modulus > 1 and (q.plain_modulus - 1) % (2 * q.n) == 0
    assert port.preset("bfv_eq").plain_modulus == 257


@pytest.mark.parametrize("name,level", [("bfv_tiny", None), ("bfv_tiny", 3), ("bfv_ci", None),
                                        ("bfv_n16", None)])
def test_bfv_aux_basis_matches_reference(name, level):
    p = port_bfv.bfv_aux_params(port.preset(name), level)
    r = ref_bfv.bfv_aux_params(ref.preset(name), level)
    assert p.q_primes == r.q_primes and p.p_primes == r.p_primes == ()
    assert (p.n, p.plain_modulus, p.scale_bits, p.sigma) == (r.n, r.plain_modulus, r.scale_bits,
                                                            r.sigma)


def test_bfv_n16_aux_basis_fits_the_kernels():
    """At bfv_n16 the aux basis (28-, 29- and 30-bit primes) stays below 2^30,
    its transform length has a K1 instantiation, and the three BFV
    conversions' K3 tables carry no refusal where they are built."""
    params = port.preset("bfv_n16")
    aux = port_bfv.bfv_aux_params(params).q_primes
    assert 30 <= len(aux) <= 40 and max(aux) < 2**30
    assert not set(aux) & set(params.q_primes + params.p_primes)
    assert k1_refusal(aux, params.n, *fourstep_split(params.n)) is None
    qs = params.q_primes
    for src, dst in ((qs, aux), (aux[:-1], qs), (aux[:-1], aux[-1:])):
        assert make_convert_tables(src, dst, "cpu").k3_refusal is None


def test_config5_boot_h_shape():
    p = port.preset("config5_boot_h")
    assert (p.n, p.num_limbs, len(p.p_primes), p.dnum, p.hamming_weight) == (2**16, 30, 5, 6, 64)
    assert p.eph_hamming_weight == 0 and p.scale_words == 1 and max(p.q_primes + p.p_primes) < 2**30
    s29 = port.preset("config5_boot_s29")
    assert max(s29.q_primes + s29.p_primes) < 2**29


# the reference's own calls (params.py config5_boot_h and ci_xf) and two more
OPS_H = ["lin"] * 8 + ["sq_z", "lin", "h", "h"] + ["sq"] * 8 + ["lin"] * 8


@pytest.mark.parametrize("two_n,ops,count", [
    (2**17, OPS_H, 29),
    (2**17, ["sq"] * 10, 14),
    (2**11, ["lin", "sq_z", "h", "sq", "lin"], 5),
])
def test_order_primes_for_circuit_matches_reference(two_n, ops, count):
    q0 = ref.gen_ntt_primes(30, two_n, 1)
    pp = ref.gen_ntt_primes(30, two_n, 5, skip=1)
    cands = ref.balanced_prime_candidates(28, two_n, exclude=tuple(q0 + pp))
    got = port.order_primes_for_circuit(list(cands), 28, ops, count)
    assert got == ref.order_primes_for_circuit(list(cands), 28, ops, count)
    assert len(got) == len(set(got)) == count


def test_order_primes_for_circuit_rejects_an_unknown_op():
    with pytest.raises(ValueError):
        port.order_primes_for_circuit([2**28 + 1], 28, ["cube"], 1)


@pytest.mark.parametrize("scale_bits,two_n,count,n_excl", [(28, 512, 59, 7), (28, 2**17, 20, 3),
                                                          (24, 2**12, 6, 0)])
def test_gen_balanced_ntt_primes_matches_reference(scale_bits, two_n, count, n_excl):
    exclude = tuple(ref.gen_ntt_primes(30, two_n, n_excl)) if n_excl else ()
    got = port.gen_balanced_ntt_primes(scale_bits, two_n, count, exclude)
    assert got == ref.gen_balanced_ntt_primes(scale_bits, two_n, count, exclude)
