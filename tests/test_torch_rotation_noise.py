"""The decode check of chip_smoke.py's rotation path, made on the reference's
golden model at config5_boot (N = 2^16) with the smoke's seeds.

A key switch adds the ModDown error times the secret at the ciphertext's own
scale. At Delta = 2^28 a single rotation of a fresh ciphertext then decodes
off by 0.068, above DECODE_TOL, in the reference as in the port (the port's
limbs equal the reference's); encrypted at 2^ROT_SCALE_BITS the same
rotation decodes far inside it. That is why the smoke's rotation path
encrypts at 2^ROT_SCALE_BITS.
"""

import numpy as np

import chip_smoke
from gpufhe_tpu.golden import ckks as gckks
from gpufhe_tpu.params.params import preset


def test_config5_boot_rotation_decode_error_reference():
    params = preset("config5_boot")
    seed = chip_smoke.SEED
    rng = np.random.default_rng(seed)  # the smoke's keygen order: sk, pk, rlk, Galois 1
    sk, pk = gckks.keygen(params, rng)
    gckks.make_relin_key(params, sk, rng)
    gk = gckks.make_galois_key(params, 1, sk, rng)
    z = chip_smoke.unit_disk(np.random.default_rng(seed + 9), params.slots)
    errors = {}
    for bits in (params.scale_bits, chip_smoke.ROT_SCALE_BITS):
        scale = float(2**bits)
        ct = gckks.encrypt(gckks.encode(z, scale, params.q_primes, params.n), params, pk,
                           np.random.default_rng(seed + 10), scale)
        got = gckks.decrypt_decode(gckks.ct_rotate(ct, 1, params, gk), params, sk)
        errors[bits] = float(np.abs(got - np.roll(z, -1)).max())
    print(f"config5_boot reference rotation max |dec - roll(z)| by scale bits: {errors}")
    assert errors[params.scale_bits] >= chip_smoke.DECODE_TOL > 100 * errors[chip_smoke.ROT_SCALE_BITS]
