"""Noise diagnostics: measure how much of the modulus budget a ciphertext has
consumed (requires the secret key: a debugging and evaluation tool, not a
runtime op).

Counterpart of gpufhe_tpu/utils/noise.py. For CKKS the meaningful quantity
is the error relative to the scale: the expected message is re-encoded at
the ciphertext's tracked scale and compared with the decrypted
coefficients; `bits_clean` says how many bits of the scale survive
(about log2(scale / max|error|)). The decryption runs on the context's
device; its coefficients are read back through .cpu().
"""

from __future__ import annotations

import math

import numpy as np

from gpufhe_tpu_torch.golden import ckks as gckks


def ckks_noise_report(ct, params, device_sk, ctx, expected_slots) -> dict:
    """Max error, bits of precision and remaining-level budget of a device ct."""
    from gpufhe_tpu_torch.ciphertext import ct as dct

    coeff = dct.decrypt_to_coeff(ct, params, device_sk, ctx)
    primes = params.q_primes[: ct.level]
    got = gckks.crt_compose_centered(coeff, primes).astype(np.float64)
    want = gckks.crt_compose_centered(
        gckks.encode(np.asarray(expected_slots), ct.scale, primes, params.n),
        primes,
    ).astype(np.float64)
    err = np.abs(got - want).max()
    return {
        "level": ct.level,
        "scale_bits": round(math.log2(ct.scale), 2),
        "max_coeff_err": float(err),
        "bits_clean": round(math.log2(ct.scale / err), 2) if err > 0 else float("inf"),
        "log_q_remaining": round(sum(math.log2(q) for q in primes), 1),
    }
