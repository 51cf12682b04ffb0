"""The cells at CI presets, for the CPU tests: each workload's files with
the configuration swapped for a small preset of the same kind, a pool of 2
and a depth the small chain holds."""

from __future__ import annotations

import math

from fhebench import harness

CI = {  # workload -> (CI preset, depth, out_level, k_bound)
    "ckks_n16_dw.boot": ("boot_dw_ci_enc", None, 2, 5.0),
    "ckks_n16_dw.mul8": ("boot_dw_ci_enc", 8, None, None),
    "n16_int.bfv_mul8": ("bfv_ci", 3, None, None),
    "n16_int.bgv_mul5": ("bgv_ci", 3, None, None),
}
LIMITS = {"ckks_n16_dw.boot": 1e-4, "ckks_n16_dw.mul8": 1e-8}


def config(preset_name: str) -> dict:
    from gpufhe_tpu_torch.params.params import preset

    p = preset(preset_name)
    return {"preset": preset_name, "n": p.n, "q_primes": list(p.q_primes),
            "p_primes": list(p.p_primes), "scale_bits": p.scale_bits,
            "scale_words": p.scale_words, "plain_modulus": p.plain_modulus,
            "hamming_weight": p.hamming_weight, "eph_hamming_weight": p.eph_hamming_weight,
            "sigma": p.sigma}


def files(name: str) -> tuple[dict, dict, dict]:
    """(configuration, mix, cell) of a workload at its CI preset."""
    _, mix, cell = harness.cell_files(harness.workload(harness.manifest(), name))
    preset_name, depth, out_level, k_bound = CI[name]
    mix = dict(mix, pool=2, sample=2)
    if depth is not None:
        mix["depth"] = depth
    cell = dict(cell)
    if name in LIMITS:
        cell["limits"] = {"max_err": LIMITS[name]}
    if out_level is not None:
        cell["out_level"] = out_level
        cell["bootstrap"] = dict(cell["bootstrap"], k_bound=k_bound,
                                 cheb_degree=int(2 * math.pi * k_bound + 25))
    return config(preset_name), mix, cell


def run(name: str, seconds: float = 0.3, trace: bool = False) -> dict:
    return harness.run_cell(name, 2**31 + 11, seconds, trace, device="cpu", files=files(name))
