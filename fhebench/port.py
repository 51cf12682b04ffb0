"""The library's parameter preset, held against the configuration file."""

from __future__ import annotations


def params_of(cfg: dict):
    """The library's preset named by the configuration, refused unless it
    is the chain the file states (a preset that moved makes the file stale)."""
    from gpufhe_tpu_torch.params.params import preset

    p = preset(cfg["preset"])
    got = {"n": p.n, "q_primes": list(p.q_primes), "p_primes": list(p.p_primes),
           "scale_bits": p.scale_bits, "scale_words": p.scale_words,
           "plain_modulus": p.plain_modulus, "hamming_weight": p.hamming_weight,
           "eph_hamming_weight": p.eph_hamming_weight, "sigma": p.sigma}
    for key, value in got.items():
        if cfg[key] != value:
            raise ValueError(f"preset {cfg['preset']!r} has {key} = {value}, the "
                             f"configuration states {cfg[key]}")
    return p

