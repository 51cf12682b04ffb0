"""Known-answer vectors (counterpart of gpufhe_tpu/golden/vectors.py).

The generators of tests/vectors/*.npz, with the reference's seeds, presets
and member names, on the port's golden model: each returns the dict of
arrays its file holds, so the port regenerates all six files exactly, and
chip_smoke.py holds the card against the five a device path can reach.

Config 1 uses a true 60-bit NTT prime (exact through the native library or
Python-int object arrays): it lies outside the device's 31-bit word and is
a golden-model artifact only.

write_all(out_dir) writes the six files; tests/vectors is the repository's
checked-in copy (VEC_DIR), which the reference's generator wrote.
"""

from __future__ import annotations

import pathlib

import numpy as np

from gpufhe_tpu_torch.golden import arithmetic as ga
from gpufhe_tpu_torch.golden import bfv as gbfv
from gpufhe_tpu_torch.golden import bgv as gbgv
from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.golden import ntt as gn
from gpufhe_tpu_torch.golden import rns as grns
from gpufhe_tpu_torch.params.params import preset

VEC_DIR = pathlib.Path(__file__).resolve().parents[2] / "tests" / "vectors"


def _find_prime_60bit(two_n: int) -> int:
    """The largest 60-bit prime p = 1 mod 2N."""
    p = ((1 << 60) - 1) // two_n * two_n + 1
    while not gn.is_prime(p):
        p -= two_n
    return p


def _as_u64(a) -> np.ndarray:
    return np.asarray([int(v) for v in a], dtype=np.uint64)


def gen_config1_ntt(n: int = 2**12, seed: int = 101) -> dict:
    """Forward negacyclic NTT at one 60-bit prime."""
    q = _find_prime_60bit(2 * n)
    psi = gn.find_primitive_root_2n(q, 2 * n)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 62, size=n, dtype=np.int64) % q  # int64 draws, exact math below
    fwd = gn.ntt_fwd(x, q, psi)
    if not (gn.ntt_inv(fwd, q, psi) == x).all():
        raise AssertionError("the 60-bit NTT does not invert")
    return {"q": np.uint64(q), "psi": np.uint64(psi), "x": _as_u64(x), "fwd": _as_u64(fwd)}


def gen_config2_rns(seed: int = 102) -> dict:
    """RNS add and multiply, the fast base conversion Q -> P and the rescale,
    N=2^14, L=10."""
    params = preset("config2_rns")
    n = params.n
    rng = np.random.default_rng(seed)
    qs, ps = params.q_primes, params.p_primes
    a = np.stack([rng.integers(0, q, size=n, dtype=np.int64) for q in qs])
    b = np.stack([rng.integers(0, q, size=n, dtype=np.int64) for q in qs])
    qcol = np.array(qs, dtype=np.int64)[:, None]
    return {
        "q_primes": np.asarray(qs, dtype=np.int64),
        "p_primes": np.asarray(ps, dtype=np.int64),
        "a": a, "b": b,
        "add": (a + b) % qcol,
        "mul": np.stack([ga.vec_mul(a[i], b[i], qs[i]) for i in range(len(qs))]),
        "base_convert_to_p": grns.base_convert(a, qs, ps),
        "rescale": grns.rescale_coeff(a, qs),
    }


def gen_config3_ckks(preset_name: str = "tiny2", seed: int = 103) -> dict:
    """The limb trace of encrypt, tensor, relinearise, rescale and decrypt."""
    params = preset(preset_name)
    rng = np.random.default_rng(seed)
    sk, pk = gckks.keygen(params, rng)
    rlk = gckks.make_relin_key(params, sk, rng)
    zrng = np.random.default_rng(seed + 1)
    slots = params.slots
    za = zrng.normal(size=slots) + 1j * zrng.normal(size=slots)
    zb = zrng.normal(size=slots) + 1j * zrng.normal(size=slots)
    pa = gckks.encode(za, params.scale, params.q_primes, params.n)
    pb = gckks.encode(zb, params.scale, params.q_primes, params.n)
    ca = gckks.encrypt(pa, params, pk, np.random.default_rng(seed + 2), params.scale)
    cb = gckks.encrypt(pb, params, pk, np.random.default_rng(seed + 3), params.scale)
    t = gckks.ct_tensor(ca, cb, params)
    r = gckks.ct_relinearize(t, params, rlk)
    s = gckks.ct_rescale(r, params)
    return {
        "seed": np.int64(seed),
        "preset": np.bytes_(preset_name.encode()),
        "za": za, "zb": zb,
        "ct_a0": ca.c[0], "ct_a1": ca.c[1],
        "tensor_d0": t.c[0], "tensor_d1": t.c[1], "tensor_d2": t.c[2],
        "relin_c0": r.c[0], "relin_c1": r.c[1],
        "rescale_c0": s.c[0], "rescale_c1": s.c[1],
        "decrypt_coeff": gckks.decrypt_to_coeff(s, params, sk),
    }


def gen_config4_rotations(preset_name: str = "tiny2", seed: int = 104) -> dict:
    """Hybrid key switching with hoisted rotations by 1 and 3."""
    params = preset(preset_name)
    rng = np.random.default_rng(seed)
    sk, pk = gckks.keygen(params, rng)
    gks = {s: gckks.make_galois_key(params, s, sk, rng) for s in (1, 3)}
    zrng = np.random.default_rng(seed + 1)
    z = zrng.normal(size=params.slots) + 1j * zrng.normal(size=params.slots)
    pt = gckks.encode(z, params.scale, params.q_primes, params.n)
    ct = gckks.encrypt(pt, params, pk, np.random.default_rng(seed + 2), params.scale)
    outs = gckks.ct_rotate_hoisted(ct, [1, 3], params, gks)
    return {
        "seed": np.int64(seed),
        "preset": np.bytes_(preset_name.encode()),
        "z": z,
        "rot1_c0": outs[0].c[0], "rot1_c1": outs[0].c[1],
        "rot3_c0": outs[1].c[0], "rot3_c1": outs[1].c[1],
    }


def _integer_inputs(scheme, params, seed: int):
    """sk, pk, rlk, the Galois key of step 1, the two messages and their
    ciphertexts, in the reference generators' draw order."""
    t = params.plain_modulus
    rng = np.random.default_rng(seed)
    sk, pk = scheme.keygen(params, rng)
    rlk = scheme.make_relin_key(params, sk, rng)
    gk = scheme.make_galois_key(params, 1, sk, rng)
    mrng = np.random.default_rng(seed + 1)
    m1 = mrng.integers(0, t, size=params.n, dtype=np.int64)
    m2 = mrng.integers(0, t, size=params.n, dtype=np.int64)
    c1, c2 = (scheme.encrypt(scheme.encode(m, params), params, pk,
                             np.random.default_rng(seed + 2 + i)) for i, m in enumerate((m1, m2)))
    return sk, rlk, gk, m1, m2, c1, c2


def gen_bgv_integer(preset_name: str = "bgv_tiny", seed: int = 105) -> dict:
    """BGV limb trace: encrypt, multiply (relinearise, ModSwitch), rotate."""
    params = preset(preset_name)
    sk, rlk, gk, m1, m2, c1, c2 = _integer_inputs(gbgv, params, seed)
    prod = gbgv.ct_mul(c1, c2, params, rlk)
    rot = gbgv.ct_rotate(c1, 1, params, gk)
    if not (gbgv.decrypt_decode(prod, params, sk) == m1 * m2 % params.plain_modulus).all():
        raise AssertionError("the BGV product does not decrypt to m1 * m2")
    return {
        "seed": np.int64(seed),
        "preset": np.bytes_(preset_name.encode()),
        "m1": m1, "m2": m2,
        "ct1_c0": c1.c[0], "ct1_c1": c1.c[1],
        "mul_c0": prod.c[0], "mul_c1": prod.c[1],
        "mul_pt_factor": np.int64(prod.pt_factor),
        "rot1_c0": rot.c[0], "rot1_c1": rot.c[1],
    }


def gen_bfv_integer(preset_name: str = "bfv_tiny", seed: int = 106) -> dict:
    """BFV limb trace: encrypt, the scale-invariant multiply (tensor and
    relinearise), ModReduce, rotate, and the switch to BGV."""
    params = preset(preset_name)
    sk, rlk, gk, m1, m2, c1, c2 = _integer_inputs(gbfv, params, seed)
    prod = gbfv.ct_mul(c1, c2, params, rlk)
    red = gbfv.ct_mod_reduce(prod, params)
    rot = gbfv.ct_rotate(c1, 1, params, gk)
    sw = gbfv.bfv_to_bgv(c1, params)
    if not (gbfv.decrypt_decode(prod, params, sk) == m1 * m2 % params.plain_modulus).all():
        raise AssertionError("the BFV product does not decrypt to m1 * m2")
    return {
        "seed": np.int64(seed),
        "preset": np.bytes_(preset_name.encode()),
        "m1": m1, "m2": m2,
        "ct1_c0": c1.c[0], "ct1_c1": c1.c[1],
        "mul_c0": prod.c[0], "mul_c1": prod.c[1],
        "modred_c0": red.c[0], "modred_c1": red.c[1],
        "rot1_c0": rot.c[0], "rot1_c1": rot.c[1],
        "switch_c0": sw.c[0], "switch_c1": sw.c[1],
        "switch_pt_factor": np.int64(sw.pt_factor),
    }


GENERATORS = {
    "config1_ntt_60bit": gen_config1_ntt,
    "config2_rns": gen_config2_rns,
    "config3_ckks": gen_config3_ckks,
    "config4_rotations": gen_config4_rotations,
    "bgv_integer": gen_bgv_integer,
    "bfv_integer": gen_bfv_integer,
}


def write_all(out_dir: pathlib.Path = VEC_DIR) -> list[pathlib.Path]:
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, gen in GENERATORS.items():
        path = out_dir / f"{name}.npz"
        np.savez_compressed(path, **gen())
        paths.append(path)
    return paths
