"""config5_boot_h's bootstrap at smaller rings: the port against the reference.

config5_boot_h's own chain (its 30 q-primes and 5 p-primes, scale 2^28, a
sparse h=64 secret, dnum 6) and the settings of the reference's
scripts/bootstrap_n16.py (factored transforms at radix_log 2, Chebyshev
EvalMod, k_bound 12), at ring degree N = 2^logN instead of 2^16: the primes
are 1 mod 2^17, so they are NTT primes of every smaller ring too. The
reference's Bootstrapper on its GoldenBackend and the port's on its
DeviceBackend (on the CPU) take the same keys (carried by
interop.chest_from_reference) and the same input ciphertext.

The tests, at N = 2^10:
- every phase output == the reference's limb for limb;
- the output decodes within the CKKS decode gate (tests/test_pipeline.py:109);
- the CoeffToSlot output's imaginary part is the conjugation key switch's
  noise and nothing else, and that noise is larger than the last stage's.

Run as a script, it prints for each logN given (default 8 10 12 14) whether
every phase is == the reference's and the reference's own errors: max and
rms |dec - z| end to end, and the CoeffToSlot output's error in its real and
imaginary parts (N = 2^14 takes minutes on a CPU):

    JAX_PLATFORMS=cpu python tests/test_torch_boot_h_ring.py 8 10 12 14
"""

import dataclasses
import pathlib
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from gpufhe_tpu.ciphertext.backend import GoldenBackend  # noqa: E402
from gpufhe_tpu.ciphertext.bootstrap import Bootstrapper as RefBootstrapper  # noqa: E402
from gpufhe_tpu.ciphertext.bootstrap import bootstrap_rotations as ref_rotations  # noqa: E402
from gpufhe_tpu.golden import ckks as rgckks  # noqa: E402
from gpufhe_tpu.keys import keys as rkeys  # noqa: E402
from gpufhe_tpu.params.params import preset as ref_preset  # noqa: E402
from gpufhe_tpu_torch import interop  # noqa: E402
from gpufhe_tpu_torch.ciphertext import ct as pct  # noqa: E402
from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend  # noqa: E402
from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper  # noqa: E402
from gpufhe_tpu_torch.ciphertext.fftboot import bit_rev_perm  # noqa: E402
from gpufhe_tpu_torch.encoding import encoder as penc  # noqa: E402
from gpufhe_tpu_torch.golden import ckks as pgckks  # noqa: E402
from gpufhe_tpu_torch.ops.context import make_context  # noqa: E402
from gpufhe_tpu_torch.params.params import preset  # noqa: E402

PRESET = "config5_boot_h"
SETTINGS = dict(transform="factored", radix_log=2, evalmod="cheb", k_bound=12.0)
DECODE_TOL = 1e-2  # tests/test_pipeline.py:109
LOG_N = 10


def run(log_n: int) -> dict:
    """Both bootstraps at N = 2^log_n on the same keys and input; every phase
    output of each (t0/t1 and y0/y1 kept apart) and the port's objects."""
    rparams = dataclasses.replace(ref_preset(PRESET), n=2**log_n)
    params = dataclasses.replace(preset(PRESET), n=2**log_n)
    rots = ref_rotations(rparams, "factored", SETTINGS["radix_log"])
    rchest = rkeys.keygen(rparams, np.random.default_rng(7), rotations=tuple(rots),
                          conjugation=True)
    chest = interop.chest_from_reference(rchest, "cpu")
    ctx = make_context(params, device="cpu")
    be = DeviceBackend(params, ctx, chest)
    bs = Bootstrapper(be, **SETTINGS)
    rbs = RefBootstrapper(GoldenBackend(rparams, rchest), **SETTINGS)
    rng = np.random.default_rng(0)
    z = (rng.normal(size=params.slots) + 1j * rng.normal(size=params.slots)) * 0.2
    pt = penc.encode(z, params)
    ct = pct.encrypt(pt, params, chest.device_pk, ctx, np.random.default_rng(1), params.scale,
                     level=1)
    rct = rgckks.encrypt(pt, rparams, rchest.pk, np.random.default_rng(1), params.scale, level=1)
    got, want = {}, {}
    for b, into in ((bs, got), (rbs, want)):
        inner = b._cheb

        def cheb(t, inner=inner, into=into):
            y = inner(t)
            into.setdefault("coeff_to_slot", []).append(t)
            into.setdefault("evalmod", []).append(y)
            return y

        b._cheb = cheb

    def raised(into):  # the port's hook passes a tuple of outputs, the reference's one
        def mark(name, x):
            if name == "mod_raise":
                into[name] = list(x) if isinstance(x, tuple) else [x]
        return mark

    t = time.perf_counter()
    got["slot_to_coeff"] = [bs(ct, _phase=raised(got))]
    port_s = time.perf_counter() - t
    t = time.perf_counter()
    want["slot_to_coeff"] = [rbs(rct, _phase=raised(want))]
    return dict(params=params, rchest=rchest, be=be, bs=bs, z=z, got=got, want=want,
                port_s=port_s, ref_s=time.perf_counter() - t)


def same(got, want) -> bool:
    return (got.level == want.level and abs(got.scale / want.scale - 1.0) < 1e-12
            and all((g.numpy() == np.asarray(w).astype(np.int64)).all()
                    for g, w in zip(got.c, want.c)))


def cts_error(r: dict) -> tuple[np.ndarray, ...]:
    """Each CoeffToSlot output's decode minus u / (q0 k_bound), u the
    decrypted ModRaise output, in the factored transform's bit-reversed slot
    order."""
    params, be = r["params"], r["be"]
    coeff = pct.decrypt_to_coeff(r["got"]["mod_raise"][0], params, r["be"].chest.device_sk,
                                 be.ctx)
    u = pgckks.crt_compose_centered(coeff, params.q_primes).astype(np.float64)
    br, slots = bit_rev_perm(params.slots), params.slots
    q0k = params.q_primes[0] * SETTINGS["k_bound"]
    return tuple(be.decrypt_decode(t) - ui[br] / q0k
                 for t, ui in zip(r["got"]["coeff_to_slot"], (u[:slots], u[slots:])))


@pytest.fixture(scope="module")
def ring():
    return run(LOG_N)


@pytest.mark.parametrize("phase", ["mod_raise", "coeff_to_slot", "evalmod", "slot_to_coeff"])
def test_every_phase_output_matches_reference(ring, phase):
    got, want = ring["got"][phase], ring["want"][phase]
    assert len(got) == len(want) == (1 if phase in ("mod_raise", "slot_to_coeff") else 2)
    for g, w in zip(got, want):
        assert same(g, w)


def test_output_decodes_within_the_ckks_gate(ring):
    out = ring["got"]["slot_to_coeff"][0]
    err = np.abs(ring["be"].decrypt_decode(out) - ring["z"]).max()
    assert err < DECODE_TOL, err


def test_coeff_to_slot_imaginary_part_is_the_conjugation_noise(ring):
    """CoeffToSlot ends with ct_lo = u_re + conj(u_re): the values are real,
    so the imaginary part of its decode is that of the conjugation key
    switch's noise n = dec(conj(u_re)) - conj(dec(u_re)) alone; the real part
    also carries the last stage's noise, which is smaller than n."""
    be, bs = ring["be"], ring["bs"]
    x = ring["got"]["mod_raise"][0]
    for plan in bs.f_cts.shared:
        x = plan.apply(x)
    u_re, _ = bs.f_cts.last.apply_multi(x)
    conj = be.conjugate(u_re)
    t0 = be.add(u_re, conj)
    assert same(t0, ring["want"]["coeff_to_slot"][0])
    v = be.decrypt_decode(u_re)
    noise = be.decrypt_decode(conj) - np.conj(v)
    err = cts_error(ring)[0]
    assert np.abs(err.imag - noise.imag).max() < 1e-9
    # err.real = 2 Re(v) + Re(noise) - t: the last stage's error in v = t / 2
    stage = (err.real - noise.real) / 2
    assert np.sqrt(np.mean(stage**2)) < np.sqrt(np.mean(np.abs(noise) ** 2)) / 3


def main(log_ns: list[int]) -> None:
    for log_n in log_ns:
        r = run(log_n)
        equal = all(same(g, w) for p in r["got"] for g, w in zip(r["got"][p], r["want"][p]))
        rchest, out = r["rchest"], r["want"]["slot_to_coeff"][0]
        d = rgckks.decrypt_decode(out, dataclasses.replace(ref_preset(PRESET), n=2**log_n),
                                  rchest.sk) - r["z"]
        e = cts_error(r)
        print(f"N=2^{log_n}: every phase == the reference's: {equal}; the reference's "
              f"end-to-end max |dec - z| {np.abs(d).max():.6e}, rms "
              f"{np.sqrt(np.mean(np.abs(d) ** 2)):.6e}; CoeffToSlot off u / (q0 k_bound) "
              f"by max {max(np.abs(x.real).max() for x in e):.3e} (rms "
              f"{max(np.sqrt(np.mean(x.real ** 2)) for x in e):.3e}) in its real part, "
              f"{max(np.abs(x.imag).max() for x in e):.3e} (rms "
              f"{max(np.sqrt(np.mean(x.imag ** 2)) for x in e):.3e}) in its imaginary part; "
              f"bootstrap {r['ref_s']:.1f} s reference, {r['port_s']:.1f} s port (CPU)",
              flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [8, 10, 12, 14])
