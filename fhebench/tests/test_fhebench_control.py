"""The controls (the reference one precision below the configuration's, in
the library's place) fail each cell's limits at the cells' own sizes; the
reference's own arithmetic holds against the definitions."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fhebench import harness, inputs
from fhebench.reference import ckks, integer, ring
from fhebench.tools import control

NAMES = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 98765])
@pytest.mark.parametrize("name", NAMES)
def test_control_fails_the_limit(name, seed):
    cfg, mix, cell = harness.cell_files(harness.workload(harness.manifest(), name))
    number, value, limit = control.reading(cfg, mix, cell, seed)
    assert value > limit, (number, value, limit)


def test_ntt_is_the_definition():
    n, q = 16, 97  # 97 = 1 mod 32
    psi = ring.find_psi(q, 2 * n)
    x = np.random.default_rng(0).integers(0, q, size=n)
    want = [sum(int(x[j]) * pow(psi, j * (2 * k + 1), q) for j in range(n)) % q
            for k in range(n)]
    r = ring.Ring((q,), n)
    got = r.fwd(torch.as_tensor(x)[None, :])
    assert got[0].tolist() == want
    assert r.inv(got)[0].tolist() == x.tolist()


def test_roots_are_the_librarys():
    from gpufhe_tpu_torch.params.params import preset

    for name in ("config5_boot_dw", "bfv_n16"):
        p = preset(name)
        primes = p.q_primes + p.p_primes
        assert [ring.find_psi(q, 2 * p.n) for q in primes] == list(p.psi)


def test_decode_inverts_the_librarys_encode():
    from gpufhe_tpu_torch.golden import ckks as gckks

    n, scale, primes = 256, 2.0**40, (1073479681, 1071513601)
    z = inputs.messages({"pool": 1, "message": {"dist": "complex_gauss", "scale": 0.2}}, n, 0,
                        3)[0]
    coeffs = ring.crt_centered(gckks.encode(z, scale, primes, n), primes)
    assert np.abs(ckks.decode(coeffs, scale) - z).max() < 1e-9


def test_power_poly_is_the_slotwise_power():
    t, n = 257, 64  # 257 = 1 mod 128
    m = np.random.default_rng(1).integers(0, t, size=n)
    r = ring.Ring((t,), n)
    slots = r.fwd(torch.as_tensor(m)[None, :])[0]
    want = r.fwd(torch.as_tensor(integer.power_poly(m, t, 3))[None, :])[0]
    assert (want == slots.pow(8) % t).all() or (want == _pow_mod(slots, 8, t)).all()


def _pow_mod(x, e, t):
    out = torch.ones_like(x)
    for _ in range(e):
        out = out * x % t
    return out
