"""The port's threshold FHE against the reference's.

gpufhe_tpu_torch/ciphertext/threshold.py against gpufhe_tpu's, from the same
numpy Generators: the common `a`, every party's share (s and b), the joint
public key, both rounds of the collaborative relinearisation key, the
collaborative Galois key and every partial decryption == the reference's.
The port's ciphertexts (encrypted under the joint key on the port's
pipeline, on the CPU) == the reference golden model's, and the port's
decrypt_ckks / decrypt_bgv / decrypt_bfv of them == the reference's; the
multiply and the rotation under the collaborative keys run on the port's
ct_mul_full / bfv.ct_mul / ct_rotate. partial_decrypt_device (on the CPU
context) == partial_decrypt limb for limb. Decodes within the reference
tests' tolerances (tests/test_threshold.py, line beside each); integer
results exact. Presets: tiny2, bgv_tiny, bfv_tiny (the reference's tests').
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpufhe_tpu.ciphertext import threshold as rth
from gpufhe_tpu.golden import bfv as rgbfv
from gpufhe_tpu.golden import bgv as rgbgv
from gpufhe_tpu.golden import ckks as rgckks
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch import interop
from gpufhe_tpu_torch.ciphertext import bfv as pbfv
from gpufhe_tpu_torch.ciphertext import bgv as pbgv
from gpufhe_tpu_torch.ciphertext import ct as pct
from gpufhe_tpu_torch.ciphertext import threshold as th
from gpufhe_tpu_torch.golden import ckks as pgckks
from gpufhe_tpu_torch.keys import keys as pkeys
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import preset


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's PyTorch CPU work: its tensors are
    small (N <= 2^10), and tier-1 runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N_PARTIES = 3


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x).astype(np.int64)


def _limbs_equal(got, want):
    assert got.level == want.level and len(got.c) == len(want.c)
    for g, w in zip(got.c, want.c):
        assert (_np(g) == _np(w)).all()


def _shares(name, seed):
    """Both packages' shares and joint key from the same draws, held ==."""
    params, rparams = preset(name), ref_preset(name)
    a, ra = th.common_a(params, seed), rth.common_a(rparams, seed)
    assert (a == ra).all()
    shares = [th.party_keygen(params, a, np.random.default_rng(100 + i))
              for i in range(N_PARTIES)]
    rshares = [rth.party_keygen(rparams, ra, np.random.default_rng(100 + i))
               for i in range(N_PARTIES)]
    for s, r in zip(shares, rshares):
        assert (s.s == r.s).all() and (s.b == r.b).all()
        carried = interop.party_share_from_reference(r)
        assert (carried.s == s.s).all() and (carried.b == s.b).all()
    pk = th.aggregate_public_key(params, a, [s.b for s in shares])
    rpk = rth.aggregate_public_key(rparams, ra, [s.b for s in rshares])
    assert (_np(pk.b) == rpk.b).all() and (_np(pk.a) == rpk.a).all()
    ctx = make_context(params, device="cpu")
    return params, rparams, ctx, shares, rshares, pk, rpk


def _ckks_pair(params, rparams, ctx, pk, rpk, z, seed):
    pt = pgckks.encode(z + 0j, params.scale, params.q_primes, params.n)
    device_pk = pkeys.upload_public_key(pk, params, ctx=ctx)
    ct = pct.encrypt(pt, params, device_pk, ctx, np.random.default_rng(seed), params.scale)
    rct = rgckks.encrypt(pt, rparams, rpk, np.random.default_rng(seed), params.scale)
    _limbs_equal(ct, rct)
    return ct, rct


def _partials(params, rparams, shares, rshares, ct, rct, seed0):
    ps = [th.partial_decrypt(ct, params, s, np.random.default_rng(seed0 + i))
          for i, s in enumerate(shares)]
    rps = [rth.partial_decrypt(rct, rparams, s, np.random.default_rng(seed0 + i))
           for i, s in enumerate(rshares)]
    for p, r in zip(ps, rps):
        assert (p == r).all()
    return ps, rps


def test_ckks_threshold_aggregation_matches_reference():
    params, rparams, ctx, shares, rshares, pk, rpk = _shares("tiny2", 0)
    rng = np.random.default_rng(1)
    vecs = [rng.uniform(-1, 1, size=params.slots) for _ in range(N_PARTIES)]
    pairs = [_ckks_pair(params, rparams, ctx, pk, rpk, v, 10 + i) for i, v in enumerate(vecs)]
    acc, racc = pairs[0]
    for ct, rct in pairs[1:]:
        acc, racc = pct.ct_add(acc, ct, ctx), rgckks.ct_add(racc, rct, rparams)
    _limbs_equal(acc, racc)
    ps, rps = _partials(params, rparams, shares, rshares, acc, racc, 20)
    got = th.decrypt_ckks(acc, params, ps)
    assert (got == rth.decrypt_ckks(racc, rparams, rps)).all()
    assert np.abs(got.real - np.sum(vecs, axis=0)).max() < 1e-3  # tests/test_threshold.py:49
    bad = th.decrypt_ckks(acc, params, ps[:-1])
    assert np.abs(bad.real - np.sum(vecs, axis=0)).max() > 1.0  # :52


@pytest.mark.parametrize("scheme", ["bgv", "bfv"])
def test_integer_threshold_aggregation_matches_reference(scheme):
    params, rparams, ctx, shares, rshares, pk, rpk = _shares(f"{scheme}_tiny", 3)
    t = params.plain_modulus
    pmod, gold = (pbgv, rgbgv) if scheme == "bgv" else (pbfv, rgbfv)
    device_pk = pkeys.upload_public_key(pk, params, ctx=ctx)
    rng = np.random.default_rng(4)
    vecs = [rng.integers(0, t, size=params.n, dtype=np.int64) for _ in range(N_PARTIES)]
    cts = [pmod.encrypt(gold.encode(v, rparams), params, device_pk, ctx,
                        np.random.default_rng(30 + i)) for i, v in enumerate(vecs)]
    rcts = [gold.encrypt(gold.encode(v, rparams), rparams, rpk, np.random.default_rng(30 + i))
            for i, v in enumerate(vecs)]
    acc, racc = cts[0], rcts[0]
    for ct, rct in zip(cts[1:], rcts[1:]):
        acc, racc = pmod.ct_add(acc, ct, ctx), gold.ct_add(racc, rct, rparams)
    _limbs_equal(acc, racc)
    ps, rps = _partials(params, rparams, shares, rshares, acc, racc, 40)
    dec, rdec = ((th.decrypt_bgv, rth.decrypt_bgv) if scheme == "bgv"
                 else (th.decrypt_bfv, rth.decrypt_bfv))
    got = dec(acc, params, ps)
    assert (got == rdec(racc, rparams, rps)).all()
    assert (gold.decode(got, rparams) == np.sum(vecs, axis=0) % t).all()  # :81


def test_device_partial_matches_host_partial():
    """tests/test_threshold.py:84: the device core (on the CPU context here)
    == the host partial limb for limb, with the same smudge draw."""
    params, rparams, ctx, shares, rshares, pk, rpk = _shares("tiny2", 7)
    v = np.random.default_rng(8).uniform(-1, 1, size=params.slots)
    ct, rct = _ckks_pair(params, rparams, ctx, pk, rpk, v, 9)
    want = rth.partial_decrypt(rct, rparams, rshares[0], np.random.default_rng(50))
    s_mont = th.upload_share(shares[0], params, ctx=ctx)
    got = th.partial_decrypt_device(ct, params, ctx, s_mont, shares[0],
                                    np.random.default_rng(50))
    assert (got.numpy() == want).all()
    assert (s_mont.numpy() == np.asarray(rth.upload_share(rshares[0], rparams))).all()


def test_collaborative_relinearization_ckks_matches_reference():
    params, rparams, ctx, shares, rshares, pk, rpk = _shares("tiny2", 11)
    rlk = th.collaborative_relin_key(params, shares, seed=12)
    rrlk = rth.collaborative_relin_key(rparams, rshares, seed=12)
    assert (_np(rlk.b) == rrlk.b).all() and (_np(rlk.a) == rrlk.a).all()
    rng = np.random.default_rng(13)
    za, zb = rng.uniform(-1, 1, size=params.slots), rng.uniform(-1, 1, size=params.slots)
    (a, ra), (b, rb) = (_ckks_pair(params, rparams, ctx, pk, rpk, z, 60 + i)
                        for i, z in enumerate((za, zb)))
    prod = pct.ct_mul_full(a, b, params, ctx, pkeys.upload_ks_key(rlk, params, ctx=ctx))
    rprod = rgckks.ct_mul(ra, rb, rparams, rrlk)
    _limbs_equal(prod, rprod)
    ps, rps = _partials(params, rparams, shares, rshares, prod, rprod, 70)
    got = th.decrypt_ckks(prod, params, ps)
    assert (got == rth.decrypt_ckks(rprod, rparams, rps)).all()
    assert np.abs(got.real - za * zb).max() < 1e-2  # tests/test_threshold.py:131


def test_collaborative_relinearization_bfv_matches_reference():
    params, rparams, ctx, shares, rshares, pk, rpk = _shares("bfv_tiny", 21)
    t = params.plain_modulus
    # BFV key noise is not t-scaled: the protocol runs with plain_modulus 0
    kp, rkp = (dataclasses.replace(p, plain_modulus=0) for p in (params, rparams))
    rlk = th.collaborative_relin_key(kp, [th.PartyShare(s=s.s, b=s.b) for s in shares], seed=22)
    rrlk = rth.collaborative_relin_key(rkp, [rth.PartyShare(s=s.s, b=s.b) for s in rshares],
                                       seed=22)
    assert (_np(rlk.b) == rrlk.b).all() and (_np(rlk.a) == rrlk.a).all()
    device_pk = pkeys.upload_public_key(pk, params, ctx=ctx)
    rng = np.random.default_rng(23)
    va, vb = (rng.integers(0, t, size=params.n, dtype=np.int64) for _ in range(2))
    cts = [pbfv.encrypt(rgbfv.encode(v, rparams), params, device_pk, ctx,
                        np.random.default_rng(80 + i)) for i, v in enumerate((va, vb))]
    rcts = [rgbfv.encrypt(rgbfv.encode(v, rparams), rparams, rpk, np.random.default_rng(80 + i))
            for i, v in enumerate((va, vb))]
    prod = pbfv.ct_mul(*cts, params, ctx, pkeys.upload_ks_key(rlk, params, ctx=ctx))
    rprod = rgbfv.ct_mul(*rcts, rparams, rrlk)
    _limbs_equal(prod, rprod)
    ps, rps = _partials(params, rparams, shares, rshares, prod, rprod, 90)
    got = th.decrypt_bfv(prod, params, ps)
    assert (got == rth.decrypt_bfv(rprod, rparams, rps)).all()
    assert (rgbfv.decode(got, rparams) == va * vb % t).all()  # tests/test_threshold.py:156


def test_collaborative_galois_key_matches_reference():
    params, rparams, ctx, shares, rshares, pk, rpk = _shares("tiny2", 31)
    gk = th.collaborative_galois_key(params, shares, steps=2, seed=32)
    rgk = rth.collaborative_galois_key(rparams, rshares, steps=2, seed=32)
    assert (_np(gk.b) == rgk.b).all() and (_np(gk.a) == rgk.a).all()
    z = np.random.default_rng(33).uniform(-1, 1, size=params.slots)
    ct, rct = _ckks_pair(params, rparams, ctx, pk, rpk, z, 34)
    rot = pct.ct_rotate(ct, 2, params, ctx, pkeys.upload_ks_key(gk, params, ctx=ctx))
    rrot = rgckks.ct_rotate(rct, 2, rparams, rgk)
    _limbs_equal(rot, rrot)
    ps, rps = _partials(params, rparams, shares, rshares, rot, rrot, 35)
    got = th.decrypt_ckks(rot, params, ps)
    assert (got == rth.decrypt_ckks(rrot, rparams, rps)).all()
    assert np.abs(got.real - np.roll(z, -2)).max() < 1e-2  # tests/test_threshold.py:177
