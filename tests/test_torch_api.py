"""The port's Session and ThresholdSession (gpufhe_tpu_torch/api.py) against
the reference's (gpufhe_tpu/api.py), for every scenario of tests/test_api.py.

Both sessions are created from the same preset, seed and rotations; the
port's runs on the CPU (device="cpu"), the reference's over its golden
model: its backend swapped for the scheme's golden backend (GoldenBackend,
BGVGoldenBackend, BFVGoldenBackend, the limb-exact models of its device
backends) and its encrypt for the golden encrypt with the session's own
Generator (the same draws as its device encrypt). Everything else is the
reference Session's own code: scheme inference, asserts, key draws, the
routing of each op, noise_budget, the threshold protocol and combine. Every
ciphertext limb and every decrypt of the port == the reference's, and each
decrypt also meets tests/test_api.py's own tolerance (line beside each).
Presets: tiny2, bgv_tiny, bfv_tiny, ci_deep, boot_ci (tests/test_api.py's).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from gpufhe_tpu import api as rapi
from gpufhe_tpu.ciphertext import linalg as rlinalg
from gpufhe_tpu.ciphertext.backend import GoldenBackend
from gpufhe_tpu.ciphertext.bfv_backend import BFVGoldenBackend
from gpufhe_tpu.ciphertext.bgv_backend import BGVGoldenBackend, _orbit_to_raw
from gpufhe_tpu.encoding import encoder as rencoder
from gpufhe_tpu.golden import bfv as rgbfv
from gpufhe_tpu.golden import bgv as rgbgv
from gpufhe_tpu.golden import ckks as rgckks
from gpufhe_tpu_torch import api as papi
from gpufhe_tpu_torch.ciphertext import linalg as plinalg


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's PyTorch CPU work: its tensors are
    small (N <= 2^10), and tier-1 runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GOLDEN = {"ckks": GoldenBackend, "bgv": BGVGoldenBackend, "bfv": BFVGoldenBackend}
NAMES = {"ckks": "tiny2", "bgv": "bgv_tiny", "bfv": "bfv_tiny"}


def _golden_encrypt(self, values, level=None):
    """Session.encrypt on the golden model: the same draws from self._rng."""
    if self.scheme == "ckks":
        z = np.asarray(values, dtype=np.complex128)
        assert z.shape == (self.params.slots,)
        return rgckks.encrypt(rencoder.encode(z, self.params), self.params, self.chest.pk,
                              self._rng, self.params.scale, level=level)
    gold = rgbgv if self.scheme == "bgv" else rgbfv
    raw = _orbit_to_raw(values, self.be.rings, self.be.t, self.params.n)
    return gold.encrypt(gold.encode(raw, self.params), self.params, self.chest.pk, self._rng,
                        level=level)


def golden(ref):
    """The reference session over its golden model (module docstring)."""
    ref.be = GOLDEN[ref.scheme](ref.params, ref.chest)
    ref.encrypt = types.MethodType(_golden_encrypt, ref)
    return ref


def both(*args, **kw):
    """(port Session on the CPU, reference Session on its golden model)."""
    port = papi.Session.create(*args, **kw, device="cpu")
    ref = golden(rapi.Session.create(*args, **kw))
    assert port.scheme == ref.scheme
    assert dataclasses.asdict(port.params) == dataclasses.asdict(ref.params)
    return port, ref


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x).astype(np.int64)


def same(got, want):
    """A port ciphertext == the reference's: level, scale / pt_factor, limbs."""
    assert got.level == want.level and len(got.c) == len(want.c)
    assert getattr(got, "scale", None) == getattr(want, "scale", None)
    assert getattr(got, "pt_factor", None) == getattr(want, "pt_factor", None)
    for g, w in zip(got.c, want.c):
        assert (_np(g) == _np(w)).all()
    return got


def same_dec(port, ref, ct, rct):
    """Both decrypts of twin ciphertexts, held ==; returns the port's."""
    got, want = port.decrypt(same(ct, rct)), ref.decrypt(rct)
    assert (got == want).all()
    return got


def enc(port, ref, values, level=None):
    """Twin encryptions of the same values, held ==."""
    ct, rct = port.encrypt(values, level=level), ref.encrypt(values, level=level)
    same(ct, rct)
    return ct, rct


def test_ckks_session():
    s, r = both("tiny2", rotations=(1, 3))
    n_s = s.params.slots
    rng = np.random.default_rng(0)
    za = rng.uniform(-1, 1, size=n_s)
    zb = rng.uniform(-1, 1, size=n_s)
    (ca, rca), (cb, rcb) = enc(s, r, za), enc(s, r, zb)
    # tests/test_api.py:16-20
    assert np.abs(same_dec(s, r, s.add(ca, cb), r.add(rca, rcb)) - (za + zb)).max() < 1e-4
    prod = s.mul(ca, cb)
    assert np.abs(same_dec(s, r, prod, r.mul(rca, rcb)) - za * zb).max() < 1e-3
    got = same_dec(s, r, s.mul_plain(ca, zb), r.mul_plain(rca, zb))
    assert np.abs(got - za * zb).max() < 1e-3
    got = same_dec(s, r, s.rotate(ca, 3), r.rotate(rca, 3))
    assert np.abs(got - np.roll(za, -3)).max() < 1e-4
    assert s.level(prod) == s.level(ca) - s.params.scale_words
    same(s.add_plain(ca, 0.25), r.add_plain(rca, 0.25))
    same(s.sub(ca, cb), r.sub(rca, rcb))
    same(s.rescale(s.mul_plain(ca, zb)), r.rescale(r.mul_plain(rca, zb)))


@pytest.mark.parametrize("scheme", ["bgv", "bfv"])
def test_integer_session(scheme):
    s, r = both(NAMES[scheme], scheme=scheme, rotations="bsgs")
    t = s.params.plain_modulus
    n_s = s.params.slots
    rng = np.random.default_rng(1)
    va = rng.integers(0, t, size=n_s, dtype=np.int64)
    vb = rng.integers(0, t, size=n_s, dtype=np.int64)
    (ca, rca), (cb, rcb) = enc(s, r, va), enc(s, r, vb)
    # tests/test_api.py:32-53, exact
    assert (same_dec(s, r, s.add(ca, cb), r.add(rca, rcb))[0] == (va + vb) % t).all()
    assert (same_dec(s, r, s.sub(ca, cb), r.sub(rca, rcb))[0] == (va - vb) % t).all()
    prod, rprod = s.mul(ca, cb), r.mul(rca, rcb)
    assert (same_dec(s, r, prod, rprod)[0] == va * vb % t).all()
    if scheme == "bfv":
        assert s.level(prod) == s.level(ca)  # scale-invariant
        red = s.rescale(prod)
        assert s.level(red) == s.level(prod) - 1
        assert (same_dec(s, r, red, r.rescale(rprod))[0] == va * vb % t).all()
    else:
        assert s.level(prod) == s.level(ca) - 1
    assert (same_dec(s, r, s.mul_plain(ca, vb), r.mul_plain(rca, vb))[0] == va * vb % t).all()
    assert (same_dec(s, r, s.add_plain(ca, vb), r.add_plain(rca, vb))[0]
            == (va + vb) % t).all()
    assert (same_dec(s, r, s.rotate(ca, 1), r.rotate(rca, 1))[0] == np.roll(va, -1)).all()
    a_mat = rng.integers(0, t, size=(n_s, n_s))
    out = same_dec(s, r, s.matmul(ca, a_mat), r.matmul(rca, a_mat))[0]
    want = (a_mat.astype(object) @ va.astype(object) % t).astype(np.int64)
    assert (out == want).all()


def test_scheme_inference_and_guards():
    assert papi.Session.create("bgv_tiny", device="cpu").scheme == "bgv"
    assert papi.Session.create("tiny2", device="cpu").scheme == "ckks"
    for cls in (papi.Session, rapi.Session):
        with pytest.raises(AssertionError):
            cls.create("tiny2", scheme="bfv")
        with pytest.raises(AssertionError):
            cls.create("bgv_tiny", scheme="ckks")
        with pytest.raises(AssertionError):
            cls.create("bgv_tiny", bootstrap=True)


def test_rotate_composed_pow2_keys():
    """Any rotation amount from the log2(slots) power-of-two keys
    (linalg.rotate_composed), on a CKKS and a BGV session
    (tests/test_api.py:73-95)."""
    slots = papi.Session.create("tiny2", device="cpu").params.slots
    assert plinalg.pow2_rotations(slots) == rlinalg.pow2_rotations(slots)
    s, r = both("tiny2", rotations=tuple(plinalg.pow2_rotations(slots)))
    n_s = s.params.slots
    z = np.random.default_rng(7).uniform(-1, 1, size=n_s)
    ct, rct = enc(s, r, z)
    for k in (3, 11, n_s - 1):
        got = same_dec(s, r, plinalg.rotate_composed(s.be, ct, k),
                       rlinalg.rotate_composed(r.be, rct, k))
        assert np.abs(got - np.roll(z, -k)).max() < 1e-3

    b, rb = both("bgv_tiny", rotations=tuple(plinalg.pow2_rotations(128)))
    t = b.params.plain_modulus
    v = np.random.default_rng(8).integers(0, t, size=b.params.slots)
    ct, rct = enc(b, rb, v)
    got = same_dec(b, rb, plinalg.rotate_composed(b.be, ct, 37),
                   rlinalg.rotate_composed(rb.be, rct, 37))
    assert (got[0] == np.roll(v, -37)).all()


def test_session_nonlinear_toolkit():
    """inverse and sqrt at ci_deep, iterations cut to 3 as the reference's
    test cuts them (tests/test_api.py:98-113); the toolkit refuses BFV."""
    s, r = both("ci_deep")
    rng = np.random.default_rng(5)
    x = rng.uniform(0.2, 1.0, size=s.params.slots)
    ct, rct = enc(s, r, x)
    inv = np.real(same_dec(s, r, s.inverse(ct, iters=3), r.inverse(rct, iters=3)))
    assert (np.abs(inv - 1.0 / x) * x).max() < 2e-1
    ct, rct = enc(s, r, x)
    rt = np.real(same_dec(s, r, s.sqrt(ct, iters=3), r.sqrt(rct, iters=3)))
    assert np.abs(rt - np.sqrt(x)).max() < 2e-1
    bfv = papi.Session.create("bfv_tiny", scheme="bfv", device="cpu")
    for op in (bfv.inverse, bfv.sqrt, bfv.exp, bfv.sign, bfv.relu, bfv.softmax,
               bfv.bootstrap):
        with pytest.raises(AssertionError):
            op(None)


def test_session_bootstrap():
    """Session.create(..., bootstrap=True) at boot_ci: the bootstrap rotation
    set and conj key, one refresh == the reference's, decoded within 0.02
    (tests/test_api.py:116-131); a session without those keys refuses."""
    s, r = both("boot_ci", bootstrap=True)
    assert sorted(s.chest.galois) == sorted(r.chest.galois) and s.chest.conj is not None
    rng = np.random.default_rng(0)
    z = (rng.normal(size=s.params.slots) + 1j * rng.normal(size=s.params.slots)) * 0.2
    ct, rct = enc(s, r, z, level=1)
    out, rout = s.bootstrap(ct), r.bootstrap(rct)
    assert s.level(out) >= 2
    assert np.abs(same_dec(s, r, out, rout) - z).max() < 0.02
    with pytest.raises(AssertionError):
        papi.Session.create("boot_ci", device="cpu").bootstrap(ct)


@pytest.mark.parametrize("scheme", ["ckks", "bgv", "bfv"])
def test_session_save_load(tmp_path, scheme):
    """save / load and save_ct / load_ct round-trip per scheme, and across
    the packages: the reference loads the port's files and the port loads
    the reference's, each restored session decrypting the other's
    ciphertext (tests/test_api.py:134-164)."""
    s, r = both(NAMES[scheme], scheme=scheme, rotations=(1,),
                conjugation=(scheme == "ckks"))
    rng = np.random.default_rng(3)
    if scheme == "ckks":
        v = rng.uniform(-1, 1, size=s.params.slots)
    else:
        v = rng.integers(0, s.params.plain_modulus, size=s.params.slots, dtype=np.int64)
    ct, rct = enc(s, r, v)
    s.save_ct(tmp_path / "ct.npz", ct)
    s.save(tmp_path / "sess.npz")
    r.save_ct(tmp_path / "rct.npz", rct)
    r.save(tmp_path / "rsess.npz")

    for sess, cts in (("sess.npz", "ct.npz"), ("rsess.npz", "rct.npz")):
        p = papi.Session.load(tmp_path / sess, device="cpu")
        q = golden(rapi.Session.load(tmp_path / sess))
        assert p.scheme == q.scheme == scheme and p.params == s.params
        ct2 = same(p.load_ct(tmp_path / cts), ct)
        rct2 = rapi.Session.load_ct(q, tmp_path / cts)
        rct2 = type(rct)([np.asarray(c).astype(np.int64) for c in rct2.c],
                         *[getattr(rct2, f) for f in ("level", "scale", "pt_factor")
                           if hasattr(rct2, f)])
        got = same_dec(p, q, p.mul(ct2, ct2), q.mul(rct2, rct2))
        got_rot = same_dec(p, q, p.rotate(ct2, 1), q.rotate(rct2, 1))
        if scheme == "ckks":
            assert np.abs(got - v * v).max() < 1e-3
            assert np.abs(got_rot - np.roll(v, -1)).max() < 1e-4
        else:
            assert (got[0] == v * v % s.params.plain_modulus).all()
            assert (got_rot[0] == np.roll(v, -1)).all()


def _threshold_both(name, scheme):
    port = papi.ThresholdSession.create_threshold(name, n_parties=3, scheme=scheme,
                                                  rotations=(1,), device="cpu")
    ref = golden(rapi.ThresholdSession.create_threshold(name, n_parties=3, scheme=scheme,
                                                        rotations=(1,)))
    for a, b in zip(port.shares, ref.shares):
        assert (a.s == b.s).all() and (a.b == b.b).all()
    assert (_np(port.chest.pk.b) == ref.chest.pk.b).all()
    assert (_np(port.chest.rlk.b) == ref.chest.rlk.b).all()
    assert (_np(port.chest.galois[1][0].b) == ref.chest.galois[1][0].b).all()
    return port, ref


@pytest.mark.parametrize("scheme", ["ckks", "bgv", "bfv"])
def test_threshold_session(scheme):
    """Joint keys, the collaborative multiply and rotation, every party's
    partial and the combine == the reference's; decryption only through all
    partials (tests/test_api.py:167-199)."""
    ts, rs = _threshold_both(NAMES[scheme], scheme)
    rng = np.random.default_rng(5)
    if scheme == "ckks":
        v = rng.uniform(-0.5, 0.5, size=ts.params.slots)
    else:
        v = rng.integers(0, ts.params.plain_modulus, size=ts.params.slots, dtype=np.int64)
    ct, rct = enc(ts, rs, v)
    rout = rs.rotate(rs.mul(rct, rct), 1)  # the collaborative rlk and Galois key
    out = same(ts.rotate(ts.mul(ct, ct), 1), rout)
    with pytest.raises(RuntimeError):
        ts.decrypt(out)
    partials = [ts.partial_decrypt(out, i, np.random.default_rng(20 + i)) for i in range(3)]
    rpartials = [rs.partial_decrypt(rout, i, np.random.default_rng(20 + i)) for i in range(3)]
    for p, q in zip(partials, rpartials):
        assert (_np(p) == _np(q)).all()
    got, want_ref = ts.combine(out, partials), rs.combine(rout, rpartials)
    assert (got == want_ref).all()
    if scheme == "ckks":
        want = np.roll(v * v, -1)
        assert np.abs(got - want).max() < 1e-2
    else:
        want = np.roll(v * v % ts.params.plain_modulus, -1)
        assert (got[0] == want).all()
    bad = ts.combine(out, partials[:-1])
    assert (bad == rs.combine(rout, rpartials[:-1])).all()
    if scheme == "ckks":
        assert np.abs(bad - want).max() > 1.0
    else:
        assert not (bad[0] == want).all()


@pytest.mark.parametrize("scheme", ["bgv", "bfv"])
def test_noise_budget_monotone(scheme):
    """noise_budget == the reference's after each squaring, falls after each
    one, and decryption holds exactly while it stays positive
    (tests/test_api.py:202-235)."""
    s, r = both(NAMES[scheme], scheme=scheme)
    t = s.params.plain_modulus
    rng = np.random.default_rng(11)
    v = rng.integers(0, t, size=s.params.slots, dtype=np.int64)
    ct, rct = enc(s, r, v)
    want = v.copy()
    budgets = [s.noise_budget(ct)]
    assert budgets[0] == r.noise_budget(rct) and budgets[0] > 10
    steps = s.params.num_limbs - 1 if scheme == "bgv" else 6
    saw_failure = False
    for _ in range(steps):
        ct, rct = s.mul(ct, ct), r.mul(rct, rct)
        want = want * want % t
        b = s.noise_budget(ct)
        assert b == r.noise_budget(rct)
        assert b < budgets[-1], "budget must decrease after a mult"
        budgets.append(b)
        ok = (same_dec(s, r, ct, rct)[0] == want).all()
        if b > 2:
            assert ok, f"decryption failed with {b:.1f} bits of budget left"
        if b < -1:
            assert not ok, "budget exhausted but decryption still correct"
        if not ok:
            saw_failure = True
            break
    if scheme == "bfv":
        assert saw_failure or budgets[-1] <= 2
