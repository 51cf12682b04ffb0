"""The port's golden backends (ciphertext/backend.py GoldenBackend,
bgv_backend.py BGVGoldenBackend, bfv_backend.py BFVGoldenBackend) against
the reference's, limb for limb (`==`):

- each on the port's own key chest (keys.keygen, bgv.keygen, bfv.keygen on
  the CPU: canonical switching keys as CPU tensors, pk on the context's
  device) against the reference's backend on the reference's chest from the
  same seed: a BSGS matvec through the port's linalg against one through
  the reference's, and every other method of the backend;
- one bootstrap at boot_dw_ci_enc (tests/test_torch_bootstrap.py's
  settings) through the port's Bootstrapper on the port's GoldenBackend
  against the reference's Bootstrapper on its GoldenBackend: every phase
  output and the result.
"""

import numpy as np
import pytest
import torch

from gpufhe_tpu.ciphertext import backend as rbackend
from gpufhe_tpu.ciphertext import bfv_backend as rbfv_backend
from gpufhe_tpu.ciphertext import bgv_backend as rbgv_backend
from gpufhe_tpu.ciphertext import bfv as rbfv
from gpufhe_tpu.ciphertext import bgv as rbgv
from gpufhe_tpu.ciphertext import linalg as rlinalg
from gpufhe_tpu.ciphertext.bootstrap import Bootstrapper as RefBootstrapper
from gpufhe_tpu.golden import bfv as rgbfv
from gpufhe_tpu.golden import bgv as rgbgv
from gpufhe_tpu.golden import ckks as rgckks
from gpufhe_tpu.keys import keys as rkeys
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch.ciphertext import backend as pbackend
from gpufhe_tpu_torch.ciphertext import bfv as pbfv
from gpufhe_tpu_torch.ciphertext import bfv_backend as pbfv_backend
from gpufhe_tpu_torch.ciphertext import bgv as pbgv
from gpufhe_tpu_torch.ciphertext import bgv_backend as pbgv_backend
from gpufhe_tpu_torch.ciphertext import linalg as plinalg
from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper, bootstrap_rotations
from gpufhe_tpu_torch.golden import bfv as gbfv
from gpufhe_tpu_torch.golden import bgv as gbgv
from gpufhe_tpu_torch.golden import ckks as gckks
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


def _same_ct(got, want):
    assert got.level == want.level and len(got.c) == len(want.c)
    for name in ("scale", "pt_factor"):
        assert getattr(got, name, None) == getattr(want, name, None)
    for g, w in zip(got.c, want.c):
        assert isinstance(g, np.ndarray) and g.dtype == np.int64
        assert (g == np.asarray(w)).all()


def _slots(params, rng):
    return rng.normal(size=params.slots) + 1j * rng.normal(size=params.slots)


@pytest.fixture(scope="module")
def ckks():
    params, rparams = preset("tiny2"), ref_preset("tiny2")
    rots = tuple(plinalg.bsgs_rotations(params.slots))
    assert list(rots) == rlinalg.bsgs_rotations(rparams.slots)
    chest = pkeys.keygen(params, np.random.default_rng(3), rotations=rots, conjugation=True,
                         ctx=make_context(params, device="cpu"))
    rchest = rkeys.keygen(rparams, np.random.default_rng(3), rotations=rots, conjugation=True)
    be, rbe = pbackend.GoldenBackend(params, chest), rbackend.GoldenBackend(rparams, rchest)
    rng = np.random.default_rng(4)
    zs = [_slots(params, rng) * 0.5 for _ in range(2)]
    cts, rcts = [], []
    for i, z in enumerate(zs):
        pt = gckks.encode(z, params.scale, params.q_primes, params.n)
        cts.append(gckks.encrypt(pt, params, chest.pk, np.random.default_rng(5 + i), params.scale))
        rcts.append(rgckks.encrypt(pt, rparams, rchest.pk, np.random.default_rng(5 + i),
                                   params.scale))
        _same_ct(cts[-1], rcts[-1])
    return params, chest, be, rbe, zs, cts, rcts


def test_golden_backend_bsgs_matvec_matches_reference(ckks):
    params, chest, be, rbe, zs, cts, rcts = ckks
    rng = np.random.default_rng(6)
    n_s = params.slots
    a = (rng.normal(size=(n_s, n_s)) + 1j * rng.normal(size=(n_s, n_s))) / n_s
    b = (rng.normal(size=(n_s, n_s)) + 1j * rng.normal(size=(n_s, n_s))) / n_s
    got = plinalg.matmul_plain(be, cts[0], a, b)
    _same_ct(got, rlinalg.matmul_plain(rbe, rcts[0], a, b))
    want = a @ zs[0] + b @ np.conj(zs[0])
    assert np.abs(be.decrypt_decode(got) - want).max() < 1e-2


def test_golden_backend_methods_match_reference(ckks):
    params, chest, be, rbe, zs, cts, rcts = ckks
    (a, b), (ra, rb) = cts, rcts
    level = params.num_limbs
    pt, rpt = be.encode_slots(zs[1], params.scale, level), rbe.encode_slots(zs[1], params.scale,
                                                                            level)
    assert pt[1] == rpt[1] and (pt[0] == rpt[0]).all()
    _same_ct(be.mul_plain(a, pt), rbe.mul_plain(ra, rpt))
    _same_ct(be.add_plain(a, 0.25), rbe.add_plain(ra, 0.25))
    _same_ct(be.add(a, b), rbe.add(ra, rb))
    _same_ct(be.sub(a, b), rbe.sub(ra, rb))
    prod = be.mul(a, b)
    _same_ct(prod, rbe.mul(ra, rb))
    _same_ct(be.add(prod, a), rbe.add(rbe.mul(ra, rb), ra))  # aligns levels
    _same_ct(be.rescale(be.mul_plain(a, pt)), rbe.rescale(rbe.mul_plain(ra, rpt)))
    assert be.rescale_prod(level) == rbe.rescale_prod(level)
    _same_ct(be.conjugate(a), rbe.conjugate(ra))
    for s, ct in be.rotate_hoisted(a, [1, 2]).items():
        _same_ct(ct, rbe.rotate_hoisted(ra, [1, 2])[s])
    _same_ct(be.drop_to_level(a, 2), rbe.drop_to_level(ra, 2))
    assert be.level(a) == rbe.level(ra) == level
    rng = np.random.default_rng(8)
    diags = [{0: _slots(params, rng), 1: _slots(params, rng)}, {2: _slots(params, rng)}]
    plan, rplan = be.make_fan_plan(diags, level), rbe.make_fan_plan(diags, level)
    assert isinstance(plan, pbackend.GoldenFanPlan) and plan.pt_scale == rplan.pt_scale
    for g, w in zip(be.apply_fan(a, plan), rbe.apply_fan(ra, rplan)):
        _same_ct(g, w)
    low = be.drop_to_level(a, params.scale_words)
    _same_ct(be.mod_raise(low), rbe.mod_raise(rbe.drop_to_level(ra, params.scale_words)))
    assert (be.decrypt_decode(a) == rbe.decrypt_decode(ra)).all()


@pytest.mark.parametrize("scheme", ["bgv", "bfv"])
def test_integer_golden_backend_matches_reference(scheme):
    """A BSGS matvec in orbit order, then every other method, on the port's
    integer golden backend against the reference's."""
    dev_mod, ref_mod, gold, rgold, pb, rb = {
        "bgv": (pbgv, rbgv, gbgv, rgbgv, pbgv_backend.BGVGoldenBackend,
                rbgv_backend.BGVGoldenBackend),
        "bfv": (pbfv, rbfv, gbfv, rgbfv, pbfv_backend.BFVGoldenBackend,
                rbfv_backend.BFVGoldenBackend)}[scheme]
    name = f"{scheme}_tiny"
    params, rparams = preset(name), ref_preset(name)
    t, n_s = params.plain_modulus, params.slots
    rots = tuple(plinalg.bsgs_rotations(n_s))
    chest = dev_mod.keygen(params, np.random.default_rng(12), rotations=rots,
                           ctx=make_context(params, device="cpu"))
    rchest = ref_mod.keygen(rparams, np.random.default_rng(12), rotations=rots)
    be, rbe = pb(params, chest), rb(rparams, rchest)
    rng = np.random.default_rng(13)
    v = rng.integers(0, t, size=(2, n_s))
    raw = np.empty(params.n, dtype=np.int64)
    raw[be.rings[0]], raw[be.rings[1]] = v[0], v[1]
    ct = gold.encrypt(gold.encode(raw, params), params, chest.pk, np.random.default_rng(14))
    rct = rgold.encrypt(rgold.encode(raw, rparams), rparams, rchest.pk,
                        np.random.default_rng(14))
    _same_ct(ct, rct)
    mat = rng.integers(0, t, size=(n_s, n_s))
    got = plinalg.matmul_plain(be, ct, mat)
    _same_ct(got, rlinalg.matmul_plain(rbe, rct, mat))
    want = (mat.astype(object) @ v.T.astype(object) % t).T.astype(np.int64)
    assert (be.decrypt_decode(got) == want).all()
    pt, rpt = be.encode_slots(v[1], None, ct.level), rbe.encode_slots(v[1], None, rct.level)
    assert (pt == rpt).all()
    _same_ct(be.mul_plain(ct, pt), rbe.mul_plain(rct, rpt))
    _same_ct(be.add(ct, ct), rbe.add(rct, rct))
    _same_ct(be.sub(ct, ct), rbe.sub(rct, rct))
    prod = be.mul(ct, ct)
    _same_ct(prod, rbe.mul(rct, rct))
    _same_ct(be.add_plain(prod, v), rbe.add_plain(rbe.mul(rct, rct), v))
    _same_ct(be.rotate(ct, 1), rbe.rotate(rct, 1))
    for s, c in be.rotate_hoisted(ct, [1, 2]).items():
        _same_ct(c, rbe.rotate_hoisted(rct, [1, 2])[s])
    _same_ct(be.rescale(prod), rbe.rescale(rbe.mul(rct, rct)))
    assert be.level(ct) == rbe.level(rct)
    assert (be.decrypt_decode(prod) == rbe.decrypt_decode(rbe.mul(rct, rct))).all()


def _recorder(into):
    def mark(name, outs):
        into[name] = outs if isinstance(outs, tuple) else (outs,)
    return mark


def test_golden_bootstrap_matches_reference():
    """boot_dw_ci_enc (double-word scale, encapsulation h=16, factored
    transforms at radix_log 3, Chebyshev EvalMod at k_bound 5): the port's
    Bootstrapper on the port's GoldenBackend and key chest == the
    reference's Bootstrapper on its GoldenBackend and chest, phase by phase."""
    name = "boot_dw_ci_enc"
    settings = dict(transform="factored", radix_log=3, evalmod="cheb", k_bound=5.0)
    params, rparams = preset(name), ref_preset(name)
    rots = tuple(bootstrap_rotations(params, "factored", 3))
    chest = pkeys.keygen(params, np.random.default_rng(7), rotations=rots, conjugation=True,
                         ctx=make_context(params, device="cpu"))
    rchest = rkeys.keygen(rparams, np.random.default_rng(7), rotations=rots, conjugation=True)
    bs = Bootstrapper(pbackend.GoldenBackend(params, chest), **settings)
    rbs = RefBootstrapper(rbackend.GoldenBackend(rparams, rchest), **settings)
    rng = np.random.default_rng(0)
    z = _slots(params, rng) * 0.2
    pt = gckks.encode(z, params.scale, params.q_primes, params.n)
    w = params.scale_words
    ct = gckks.encrypt(pt, params, chest.pk, np.random.default_rng(1), params.scale, level=w)
    rct = rgckks.encrypt(pt, rparams, rchest.pk, np.random.default_rng(1), params.scale, level=w)
    _same_ct(ct, rct)
    got, want = {}, {}
    out = bs(ct, _phase=_recorder(got))
    rout = rbs(rct, _phase=_recorder(want))
    assert list(want) == list(got) == ["mod_raise", "coeff_to_slot", "evalmod", "slot_to_coeff"]
    for phase, outs in want.items():
        # the reference's hook passes each phase's last output; the port's all of them
        _same_ct(got[phase][-1], outs[-1])
    _same_ct(out, rout)
    assert np.abs(bs.be.decrypt_decode(out) - z).max() < 1e-3
