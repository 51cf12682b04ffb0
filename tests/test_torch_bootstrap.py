"""The port's CKKS bootstrap against the reference's.

gpufhe_tpu_torch's Bootstrapper on its DeviceBackend (on the CPU) against
gpufhe_tpu's Bootstrapper on its GoldenBackend (the reference's oracle,
limb-equal to its DeviceBackend), with the same keys (carried by
interop.chest_from_reference) and the same input ciphertext, at three
configurations:

- boot_dw_ci_enc: double-word scale, encapsulation (eph h=16), factored
  transforms at radix_log 3, Chebyshev EvalMod with k_bound 5;
- boot_ci_cheb: factored radix 3, Chebyshev EvalMod, k_bound 12;
- boot_ci and boot_ci_deep: dense BSGS transforms, Taylor cos EvalMod;
- boot_ci_deep at config5_boot_h's settings: factored radix 2, Chebyshev
  EvalMod, k_bound 12.

Every phase output (mod_raise, coeff_to_slot t0 and t1, evalmod y0 and y1,
slot_to_coeff) is == limb for limb at an equal level, scales within 1e-12
relative, and the decode within the reference tests' tolerances. A steady
call encodes nothing; galois_step_levels and bootstrap_rotations equal the
reference's. The backend's rescale drops scale_words limbs in one drop with
one transform each way, == ct_rescale scale_words times and the reference's. A lean_keys run on a device_keygen chest drops and draws again
the Galois keys' `a` halves around its first EvalMod, and every phase output
== a run that keeps them.
"""

import numpy as np
import pytest
import torch

from gpufhe_tpu.ciphertext.backend import GoldenBackend
from gpufhe_tpu.ciphertext.bootstrap import Bootstrapper as RefBootstrapper
from gpufhe_tpu.ciphertext.bootstrap import bootstrap_rotations as ref_rotations
from gpufhe_tpu.golden import ckks as gckks
from gpufhe_tpu.keys import keys as rkeys
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch import interop
from gpufhe_tpu_torch.ciphertext import ct as pct
from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper, bootstrap_rotations
from gpufhe_tpu_torch.encoding import encoder as penc
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import preset

FACTORED = dict(transform="factored", radix_log=3, evalmod="cheb")
# preset -> (Bootstrapper settings, decode tolerance: tests/test_fftboot.py
# :193 for the dw bootstrap, :141 for the Chebyshev one, tests/test_bootstrap
# .py:83 for the dense one)
CASES = {
    "boot_dw_ci_enc": (dict(FACTORED, k_bound=5.0), 1e-3),
    "boot_ci_cheb": (dict(FACTORED, k_bound=12.0), 1e-2),
    "boot_ci": ({}, 2e-2),
    # the bootstrap with compute headroom (19 limbs), as the reference's
    # tests drive it: dense transforms, Taylor cos (tests/test_bootstrap.py)
    "boot_ci_deep": ({}, 2e-2),
    # and with config5_boot_h's settings (scripts/bootstrap_n16.py): factored
    # radix 2, Chebyshev EvalMod, k_bound 12, a single-word sparse secret
    "boot_ci_deep_h": (dict(FACTORED, radix_log=2, k_bound=12.0), 1e-2),
}
PRESET = {"boot_ci_deep_h": "boot_ci_deep"}  # case -> preset, where they differ
PHASES = ("mod_raise", "coeff_to_slot", "evalmod", "slot_to_coeff")


def _recorder(into):
    def mark(name, outs):
        into[name] = outs if isinstance(outs, tuple) else (outs,)
    return mark


def _record_evalmod_inputs(bs, into):
    """Wrap the reference's EvalMod so its inputs (t0, t1) and outputs (y0,
    y1) are kept: the reference's phase hook passes t1 and y1 only."""
    name = "_cheb" if bs.evalmod == "cheb" else "_evalmod"
    inner = getattr(bs, name)

    def wrapped(t):
        y = inner(t)
        into.setdefault("t", []).append(t)
        into.setdefault("y", []).append(y)
        return y

    setattr(bs, name, wrapped)


@pytest.fixture(scope="module", params=list(CASES))
def boot(request):
    name = PRESET.get(request.param, request.param)
    settings, tol = CASES[request.param]
    params, rparams = preset(name), ref_preset(name)
    transform = settings.get("transform", "dense")
    rots = ref_rotations(rparams, transform, settings.get("radix_log", 3))
    rchest = rkeys.keygen(rparams, np.random.default_rng(7), rotations=tuple(rots),
                          conjugation=True)
    chest = interop.chest_from_reference(rchest, "cpu")
    ctx = make_context(params, device="cpu")
    be = DeviceBackend(params, ctx, chest)
    bs = Bootstrapper(be, **settings)
    rbs = RefBootstrapper(GoldenBackend(rparams, rchest), **settings)
    rng = np.random.default_rng(0)
    z = (rng.normal(size=params.slots) + 1j * rng.normal(size=params.slots)) * 0.2
    pt = penc.encode(z, params)
    w = params.scale_words
    ct = pct.encrypt(pt, params, chest.device_pk, ctx, np.random.default_rng(1), params.scale,
                     level=w)
    rct = gckks.encrypt(pt, rparams, rchest.pk, np.random.default_rng(1), params.scale, level=w)
    got, want = {}, {}
    out = bs(ct, _phase=_recorder(got))
    _record_evalmod_inputs(rbs, want)
    rout = rbs(rct, _phase=_recorder(want))
    return dict(name=name, params=params, rparams=rparams, be=be, bs=bs, rbs=rbs, ct=ct, z=z,
                tol=tol, out=out, rout=rout, got=got, want=want)


def _assert_ct_equal(got, want):
    assert got.level == want.level and len(got.c) == len(want.c)
    assert abs(got.scale / want.scale - 1.0) < 1e-12
    for g, w in zip(got.c, want.c):
        assert (g.numpy() == np.asarray(w).astype(np.int64)).all()


def test_every_phase_output_matches_reference(boot):
    got, want = boot["got"], boot["want"]
    assert list(got) == list(PHASES)
    _assert_ct_equal(got["mod_raise"][0], want["mod_raise"][0])
    assert want["mod_raise"][0].level == boot["params"].num_limbs
    for g, w in zip(got["coeff_to_slot"], want["t"]):
        _assert_ct_equal(g, w)
    for g, w in zip(got["evalmod"], want["y"]):
        _assert_ct_equal(g, w)
    # the reference's hook saw t1 and y1 after its EvalMod's inputs were kept
    _assert_ct_equal(got["coeff_to_slot"][1], want["coeff_to_slot"][0])
    _assert_ct_equal(got["evalmod"][1], want["evalmod"][0])
    _assert_ct_equal(got["slot_to_coeff"][0], want["slot_to_coeff"][0])
    _assert_ct_equal(boot["out"], boot["rout"])


def test_output_decodes_to_the_input(boot):
    params, out = boot["params"], boot["out"]
    # boot_ci_cheb at k_bound 12 lands on level 1, as the reference does
    assert out.level >= 1 and abs(out.scale / params.scale - 1.0) < 1e-9
    err = np.abs(boot["be"].decrypt_decode(out) - boot["z"]).max()
    assert err < boot["tol"], err


def test_steady_call_encodes_nothing_and_times_its_phases(boot):
    be, bs = boot["be"], boot["bs"]
    before = be.encode_misses
    out, times = bs.timed_call(boot["ct"])
    assert be.encode_misses == before, f"{be.encode_misses - before} host encodes"
    assert list(times) == list(PHASES) and all(t >= 0 for t in times.values())
    _assert_ct_equal(out, boot["rout"])


def test_backend_rescale_is_one_drop_between_two_transforms(boot, monkeypatch):
    """DeviceBackend.rescale on CoeffToSlot's first output: two NTT calls
    (one batched transform each way) and one drop_limbs call for all
    scale_words limbs; its limbs == ct_rescale applied scale_words times ==
    the reference's GoldenBackend.rescale."""
    from gpufhe_tpu_torch.ops import ntt, rescale_cuda

    be, params = boot["be"], boot["params"]
    ct, rct = boot["got"]["coeff_to_slot"][0], boot["want"]["t"][0]
    calls = {"fourstep": 0, "drop_limbs": 0}

    def counted(module, name):
        inner = getattr(module, name)

        def wrapped(*args, **kwargs):
            calls[name] += 1
            return inner(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapped)

    counted(ntt, "fourstep")
    counted(rescale_cuda, "drop_limbs")
    out = be.rescale(ct)
    assert calls == {"fourstep": 2, "drop_limbs": 1}
    assert out.level == ct.level - params.scale_words
    seq = ct
    for _ in range(params.scale_words):
        seq = pct.ct_rescale(seq, params, be.ctx)
    assert out.scale == seq.scale and all(torch.equal(a, b) for a, b in zip(out.c, seq.c))
    _assert_ct_equal(out, boot["rbs"].be.rescale(rct))


def test_galois_step_levels_and_rotations_match_reference(boot):
    bs, rbs, params = boot["bs"], boot["rbs"], boot["params"]
    assert bs.galois_step_levels() == rbs.galois_step_levels()
    for transform in ("dense", "factored"):
        for radix in (2, 3):
            assert bootstrap_rotations(params, transform, radix) == ref_rotations(
                boot["rparams"], transform, radix)


def test_lean_keys_cycle_changes_no_phase_output():
    """Bootstrapper(lean_keys=True) on a seeded device chest: the first call
    drops every Galois `a` after CoeffToSlot and draws them again before
    SlotToCoeff; each phase output of it and of a second call == a run on
    the same keys kept whole. On a KeyChest the option does nothing."""
    from gpufhe_tpu_torch.keys import keys as pkeys
    from gpufhe_tpu_torch.keys.device_keygen import device_keygen

    name = "boot_ci_cheb"
    settings, tol = CASES[name]
    params = preset(name)
    ctx = make_context(params, device="cpu")
    rots = bootstrap_rotations(params, "factored", 3)

    def chest():
        return device_keygen(params, np.random.default_rng(7), tuple(rots), True, ctx=ctx)

    lean_chest, whole_chest = chest(), chest()
    lean = Bootstrapper(DeviceBackend(params, ctx, lean_chest), lean_keys=True, **settings)
    whole = Bootstrapper(DeviceBackend(params, ctx, whole_chest), **settings)
    assert lean._lean_pending and not whole._lean_pending
    seen = {}
    drop, regen = lean_chest.drop_galois_a, lean_chest.regen_galois_a

    def counted_drop():
        seen["dropped"] = drop()
        return seen["dropped"]

    def counted_regen(c):
        assert all(k.a_mont is None for _, k in lean_chest.galois.values())
        seen["regen"] = regen(c)
        return seen["regen"]

    lean_chest.drop_galois_a, lean_chest.regen_galois_a = counted_drop, counted_regen
    z = np.random.default_rng(0).normal(size=params.slots) * 0.2
    ct = pct.encrypt(penc.encode(z, params), params, lean_chest.device_pk, ctx,
                     np.random.default_rng(1), params.scale, level=1)
    for call in range(2):
        got, want = {}, {}
        out = lean(ct, _phase=_recorder(got))
        whole(ct, _phase=_recorder(want))
        assert list(got) == list(PHASES)
        for phase in PHASES:
            for g, w in zip(got[phase], want[phase], strict=True):
                _assert_ct_equal(g, w)
        if call == 0:
            assert seen == {"dropped": len(rots) + 1, "regen": len(rots) + 1}
            seen.clear()
    assert not seen and not lean._lean_pending  # the second call keeps every key
    for s in rots:
        assert torch.equal(lean_chest.galois_key(s).a_mont, whole_chest.galois_key(s).a_mont)
    assert np.abs(lean.be.decrypt_decode(out) - z).max() < tol

    keys_chest = pkeys.keygen(params, np.random.default_rng(7), tuple(rots), True, ctx=ctx)
    assert not Bootstrapper(DeviceBackend(params, ctx, keys_chest), lean_keys=True,
                            **settings)._lean_pending
