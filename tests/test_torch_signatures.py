"""The port's public functions take the reference's parameter lists, so a
caller written against gpufhe_tpu runs unchanged against gpufhe_tpu_torch:
decrypt_to_coeff(ct, params, sk, ctx) and plaintext_to_device(pt_coeff,
params, ctx), each pinned by name and called with `params` at `tiny`; the
bootstrap's surface (Bootstrapper, every DeviceBackend method, ct_diag_fan,
both ModRaises, truncate_galois_device) pinned by name; the prime-ordering
helpers, regen_ks_a, regen_pk_a and every DeviceKeyChest method pinned by
name; keygen (CKKS, BGV, BFV), the three uploads, make_context and
device_keygen taking the reference's parameters first, in its order with
its defaults, and only keyword-only extras with defaults (ctx, err_factor,
device), each also called the reference's way and == the reference; the
fields of CKKSParams and of the four key chests in the reference's order;
the public surface (api.py Session and ThresholdSession with their class
methods, cli.py and its subcommands' arguments and defaults, utils/*) name
for name and parameter for parameter, the port's extras keyword-only; the
golden model (every golden/* module, the three golden backends and
GoldenFanPlan) name for name, its key generators' ctx and err_factor
keyword-only, and each called the reference's way == the reference; and
KeyChest.golden_galois_key, bfv.plaintext_to_device, rns.base_convert and
sharded.make_fhe_mesh, each defined where the reference defines it."""

import inspect

import numpy as np
import pytest
import torch

from gpufhe_tpu.ciphertext import backend as rbackend
from gpufhe_tpu.ciphertext import bfv as rbfv
from gpufhe_tpu.ciphertext import bgv as rbgv
from gpufhe_tpu.ciphertext import bootstrap as rboot
from gpufhe_tpu.ciphertext import ct as rct
from gpufhe_tpu.encoding import encoder as renc
from gpufhe_tpu.keys import device_keygen as rdk
from gpufhe_tpu.keys import keys as rkeys
from gpufhe_tpu.ops import modops as rmodops
from gpufhe_tpu.ops.context import make_context as ref_context
from gpufhe_tpu.params import params as rparams_mod
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch.ciphertext import backend as pbackend
from gpufhe_tpu_torch.ciphertext import bfv as pbfv
from gpufhe_tpu_torch.ciphertext import bgv as pbgv
from gpufhe_tpu_torch.ciphertext import bootstrap as pboot
from gpufhe_tpu_torch.ciphertext import ct as pct
from gpufhe_tpu_torch.encoding import encoder as penc
from gpufhe_tpu_torch.keys import device_keygen as pdk
from gpufhe_tpu_torch.keys import keys as pkeys
from gpufhe_tpu_torch.ops import modops as pmodops
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params import params as pparams_mod
from gpufhe_tpu_torch.params.params import preset

PAIRS = [
    (pct.decrypt_to_coeff, rct.decrypt_to_coeff),
    (penc.plaintext_to_device, renc.plaintext_to_device),
    (penc.encode_to_device, renc.encode_to_device),
    (pct.decrypt_decode, rct.decrypt_decode),
    (pct.ct_diag_fan, rct.ct_diag_fan),
    (pct.ct_mod_raise, rct.ct_mod_raise),
    (pct.ct_mod_raise2, rct.ct_mod_raise2),
    (pkeys.truncate_galois_device, rkeys.truncate_galois_device),
    (pboot.Bootstrapper.__init__, rboot.Bootstrapper.__init__),
    (pboot.Bootstrapper.__call__, rboot.Bootstrapper.__call__),
    (pboot.Bootstrapper.timed_call, rboot.Bootstrapper.timed_call),
    (pboot.Bootstrapper.galois_step_levels, rboot.Bootstrapper.galois_step_levels),
    (pboot.bootstrap_rotations, rboot.bootstrap_rotations),
]
# the reference DeviceBackend's surface, minus nothing: every method it has
BACKEND_METHODS = sorted(
    name for name, f in vars(rbackend.DeviceBackend).items()
    if callable(f) and not name.startswith("__"))
GHOST_METHODS = sorted(
    name for name, f in vars(rbackend.GhostBackend).items()
    if callable(f) and not name.startswith("__"))


@pytest.mark.parametrize("port,ref", PAIRS, ids=lambda f: f.__name__)
def test_parameter_names_match_the_reference(port, ref):
    assert list(inspect.signature(port).parameters) == list(inspect.signature(ref).parameters)


@pytest.mark.parametrize("cls,method", [("DeviceBackend", m) for m in BACKEND_METHODS]
                         + [("GhostBackend", m) for m in GHOST_METHODS])
def test_backend_methods_match_the_reference(cls, method):
    port, ref = getattr(getattr(pbackend, cls), method), getattr(getattr(rbackend, cls), method)
    assert list(inspect.signature(port).parameters) == list(inspect.signature(ref).parameters)


def test_bootstrapper_defaults_match_the_reference():
    port = inspect.signature(pboot.Bootstrapper.__init__).parameters
    ref = inspect.signature(rboot.Bootstrapper.__init__).parameters
    assert {k: v.default for k, v in port.items()} == {k: v.default for k, v in ref.items()}


@pytest.fixture(scope="module")
def tiny():
    params, rparams = preset("tiny"), ref_preset("tiny")
    ctx, rctx = make_context(params, device="cpu"), ref_context(rparams)
    chest = pkeys.keygen(params, np.random.default_rng(5), ctx=ctx)
    rchest = rkeys.keygen(rparams, np.random.default_rng(5))
    return params, rparams, ctx, rctx, chest, rchest


def test_plaintext_to_device_with_params_equals_reference(tiny):
    params, rparams, ctx, rctx, _, _ = tiny
    rng = np.random.default_rng(6)
    pt = penc.encode(rng.normal(size=params.slots) + 1j * rng.normal(size=params.slots), params)
    got = penc.plaintext_to_device(pt, params, ctx)
    want = renc.plaintext_to_device(pt, rparams, rctx)
    assert (got.numpy() == np.asarray(want).astype(np.int64)).all()


def test_decrypt_to_coeff_with_params_equals_reference(tiny):
    params, rparams, ctx, rctx, chest, rchest = tiny
    rng = np.random.default_rng(7)
    pt = penc.encode(rng.normal(size=params.slots) + 1j * rng.normal(size=params.slots), params)
    ct = pct.encrypt(pt, params, chest.device_pk, ctx, np.random.default_rng(8), params.scale)
    rc = rct.encrypt(pt, rparams, rchest.device_pk, rctx, np.random.default_rng(8), params.scale)
    got = pct.decrypt_to_coeff(ct, params, chest.device_sk, ctx)
    want = rct.decrypt_to_coeff(rc, rparams, rchest.device_sk, rctx)
    assert (got == want).all()


# --- keygen, the uploads, mul_mod, make_context, CKKSParams and the chests ------


# the same parameter names, in order
SAME = [
    (pmodops.mul_mod, rmodops.mul_mod),
    (pparams_mod.order_primes_for_circuit, rparams_mod.order_primes_for_circuit),
    (pparams_mod.gen_balanced_ntt_primes, rparams_mod.gen_balanced_ntt_primes),
    (pdk.regen_ks_a, rdk.regen_ks_a),
    (pdk.regen_pk_a, rdk.regen_pk_a),
    *[(getattr(pdk.DeviceKeyChest, m), getattr(rdk.DeviceKeyChest, m))
      for m in ("galois_key", "conj_key", "drop_galois_a", "regen_galois_a")],
]
# the reference's parameters first, then keyword-only extras with defaults
# (ctx: the context, the card's by default; err_factor; device)
EXTENDED = [
    (pkeys.keygen, rkeys.keygen),
    (pbgv.keygen, rbgv.keygen),
    (pbfv.keygen, rbfv.keygen),
    (pkeys.upload_public_key, rkeys.upload_public_key),
    (pkeys.upload_ks_key, rkeys.upload_ks_key),
    (pkeys.upload_secret_key, rkeys.upload_secret_key),
    (pparams_mod.make_context, rparams_mod.make_context),
    (pdk.device_keygen, rdk.device_keygen),
]
FIELDS = [
    (pparams_mod.CKKSParams, rparams_mod.CKKSParams),
    (pkeys.KeyChest, rkeys.KeyChest),
    (pbgv.BGVKeyChest, rbgv.BGVKeyChest),
    (pbfv.BFVKeyChest, rbfv.BFVKeyChest),
    (pdk.DeviceKeyChest, rdk.DeviceKeyChest),
]


def _name(f):
    return f"{f.__module__.rsplit('.', 1)[-1]}.{f.__qualname__}"


@pytest.mark.parametrize("port,ref", SAME, ids=lambda f: _name(f))
def test_repaired_parameter_names_match_the_reference(port, ref):
    assert list(inspect.signature(port).parameters) == list(inspect.signature(ref).parameters)


@pytest.mark.parametrize("port,ref", EXTENDED, ids=lambda f: _name(f))
def test_reference_parameters_lead_and_extras_are_keyword_only(port, ref):
    p = list(inspect.signature(port).parameters.values())
    r = list(inspect.signature(ref).parameters.values())
    assert [(x.name, x.kind, x.default) for x in p[: len(r)]] == [
        (x.name, x.kind, x.default) for x in r]
    extras = p[len(r):]
    assert extras and all(x.kind is inspect.Parameter.KEYWORD_ONLY
                          and x.default is not inspect.Parameter.empty for x in extras)


@pytest.mark.parametrize("port,ref", FIELDS, ids=lambda c: c.__name__)
def test_dataclass_fields_match_the_reference_in_order(port, ref):
    import dataclasses

    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]


def test_ckks_params_positional_construction_matches_the_reference():
    p = preset("tiny")
    args = (p.n, p.q_primes, p.p_primes, 28, 3.2, 16, 8, 0, 2)
    port, ref = pparams_mod.CKKSParams(*args), rparams_mod.CKKSParams(*args)
    assert (port.hamming_weight, port.eph_hamming_weight, port.plain_modulus,
            port.scale_words) == (ref.hamming_weight, ref.eph_hamming_weight,
                                  ref.plain_modulus, ref.scale_words) == (16, 8, 0, 2)


@pytest.fixture
def cpu_by_default(monkeypatch):
    """The default context, which an entry point builds without `ctx`, taken
    on the CPU: the calls record what they asked for."""
    asked = []

    def cpu_context(params):
        asked.append(params)
        return make_context(params, device="cpu")

    monkeypatch.setattr(pkeys, "make_context", cpu_context)
    return asked


def test_default_context_is_the_card():
    """Without ctx an entry point asks for the parameters' context on the
    card: ops.context.make_context's default device."""
    from gpufhe_tpu_torch.ops import context as pcontext

    assert inspect.signature(pcontext.make_context).parameters["device"].default == "cuda"
    assert inspect.signature(pparams_mod.make_context).parameters["device"].default == "cuda"
    assert pkeys.make_context is pcontext.make_context


def test_keygen_called_the_reference_way_equals_reference(tiny, cpu_by_default):
    params, rparams, ctx, rctx, chest, rchest = tiny
    got = pkeys.keygen(params, np.random.default_rng(5))
    assert cpu_by_default == [params]
    assert (got.device_pk.b_mont.numpy() == np.asarray(rchest.device_pk.b_mont)).all()
    assert (got.device_rlk.a_mont.numpy() == np.asarray(rchest.device_rlk.a_mont)).all()
    rot = pkeys.keygen(params, np.random.default_rng(5), (1,), True)
    want = rkeys.keygen(rparams, np.random.default_rng(5), (1,), True)
    assert (rot.galois_key(1).b_mont.numpy() == np.asarray(want.galois_key(1).b_mont)).all()
    assert (rot.conj_key().a_mont.numpy() == np.asarray(want.conj_key().a_mont)).all()


@pytest.mark.parametrize("scheme", ["bgv", "bfv"])
def test_integer_keygen_called_the_reference_way_equals_reference(scheme, cpu_by_default):
    port, ref = {"bgv": (pbgv, rbgv), "bfv": (pbfv, rbfv)}[scheme]
    name = f"{scheme}_tiny"
    params, rparams = preset(name), ref_preset(name)
    got = port.keygen(params, np.random.default_rng(3), (1,))
    want = ref.keygen(rparams, np.random.default_rng(3), (1,))
    assert type(got).__name__ == type(want).__name__
    assert (got.device_rlk.b_mont.numpy() == np.asarray(want.device_rlk.b_mont)).all()
    assert (got.galois_key(1).b_mont.numpy() == np.asarray(want.galois[1][1].b_mont)).all()
    assert (got.pk.b.numpy() == want.pk.b).all() and (got.rlk.a.numpy() == want.rlk.a).all()


def test_uploads_called_the_reference_way_equal_reference(tiny):
    params, rparams, ctx, rctx, chest, rchest = tiny
    pk = pkeys.upload_public_key(chest.pk, params, ctx=ctx)
    rpk = rkeys.upload_public_key(rchest.pk, rparams)
    assert (pk.b_mont.numpy() == np.asarray(rpk.b_mont)).all()
    assert (pk.a_mont.numpy() == np.asarray(rpk.a_mont)).all()
    ks = pkeys.upload_ks_key(chest.rlk, params, ctx=ctx)
    rks = rkeys.upload_ks_key(rchest.rlk, rparams)
    assert (ks.b_mont.numpy() == np.asarray(rks.b_mont)).all()
    assert (ks.a_mont.numpy() == np.asarray(rks.a_mont)).all()
    sk = pkeys.upload_secret_key(chest.sk, params, ctx=ctx)
    assert (sk.s_mont.numpy() == np.asarray(rkeys.upload_secret_key(rchest.sk, rparams).s_mont)).all()


def test_mul_mod_called_the_reference_way_equals_reference(tiny):
    params, rparams, ctx, rctx, _, _ = tiny
    rng = np.random.default_rng(11)
    q = np.asarray(params.q_primes, dtype=np.int64)[:, None]
    a, b = (rng.integers(0, q, size=(len(q), params.n)) for _ in range(2))
    a[:, 0], b[:, 0] = q[:, 0] - 1, q[:, 0] - 1
    rows = range(params.num_limbs)
    got = pmodops.mul_mod(torch.from_numpy(a), torch.from_numpy(b), ctx.col("q", rows),
                          ctx.col("qinv_neg", rows), ctx.col("r2", rows))
    u32 = lambda x: np.asarray(x, dtype=np.uint32)  # noqa: E731
    want = rmodops.mul_mod(u32(a), u32(b), u32(q), np.asarray(rctx.qinv_neg)[: len(q), None],
                           np.asarray(rctx.r2)[: len(q), None])
    assert (got.numpy() == np.asarray(want).astype(np.int64)).all()
    assert (got.numpy() == a * b % q).all()


def test_make_context_by_name_or_params():
    by_name = pparams_mod.make_context("tiny", device="cpu")
    assert by_name is pparams_mod.make_context(preset("tiny"), device="cpu")
    assert by_name.primes == tuple(int(q) for q in np.asarray(ref_context(ref_preset("tiny")).q))
    assert by_name.device.type == "cpu"


def test_device_keygen_called_the_reference_way_equals_reference(cpu_by_default):
    params, rparams = preset("tiny"), ref_preset("tiny")
    got = pdk.device_keygen(params, np.random.default_rng(9), (1,), True)
    want = rdk.device_keygen(rparams, np.random.default_rng(9), (1,), True)
    assert cpu_by_default == [params]
    assert (got.galois_key(1).a_mont.numpy() == np.asarray(want.galois_key(1).a_mont)).all()
    assert (got.conj_key().b_mont.numpy() == np.asarray(want.conj_key().b_mont)).all()


# --- the function libraries and the models: every public name of each
#     reference module, with its parameters ----------------------------------

LIBRARIES = ["ciphertext.approx", "ciphertext.compare", "ciphertext.exact",
             "ciphertext.batch", "ciphertext.threshold", "models.linear", "models.mlp",
             "models.cnn", "models.logreg", "models.logreg_train", "models.pir",
             "models.attention", "models.transformer"]
# the reference's parameters first, then keyword-only extras with defaults
LIBRARY_EXTENDED = {("ciphertext.threshold", "upload_share")}


def _modules(path):
    import importlib

    return (importlib.import_module(f"gpufhe_tpu_torch.{path}"),
            importlib.import_module(f"gpufhe_tpu.{path}"))


def _public(module) -> dict:
    """The functions and classes a module defines whose names are public."""
    return {name: obj for name, obj in vars(module).items()
            if not name.startswith("_") and (inspect.isfunction(obj) or inspect.isclass(obj))
            and obj.__module__ == module.__name__}


def _callables(obj) -> dict:
    """A function, or a class's __init__ and public methods and properties."""
    if inspect.isfunction(obj):
        return {"": obj}
    out = {name: f for name, f in vars(obj).items()
           if inspect.isfunction(f) and (not name.startswith("_") or name == "__init__")}
    out.update({name: p.fget for name, p in vars(obj).items() if isinstance(p, property)})
    return out


LIBRARY_NAMES = [(path, name) for path in LIBRARIES for name in _public(_modules(path)[1])]


@pytest.mark.parametrize("path", LIBRARIES)
def test_library_modules_define_the_reference_names(path):
    port, ref = _modules(path)
    assert sorted(_public(port)) == sorted(_public(ref))


@pytest.mark.parametrize("path,name", LIBRARY_NAMES, ids=lambda x: x)
def test_library_signatures_match_the_reference(path, name):
    import dataclasses

    port, ref = (getattr(m, name) for m in _modules(path))
    if dataclasses.is_dataclass(ref):
        assert ([f.name for f in dataclasses.fields(port)]
                == [f.name for f in dataclasses.fields(ref)])
    pc, rc = _callables(port), _callables(ref)
    assert sorted(pc) == sorted(rc)
    for key, rf in rc.items():
        p = list(inspect.signature(pc[key]).parameters.values())
        r = list(inspect.signature(rf).parameters.values())
        if (path, name) in LIBRARY_EXTENDED:
            extras = p[len(r):]
            assert extras and all(x.kind is inspect.Parameter.KEYWORD_ONLY
                                  and x.default is not inspect.Parameter.empty
                                  for x in extras)
            p = p[: len(r)]
        assert [(x.name, x.kind, x.default) for x in p] == [
            (x.name, x.kind, x.default) for x in r], f"{name}.{key}"


def test_models_package_exports_the_reference_names():
    import gpufhe_tpu.models as rmodels
    import gpufhe_tpu_torch.models as pmodels

    names = lambda m: sorted(n for n in vars(m) if not n.startswith("_")  # noqa: E731
                             and not inspect.ismodule(getattr(m, n)))
    assert names(pmodels) == names(rmodels)


# --- the public surface: Session / ThresholdSession, the CLI, the utilities ----

SURFACE = ["api", "cli", "utils.serialization", "utils.security", "utils.noise",
           "utils.profiling", "utils.benchkit"]
# names only the port has: the card's bounds, which chip_smoke.py and
# bench_all share (the reference's benchkit holds a TPU's peaks instead)
SURFACE_EXTRAS = {"utils.benchkit": {"Bounds", "measured_bounds"}}
# the reference's parameters first, then keyword-only extras with defaults
# (device: where a session lives; ctx: where a loader uploads)
SURFACE_EXTENDED = {("api", "Session", "create"), ("api", "Session", "load"),
                    ("api", "ThresholdSession", "create_threshold"),
                    ("utils.serialization", "load_keychest", ""),
                    ("utils.serialization", "load_device_keychest", ""),
                    ("utils.serialization", "load_ciphertext", ""),
                    ("utils.benchkit", "bench_all", "")}


def _surface_callables(obj) -> dict:
    """A function, or a class's __init__ and its public methods, class and
    static methods (unwrapped) and properties."""
    if inspect.isfunction(obj):
        return {"": obj}
    out = {}
    for name, f in vars(obj).items():
        if name.startswith("_") and name != "__init__":
            continue
        if isinstance(f, (classmethod, staticmethod)):
            out[name] = f.__func__
        elif inspect.isfunction(f):
            out[name] = f
        elif isinstance(f, property):
            out[name] = f.fget
    return out


SURFACE_NAMES = [(path, name) for path in SURFACE for name in _public(_modules(path)[1])]


@pytest.mark.parametrize("path", SURFACE)
def test_surface_modules_define_the_reference_names(path):
    port, ref = _modules(path)
    assert sorted(set(_public(port)) - SURFACE_EXTRAS.get(path, set())) == sorted(_public(ref))
    assert SURFACE_EXTRAS.get(path, set()) <= set(_public(port))


@pytest.mark.parametrize("path,name", SURFACE_NAMES, ids=lambda x: x)
def test_surface_signatures_match_the_reference(path, name):
    import dataclasses

    port, ref = (getattr(m, name) for m in _modules(path))
    if dataclasses.is_dataclass(ref):
        assert ([f.name for f in dataclasses.fields(port)]
                == [f.name for f in dataclasses.fields(ref)])
    pc, rc = _surface_callables(port), _surface_callables(ref)
    assert sorted(pc) == sorted(rc)
    for key, rf in rc.items():
        p = list(inspect.signature(pc[key]).parameters.values())
        r = list(inspect.signature(rf).parameters.values())
        if (path, name, key) in SURFACE_EXTENDED:
            extras = p[len(r):]
            assert extras and all(x.kind is inspect.Parameter.KEYWORD_ONLY
                                  and x.default is not inspect.Parameter.empty
                                  for x in extras), f"{name}.{key}"
            p = p[: len(r)]
        assert [(x.name, x.kind, x.default) for x in p] == [
            (x.name, x.kind, x.default) for x in r], f"{name}.{key}"


def test_threshold_session_extends_session_as_the_reference_does():
    from gpufhe_tpu import api as rapi
    from gpufhe_tpu_torch import api as papi

    assert issubclass(papi.ThresholdSession, papi.Session)
    assert [c.__name__ for c in papi.ThresholdSession.__mro__] == [
        c.__name__ for c in rapi.ThresholdSession.__mro__]
    assert papi.ThresholdSession.shares is None is rapi.ThresholdSession.shares


def test_package_and_utils_export_the_reference_names():
    import gpufhe_tpu.utils as rutils
    import gpufhe_tpu_torch
    import gpufhe_tpu_torch.utils as putils

    names = lambda m: sorted(n for n in vars(m) if not n.startswith("_")  # noqa: E731
                             and not inspect.ismodule(getattr(m, n)))
    assert names(putils) == names(rutils)
    for name in ("CKKSParams", "make_context", "Session"):
        assert getattr(gpufhe_tpu_torch, name).__name__ == name


def test_cli_subcommands_and_arguments_match_the_reference(monkeypatch):
    """Every subcommand of the reference's CLI, bench included, with the
    reference's arguments and defaults; the global --cpu flag, not --cache
    (XLA's compile cache)."""
    import argparse

    from gpufhe_tpu import cli as rcli
    from gpufhe_tpu_torch import cli as pcli

    def parsers(main):
        seen = []

        def capture(self, argv=None, namespace=None):
            seen.append(self)
            raise SystemExit(0)

        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(SystemExit):
            main([])
        monkeypatch.undo()
        (root,) = seen
        sub = next(a for a in root._actions if isinstance(a, argparse._SubParsersAction))
        spec = {name: sorted((a.dest, a.default) for a in sp._actions
                             if a.dest not in ("help", "fn"))
                for name, sp in sub.choices.items()}
        flags = sorted(a.dest for a in root._actions if a.dest not in ("help", "cmd"))
        return spec, flags

    port, port_flags = parsers(pcli.main)
    ref, ref_flags = parsers(rcli.main)
    assert sorted(port) == sorted(ref)
    for name, args in port.items():
        assert args == ref[name], name
    assert port_flags == ["cpu"] and ref_flags == ["cache", "cpu"]


# --- the golden model: every public name of each reference golden module, and
#     the golden backends, with their parameters ------------------------------

GOLDEN = ["golden.arithmetic", "golden.ntt", "golden.native", "golden.rns", "golden.ckks",
          "golden.bgv", "golden.bfv", "golden.vectors"]
# names only the port has: the native library's path; host_limbs and
# inner_product_coeff (the host inner product every scheme's decryption and
# noise report share) and ntt_small (the device path's key helper)
GOLDEN_EXTRAS = {"golden.native": {"lib_path"},
                 "golden.ckks": {"host_limbs", "inner_product_coeff", "ntt_small"}}
# key generation: the reference's parameters, then keyword-only ctx (the
# device path; none: numpy on the host) and err_factor
GOLDEN_EXTENDED = {("golden.ckks", n) for n in ("keygen", "make_kskey", "make_relin_key",
                                                "make_galois_key", "make_conj_key")} | {
    ("golden.bgv", n) for n in ("keygen", "make_relin_key", "make_galois_key")}


def _defined(module) -> dict:
    """_public, with functions behind functools.lru_cache too."""
    return {name: obj for name, obj in vars(module).items()
            if not name.startswith("_") and callable(obj)
            and getattr(obj, "__module__", None) == module.__name__
            and (inspect.isclass(obj) or inspect.isfunction(inspect.unwrap(obj)))}


GOLDEN_NAMES = [(path, name) for path in GOLDEN for name in _defined(_modules(path)[1])]


@pytest.mark.parametrize("path", GOLDEN)
def test_golden_modules_define_the_reference_names(path):
    port, ref = _modules(path)
    extras = GOLDEN_EXTRAS.get(path, set())
    assert sorted(set(_defined(port)) - extras) == sorted(_defined(ref))
    assert extras <= set(_defined(port))


@pytest.mark.parametrize("path,name", GOLDEN_NAMES, ids=lambda x: x)
def test_golden_signatures_match_the_reference(path, name):
    import dataclasses

    port, ref = (getattr(m, name) for m in _modules(path))
    if dataclasses.is_dataclass(ref):
        assert ([f.name for f in dataclasses.fields(port)]
                == [f.name for f in dataclasses.fields(ref)])
    pc = _callables(port) if inspect.isclass(port) else {"": inspect.unwrap(port)}
    rc = _callables(ref) if inspect.isclass(ref) else {"": inspect.unwrap(ref)}
    assert sorted(pc) == sorted(rc)
    for key, rf in rc.items():
        p = list(inspect.signature(pc[key]).parameters.values())
        r = list(inspect.signature(rf).parameters.values())
        if (path, name) in GOLDEN_EXTENDED:
            extras = p[len(r):]
            assert extras and all(x.kind is inspect.Parameter.KEYWORD_ONLY
                                  and x.default is not inspect.Parameter.empty for x in extras)
            p = p[: len(r)]
        assert [(x.name, x.kind, x.default) for x in p] == [
            (x.name, x.kind, x.default) for x in r], f"{name}.{key}"


def test_golden_module_constants_and_aliases_match_the_reference():
    port, ref = _modules("golden.vectors")
    assert list(port.GENERATORS) == list(ref.GENERATORS) and port.VEC_DIR == ref.VEC_DIR
    for alias in ("encode", "decode", "slot_rotation_perm", "slot_orbit_rings", "keygen",
                  "make_relin_key", "make_galois_key"):
        p, r = (getattr(m, alias) for m in _modules("golden.bfv"))
        assert p.__name__ == r.__name__, alias
    port, ref = _modules("golden.arithmetic")
    assert (port.R, port.R_BITS, port.R_MASK) == (ref.R, ref.R_BITS, ref.R_MASK)


GOLDEN_BACKENDS = [("ciphertext.backend", "GoldenBackend"),
                   ("ciphertext.backend", "GoldenFanPlan"),
                   ("ciphertext.bgv_backend", "BGVGoldenBackend"),
                   ("ciphertext.bfv_backend", "BFVGoldenBackend")]


@pytest.mark.parametrize("path,name", GOLDEN_BACKENDS, ids=lambda x: x)
def test_golden_backends_match_the_reference(path, name):
    port, ref = (getattr(m, name) for m in _modules(path))
    if hasattr(ref, "_fields"):  # a NamedTuple
        assert port._fields == ref._fields
        return
    methods = lambda c: {k: f for k, f in vars(c).items() if inspect.isfunction(f)}  # noqa: E731
    pm, rm = methods(port), methods(ref)
    assert sorted(pm) == sorted(rm)
    for key, rf in rm.items():
        assert list(inspect.signature(pm[key]).parameters) == list(
            inspect.signature(rf).parameters), key


# the reference's names the port lacked until the golden slice, each with the
# reference's parameters
NEW_PAIRS = [("keys.keys", "KeyChest.golden_galois_key"),
             ("ciphertext.bfv", "plaintext_to_device"),
             ("primitives.rns", "base_convert"),
             ("parallel.sharded", "make_fhe_mesh")]


@pytest.mark.parametrize("path,name", NEW_PAIRS, ids=lambda x: x)
def test_new_names_match_the_reference(path, name):
    import functools
    import importlib

    port_mod = importlib.import_module(f"gpufhe_tpu_torch.{path}")
    ref_mod = importlib.import_module(f"gpufhe_tpu.{path}")
    port, ref = (functools.reduce(getattr, name.split("."), m) for m in (port_mod, ref_mod))
    assert port.__module__ == port_mod.__name__  # defined there, not only imported
    p = list(inspect.signature(port).parameters.values())
    r = list(inspect.signature(ref).parameters.values())
    assert [(x.name, x.kind, x.default) for x in p] == [(x.name, x.kind, x.default) for x in r]


@pytest.mark.parametrize("name", ["tiny2", "bgv_tiny"])
def test_golden_keygen_called_the_reference_way_equals_reference(name):
    """golden keygen(params, rng) and the key functions called as the
    reference's are: numpy keys, the reference's limb for limb."""
    from gpufhe_tpu.golden import bgv as rgbgv
    from gpufhe_tpu.golden import ckks as rgckks
    from gpufhe_tpu_torch.golden import bgv as gbgv
    from gpufhe_tpu_torch.golden import ckks as gckks

    params, rparams = preset(name), ref_preset(name)
    port, ref = (gbgv, rgbgv) if params.plain_modulus else (gckks, rgckks)
    got, want = [], []
    for mod, p, out in ((port, params, got), (ref, rparams, want)):
        rng = np.random.default_rng(17)
        sk, pk = mod.keygen(p, rng)
        out += [sk.s, pk.b, pk.a]
        for key in (mod.make_relin_key(p, sk, rng), mod.make_galois_key(p, 3, sk, rng)):
            out += [key.b, key.a]
        if mod in (gckks, rgckks):
            ck = mod.make_conj_key(p, sk, rng)
            out += [ck.b, ck.a]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.int64 and (g == w).all()


# --- every module of the reference: its counterpart in the port, every name it
#     defines, and each name's parameters -----------------------------------------

def _reference_modules() -> list[str]:
    import pkgutil

    import gpufhe_tpu

    return sorted(m.name.split(".", 1)[1]
                  for m in pkgutil.walk_packages(gpufhe_tpu.__path__, "gpufhe_tpu."))


# the reference's Pallas kernels, ported as hand-written CUDA kernels behind
# modules of their own (csrc/ntt.cu, csrc/convert.cu)
KERNEL_MODULES = {"ops.ntt_pallas": "ops.ntt_cuda", "ops.convert_pallas": "ops.convert_cuda"}
# JAX-only mechanics, not ported as behaviour (ROADMAP §1): the fused jit
# pipeline and raw jit cores, the lazy-recombine table type, the key switch's
# fence gate and staged key-row gather, and the PartitionSpecs of the sharded
# tables (the planner's _capture_jit and _sds are private, and the CLI's
# --cache is test_cli_subcommands_and_arguments_match_the_reference's)
JAX_ONLY = {("ciphertext.backend", "FusedPipeline"), ("ciphertext.ct", "raw_cores"),
            ("ops.context", "NTTTablesLazy"), ("primitives.keyswitch", "fence_enabled"),
            ("primitives.keyswitch", "key_rows"), ("parallel.sharded", "ShardedNTT.spec"),
            ("parallel.sharded", "ShardedKS.spec")}
# names only the port defines: the cores BGV and BFV share with CKKS, the key
# switch's stages, the rescale of a multi-word scale, the kernels' tables, the
# golden model's host helpers, the card's bounds, and the bench's lines beyond
# the reference's bench_mult
PORT_ONLY = {
    "bench": {"bench_int_mult", "bench_ntt", "bench_bootstrap", "bench_mlp",
              "bench_deep_mlp", "bench_mesh_parity"},
    "ciphertext.bfv": {"sk_convert_to_q"},
    "ciphertext.ct": {"PlainGroup", "add_core", "ct_baby_sums", "decrypt_core", "encrypt_core",
                      "galois_core", "galois_perm", "hoisted_galois_core", "mul_plain_core",
                      "relin_core", "rescale_core", "sub_core", "tensor_core"},
    "golden.ckks": {"host_limbs", "inner_product_coeff", "ntt_small"},
    "golden.native": {"lib_path"},
    "keys.keys": {"IntegerKeyChest", "default_context", "host", "integer_chest_fields",
                  "mont_form"},
    "ops.context": {"K1Tables", "k1_refusal", "ntt_tables_np", "pow_table", "shoup",
                    "stage_root_exponents"},
    "parallel.sharded": {"mesh_contexts"},
    "primitives.keyswitch": {"gadget_mac", "gadget_macs", "hoist", "key_row_index",
                             "ks_finish"},
    "primitives.rns": {"rescale_words"},
    "utils.benchkit": {"Bounds", "measured_bounds"},
}
# device tables whose layout the port is free in (ROADMAP, the north star):
# the reference's NamedTuples of jnp arrays; their fields are not compared
TABLE_LAYOUTS = {("ops.context", "Context"), ("ops.context", "NTTTables"),
                 ("primitives.rns", "KSContext"), ("ciphertext.bfv", "BFVMulTables"),
                 ("parallel.sharded", "ShardedNTT"), ("parallel.sharded", "ShardedKS")}
# keyword-only extras the port needs without a default: the mesh, which the
# reference's shard_map bodies find around them
REQUIRED_EXTRAS = {"mesh"}
# the root bench.py, whose counterpart is gpufhe_tpu_torch/bench.py
SCANNED = sorted(set(_reference_modules()) - set(KERNEL_MODULES)) + ["bench"]


def _scan_modules(path):
    import importlib

    ref = importlib.import_module("bench" if path == "bench" else f"gpufhe_tpu.{path}")
    return importlib.import_module(f"gpufhe_tpu_torch.{path}"), ref


def _members(cls) -> dict:
    """A class's public methods, class and static methods (unwrapped) and
    properties, its own and its bases' (the port's chests share a base)."""
    out = {}
    for klass in reversed(cls.__mro__[:-1]):
        for name, f in vars(klass).items():
            if name.startswith("_") and name != "__init__":
                continue
            if isinstance(f, (classmethod, staticmethod)):
                out[name] = f.__func__
            elif inspect.isfunction(f):
                out[name] = f
            elif isinstance(f, property) and f.fget is not None:
                out[name] = f.fget
    return out


def _generated_init(cls) -> bool:
    import dataclasses

    return dataclasses.is_dataclass(cls) or hasattr(cls, "_fields")


def _signature_extends(port, ref) -> str | None:
    """None if port takes ref's parameters in order, with ref's kinds and
    defaults (a default where ref has none is allowed), then keyword-only
    extras, each with a default or named in REQUIRED_EXTRAS; else what
    differs."""
    p = list(inspect.signature(inspect.unwrap(port)).parameters.values())
    r = list(inspect.signature(inspect.unwrap(ref)).parameters.values())
    for x, y in zip(p, r):
        if (x.name, x.kind) != (y.name, y.kind) or (
                y.default is not inspect.Parameter.empty and x.default != y.default):
            return f"{x} against the reference's {y}"
    if len(p) < len(r):
        return f"missing {[y.name for y in r[len(p):]]}"
    bad = [x.name for x in p[len(r):] if x.kind is not inspect.Parameter.KEYWORD_ONLY
           or (x.default is inspect.Parameter.empty and x.name not in REQUIRED_EXTRAS)]
    return f"extras not keyword-only with defaults: {bad}" if bad else None


@pytest.mark.parametrize("path", SCANNED)
def test_every_reference_module_has_its_names_in_the_port(path):
    port, ref = _scan_modules(path)
    want = {n for n in _defined(ref) if (path, n) not in JAX_ONLY}
    assert sorted(n for n in want if not hasattr(port, n)) == []
    assert sorted(set(_defined(port)) - set(_defined(ref))) == sorted(PORT_ONLY.get(path, ()))


def test_kernel_modules_are_the_reference_pallas_modules():
    """The scan leaves out only the reference's two Pallas modules, and the
    port has the module of each one's hand-written kernel."""
    import importlib

    assert sorted(set(_reference_modules()) - set(SCANNED)) == sorted(KERNEL_MODULES)
    for path in KERNEL_MODULES.values():
        assert hasattr(importlib.import_module(f"gpufhe_tpu_torch.{path}"), "KERNEL")


SCANNED_NAMES = [(path, name) for path in SCANNED
                 for name in sorted(_defined(_scan_modules(path)[1]))
                 if (path, name) not in JAX_ONLY]


@pytest.mark.parametrize("path,name", SCANNED_NAMES, ids=lambda x: x)
def test_every_reference_name_takes_the_reference_parameters(path, name):
    import dataclasses

    port_mod, ref_mod = _scan_modules(path)
    port, ref = getattr(port_mod, name), getattr(ref_mod, name)
    if not inspect.isclass(ref):
        assert not inspect.isclass(port), name
        assert _signature_extends(port, ref) is None, (name, _signature_extends(port, ref))
        return
    assert inspect.isclass(port), name
    if _generated_init(ref) and (path, name) not in TABLE_LAYOUTS:
        fields = (lambda c: [f.name for f in dataclasses.fields(c)]
                  if dataclasses.is_dataclass(c) else list(c._fields))
        assert fields(port) == fields(ref), name
    pm, rm = _members(port), _members(ref)
    for key, rf in rm.items():
        if (path, f"{name}.{key}") in JAX_ONLY or (key == "__init__" and _generated_init(ref)):
            continue
        assert key in pm, f"{name}.{key}"
        assert _signature_extends(pm[key], rf) is None, (
            f"{name}.{key}", _signature_extends(pm[key], rf))
