"""The port's utilities (gpufhe_tpu_torch/utils/) against the reference's
(gpufhe_tpu/utils/).

- serialization, across the packages both ways: key chests (CKKS with
  rotation, conjugation and encapsulation keys; BGV; BFV), seeded device
  chests (tiny2, boot_dw_ci_enc) and ciphertexts of all three schemes; a
  file written by either loads in the other to equal arrays, and the two
  files' `__meta__` are equal key for key;
- security: the two security_table.json files are byte-equal, and report,
  security_level, max_log_qp and check agree for every preset;
- noise: ckks_noise_report and the golden noise_budget_bits of BGV and BFV
  == the reference's;
- profiling: stage, trace and Timer on the CPU;
- benchkit: bench_all on the CPU gives the reference's row names, and the
  TPU peaks of the reference's benchkit are not in the port's.
"""

import dataclasses
import json
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufhe_tpu.ciphertext import bfv as rbfv
from gpufhe_tpu.ciphertext import bgv as rbgv
from gpufhe_tpu.ciphertext import ct as rct
from gpufhe_tpu.golden import bfv as rgbfv
from gpufhe_tpu.golden import bgv as rgbgv
from gpufhe_tpu.keys import device_keygen as rdk
from gpufhe_tpu.keys import keys as rkeys
from gpufhe_tpu.ops.context import make_context as ref_context
from gpufhe_tpu.params import params as rparams_mod
from gpufhe_tpu.utils import noise as rnoise
from gpufhe_tpu.utils import security as rsecurity
from gpufhe_tpu.utils import serialization as rser
from gpufhe_tpu_torch.ciphertext import bfv as pbfv
from gpufhe_tpu_torch.ciphertext import bgv as pbgv
from gpufhe_tpu_torch.ciphertext import ct as pct
from gpufhe_tpu_torch.encoding import encoder as penc
from gpufhe_tpu_torch.golden import bfv as gbfv
from gpufhe_tpu_torch.golden import bgv as gbgv
from gpufhe_tpu_torch.keys import device_keygen as pdk
from gpufhe_tpu_torch.keys import keys as pkeys
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params import params as pparams_mod
from gpufhe_tpu_torch.params.params import preset
from gpufhe_tpu_torch.utils import benchkit, noise, profiling, security
from gpufhe_tpu_torch.utils import serialization as ser

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's PyTorch CPU work: its tensors are
    small (N <= 2^10), and tier-1 runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x).astype(np.int64)


def _eq(a, b) -> bool:
    return np.shape(a) == np.shape(b) and (_np(a) == _np(b)).all()


def _meta(path) -> dict:
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode())


def _members(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}


def _same_files(a, b):
    """Two npz files of the two packages: the same members, dtypes, shapes and
    values, and __meta__ equal key for key (and byte for byte)."""
    ma, mb = _meta(a), _meta(b)
    assert list(ma) == list(mb) and ma == mb
    with np.load(a) as za, np.load(b) as zb:
        assert bytes(za["__meta__"]) == bytes(zb["__meta__"])
    xa, xb = _members(a), _members(b)
    assert sorted(xa) == sorted(xb)
    for k in xa:
        assert xa[k].dtype == xb[k].dtype and _eq(xa[k], xb[k]), k


def _params_pair(name):
    return preset(name), rparams_mod.preset(name)


# --- serialization --------------------------------------------------------------


def test_params_dict_equals_the_reference_key_for_key():
    for name in ("tiny2", "bgv_tiny", "boot_dw_ci_enc", "config5_boot_dw"):
        p, r = _params_pair(name)
        d, rd = ser.params_to_dict(p), rser.params_to_dict(r)
        assert list(d) == list(rd) and d == rd
        assert json.dumps(d) == json.dumps(rd)
        assert ser.params_from_dict(rd) == p
        assert rser.params_from_dict(d) == r


def _check_keychest(chest, rchest, scheme):
    assert type(chest).__name__ == type(rchest).__name__
    assert _eq(chest.sk.s, rchest.sk.s)
    assert _eq(chest.pk.b, rchest.pk.b) and _eq(chest.pk.a, rchest.pk.a)
    assert _eq(chest.rlk.b, rchest.rlk.b) and _eq(chest.rlk.a, rchest.rlk.a)
    for k in ("device_pk", "device_rlk"):
        for f in ("b_mont", "a_mont"):
            assert _eq(getattr(getattr(chest, k), f), getattr(getattr(rchest, k), f)), (k, f)
    assert _eq(chest.device_sk.s_mont, rchest.device_sk.s_mont)
    assert sorted(chest.galois) == sorted(rchest.galois)
    for s in chest.galois:
        assert _eq(chest.galois[s][0].b, rchest.galois[s][0].b)
        assert _eq(chest.galois[s][1].a_mont, rchest.galois[s][1].a_mont)
    if scheme == "ckks":
        for attr in ("conj",):
            assert (getattr(chest, attr) is None) == (getattr(rchest, attr) is None)
        if chest.conj is not None:
            assert _eq(chest.conj[1].b_mont, rchest.conj[1].b_mont)
        assert (chest.eph is None) == (rchest.eph is None)
        if chest.eph is not None:
            assert _eq(chest.eph["s_eph"], rchest.eph["s_eph"])
            for k in ("to_eph", "from_eph"):
                assert _eq(chest.eph[k][0].a, rchest.eph[k][0].a)
                assert _eq(chest.eph[k][1].b_mont, rchest.eph[k][1].b_mont)


KEYCHESTS = [("ckks", "tiny2", (1, 2), True), ("ckks", "boot_dw_ci_enc", (1,), False),
             ("bgv", "bgv_tiny", (1,), False), ("bfv", "bfv_tiny", (1,), False)]


@pytest.mark.parametrize("scheme,name,rots,conj", KEYCHESTS,
                         ids=[f"{s}-{n}" for s, n, _, _ in KEYCHESTS])
def test_keychest_files_load_across_packages(tmp_path, scheme, name, rots, conj):
    p, r = _params_pair(name)
    ctx = make_context(p, device="cpu")
    rng, rrng = np.random.default_rng(3), np.random.default_rng(3)
    if scheme == "ckks":
        chest = pkeys.keygen(p, rng, rots, conj, ctx=ctx)
        rchest = rkeys.keygen(r, rrng, rots, conj)
    else:
        port_mod, ref_mod = (pbgv, rbgv) if scheme == "bgv" else (pbfv, rbfv)
        chest = port_mod.keygen(p, rng, rots, ctx=ctx)
        rchest = ref_mod.keygen(r, rrng, rots)
    ser.save_keychest(tmp_path / "port.npz", chest, scheme=scheme)
    rser.save_keychest(tmp_path / "ref.npz", rchest, scheme=scheme)
    _same_files(tmp_path / "port.npz", tmp_path / "ref.npz")
    # the reference loads the port's file; the port loads the reference's
    got_scheme, back = rser.load_keychest(tmp_path / "port.npz", with_scheme=True)
    assert got_scheme == scheme
    _check_keychest(chest, back, scheme)
    got_scheme, back = ser.load_keychest(tmp_path / "ref.npz", with_scheme=True, ctx=ctx)
    assert got_scheme == scheme
    _check_keychest(back, rchest, scheme)
    assert back.pk.b.device == ctx.device and back.rlk.b.device.type == "cpu"


def _ref_device_chest(chest):
    """The port's DeviceKeyChest as the reference's (uint32 device arrays,
    uint32 seed words), field for field: what the reference's saver reads."""
    u32 = lambda x: jnp.asarray(_np(x).astype(np.uint32))  # noqa: E731

    def ks(pair):
        return None if pair is None else (
            None, rkeys.DeviceKSKey(b_mont=u32(pair[1].b_mont), a_mont=u32(pair[1].a_mont)))

    eph = chest.eph and {"s_eph": chest.eph["s_eph"],
                         **{k: ks(chest.eph[k]) for k in ("to_eph", "from_eph")}}
    return rdk.DeviceKeyChest(
        params=rparams_mod.preset(NAME_OF[chest.params]), sk=chest.sk,
        device_sk=rkeys.DeviceSecretKey(s_mont=u32(chest.device_sk.s_mont)),
        device_pk=rkeys.DevicePublicKey(b_mont=u32(chest.device_pk.b_mont),
                                        a_mont=u32(chest.device_pk.a_mont)),
        device_rlk=ks((None, chest.device_rlk))[1],
        galois={s: ks(pair) for s, pair in chest.galois.items()}, conj=ks(chest.conj),
        eph=eph, seeds={k: _np(v).astype(np.uint32) for k, v in chest.seeds.items()})


NAME_OF = {preset(n): n for n in ("tiny2", "boot_dw_ci_enc")}


def _check_device_chest(got, want):
    assert sorted(got.galois) == sorted(want.galois)
    keys = [(got.device_rlk, want.device_rlk)]
    keys += [(got.galois[s][1], want.galois[s][1]) for s in got.galois]
    if want.conj is not None:
        keys.append((got.conj[1], want.conj[1]))
    if want.eph is not None:
        assert _eq(got.eph["s_eph"], want.eph["s_eph"])
        keys += [(got.eph[k][1], want.eph[k][1]) for k in ("to_eph", "from_eph")]
    for g, w in keys:
        assert _eq(g.b_mont, w.b_mont) and _eq(g.a_mont, w.a_mont)
    assert _eq(got.device_pk.a_mont, want.device_pk.a_mont)
    assert _eq(got.device_pk.b_mont, want.device_pk.b_mont)
    assert _eq(got.device_sk.s_mont, want.device_sk.s_mont) and _eq(got.sk.s, want.sk.s)
    assert sorted(got.seeds) == sorted(want.seeds)
    for k in got.seeds:
        assert _eq(got.seeds[k], want.seeds[k])


@pytest.mark.parametrize("name,rots", [("tiny2", (1, 2)), ("boot_dw_ci_enc", (1,))])
def test_seeded_device_keychest_files_load_across_packages(tmp_path, name, rots):
    """The seeded file stores each key's b rows and its threefry key words
    (uint32[2], the reference's 64-bit key_data); both packages draw the same
    a rows from it again. The port's chest comes from device_keygen on the
    CPU; the reference's saver is given the same arrays."""
    p = preset(name)
    ctx = make_context(p, device="cpu")
    chest = pdk.device_keygen(p, np.random.default_rng(11), rots, True, ctx=ctx)
    rchest = _ref_device_chest(chest)
    for seeded in (True, False):
        ser.save_device_keychest(tmp_path / "port.npz", chest, seeded=seeded)
        rser.save_device_keychest(tmp_path / "ref.npz", rchest, seeded=seeded)
        _same_files(tmp_path / "port.npz", tmp_path / "ref.npz")
        if seeded:
            assert _members(tmp_path / "port.npz")["rlk_seed"].dtype == np.uint32
    ser.save_device_keychest(tmp_path / "port.npz", chest)
    rser.save_device_keychest(tmp_path / "ref.npz", rchest)
    _check_device_chest(ser.load_device_keychest(tmp_path / "ref.npz", ctx=ctx), chest)
    _check_device_chest(rser.load_device_keychest(tmp_path / "port.npz"), chest)


def _ciphertexts():
    """One fresh ciphertext per scheme on the port (tiny2, bgv_tiny with
    pt_factor 7, bfv_tiny), with its reference twin built from its limbs."""
    out = []
    p = preset("tiny2")
    ctx = make_context(p, device="cpu")
    chest = pkeys.keygen(p, np.random.default_rng(3), ctx=ctx)
    z = np.random.default_rng(4).normal(size=p.slots) + 0j
    ct = pct.encrypt(penc.encode(z, p), p, chest.device_pk, ctx, np.random.default_rng(5),
                     p.scale)
    out.append((ct, rct.Ciphertext([jnp.asarray(_np(c).astype(np.uint32)) for c in ct.c],
                                   ct.level, ct.scale)))
    p = preset("bgv_tiny")
    ctx = make_context(p, device="cpu")
    chest = pbgv.keygen(p, np.random.default_rng(71), ctx=ctx)
    m = np.random.default_rng(72).integers(0, p.plain_modulus, size=p.n, dtype=np.int64)
    ct = pbgv.encrypt(gbgv.encode(m, p), p, chest.device_pk, ctx, np.random.default_rng(73))
    ct.pt_factor = 7
    out.append((ct, rbgv.BGVCiphertext([jnp.asarray(_np(c).astype(np.uint32)) for c in ct.c],
                                       ct.level, 7)))
    bf = pbfv.encrypt(gbfv.encode(m, p), p, chest.device_pk, ctx, np.random.default_rng(74))
    out.append((bf, rbfv.BFVCiphertext([jnp.asarray(_np(c).astype(np.uint32)) for c in bf.c],
                                       bf.level)))
    return out


def test_ciphertext_files_load_across_packages(tmp_path):
    ctx = make_context(preset("tiny2"), device="cpu")
    for ct, ref in _ciphertexts():
        ser.save_ciphertext(tmp_path / "port.npz", ct)
        rser.save_ciphertext(tmp_path / "ref.npz", ref)
        _same_files(tmp_path / "port.npz", tmp_path / "ref.npz")
        for back in (rser.load_ciphertext(tmp_path / "port.npz"),
                     rser.load_ciphertext(tmp_path / "port.npz", device=False),
                     ser.load_ciphertext(tmp_path / "ref.npz", ctx=ctx),
                     ser.load_ciphertext(tmp_path / "ref.npz", device=False)):
            assert type(back).__name__ == type(ct).__name__ and back.level == ct.level
            assert getattr(back, "scale", None) == getattr(ct, "scale", None)
            assert getattr(back, "pt_factor", None) == getattr(ct, "pt_factor", None)
            for a, b in zip(ct.c, back.c, strict=True):
                assert _eq(a, b)
        port_back = ser.load_ciphertext(tmp_path / "ref.npz", ctx=ctx)
        assert all(c.dtype == torch.int64 and c.device == ctx.device for c in port_back.c)


def test_loaders_accept_int64_files(tmp_path):
    """A file whose limbs are int64 (the port's own dtype) loads too."""
    ct, _ = _ciphertexts()[0]
    meta = {"level": ct.level, "n_components": 2, "scheme": "ckks", "scale": ct.scale}
    np.savez_compressed(tmp_path / "ct.npz", __meta__=np.bytes_(json.dumps(meta).encode()),
                        c0=_np(ct.c[0]), c1=_np(ct.c[1]))
    for back in (ser.load_ciphertext(tmp_path / "ct.npz", device=False),
                 rser.load_ciphertext(tmp_path / "ct.npz")):
        assert all(_eq(a, b) for a, b in zip(ct.c, back.c))


# --- security -------------------------------------------------------------------


def test_security_tables_are_byte_equal():
    port = ROOT / "gpufhe_tpu_torch" / "params" / "security_table.json"
    ref = ROOT / "gpufhe_tpu" / "params" / "security_table.json"
    assert port.read_bytes() == ref.read_bytes()
    assert pathlib.Path(security._TABLE_PATH).resolve() == port.resolve()
    assert security._HE_STD_DENSE == rsecurity._HE_STD_DENSE


@pytest.mark.parametrize("name", sorted(pparams_mod._PRESETS))  # every reference preset
def test_security_report_equals_the_reference(name):
    p, r = _params_pair(name)
    assert security.report(p) == rsecurity.report(r)
    assert security.security_level(p) == rsecurity.security_level(r)
    assert [security.max_log_qp(p, i) for i in range(3)] == [
        rsecurity.max_log_qp(r, i) for i in range(3)]
    for bits in (128, 192):
        try:
            rsecurity.check(r, bits)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                security.check(p, bits)
        else:
            security.check(p, bits)


def test_security_sparse_and_encapsulated_budgets_equal_the_reference():
    base, rbase = pparams_mod._mk(n=2**16, n_q=2, n_p=1, scale_bits=28), \
        rparams_mod._mk(n=2**16, n_q=2, n_p=1, scale_bits=28)
    for h in (0, 8, 16, 32, 64, 100, 128, 192, 4096, 50000):
        for field in ("hamming_weight", "eph_hamming_weight"):
            p = dataclasses.replace(base, **{field: h})
            r = dataclasses.replace(rbase, **{field: h})
            assert [security.max_log_qp(p, i) for i in range(3)] == [
                rsecurity.max_log_qp(r, i) for i in range(3)], (field, h)


# --- noise ----------------------------------------------------------------------


def test_ckks_noise_report_equals_the_reference():
    """Fresh and after one multiply (the reference's tests/test_models_utils.py
    scenario), each report == the reference's on the same limbs."""
    p, r = _params_pair("tiny2")
    ctx, rctx = make_context(p, device="cpu"), ref_context(r)
    chest = pkeys.keygen(p, np.random.default_rng(5), ctx=ctx)
    rchest = rkeys.keygen(r, np.random.default_rng(5))
    z = np.random.default_rng(6).normal(size=p.slots) + 0j
    ct = pct.encrypt(penc.encode(z, p), p, chest.device_pk, ctx, np.random.default_rng(7),
                     p.scale)
    prod = pct.ct_mul(ct, ct, p, ctx, chest.device_rlk)
    reports = []
    for c, want in ((ct, z), (prod, z * z)):
        ref_ct = rct.Ciphertext([jnp.asarray(_np(x).astype(np.uint32)) for x in c.c],
                                c.level, c.scale)
        got = noise.ckks_noise_report(c, p, chest.device_sk, ctx, want)
        assert got == rnoise.ckks_noise_report(ref_ct, r, rchest.device_sk, rctx, want)
        reports.append(got)
    assert reports[0]["bits_clean"] > 10 and reports[1]["level"] == ct.level - 1
    assert 0 < reports[1]["bits_clean"] < reports[0]["bits_clean"]


@pytest.mark.parametrize("scheme", ["bgv", "bfv"])
def test_golden_noise_budget_bits_equals_the_reference(scheme):
    """Fresh, after a multiply and after a squaring chain to exhaustion: the
    port's golden noise_budget_bits (on the port's ciphertexts, limbs on the
    CPU) == the reference's (on the same limbs as its golden ciphertexts)."""
    name = f"{scheme}_tiny"
    p = preset(name)
    ctx = make_context(p, device="cpu")
    mod, gold, rgold = {"bgv": (pbgv, gbgv, rgbgv), "bfv": (pbfv, gbfv, rgbfv)}[scheme]
    chest = mod.keygen(p, np.random.default_rng(11), ctx=ctx)
    r = rparams_mod.preset(name)
    rsk = type("SK", (), {"s": chest.sk.s})()
    m = np.random.default_rng(12).integers(0, p.plain_modulus, size=p.n, dtype=np.int64)
    ct = mod.encrypt(gold.encode(m, p), p, chest.device_pk, ctx, np.random.default_rng(13))
    budgets = []
    for _ in range(4):
        if scheme == "bgv":
            ref = rgbgv.BGVCiphertext([_np(c) for c in ct.c], ct.level, ct.pt_factor)
        else:
            ref = rgbfv.BFVCiphertext([_np(c) for c in ct.c], ct.level)
        got = gold.noise_budget_bits(ct, p, chest.sk)
        assert got == rgold.noise_budget_bits(ref, r, rsk)
        budgets.append(got)
        if ct.level == 1:
            break
        ct = mod.ct_mul(ct, ct, p, ctx, chest.device_rlk)
    assert all(b > a for a, b in zip(budgets[1:], budgets))


def test_bfv_inner_product_centered_equals_the_reference():
    p, r = _params_pair("bfv_tiny")
    ctx = make_context(p, device="cpu")
    chest = pbfv.keygen(p, np.random.default_rng(21), ctx=ctx)
    m = np.random.default_rng(22).integers(0, p.plain_modulus, size=p.n, dtype=np.int64)
    ct = pbfv.encrypt(gbfv.encode(m, p), p, chest.device_pk, ctx, np.random.default_rng(23))
    got, big_q = gbfv._inner_product_centered(ct, p, chest.sk)
    want, rbig_q = rgbfv._inner_product_centered(
        rgbfv.BFVCiphertext([_np(c) for c in ct.c], ct.level), r, chest.sk)
    assert big_q == rbig_q and (got == want).all()
    assert (gbfv.decode(gbfv.round_decode_coeff(got, p.plain_modulus, big_q), p) == m).all()


# --- profiling and benchkit -----------------------------------------------------


def test_stage_trace_and_timer_on_the_cpu(tmp_path):
    x = torch.arange(64, dtype=torch.int64)
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.stage("fhe_stage"):
            y = (x * x) % 97
    assert int(y.sum()) == int(((np.arange(64) ** 2) % 97).sum())
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert "fhe_stage" in json.loads(text)["traceEvents"].__repr__()
    t = profiling.Timer()
    for _ in range(3):
        with t.measure("op"):
            (x * 3).sum()
    with t.measure("other"):
        pass
    rows = t.report()
    assert [r["op"] for r in rows] == ["op", "other"] and rows[0]["n"] == 3
    assert set(rows[0]) == {"op", "n", "mean_ms", "min_ms", "total_s"}


def _reference_row_names() -> list[str]:
    src = (ROOT / "gpufhe_tpu" / "utils" / "benchkit.py").read_text()
    return re.findall(r'row\(\s*"(\w+)"', src)


def test_bench_all_on_the_cpu_gives_the_reference_rows():
    names = _reference_row_names()
    assert names == ["add_mod", "mont_mul", "mul_mod", "ntt_fwd", "ntt_inv", "mod_up",
                     "mod_down", "ks_mac", "key_switch"]
    rows = benchkit.bench_all("tiny2", iters=1, device="cpu")
    assert [r["kernel"] for r in rows] == names
    assert all(r["ms"] > 0 and "bound_ms" not in r for r in rows)


def test_time_it_uses_the_host_clock_on_the_cpu():
    x = torch.ones(16, dtype=torch.int64)
    assert benchkit.time_it(lambda a: a + 1, x, iters=3, warmup=1) > 0


def test_the_tpu_peaks_are_gone_from_the_port():
    src = (ROOT / "gpufhe_tpu_torch" / "utils" / "benchkit.py").read_text()
    assert "819e9" not in src and "394e12" not in src and "PEAK_" not in src
    assert benchkit.HBM_BYTES_PER_S == 3.35e12
