"""Card-side key generation against the reference's, on the CPU.

gpufhe_tpu_torch.keys.prng against jax.random (threefry-2x32, partitionable,
64-bit types off): key's seed truncation, split and bits, at seeds below
2^31, at and above 2^32 and 2^63 - 1, and shapes of odd size. Then
device_keygen against gpufhe_tpu.keys.device_keygen from the same numpy
seed: every device array and every recorded seed ==, at tiny2 with
rotations (1, 2) and conjugation and at boot_dw_ci_enc (the encapsulation
keys); regen_ks_a and regen_pk_a == the reference's; _uniform_mod_q at the
edges of its input range; the lean-key cycle (drop_galois_a,
regen_galois_a) on a truncated chest; and a ct_mul and a rotation under
device keys == the reference's jnp path on the keys carried across by
interop.chest_from_reference.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gpufhe_tpu.ciphertext import ct as rct
from gpufhe_tpu.keys import device_keygen as rdk
from gpufhe_tpu.keys.keys import truncate_galois_device as ref_truncate
from gpufhe_tpu.ops.context import make_context as ref_context
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu_torch import interop
from gpufhe_tpu_torch.ciphertext import ct as pct
from gpufhe_tpu_torch.encoding import encoder as penc
from gpufhe_tpu_torch.keys import device_keygen as pdk
from gpufhe_tpu_torch.keys import prng
from gpufhe_tpu_torch.keys.keys import truncate_galois_device
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import preset

SEEDS = [0, 7, 2**31 - 1, 2**31 + 5, 2**32 - 1, 2**32, 2**32 + 7, 2**40 + 5, 2**63 - 1]
SHAPES = [(1,), (7,), (3, 5), (2, 3, 11)]


def _np(x):
    return np.asarray(x).astype(np.int64)


def _eq(got: torch.Tensor, want) -> bool:
    return got.shape == np.shape(want) and (got.cpu().numpy() == _np(want)).all()


# --- threefry ------------------------------------------------------------------


def test_jax_runs_partitionable_threefry_in_32_bits():
    """The reference's generator settings, which the port reproduces."""
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_bits_match_jax(seed):
    k = jax.random.key(seed)
    pk = prng.key(seed)
    assert _eq(prng.key_data(pk), jax.random.key_data(k))
    assert pk.tolist() == [0, seed % 2**32]  # 64-bit types off: the low word only
    for num in (2, 5):
        assert _eq(prng.split(pk, num), jax.random.key_data(jax.random.split(k, num)))
    for shape in SHAPES:
        got = prng.bits_u32(pk, shape)
        assert got.dtype == torch.int64
        assert _eq(got, jax.random.bits(k, shape, dtype=np.uint32))


def test_split_chain_and_wrapped_keys_match_jax():
    """The draw sequence of _a_rows: key, sub = split(key), twice over, and
    each sub's two halves drawn from; wrap_key_data takes uint32 words."""
    k, pk = jax.random.key(123456789), prng.key(123456789)
    for _ in range(3):
        k, sub = jax.random.split(k)
        pk, psub = prng.split(pk)
        k1, k2 = jax.random.split(sub)
        p1, p2 = prng.split(psub)
        for a, b in ((k1, p1), (k2, p2)):
            assert _eq(prng.bits_u32(b, (4, 9)), jax.random.bits(a, (4, 9), dtype=np.uint32))
    data = np.asarray(jax.random.key_data(k))
    assert data.dtype == np.uint32 and _eq(prng.wrap_key_data(data), data)
    assert _eq(prng.bits_u32(prng.wrap_key_data(data), (5,)),
               jax.random.bits(jax.random.wrap_key_data(data), (5,), dtype=np.uint32))


# --- device_keygen ---------------------------------------------------------------

CASES = {"tiny2": ((1, 2), True), "boot_dw_ci_enc": ((1,), False)}


@pytest.fixture(scope="module", params=list(CASES))
def chests(request):
    name = request.param
    rots, conj = CASES[name]
    params, rparams = preset(name), ref_preset(name)
    ctx = make_context(params, device="cpu")
    chest = pdk.device_keygen(params, np.random.default_rng(7), rots, conj, ctx=ctx)
    rchest = rdk.device_keygen(rparams, np.random.default_rng(7), rots, conj)
    return name, params, rparams, ctx, chest, rchest


def _ks_eq(got, want) -> bool:
    return _eq(got.b_mont, want.b_mont) and _eq(got.a_mont, want.a_mont)


def test_device_keygen_matches_reference(chests):
    name, params, _, _, chest, rchest = chests
    assert (chest.sk.s == rchest.sk.s).all()
    assert _eq(chest.device_sk.s_mont, rchest.device_sk.s_mont)
    assert _eq(chest.device_pk.b_mont, rchest.device_pk.b_mont)
    assert _eq(chest.device_pk.a_mont, rchest.device_pk.a_mont)
    assert _ks_eq(chest.device_rlk, rchest.device_rlk)
    assert list(chest.galois) == list(rchest.galois) == list(CASES[name][0])
    for s, (canon, key) in chest.galois.items():
        assert canon is None and _ks_eq(key, rchest.galois[s][1])
    if CASES[name][1]:
        assert chest.conj[0] is None and _ks_eq(chest.conj[1], rchest.conj[1])
    else:
        assert chest.conj is None and rchest.conj is None
    if params.eph_hamming_weight:
        assert (chest.eph["s_eph"] == rchest.eph["s_eph"]).all()
        for k in ("to_eph", "from_eph"):
            assert chest.eph[k][0] is None and _ks_eq(chest.eph[k][1], rchest.eph[k][1])
    else:
        assert chest.eph is None and rchest.eph is None


def test_device_keygen_records_the_reference_seeds(chests):
    name, params, _, _, chest, rchest = chests
    assert list(chest.seeds) == list(rchest.seeds)
    expect = ["pk", "rlk", *(f"gk{s}" for s in CASES[name][0])]
    expect += ["conj"] * CASES[name][1] + ["to_eph", "from_eph"] * bool(params.eph_hamming_weight)
    assert list(chest.seeds) == expect
    for k, v in chest.seeds.items():
        assert v.dtype == torch.int64 and _eq(v, rchest.seeds[k])


def test_regen_matches_reference_and_the_keys(chests):
    name, params, rparams, ctx, chest, rchest = chests
    rctx = ref_context(rparams)
    pk_a = pdk.regen_pk_a(params, ctx, chest.seeds["pk"])
    assert _eq(pk_a, rdk.regen_pk_a(rparams, rctx, rchest.seeds["pk"]))
    assert torch.equal(pk_a, chest.device_pk.a_mont)
    a = pdk.regen_ks_a(params, ctx, chest.seeds["rlk"])
    assert _eq(a, rdk.regen_ks_a(rparams, rctx, rchest.seeds["rlk"]))
    assert torch.equal(a, chest.device_rlk.a_mont)
    for s, (_, key) in chest.galois.items():
        assert torch.equal(pdk.regen_ks_a(params, ctx, np.asarray(rchest.seeds[f"gk{s}"])),
                           key.a_mont)


@pytest.mark.parametrize("name", ["tiny", "ci_small"])
def test_uniform_mod_q_at_the_edges_of_its_input(name):
    """hi and lo anywhere in [0, 2^32): (hi 2^32 + lo) mod q exactly, at 0,
    q - 1, q, 2^31 and 2^32 - 1 (words that are not residues), against
    Python integers."""
    params = preset(name)
    ctx = make_context(params, device="cpu")
    idx = range(len(ctx.primes))
    q = ctx.col("q", idx)
    words = torch.tensor([0, 1, 2**31, 2**32 - 1], dtype=torch.int64)
    cols = torch.cat([words.expand(len(idx), -1), q - 1, q, q + 1], dim=1)
    c = cols.shape[1]
    hi = cols[:, :, None].expand(-1, -1, c).reshape(len(idx), -1)  # every (hi, lo) pair
    lo = cols[:, None, :].expand(-1, c, -1).reshape(len(idx), -1)
    real, draws = prng.bits_u32, [hi, lo]  # _uniform_mod_q draws hi, then lo
    prng.bits_u32 = lambda key_, shape, device=None: draws.pop(0).reshape(shape)
    try:
        got = pdk._uniform_mod_q(prng.key(1), ctx, idx, c * c)
    finally:
        prng.bits_u32 = real
    assert not draws
    for r, p in enumerate(ctx.primes):
        want = [(a * 2**32 + b) % p for a, b in zip(hi[r].tolist(), lo[r].tolist())]
        assert got[r].tolist() == want


def test_lean_key_drop_regen_cycle():
    """drop_galois_a then regen_galois_a gives back the Galois keys, a
    truncated one with its rows, bit for bit; a dropped key refuses use
    (port of tests/test_models_utils.py::test_lean_key_drop_regen_cycle)."""
    params = preset("tiny2")
    ctx = make_context(params, device="cpu")
    chest = pdk.device_keygen(params, np.random.default_rng(21), (1, 3), True, ctx=ctx)
    truncate_galois_device(chest, {1: params.num_limbs - 1}, None, params)
    want = {s: chest.galois[s][1].a_mont.clone() for s in (1, 3)}
    want_c = chest.conj[1].a_mont.clone()
    assert want[1].shape[1] == params.num_limbs - 1 + len(params.p_primes)

    assert chest.drop_galois_a() == 3
    assert chest.galois[1][1].a_mont is None and chest.conj[1].a_mont is None
    with pytest.raises(RuntimeError):
        chest.galois_key(1)
    with pytest.raises(RuntimeError):
        chest.conj_key()
    assert chest.regen_galois_a(ctx) == 3
    for s in (1, 3):
        assert torch.equal(chest.galois_key(s).a_mont, want[s])
    assert torch.equal(chest.conj_key().a_mont, want_c)
    assert chest.drop_galois_a() == 3 and chest.regen_galois_a(ctx) == 3
    assert torch.equal(chest.galois_key(1).a_mont, want[1])
    assert chest.regen_galois_a(ctx) == 0


def test_lean_cycle_matches_the_reference_on_a_truncated_chest():
    """The same cycle on both packages' chests gives the same rows."""
    params, rparams = preset("tiny2"), ref_preset("tiny2")
    ctx = make_context(params, device="cpu")
    chest = pdk.device_keygen(params, np.random.default_rng(21), (1, 3), True, ctx=ctx)
    rchest = rdk.device_keygen(rparams, np.random.default_rng(21), (1, 3), True)
    levels = {1: params.num_limbs - 1, 3: params.num_limbs - 2}
    truncate_galois_device(chest, levels, params.num_limbs - 1, params)
    ref_truncate(rchest, levels, params.num_limbs - 1, rparams)
    for c, cx in ((chest, ctx), (rchest, ref_context(rparams))):
        c.drop_galois_a()
        c.regen_galois_a(cx)
    for s in (1, 3):
        assert _ks_eq(chest.galois_key(s), rchest.galois_key(s))
    assert _ks_eq(chest.conj_key(), rchest.conj_key())


def test_chest_from_reference_carries_a_device_chest(chests):
    _, params, _, _, chest, rchest = chests
    carried = interop.chest_from_reference(rchest, "cpu")
    assert isinstance(carried, pdk.DeviceKeyChest) and carried.params == params
    assert [f.name for f in dataclasses.fields(carried)] == [
        f.name for f in dataclasses.fields(rdk.DeviceKeyChest)]
    assert _eq(carried.device_sk.s_mont, rchest.device_sk.s_mont)
    assert _eq(carried.device_pk.a_mont, rchest.device_pk.a_mont)
    assert _ks_eq(carried.device_rlk, rchest.device_rlk)
    for s, (canon, key) in carried.galois.items():
        assert canon is None and _ks_eq(key, chest.galois[s][1])
    for k, v in carried.seeds.items():
        assert torch.equal(v, chest.seeds[k])
    if rchest.eph is not None:
        for k in ("to_eph", "from_eph"):
            assert carried.eph[k][0] is None and _ks_eq(carried.eph[k][1], rchest.eph[k][1])


def test_ct_mul_and_rotation_under_device_keys_match_reference():
    """Device keys from the reference, carried across: a ct_mul and a
    rotation on the port == the reference's jnp path, and decode."""
    params, rparams = preset("tiny2"), ref_preset("tiny2")
    rchest = rdk.device_keygen(rparams, np.random.default_rng(3), (1,), False)
    chest = interop.chest_from_reference(rchest, "cpu")
    ctx, rctx = make_context(params, device="cpu"), ref_context(rparams)
    rng = np.random.default_rng(0)
    z = rng.normal(size=params.slots) + 1j * rng.normal(size=params.slots)
    pt = penc.encode(z, params)
    ct = pct.encrypt(pt, params, chest.device_pk, ctx, np.random.default_rng(1), params.scale)
    rc = rct.encrypt(pt, rparams, rchest.device_pk, rctx, np.random.default_rng(1), params.scale)
    outs = {"ct_mul": (pct.ct_mul(ct, ct, params, ctx, chest.device_rlk),
                       rct.ct_mul(rc, rc, rparams, rctx, rchest.device_rlk), z * z),
            "ct_rotate": (pct.ct_rotate(ct, 1, params, ctx, chest.galois_key(1)),
                          rct.ct_rotate(rc, 1, rparams, rctx, rchest.galois_key(1)),
                          np.roll(z, -1))}
    for what, (got, want, clear) in outs.items():
        assert got.level == want.level and got.scale == want.scale, what
        for g, w in zip(got.c, want.c):
            assert _eq(g, w), what
        err = np.abs(pct.decrypt_decode(got, params, chest.device_sk, ctx) - clear).max()
        assert err < 1e-2, (what, err)
