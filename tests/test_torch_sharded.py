"""gpufhe_tpu_torch.parallel (the mesh, the sharded programs and the sharded
backend) on a (2, 4) mesh of eight "cpu" shards.

The distributed four-step (K1's passes per block between two all_to_alls)
is held == the single-device NTT, and each plain pass == its slice of
fourstep_plain. The sharded multiply at ci_small and the sharded BFV
multiply at bfv_ci are held == the reference's own sharded programs on its
eight virtual CPU devices (tests/conftest.py), on the same random limbs and
the reference's keys carried by interop.chest_from_reference. Every other
program, as tests/test_sharded.py pairs them, is held == the port's
single-device op: the rotation, conjugation and hoisted fan, the BGV
multiply and rotation, the BFV rotation and hoisted fan, the routed
permute (v2) == the all_gather one (v1); ShardedBackend's factored
transform round trip and fused fan at fft_ci_small, and the whole dw
bootstrap at boot_dw_ci, are held == DeviceBackend limb for limb. Every
comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpufhe_tpu.keys import keys as rkeys
from gpufhe_tpu.params.params import preset as ref_preset
from gpufhe_tpu.parallel import sharded as rsh
from gpufhe_tpu_torch import interop
from gpufhe_tpu_torch.ciphertext import bfv as pbfv
from gpufhe_tpu_torch.ciphertext import bgv as pbgv
from gpufhe_tpu_torch.ciphertext import ct as dct
from gpufhe_tpu_torch.ciphertext import fftboot as fb
from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper, bootstrap_rotations
from gpufhe_tpu_torch.encoding import encoder
from gpufhe_tpu_torch.golden import bfv as gbfv
from gpufhe_tpu_torch.golden import bgv as gbgv
from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.keys import keys as dkeys
from gpufhe_tpu_torch.ops import ntt_cuda
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
from gpufhe_tpu_torch.parallel import sharded as sh
from gpufhe_tpu_torch.parallel.backend import ShardedBackend
from gpufhe_tpu_torch.parallel.bfv_sharded import (make_sharded_bfv_hoisted_fan,
                                                   make_sharded_bfv_mult,
                                                   make_sharded_bfv_rotation)
from gpufhe_tpu_torch.params.params import preset


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's PyTorch CPU work: its tensors are
    small (N <= 2^10), and tier-1 runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mesh():
    return sh.make_fhe_mesh(2, 4, devices=["cpu"] * 8)


def _got(grid) -> torch.Tensor:
    return sh.unshard_ct_component(grid)


def _same(sharded_pair, single_comps):
    for g, w in zip(sharded_pair, single_comps):
        assert torch.equal(_got(g), w.cpu())


def _random_limbs(params, level, rng, count):
    q = np.asarray(params.q_primes[:level], dtype=np.int64)[:, None]
    return [rng.integers(0, q, size=(level, params.n)) for _ in range(count)]


def test_make_fhe_mesh_without_a_card_raises(monkeypatch):
    """devices=None takes CUDA devices only: with none it raises, and never
    substitutes the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        sh.make_fhe_mesh(2, 4)
    m = sh.make_fhe_mesh(2, 4, devices=["cpu"] * 8)
    assert m.shape == {"limb": 2, "coeff": 4} and m.distinct_devices == [torch.device("cpu")]


@pytest.mark.parametrize("name", ["tiny2", "fft_ci_small", "ci_small"])
def test_fourstep_pass_plain_composes_to_fourstep_plain(name):
    """Four column blocks through pass A (at their offsets) and four row
    blocks through pass B give fourstep_plain's transform in the [k1, k2]
    layout, and back."""
    params = preset(name)
    ctx = make_context(params, device="cpu")
    n1, n2, L = ctx.n1, ctx.n2, params.num_limbs
    x = torch.from_numpy(np.stack(_random_limbs(params, L, np.random.default_rng(0), 1)[0]))
    idx = ctx.index(range(L), torch.int32)
    w, h = n2 // 4, n1 // 4
    x3 = x.view(L, n1, n2)
    a = torch.cat([ntt_cuda.fourstep_pass_plain(x3[:, :, c * w:(c + 1) * w].contiguous(), idx,
                                                ctx, ntt_cuda.FWD_A, c * w)
                   for c in range(4)], dim=2)
    assert a.dtype == torch.int32
    e = torch.cat([ntt_cuda.fourstep_pass_plain(a[:, r * h:(r + 1) * h].contiguous(), idx, ctx,
                                                ntt_cuda.FWD_B) for r in range(4)], dim=1)
    assert torch.equal(sh.eval3d_to_natural(e), ntt_cuda.fourstep_plain(x, idx, ctx, False))
    b = torch.cat([ntt_cuda.fourstep_pass_plain(e[:, r * h:(r + 1) * h].contiguous(), idx, ctx,
                                                ntt_cuda.INV_B) for r in range(4)], dim=1)
    back = torch.cat([ntt_cuda.fourstep_pass_plain(b[:, :, c * w:(c + 1) * w].contiguous(), idx,
                                                   ctx, ntt_cuda.INV_A, c * w)
                      for c in range(4)], dim=2)
    assert torch.equal(back.reshape(L, -1), x)
    with pytest.raises(ValueError):  # a block of rows takes no column offset
        ntt_cuda.fourstep_pass_plain(a[:, :h].contiguous(), idx, ctx, ntt_cuda.FWD_B, 1)


@pytest.mark.parametrize("name", ["tiny2", "ci_small"])
def test_distributed_ntt_round_trip_matches_single_device(name, mesh):
    params = preset(name)
    ctx = make_context(params, device="cpu")
    n1, n2, L = ctx.n1, ctx.n2, params.num_limbs
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy(v) for v in _random_limbs(params, L, rng, 2))
    t_q = sh.gather_ntt_tables(sh.full_ntt_tables(params, mesh=mesh), range(L))
    b = n1 // 4
    blocks = mesh.put(lambda l, c, d: sh.coeff_to_3d(x, n1, n2)[:, c * b:(c + 1) * b]
                      .contiguous())
    e = sh.ntt_fwd_body(blocks, t_q)
    assert torch.equal(_got(e), ntt_fwd(x, ctx, limbs=range(L)))
    back = sh.ntt_inv_body(e, t_q)
    for row in back:  # every limb row holds the whole coefficient matrix
        assert torch.equal(torch.cat(row, dim=1).reshape(L, -1), x)
    got_inv = sh.ntt_inv_body(sh.shard_ct_component(y, params, mesh), t_q)
    assert torch.equal(torch.cat(got_inv[0], dim=1).reshape(L, -1),
                       ntt_inv(y, ctx, limbs=range(L)))


def _reference_run(make, rparams, level, rchest_key, comps, *extra):
    """The reference's sharded program on its 8 virtual CPU devices."""
    rmesh = rsh.make_fhe_mesh(2, 4, devices=jax.devices()[:8])
    run, prepare = make(rparams, level, rmesh)
    blocks = [rsh.shard_ct_component(jnp.asarray(c.astype(np.uint32)), rparams, rmesh)
              for c in comps]
    return [np.asarray(rsh.unshard_ct_component(o)).astype(np.int64)
            for o in run(*blocks, prepare(rchest_key))]


def test_sharded_mult_matches_reference_sharded_mult(mesh):
    """ci_small, level 6: the port's make_sharded_mult == the reference's
    make_sharded_mult on the same limbs and keys, and == ct_mul."""
    params, rparams = preset("ci_small"), ref_preset("ci_small")
    rchest = rkeys.keygen(rparams, np.random.default_rng(7))
    chest = interop.chest_from_reference(rchest, device="cpu")
    ctx = make_context(params, device="cpu")
    level = params.num_limbs
    comps = _random_limbs(params, level, np.random.default_rng(5), 4)
    want = _reference_run(rsh.make_sharded_mult, rparams, level, rchest.device_rlk, comps)
    run, prepare = sh.make_sharded_mult(params, level, mesh)
    got = run(*[sh.shard_ct_component(torch.from_numpy(c), params, mesh) for c in comps],
              prepare(chest.device_rlk))
    for g, w in zip(got, want):
        assert (_got(g).numpy() == w).all()
    a, b = (dct.Ciphertext([torch.from_numpy(c) for c in pair], level, params.scale)
            for pair in (comps[:2], comps[2:]))
    _same(got, dct.ct_mul(a, b, params, ctx, chest.device_rlk).c)


def test_sharded_bfv_mult_matches_reference_sharded_bfv_mult(mesh):
    """bfv_ci (N = 2^10, n1 = n2 = 32, which the 2 x 4 mesh divides): the
    port's make_sharded_bfv_mult == the reference's, and == bfv.ct_mul."""
    from gpufhe_tpu.ciphertext import bfv as rbfv
    from gpufhe_tpu.parallel import bfv_sharded as rbfv_sh

    params, rparams = preset("bfv_ci"), ref_preset("bfv_ci")
    rchest = rbfv.keygen(rparams, np.random.default_rng(7))
    chest = interop.chest_from_reference(rchest, device="cpu")
    ctx = make_context(params, device="cpu")
    level = params.num_limbs
    comps = _random_limbs(params, level, np.random.default_rng(2), 4)
    want = _reference_run(rbfv_sh.make_sharded_bfv_mult, rparams, level, rchest.device_rlk,
                          comps)
    run, prepare = make_sharded_bfv_mult(params, level, mesh)
    got = run(*[sh.shard_ct_component(torch.from_numpy(c), params, mesh) for c in comps],
              prepare(chest.device_rlk))
    for g, w in zip(got, want):
        assert (_got(g).numpy() == w).all()
    a, b = (pbfv.BFVCiphertext([torch.from_numpy(c) for c in pair], level)
            for pair in (comps[:2], comps[2:]))
    _same(got, pbfv.ct_mul(a, b, params, ctx, chest.device_rlk).c)


@pytest.fixture(scope="module")
def ckks_stack():
    params = preset("tiny2")
    ctx = make_context(params, device="cpu")
    chest = dkeys.keygen(params, np.random.default_rng(11), rotations=(1, 2, 5),
                         conjugation=True, ctx=ctx)
    z = np.random.default_rng(12).normal(size=(params.slots, 2)) @ np.array([1, 1j])
    ct = dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx,
                     np.random.default_rng(13), params.scale)
    return params, ctx, chest, ct


def test_sharded_rotation_and_conjugation_match_single_device(ckks_stack, mesh):
    params, ctx, chest, ct = ckks_stack
    c0, c1 = (sh.shard_ct_component(c, params, mesh) for c in ct.c)
    run, prepare = sh.make_sharded_rotation(params, ct.level, mesh, 2)
    _same(run(c0, c1, prepare(chest.galois_key(2))),
          dct.ct_rotate(ct, 2, params, ctx, chest.galois_key(2)).c)
    run, prepare = sh.make_sharded_conjugation(params, ct.level, mesh)
    _same(run(c0, c1, prepare(chest.conj_key())),
          dct.ct_conjugate(ct, params, ctx, chest.conj_key()).c)


def test_sharded_hoisted_fan_matches_single_device(ckks_stack, mesh):
    """ShardedBackend.rotate_hoisted's shared-hoist fan == ct_rotate_hoisted
    (one ModUp for the whole fan)."""
    params, ctx, chest, ct = ckks_stack
    steps = (1, 2, 5)
    want = dct.ct_rotate_hoisted(ct, list(steps), params, ctx,
                                 {s: chest.galois_key(s) for s in steps})
    be = ShardedBackend(params, mesh, chest)
    got = be.rotate_hoisted(be.from_single(ct), list(steps))
    for s, w in zip(steps, want):
        assert got[s].level == w.level
        _same(got[s].c, w.c)


@pytest.mark.parametrize("scheme", ["bgv", "bfv"])
def test_sharded_integer_ops_match_single_device(scheme, mesh):
    """bgv_ci: the sharded multiply (the t-corrected ModSwitch) and rotation;
    bfv_ci: the rotation and the hoisted fan (the plain ModDown view); each
    == the single-device op, and the BGV rotation decrypts to the rotated
    slots."""
    mod, gold = (pbgv, gbgv) if scheme == "bgv" else (pbfv, gbfv)
    params = preset(f"{scheme}_ci")
    ctx = make_context(params, device="cpu")
    chest = mod.keygen(params, np.random.default_rng(7), rotations=(3, 5), ctx=ctx)
    t = params.plain_modulus
    rng = np.random.default_rng(2)
    za, zb = rng.integers(0, t, size=params.n), rng.integers(0, t, size=params.n)
    a, b = (mod.encrypt(gold.encode(z, params), params, chest.device_pk, ctx,
                        np.random.default_rng(31 + i)) for i, z in enumerate((za, zb)))
    c0, c1 = (sh.shard_ct_component(c, params, mesh) for c in a.c)
    gk = chest.galois[3][1]
    if scheme == "bgv":
        run, prepare = sh.make_sharded_mult(params, a.level, mesh)
        got = run(c0, c1, *(sh.shard_ct_component(c, params, mesh) for c in b.c),
                  prepare(chest.device_rlk))
        _same(got, pbgv.ct_mul(a, b, params, ctx, chest.device_rlk).c)
        run, prepare = sh.make_sharded_rotation(params, a.level, mesh, 3)
        got = run(c0, c1, prepare(gk))
        want = pbgv.ct_rotate(a, 3, params, ctx, gk)
        _same(got, want.c)
        dec = pbgv.decrypt_decode(pbgv.BGVCiphertext([_got(g) for g in got], want.level,
                                                     want.pt_factor), params, chest.device_sk,
                                  ctx)
        assert (dec == (za % t)[gbgv.slot_rotation_perm(params, 3)]).all()
        return
    run, prepare = make_sharded_bfv_rotation(params, a.level, mesh, 3)
    _same(run(c0, c1, prepare(gk)), pbfv.ct_rotate(a, 3, params, ctx, gk).c)
    gks = {s: chest.galois[s][1] for s in (3, 5)}
    want = pbfv.ct_rotate_hoisted(a, [3, 5], params, ctx, gks)
    run, prepare = make_sharded_bfv_hoisted_fan(params, a.level, mesh, 2)
    lins = sh._lin_blocks(np.stack([sh._perm_lin_e3(gckks.galois_exponent(s, params.n),
                                                    ctx.n1, ctx.n2) for s in (3, 5)]), mesh)
    for got, w in zip(run(c0, c1, lins, prepare([gks[3], gks[5]])), want):
        _same(got, w.c)


def test_permute_v2_routing_matches_v1_all_gather(mesh):
    """The 1x-traffic all_to_all-routed automorphism == the all_gather path,
    for rotations and conjugation, at ci_small."""
    params = preset("ci_small")
    n1, n2 = make_context(params, device="cpu").n1, make_context(params, device="cpu").n2
    qp = np.asarray(params.q_primes + params.p_primes, dtype=np.int64)
    x = torch.from_numpy(np.random.default_rng(3).integers(0, qp[:, None, None],
                                                           size=(len(qp), n1, n2)))
    xs = mesh.put(lambda l, c, d: x[:, c * (n1 // 4):(c + 1) * (n1 // 4)].contiguous())
    for g in [gckks.galois_exponent(1, params.n), gckks.galois_exponent(5, params.n),
              gckks.galois_exponent(params.slots - 1, params.n), 2 * params.n - 1]:
        v1 = sh._permute_body(mesh, xs, sh._lin_blocks(sh._perm_lin_e3(g, n1, n2), mesh))
        v2 = sh._permute_body_v2(mesh, xs, sh._route_blocks(g, n1, n2, mesh))
        assert torch.equal(_got(v1), _got(v2)), g
        perm = torch.from_numpy(gckks.automorphism_perm_eval(g, params.n))
        assert torch.equal(_got(v2), sh.eval3d_to_natural(x)[:, perm]), g


def _equal_cts(sharded_ct, single_ct, be):
    got = be.to_single(sharded_ct)
    assert got.level == single_ct.level and got.scale == single_ct.scale
    for g, w in zip(got.c, single_ct.c):
        assert torch.equal(g, w)


def test_sharded_backend_transform_and_fused_fan_match_device_backend(mesh):
    """fft_ci_small: the factored CtS and StC over ShardedBackend == over
    DeviceBackend, decoded back to the input; the fused diagonal fan (one
    hoisted ModUp, a zero-offset diagonal in one set) == DeviceBackend's."""
    params = preset("fft_ci_small")
    ctx = make_context(params, device="cpu")
    rots = fb.factored_rotations(params.slots, radix_log=3)
    chest = dkeys.keygen(params, np.random.default_rng(7), rotations=tuple(rots),
                         conjugation=True, ctx=ctx)
    sb, db = ShardedBackend(params, mesh, chest), DeviceBackend(params, ctx, chest)
    rng = np.random.default_rng(0)
    ns = params.slots
    z = rng.normal(size=ns) + 1j * rng.normal(size=ns)
    ct = dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx,
                     np.random.default_rng(1), params.scale)
    lo, hi = fb.FactoredCtS(sb, level=params.num_limbs, radix_log=3)(sb.from_single(ct))
    lo_d, hi_d = fb.FactoredCtS(db, level=params.num_limbs, radix_log=3)(ct)
    _equal_cts(lo, lo_d, sb)
    _equal_cts(hi, hi_d, sb)
    out = fb.FactoredStC(sb, level=sb.level(lo), radix_log=3)(lo, hi)
    _equal_cts(out, fb.FactoredStC(db, level=db.level(lo_d), radix_log=3)(lo_d, hi_d), sb)
    assert np.abs(sb.decrypt_decode(out) - z).max() < 1e-3
    d1, d2 = (rng.normal(size=ns) + 1j * rng.normal(size=ns) for _ in range(2))
    sets = [{0: d1, 1: d2, 5: d1}, {1: d2, 2: d1}]
    out_s = sb.apply_fan(sb.from_single(ct), sb.make_fan_plan(sets, ct.level))
    out_d = db.apply_fan(ct, db.make_fan_plan(sets, ct.level))
    for s_, d_ in zip(out_s, out_d):
        _equal_cts(s_, d_, sb)


def test_sharded_double_word_bootstrap_matches_device_backend(mesh):
    """The whole dw bootstrap (boot_dw_ci, factored radix 6, Chebyshev
    EvalMod) composed over ShardedBackend == over DeviceBackend, limb for
    limb; Bootstrapper, fftboot and polyeval take the sharded backend
    unchanged, and a second call performs no host encode."""
    params = preset("boot_dw_ci")
    ctx = make_context(params, device="cpu")
    rots = bootstrap_rotations(params, transform="factored", radix_log=6)
    chest = dkeys.keygen(params, np.random.default_rng(7), rotations=tuple(rots),
                         conjugation=True, ctx=ctx)
    kw = dict(transform="factored", radix_log=6, evalmod="cheb", k_bound=5.0)
    bs_dev = Bootstrapper(DeviceBackend(params, ctx, chest), fuse_evalmod=False, **kw)
    shb = ShardedBackend(params, mesh, chest)
    bs_sh = Bootstrapper(shb, **kw)
    rng = np.random.default_rng(0)
    z = (rng.normal(size=params.slots) + 1j * rng.normal(size=params.slots)) * 0.2
    ct = dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx,
                     np.random.default_rng(1), params.scale, level=2)
    want = bs_dev(ct)
    _equal_cts(bs_sh(shb.from_single(ct)), want, shb)
    before = shb.encode_misses
    again = bs_sh(shb.from_single(ct))
    assert shb.encode_misses == before
    assert np.abs(shb.decrypt_decode(again) - z).max() < 1e-3


def test_interop_carries_a_reference_sharded_ciphertext(mesh):
    """interop.sharded_ct_from_numpy and mesh_from_reference: a reference
    ShardedCiphertext's eval3d components become the port's, on a mesh of
    the reference's shape."""
    from gpufhe_tpu.parallel.backend import ShardedCiphertext as RShardedCiphertext

    params, rparams = preset("tiny2"), ref_preset("tiny2")
    rmesh = rsh.make_fhe_mesh(2, 4, devices=jax.devices()[:8])
    pmesh = interop.mesh_from_reference(rmesh.shape, ["cpu"] * 8)
    assert pmesh.shape == {"limb": 2, "coeff": 4}
    comps = _random_limbs(params, 3, np.random.default_rng(4), 2)
    rct = RShardedCiphertext([rsh.shard_ct_component(jnp.asarray(c.astype(np.uint32)), rparams,
                                                     rmesh) for c in comps], 3, 2.0**20)
    got = interop.sharded_ct_from_numpy([np.asarray(c) for c in rct.c], rct.level, rct.scale,
                                        pmesh)
    assert got.level == 3 and got.scale == 2.0**20
    for g, c in zip(got.c, comps):
        assert (_got(g).numpy() == c).all()
