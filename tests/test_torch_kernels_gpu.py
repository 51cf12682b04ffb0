"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips where no CUDA device is present;
the file imports neither jax nor gpufhe_tpu, so it also runs on a machine
that has only PyTorch (tests/conftest.py imports jax, hence --noconftest):

    python3 -m pytest -q -p no:cacheprovider --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import chip_smoke
from gpufhe_tpu_torch.ciphertext import ct as dct
from gpufhe_tpu_torch.encoding import encoder
from gpufhe_tpu_torch.keys import device_keygen as dkg
from gpufhe_tpu_torch.keys import keys as dkeys
from gpufhe_tpu_torch.keys import prng
from gpufhe_tpu_torch.ops import (convert_cuda, mac_cuda, ntt_cuda, probes, rescale_cuda,
                                  tensor_cuda)
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.ops.convert_cuda import make_convert_tables
from gpufhe_tpu_torch.params.params import gen_ntt_primes, is_prime, preset
from gpufhe_tpu_torch.primitives import keyswitch, rns

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rand(primes, rows, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, primes[r], size=n, dtype=np.int64) for r in rows])


# R = 8 .. 256: tiny 8 x 8, boot_dw_ci 16 x 8, tiny2 16 x 16, ci_small 32 x 32,
# config3_ckks 256 x 128, config5_boot 256 x 256
@pytest.mark.parametrize("name", ["tiny", "tiny2", "ci_small", "config3_ckks", "boot_dw_ci",
                                  "config5_boot"])
def test_ntt_kernel_matches_plain(cuda_device, name):
    params = preset(name)
    ctx = make_context(params, device=cuda_device)
    primes = params.q_primes + params.p_primes
    sel = list(range(len(primes)))[::-1]
    idx = ctx.index(sel, torch.int32)
    x = torch.from_numpy(_rand(primes, sel * 2, params.n, 8)).to(cuda_device)  # batch of 2
    before = ntt_cuda.KERNEL.launches
    for inverse in (False, True):
        got = ntt_cuda.fourstep_cuda(x, idx, ctx, inverse)
        assert torch.equal(got, ntt_cuda.fourstep_plain(x, idx, ctx, inverse))
    assert ntt_cuda.KERNEL.launches == before + 2
    top = x.clone()
    for r, p in enumerate(sel * 2):
        top[r] = primes[p] - 1  # the largest canonical residue everywhere
    back = ntt_cuda.fourstep_cuda(ntt_cuda.fourstep_cuda(top, idx, ctx, False), idx, ctx, True)
    assert torch.equal(back, top)


@pytest.mark.parametrize("s_dim,t_dim", [(15, 45), (15, 30), (2, 6), (1, 3), (16, 45), (17, 45),
                                         (33, 40), (10, 58), (8, 58)])
def test_convert_kernel_matches_plain(cuda_device, s_dim, t_dim):
    """Random and worst-case residues (x = q - 1) against primes just below
    2^30, one launch per call; S = 1, 16, 17 and 33 cross the kernel's
    chunk and reduction boundaries."""
    src = tuple(gen_ntt_primes(30, 2**17, s_dim))
    dst = tuple(gen_ntt_primes(28, 2**17, t_dim))
    tabs = make_convert_tables(src, dst, cuda_device)
    x = torch.from_numpy(_rand(src, range(s_dim), 2**16, 9)).to(cuda_device)
    top = (tabs.sq[:, None] - 1).expand(s_dim, 2**16).contiguous()
    for data in (x, top):
        before = convert_cuda.KERNEL.launches
        got = convert_cuda.base_convert_cuda(data, tabs)
        assert convert_cuda.KERNEL.launches == before + 1
        assert torch.equal(got, convert_cuda.base_convert_plain(data, tabs))


def test_convert_kernel_raises_its_refusal(cuda_device):
    """Tables with a prime >= 2^30: the wrapper raises the reason recorded
    when they were built, and launches nothing."""
    big = next(p for p in range((1 << 30) + 1, (1 << 30) + 10**4, 2) if is_prime(p))
    tabs = make_convert_tables((97, big), (193, 257), cuda_device)
    x = torch.ones((2, 1024), dtype=torch.int64, device=cuda_device)
    before = convert_cuda.KERNEL.launches
    with pytest.raises(ValueError, match=re.escape(tabs.k3_refusal)):
        convert_cuda.base_convert_cuda(x, tabs)
    assert convert_cuda.KERNEL.launches == before


def _mod_down_context(case: str, device):
    """(KSContext, level) of each cell's ModDown: ckks_n16_dw 58 -> 48
    (alpha 10); n16_int 45 -> 30 (alpha 15) with BGV's t-folded tables and
    as BFV's CKKS view; ckks_n16_l30 at its lowest level, 21 -> 6; a
    synthetic basis of 33 or 40 special primes below 2^30 onto 8 (the
    kernel's chunked path)."""
    if case.startswith("chunked"):
        alpha, k = int(case.split("_")[1]), 8
        primes = gen_ntt_primes(30, 2**17, alpha + k)
        ps, qs = primes[:alpha], primes[alpha:]
        return rns.KSContext(
            modup=(), p2q=make_convert_tables(ps, qs, device),
            p2q_epilogue=convert_cuda.make_mod_down_table(ps, qs, device)), k
    name, level = {"ckks_n16_dw": ("config5_boot_dw", 48), "n16_int_bgv": ("bfv_n16", 30),
                   "n16_int_bfv": ("bfv_n16", 30), "ckks_n16_l30": ("config5_boot", 6)}[case]
    params = preset(name)
    if case == "n16_int_bfv":
        params = dataclasses.replace(params, plain_modulus=0)
    return rns.make_ks_context(params, level, device=device), level


@pytest.mark.parametrize("case", ["ckks_n16_dw", "n16_int_bgv", "n16_int_bfv", "ckks_n16_l30",
                                  "chunked_33", "chunked_40"])
@pytest.mark.parametrize("b_dim,add_rows,alias", [
    (1, 0, False), (1, 1, False), (1, 1, True), (2, 0, False), (2, 1, False), (2, 2, False),
    (2, 1, True), (2, 2, True)])
def test_mod_down_kernel_matches_plain(cuda_device, case, b_dim, add_rows, alias):
    """The fused ModDown (K3 with its epilogue) of int64[B, K + alpha, 2^16]
    == the plain ModDown and add_mod of the addend's leading rows, with the
    largest residues (q - 1) in column 0; with alias the output is written
    over the addend. One launch, counted by KERNEL and MOD_DOWN; the plain
    conversions' launch shape gives the same."""
    ksc, k = _mod_down_context(case, cuda_device)
    primes = ksc.p2q.dq.tolist() + ksc.p2q.sq.tolist()
    acc = torch.from_numpy(np.stack([_rand(primes, range(len(primes)), 2**16, 50 + b)
                                     for b in range(b_dim)])).to(cuda_device)
    acc[..., 0] = torch.tensor(primes, device=cuda_device) - 1
    add = None
    if add_rows:
        add = torch.from_numpy(np.stack([_rand(primes, range(k), 2**16, 60 + b)
                                         for b in range(add_rows)])).to(cuda_device)
    want = convert_cuda.mod_down_plain(acc, ksc.p2q, ksc.p2q_epilogue, add)
    out = None
    if alias:  # the addend as the leading rows of the output buffer
        out = torch.zeros((b_dim, k, 2**16), dtype=torch.int64, device=cuda_device)
        out[:add_rows] = add
        add = out[:add_rows]
    before = (convert_cuda.KERNEL.launches, convert_cuda.MOD_DOWN.launches,
              convert_cuda.MOD_DOWN.components)
    got = convert_cuda.mod_down_cuda(acc, ksc.p2q, ksc.p2q_epilogue, add, out=out)
    after = (convert_cuda.KERNEL.launches, convert_cuda.MOD_DOWN.launches,
             convert_cuda.MOD_DOWN.components)
    assert after == (before[0] + 1, before[1] + 1, before[2] + b_dim)
    assert torch.equal(got, want)
    if alias:
        assert got.data_ptr() == out.data_ptr()
    else:  # the plain conversions' launch shape: groups of 16, two coefficients a thread
        assert torch.equal(convert_cuda.mod_down_cuda(acc, ksc.p2q, ksc.p2q_epilogue, add, None,
                                                      convert_cuda.GROUP, convert_cuda.CPT), want)


@pytest.mark.parametrize("name,level", [("config5_boot_dw", 48), ("config5_boot_dw", 37),
                                        ("bfv_n16", 30), ("config5_boot", 6)])
def test_mod_up_in_place_matches_stacked_list(cuda_device, name, level):
    """mod_up writes each group's conversion into its row of one stack: ==
    the stacked list of plain conversions, one K3 launch per group."""
    params = preset(name)
    ctx = make_context(params, device=cuda_device)
    ksc = rns.make_ks_context(params, level, device=cuda_device)
    x = torch.from_numpy(_rand(params.q_primes, range(level), params.n, level)).to(cuda_device)
    groups = rns.ks_groups(params, level)
    want = torch.stack([convert_cuda.base_convert_plain(x[d0:d1], ksc.modup[g])
                        for g, (d0, d1) in enumerate(groups)])
    before = convert_cuda.KERNEL.launches
    got = rns.mod_up(x, params, level, ctx, ksc)
    assert convert_cuda.KERNEL.launches == before + len(groups)
    assert torch.equal(got, want)


def test_mod_down_once_per_key_switch(cuda_device):
    """One fused ModDown launch for both components of every key switch: a
    ct_mul_full (the addend its d0, d1), a rotation, a BGV and a BFV ct_mul;
    and the card's limbs == the CPU path's."""
    from gpufhe_tpu_torch.ciphertext import bfv, bgv
    from gpufhe_tpu_torch.golden import bfv as gbfv
    from gpufhe_tpu_torch.golden import bgv as gbgv

    def count(fn):
        before = (convert_cuda.MOD_DOWN.launches, convert_cuda.MOD_DOWN.components)
        out = fn()
        return out, (convert_cuda.MOD_DOWN.launches - before[0],
                     convert_cuda.MOD_DOWN.components - before[1])

    params = preset("boot_dw_ci")
    z = np.random.default_rng(1).normal(size=params.slots)
    outs = {}
    for device in ("cpu", cuda_device):
        ctx = make_context(params, device=device)
        chest = dkeys.keygen(params, np.random.default_rng(2), rotations=(1,), ctx=ctx)
        ca = dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx,
                         np.random.default_rng(3), params.scale)
        prod, n_mul = count(lambda: dct.ct_mul_full(ca, ca, params, ctx, chest.device_rlk))
        rot, n_rot = count(lambda: dct.ct_rotate(ca, 1, params, ctx, chest.galois_key(1)))
        outs[str(device)] = [c.cpu() for c in (*prod.c, *rot.c)]
        if device != "cpu":
            assert n_mul == (1, 2) and n_rot == (1, 2)
        else:
            assert n_mul == n_rot == (0, 0)
    assert all(torch.equal(g, w) for g, w in zip(outs[str(cuda_device)], outs["cpu"]))

    for mod, gmod, name in ((bgv, gbgv, "bgv_ci"), (bfv, gbfv, "bfv_ci")):
        params = preset(name)
        ctx = make_context(params, device=cuda_device)
        chest = mod.keygen(params, np.random.default_rng(2), ctx=ctx)
        zi = np.random.default_rng(4).integers(0, params.plain_modulus, size=params.n)
        a = mod.encrypt(gmod.encode(zi, params), params, chest.device_pk, ctx,
                        np.random.default_rng(5))
        prod, n_mul = count(lambda: mod.ct_mul(a, a, params, ctx, chest.device_rlk))
        assert n_mul == (1, 2), name
        want = zi * zi % params.plain_modulus
        assert (mod.decrypt_decode(prod, params, chest.device_sk, ctx) == want).all(), name


@pytest.mark.parametrize("name", ["ci_small", "boot_dw_ci"])
def test_mul_full_on_card_equals_cpu_path(cuda_device, name):
    """ci_small and the double-word boot_dw_ci end to end: the card's limbs
    equal the CPU path's."""
    params = preset(name)
    z = np.random.default_rng(1)
    za = z.normal(size=params.slots) + 1j * z.normal(size=params.slots)
    outs = []
    for dev in (cuda_device, "cpu"):
        ctx = make_context(params, device=dev)
        chest = dkeys.keygen(params, np.random.default_rng(2), ctx=ctx)
        ca = dct.encrypt(encoder.encode(za, params), params, chest.device_pk, ctx,
                         np.random.default_rng(3), params.scale)
        outs.append(dct.ct_mul_full(ca, ca, params, ctx, chest.device_rlk))
    for g, c in zip(*(o.c for o in outs)):
        assert torch.equal(g.cpu(), c)


@pytest.mark.parametrize("name,d_dim,drop,with_perm", [
    ("config5_boot", 2, 0, False),  # the relinearisation's MAC, D=2 T=45
    ("config5_boot", 2, 1, False),  # a key stored above the level, T=44
    ("config5_boot", 2, 0, True),  # a hoisted rotation's, automorphism folded in
    ("config5_boot_dw", 5, 0, False),  # the dw key switch's, D=5 T=58
    ("boot_dw_ci_enc", 6, 3, True),  # dnum=6: the Barrett step before the REDC
    ("config5_boot_h", 6, 0, True),  # the single-word bootstrap's, D=6 T=35
])
def test_mac_kernel_matches_plain(cuda_device, name, d_dim, drop, with_perm):
    params = preset(name)
    ctx = make_context(params, device=cuda_device)
    level = params.num_limbs - drop
    rows = ctx.index(keyswitch.key_row_index(params, level, ctx.num_total), torch.int32)
    chain_rows = keyswitch.qp_indices(params, level)
    chain = ctx.index(chain_rows, torch.int32)
    x = torch.from_numpy(np.stack([_rand(ctx.primes, chain_rows, params.n, 10 + d)
                                   for d in range(d_dim)])).to(cuda_device)
    y0, y1 = (torch.from_numpy(np.stack([_rand(ctx.primes, range(ctx.num_total), params.n, s + d)
                                         for d in range(d_dim)])).to(cuda_device)
              for s in (20, 40))
    perm = None
    if with_perm:
        perm = dct.galois_perm(5, ctx, torch.int32)
    before = mac_cuda.KERNEL.launches
    got = mac_cuda.mac_cuda(x, y0, y1, rows, chain, ctx, perm)
    assert torch.equal(got, mac_cuda.mac_plain(x, y0, y1, rows, chain, ctx, perm))
    assert mac_cuda.KERNEL.launches == before + 1


def test_mac_kernel_single_output_matches_plain(cuda_device):
    """ct_mul_plain's launch for a third component: y1 None, one output."""
    params = preset("config5_boot")
    ctx = make_context(params, device=cuda_device)
    rows = list(range(params.num_limbs))
    idx = ctx.index(rows, torch.int32)
    x, y0 = (torch.from_numpy(_rand(ctx.primes, rows, params.n, s)[None]).to(cuda_device)
             for s in (50, 51))
    before = mac_cuda.KERNEL.launches
    got = mac_cuda.mac_cuda(x, y0, None, idx, idx, ctx)
    assert got.shape == (1, len(rows), params.n)
    assert torch.equal(got, mac_cuda.mac_plain(x, y0, None, idx, idx, ctx))
    assert mac_cuda.KERNEL.launches == before + 1


def _rand_stack(ctx, rows, d_dim, seed):
    return torch.from_numpy(np.stack([_rand(ctx.primes, rows, ctx.n, seed + d)
                                      for d in range(d_dim)])).to(ctx.device)


def test_mac_kernel_fan_plaintext_level(cuda_device):
    """The diagonal fan's second MAC level at config5_boot_dw: a plaintext
    stack of D = 15 diagonals against the two stacks of the offsets' key
    switch outputs (T = 58), written into slices of a larger stack through
    `out`; and the gathered c0 stack against the plaintext stack's q rows."""
    params = preset("config5_boot_dw")
    ctx = make_context(params, device=cuda_device)
    qp = keyswitch.qp_indices(params, params.num_limbs)
    rows_qp = ctx.index(range(len(qp)), torch.int32)
    chain = ctx.index(qp, torch.int32)
    pts, t0, t1 = (_rand_stack(ctx, qp, 15, s) for s in (60, 80, 100))
    out = torch.zeros((2, 3, len(qp), params.n), dtype=torch.int64, device=cuda_device)
    before = mac_cuda.KERNEL.launches
    got = mac_cuda.mac_cuda(pts, t0, t1, rows_qp, chain, ctx, out=out[:, 1])
    assert torch.equal(got, mac_cuda.mac_plain(pts, t0, t1, rows_qp, chain, ctx))
    assert torch.equal(out[:, 1], got) and not out[:, [0, 2]].any()
    q_rows = list(range(params.num_limbs))
    idx_q = ctx.index(q_rows, torch.int32)
    c0g = _rand_stack(ctx, q_rows, 15, 120)
    got = mac_cuda.mac_cuda(c0g, pts, None, idx_q, idx_q, ctx)
    assert torch.equal(got, mac_cuda.mac_plain(c0g, pts, None, idx_q, idx_q, ctx))
    assert mac_cuda.KERNEL.launches == before + 2


def test_mac_kernel_fan_key_level_truncated_key(cuda_device):
    """The fan's first MAC level: raised digits read through an automorphism
    against a Galois key truncated to level 40 of 48 (rows selected by
    truncate_galois_device), used at level 36, == the full key's result."""
    params = preset("config5_boot_dw")
    ctx = make_context(params, device=cuda_device)
    level = 36
    qp = keyswitch.qp_indices(params, level)
    chain = ctx.index(qp, torch.int32)
    d_dim = -(-level // params.alpha)
    x = _rand_stack(ctx, qp, d_dim, 140)
    full = dkeys.DeviceKSKey(*(_rand_stack(ctx, range(ctx.num_total), params.dnum, s)
                               for s in (160, 180)))
    chest = dkeys.KeyChest(params, None, None, None, None, None, None, galois={1: (None, full)})
    dkeys.truncate_galois_device(chest, {1: 40}, None, params)
    short = chest.galois_key(1)
    assert short.b_mont.shape[1] == 40 + params.alpha
    perm = dct.galois_perm(5, ctx, torch.int32)
    got = keyswitch.gadget_mac(x, params, level, ctx, short, perm=perm)
    assert torch.equal(got, keyswitch.gadget_mac(x, params, level, ctx, full, perm=perm))
    rows = ctx.index(keyswitch.key_row_index(params, level, short.b_mont.shape[1]), torch.int32)
    assert torch.equal(got, mac_cuda.mac_plain(x, short.b_mont, short.a_mont, rows, chain, ctx,
                                               perm))


@pytest.mark.parametrize("name,settings", [
    ("boot_dw_ci_enc", dict(transform="factored", radix_log=3, evalmod="cheb", k_bound=5.0)),
    ("boot_ci", {}),
])
def test_bootstrap_on_card_equals_cpu_path(cuda_device, name, settings):
    """The whole CI bootstrap on the card, every phase output == the CPU
    path's, with the same keys and the same draws."""
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper, bootstrap_rotations

    params = preset(name)
    rots = tuple(bootstrap_rotations(params, settings.get("transform", "dense"), 3))
    z = np.random.default_rng(0)
    z = (z.normal(size=params.slots) + 1j * z.normal(size=params.slots)) * 0.2
    phases = []
    for dev in (cuda_device, "cpu"):
        ctx = make_context(params, device=dev)
        chest = dkeys.keygen(params, np.random.default_rng(7), rots, conjugation=True, ctx=ctx)
        bs = Bootstrapper(DeviceBackend(params, ctx, chest), **settings)
        ct = dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx,
                         np.random.default_rng(1), params.scale, level=params.scale_words)
        seen = {}
        bs(ct, _phase=lambda name, outs: seen.__setitem__(name, outs))
        phases.append(seen)
    assert list(phases[0]) == ["mod_raise", "coeff_to_slot", "evalmod", "slot_to_coeff"]
    for name in phases[0]:
        for g, c in zip(phases[0][name], phases[1][name]):
            assert g.level == c.level and g.scale == c.scale
            for gc, cc in zip(g.c, c.c):
                assert torch.equal(gc.cpu(), cc)


def test_ntt_kernel_on_the_bfv_n16_aux_basis(cuda_device):
    """K1 over BFV's auxiliary basis at bfv_n16 (34 limbs of 28-bit primes,
    N = 2^16, a context of its own), forward and inverse, a batch of 2."""
    from gpufhe_tpu_torch.golden.bfv import bfv_aux_params

    auxp = bfv_aux_params(preset("bfv_n16"))
    ctx = make_context(auxp, device=cuda_device)
    assert ctx.k1_refusal is None
    sel = list(range(len(auxp.q_primes)))
    idx = ctx.index(sel, torch.int32)
    x = torch.from_numpy(_rand(auxp.q_primes, sel * 2, auxp.n, 10)).to(cuda_device)
    for inverse in (False, True):
        assert torch.equal(ntt_cuda.fourstep_cuda(x, idx, ctx, inverse),
                           ntt_cuda.fourstep_plain(x, idx, ctx, inverse))


@pytest.mark.parametrize("which", ["q2aux", "b2q", "b2msk", "p2q_bgv"])
def test_convert_kernel_at_the_integer_shapes(cuda_device, which):
    """K3 at Q -> aux 30 -> 34, B -> Q 33 -> 30, B -> m_sk 33 -> 1 and BGV's
    t-folded P -> Q 15 -> 30 at bfv_n16, random and x = q - 1."""
    from gpufhe_tpu_torch.ciphertext.bfv import make_bfv_mul_context
    from gpufhe_tpu_torch.primitives import rns

    params = preset("bfv_n16")
    if which == "p2q_bgv":
        tabs = rns.make_ks_context(params, params.num_limbs, device=cuda_device).p2q
    else:
        tabs = getattr(make_bfv_mul_context(params, params.num_limbs, device=cuda_device)[2], which)
    src = tabs.sq.tolist()
    x = torch.from_numpy(_rand(src, range(len(src)), 2**16, 11)).to(cuda_device)
    top = (tabs.sq[:, None] - 1).expand(len(src), 2**16).contiguous()
    for data in (x, top):
        assert torch.equal(convert_cuda.base_convert_cuda(data, tabs),
                           convert_cuda.base_convert_plain(data, tabs))


@pytest.mark.parametrize("scheme", ["bgv", "bfv"])
def test_integer_mul_on_card_equals_cpu_path(cuda_device, scheme):
    """A BGV and a BFV ct_mul at bfv_ci (bgv_ci for BGV): the card's limbs
    and pt_factor equal the CPU path's, the decrypt is exact."""
    from gpufhe_tpu_torch.ciphertext import bfv, bgv
    from gpufhe_tpu_torch.golden import bgv as gbgv

    mod = bgv if scheme == "bgv" else bfv
    params = preset(f"{scheme}_ci")
    t = params.plain_modulus
    za, zb = (np.random.default_rng(i).integers(0, t, size=params.n) for i in (1, 2))
    outs = []
    for dev in (cuda_device, "cpu"):
        ctx = make_context(params, device=dev)
        chest = mod.keygen(params, np.random.default_rng(2), ctx=ctx)
        a, b = (mod.encrypt(gbgv.encode(z, params), params, chest.device_pk, ctx,
                            np.random.default_rng(3 + i)) for i, z in enumerate((za, zb)))
        prod = mod.ct_mul(a, b, params, ctx, chest.device_rlk)
        assert (mod.decrypt_decode(prod, params, chest.device_sk, ctx) == za * zb % t).all()
        outs.append(prod)
    assert outs[0].level == outs[1].level
    assert getattr(outs[0], "pt_factor", 1) == getattr(outs[1], "pt_factor", 1)
    for g, c in zip(outs[0].c, outs[1].c):
        assert torch.equal(g.cpu(), c)


def test_keygen_keeps_canonical_keys_on_host(cuda_device):
    """keygen on the card keeps every switching key's canonical form on the
    host and its device form on the card, each equal to the CPU keygen's."""
    params = preset("boot_dw_ci_enc")
    chests = [dkeys.keygen(params, np.random.default_rng(7), (1,), conjugation=True,
                           ctx=make_context(params, device=dev))
              for dev in (cuda_device, "cpu")]
    pairs = [[c.galois[1], c.conj, c.eph["to_eph"], c.eph["from_eph"]] for c in chests]
    for (canon, key), (canon_c, key_c) in zip(*pairs):
        assert canon.b.device.type == canon.a.device.type == "cpu"
        assert key.b_mont.device.type == "cuda"
        assert torch.equal(canon.b, canon_c.b) and torch.equal(canon.a, canon_c.a)
        assert torch.equal(key.b_mont.cpu(), key_c.b_mont)
    assert chests[0].rlk.b.device.type == "cpu"


def test_mac_kernel_refuses_bad_input(cuda_device):
    ctx = make_context(preset("tiny"), device=cuda_device)
    idx = ctx.index(range(ctx.num_total), torch.int32)
    x = torch.zeros((1, ctx.num_total, ctx.n), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        mac_cuda.mac_cuda(x, x, x, idx.long(), idx, ctx)
    with pytest.raises(ValueError):
        mac_cuda.mac_cuda(x, x[:, :, :-1], x[:, :, :-1], idx, idx, ctx)


@pytest.mark.parametrize("mix", probes.MIXES)
def test_int_rate_kernel_matches_plain(cuda_device, mix):
    got = probes.int_rate_cuda(mix, 2, 33, cuda_device)
    assert torch.equal(got, probes.int_rate_plain(mix, 2, 33, cuda_device))


@pytest.mark.parametrize("name", ["ci_small", "config5_boot"])
def test_ntt_natural_store_build_is_still_the_ntt(cuda_device, name):
    """The ablation without the tile's padding changes the banks, not the function."""
    params = preset(name)
    ctx = make_context(params, device=cuda_device)
    rows = list(range(ctx.num_total))
    x = torch.from_numpy(_rand(ctx.primes, rows, params.n, 6)).to(cuda_device)
    idx = ctx.index(rows, torch.int32)
    for inverse in (False, True):
        got = ntt_cuda.fourstep_cuda(x, idx, ctx, inverse, probes.ABLATION_KERNELS["natural_store"])
        assert torch.equal(got, ntt_cuda.fourstep_plain(x, idx, ctx, inverse))


@pytest.mark.parametrize("name", ["tiny", "ci_small", "config3_ckks", "config5_boot"])
def test_ntt_narrow_tfast_build_is_still_the_ntt(cuda_device, name):
    """The ablation with one word per thread on pass B's t-fast side (no
    pairs, no shuffle) changes the segment width, not the function."""
    params = preset(name)
    ctx = make_context(params, device=cuda_device)
    rows = list(range(ctx.num_total))
    x = torch.from_numpy(_rand(ctx.primes, rows, params.n, 5)).to(cuda_device)
    idx = ctx.index(rows, torch.int32)
    for inverse in (False, True):
        got = ntt_cuda.fourstep_cuda(x, idx, ctx, inverse, probes.ABLATION_KERNELS["narrow_tfast"])
        assert torch.equal(got, ntt_cuda.fourstep_plain(x, idx, ctx, inverse))


def test_ntt_copy_only_build_matches_plain(cuda_device):
    params = preset("ci_small")
    ctx = make_context(params, device=cuda_device)
    rows = list(range(ctx.num_total))
    x = torch.from_numpy(_rand(ctx.primes, rows, params.n, 7)).to(cuda_device)
    got = ntt_cuda.fourstep_cuda(x, ctx.index(rows, torch.int32), ctx, False,
                                 probes.ABLATION_KERNELS["copy_only"])
    assert torch.equal(got, probes.copy_only_plain(x, ctx))


@pytest.mark.parametrize("which", ["modup", "moddown"])
def test_convert_kernel_at_the_boot_h_shapes(cuda_device, which):
    """config5_boot_h at its top level: ModUp 5 -> 35 for every group and
    ModDown 5 -> 30, random and x = q - 1, == plain."""
    params = preset("config5_boot_h")
    level, alpha = params.num_limbs, len(params.p_primes)
    ksc = rns.make_ks_context(params, level, device=cuda_device)
    primes = params.q_primes + params.p_primes
    cases = ([(ksc.modup[g], range(d0, d1)) for g, (d0, d1) in
              enumerate(rns.ks_groups(params, level))] if which == "modup"
             else [(ksc.p2q, range(level, level + alpha))])
    for tabs, rows in cases:
        assert tabs.k3_refusal is None and tabs.sq.numel() == alpha
        assert tabs.dq.numel() == (level + alpha if which == "modup" else level)
        x = torch.from_numpy(_rand(primes, rows, params.n, 11)).to(cuda_device)
        top = (tabs.sq[:, None] - 1).expand(alpha, params.n).contiguous()
        for data in (x, top):
            assert torch.equal(convert_cuda.base_convert_cuda(data, tabs),
                               convert_cuda.base_convert_plain(data, tabs))


def test_threefry_bits_on_card_equal_cpu(cuda_device):
    """keys/prng.py draws the same bits on the card and on the CPU (the
    seeded-key contract is device-independent), at a key-sized draw."""
    for seed in (0, 2**32 + 7, 2**63 - 1):
        key = prng.key(seed)
        for shape in ((35, 2**16), (3, 5, 7)):
            got = prng.bits_u32(key, shape, cuda_device)
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu(), prng.bits_u32(key, shape))
        assert torch.equal(prng.split(key.to(cuda_device)).cpu(), prng.split(key))


def test_device_keygen_on_card_equals_cpu(cuda_device):
    """device_keygen on the card == on the CPU, every device key and seed,
    encapsulation keys included; regen_galois_a on the card after a drop
    gives the keys back."""
    params = preset("boot_dw_ci_enc")
    chests = [dkg.device_keygen(params, np.random.default_rng(7), (1, 5), True,
                                ctx=make_context(params, device=dev)) for dev in (cuda_device, "cpu")]
    card, cpu = chests

    def keys(c):
        return [c.device_sk.s_mont, *c.device_pk, *c.device_rlk, *c.galois[1][1], *c.galois[5][1],
                *c.conj[1], *c.eph["to_eph"][1], *c.eph["from_eph"][1]]

    for g, w in zip(keys(card), keys(cpu), strict=True):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)
    assert all(torch.equal(card.seeds[k], cpu.seeds[k]) for k in cpu.seeds)
    want = card.galois[5][1].a_mont.clone()
    assert card.drop_galois_a() == 3
    assert card.regen_galois_a(make_context(params, device=cuda_device)) == 3
    assert torch.equal(card.galois_key(5).a_mont, want)


# --- the MNIST MLP's shapes at config3_ckks (N = 2^15, 12 q-limbs, alpha 3,
#     dnum 4) and a model forward -----------------------------------------------


@pytest.mark.parametrize("rows,batch", [(15, 4), (12, 2), (15, 2), (12, 1)])
def test_ntt_kernel_at_the_mlp_n15_shapes(cuda_device, rows, batch):
    """K1 at N = 2^15: the hoist's 4 raised digits over Q+P (15 limbs), both
    accumulators over Q+P, both components over Q and one, fwd and inv."""
    params = preset("config3_ckks")
    ctx = make_context(params, device=cuda_device)
    sel = list(range(rows))
    idx = ctx.index(sel, torch.int32)
    x = torch.from_numpy(_rand(ctx.primes, sel * batch, params.n, 12)).to(cuda_device)
    for inverse in (False, True):
        assert torch.equal(ntt_cuda.fourstep_cuda(x, idx, ctx, inverse),
                           ntt_cuda.fourstep_plain(x, idx, ctx, inverse))


@pytest.mark.parametrize("which", ["modup", "moddown"])
def test_convert_kernel_at_the_mlp_n15_shapes(cuda_device, which):
    """config3_ckks at its top level: ModUp 3 -> 15 for every group and
    ModDown 3 -> 12, random and x = q - 1, == plain."""
    params = preset("config3_ckks")
    level, alpha = params.num_limbs, len(params.p_primes)
    ksc = rns.make_ks_context(params, level, device=cuda_device)
    primes = params.q_primes + params.p_primes
    cases = ([(ksc.modup[g], range(d0, d1)) for g, (d0, d1) in
              enumerate(rns.ks_groups(params, level))] if which == "modup"
             else [(ksc.p2q, range(level, level + alpha))])
    for tabs, rows in cases:
        assert tabs.dq.numel() == (level + alpha if which == "modup" else level)
        x = torch.from_numpy(_rand(primes, rows, params.n, 13)).to(cuda_device)
        top = (tabs.sq[:, None] - 1).expand(alpha, params.n).contiguous()
        for data in (x, top):
            assert torch.equal(convert_cuda.base_convert_cuda(data, tabs),
                               convert_cuda.base_convert_plain(data, tabs))


def test_mac_kernel_at_the_mlp_n15_shape(cuda_device):
    """K4 at D = 4 x T = 15 against a key stored over the full chain, with a
    rotation's automorphism folded in, == plain."""
    params = preset("config3_ckks")
    ctx = make_context(params, device=cuda_device)
    level = params.num_limbs
    rows = ctx.index(keyswitch.key_row_index(params, level, ctx.num_total), torch.int32)
    chain_rows = keyswitch.qp_indices(params, level)
    chain = ctx.index(chain_rows, torch.int32)
    x = torch.from_numpy(np.stack([_rand(ctx.primes, chain_rows, params.n, 14 + d)
                                   for d in range(params.dnum)])).to(cuda_device)
    y0, y1 = (torch.from_numpy(np.stack([_rand(ctx.primes, range(ctx.num_total), params.n, s + d)
                                         for d in range(params.dnum)])).to(cuda_device)
              for s in (30, 50))
    perm = dct.galois_perm(5, ctx, torch.int32)
    assert len(chain_rows) == 15 and params.dnum == 4
    assert torch.equal(mac_cuda.mac_cuda(x, y0, y1, rows, chain, ctx, perm),
                       mac_cuda.mac_plain(x, y0, y1, rows, chain, ctx, perm))


def test_mac_each_at_the_mlp_n15_shape(cuda_device):
    """K4 back to back over one x (ct.py ct_baby_sums' babies): three keys,
    one stored a level lower, each through its own automorphism, into one
    int64[2, 3, T, N] stack == plain, pair by pair."""
    params = preset("config3_ckks")
    ctx = make_context(params, device=cuda_device)
    level = params.num_limbs - 1
    chain_rows = keyswitch.qp_indices(params, level)
    chain = ctx.index(chain_rows, torch.int32)
    x = torch.from_numpy(np.stack([_rand(ctx.primes, chain_rows, params.n, 14 + d)
                                   for d in range(params.dnum)])).to(cuda_device)
    pairs, rows, perms = [], [], []
    alpha = len(params.p_primes)
    for i, stored in enumerate((ctx.num_total, ctx.num_total, ctx.num_total - 1)):
        held = list(range(stored - alpha)) + list(range(params.num_limbs, ctx.num_total))
        y0, y1 = (torch.from_numpy(np.stack([_rand(ctx.primes, held, params.n, s + 7 * i + d)
                                             for d in range(params.dnum)])).to(cuda_device)
                  for s in (30, 50))
        pairs.append((y0, y1))
        rows.append(ctx.index(keyswitch.key_row_index(params, level, stored), torch.int32))
        perms.append(dct.galois_perm(5 ** (i + 1) % (2 * params.n), ctx, torch.int32))
    out = torch.empty((2, 3, len(chain_rows), params.n), dtype=torch.int64, device=cuda_device)
    got = mac_cuda.mac_each(x, pairs, rows, chain, ctx, perms, out)
    for i, ((y0, y1), r, p) in enumerate(zip(pairs, rows, perms)):
        assert torch.equal(got[:, i], mac_cuda.mac_plain(x, y0, y1, r, chain, ctx, p))


def test_mlp_forward_on_card_equals_cpu_path(cuda_device):
    """A two-layer EncryptedMLP at ci_small (its plans built from the
    blocks): the card's logits ciphertext == the CPU path's limb for limb,
    and it decodes within 1e-2 of the cleartext forward
    (tests/test_models_utils.py:73)."""
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.models.mlp import EncryptedMLP, mlp_rotations_for

    params = preset("ci_small")
    rng = np.random.default_rng(1)
    layers = [(rng.normal(size=(8, 12)) * 0.3, rng.normal(size=8) * 0.3),
              (rng.normal(size=(4, 8)) * 0.3, rng.normal(size=4) * 0.3)]
    x = rng.normal(size=12) * 0.5
    z = np.zeros(params.slots, dtype=np.complex128)
    z[:12] = x
    outs = []
    for dev in (cuda_device, "cpu"):
        ctx = make_context(params, device=dev)
        chest = dkeys.keygen(params, np.random.default_rng(0),
                             tuple(mlp_rotations_for(layers, params.slots)), ctx=ctx)
        be = DeviceBackend(params, ctx, chest)
        model = EncryptedMLP(be, layers)
        ct = dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx,
                         np.random.default_rng(2), params.scale)
        outs.append((be, model, model(ct)))
    (be, model, card), (_, _, cpu) = outs
    assert (card.level, card.scale) == (cpu.level, cpu.scale)
    for g, c in zip(card.c, cpu.c):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), c)
    got = np.real(be.decrypt_decode(card)[:4])
    assert np.abs(got - model.reference(x)).max() < 1e-2


@pytest.mark.parametrize("name", chip_smoke.MODELS_CI_ITEMS)
def test_models_ci_item_on_card_equals_cpu(cuda_device, name):
    """Each library and model item of chip_smoke.py's models_ci (at the
    preset and on the inputs of the reference's test) on the card and on the
    CPU with the same keys and draws: every output == limb for limb, decoded
    within the reference test's tolerance (or exact), K1 launched on the
    card. The smoke runs MODELS_CI_SMOKE of them; this runs all."""
    kernels = (ntt_cuda.KERNEL, convert_cuda.KERNEL, mac_cuda.KERNEL)

    def counts():
        return dict(zip(("ntt", "convert", "mac"), (k.launches for k in kernels)))

    card, _, per = chip_smoke.models_ci_run(cuda_device, counts, (name,))
    cpu, _, _ = chip_smoke.models_ci_run("cpu", counts, (name,))
    assert chip_smoke.same_outputs(card, cpu, "card against CPU") >= 1
    assert per[name]["ntt"] > 0


@pytest.mark.parametrize("name", chip_smoke.SESSION_CI_ITEMS)
def test_session_ci_item_on_card_equals_cpu(cuda_device, name):
    """Each Session item of chip_smoke.py's session_ci (a CKKS, BGV and BFV
    Session with the BSGS keys through every op and a matmul, a 3-party
    ThresholdSession through its combine, Session.bootstrap at
    boot_dw_ci_enc) on the card and on the CPU with the same seeds: every
    output == limb for limb, decoded within its tolerance (or exact), K1,
    K3 and K4 launched on the card."""
    kernels = (ntt_cuda.KERNEL, convert_cuda.KERNEL, mac_cuda.KERNEL)

    def counts():
        return dict(zip(("ntt", "convert", "mac"), (k.launches for k in kernels)))

    card, _, per = chip_smoke.session_ci_run(cuda_device, counts, (name,))
    cpu, _, _ = chip_smoke.session_ci_run("cpu", counts, (name,))
    assert chip_smoke.same_outputs(card, cpu, "card against CPU") >= 2
    assert min(per[name].values()) > 0


@pytest.mark.parametrize("scheme", ["ckks", "bgv", "bfv"])
def test_session_save_load_on_card_equals_cpu(cuda_device, scheme, tmp_path):
    """A Session saved on the card loads on the CPU and back: the keys and a
    ciphertext round-trip, and the loaded sessions' multiplies == limb for
    limb on both devices."""
    from gpufhe_tpu_torch.api import Session

    name = {"ckks": "tiny2", "bgv": "bgv_tiny", "bfv": "bfv_tiny"}[scheme]
    s = Session.create(name, scheme=scheme, rotations=(1,), seed=9, device=cuda_device)
    rng = np.random.default_rng(10)
    if scheme == "ckks":
        v = rng.uniform(-1, 1, size=s.params.slots)
    else:
        v = rng.integers(0, s.params.plain_modulus, size=s.params.slots, dtype=np.int64)
    ct = s.encrypt(v)
    s.save(tmp_path / "s.npz")
    s.save_ct(tmp_path / "ct.npz", ct)
    cpu = Session.load(tmp_path / "s.npz", device="cpu")
    card = Session.load(tmp_path / "s.npz", device=cuda_device)
    outs = []
    for sess in (card, cpu):
        c = sess.load_ct(tmp_path / "ct.npz")
        chip_smoke.same_limbs(c, ct, f"{scheme} load_ct")
        outs.append(sess.rotate(sess.mul(c, c), 1))
    chip_smoke.same_limbs(outs[0], outs[1], f"{scheme} loaded mul and rotate")
    chip_smoke.same_limbs(outs[0], s.rotate(s.mul(ct, ct), 1), f"{scheme} against the original")


# -- the mesh (gpufhe_tpu_torch/parallel): K1's pass entry point and the
# sharded programs on eight logical shards of the card, each == the CPU --

# boot_dw_ci: pass A blocks of 2 columns (fewer lanes than a t-fast group)
@pytest.mark.parametrize("name", ["tiny2", "boot_dw_ci", "ci_small", "config5_boot"])
def test_ntt_pass_kernel_matches_plain(cuda_device, name):
    """Each of ntt_pass's four kinds == fourstep_pass_plain on every block
    of a 4-way cut of the Q+P chain, at its column offset."""
    params = preset(name)
    ctx = make_context(params, device=cuda_device)
    rows, n1, n2 = ctx.num_total, ctx.n1, ctx.n2
    idx = ctx.index(range(rows), torch.int32)
    q = torch.tensor(ctx.primes, dtype=torch.int64, device=cuda_device)[:, None, None]
    rng = np.random.default_rng(9)
    before = ntt_cuda.PASS_KERNEL.launches
    shapes = {ntt_cuda.FWD_A: ((n1, n2 // 4), torch.int64), ntt_cuda.FWD_B: ((n1 // 4, n2), torch.int32),
              ntt_cuda.INV_B: ((n1 // 4, n2), torch.int64), ntt_cuda.INV_A: ((n1, n2 // 4), torch.int32)}
    for kind, (shape, dtype) in shapes.items():
        for c in range(4):
            x = torch.remainder(torch.from_numpy(rng.integers(0, 1 << 62, size=(rows, *shape)))
                                .to(cuda_device), q).to(dtype)
            col0 = c * shape[1] if kind in (ntt_cuda.FWD_A, ntt_cuda.INV_A) else 0
            got = ntt_cuda.fourstep_pass_cuda(x, idx, ctx, kind, col0)
            assert torch.equal(got, ntt_cuda.fourstep_pass_plain(x, idx, ctx, kind, col0))
    assert ntt_cuda.PASS_KERNEL.launches == before + 16


def _mesh_same(got, want):
    from gpufhe_tpu_torch.parallel import sharded as sh

    for g, w in zip(got, want):
        assert torch.equal(sh.unshard_ct_component(g), sh.unshard_ct_component(w))


@pytest.mark.parametrize("name", ["ci_small", "bgv_ci", "bfv_ci"])
def test_sharded_mult_on_card_equals_cpu(cuda_device, name):
    """make_sharded_mult (CKKS at ci_small, BGV at bgv_ci) and
    make_sharded_bfv_mult (bfv_ci) on eight shards of the card == on eight
    CPU shards, with K1's passes, K3 and K4 launched and no whole-limb NTT."""
    from gpufhe_tpu_torch.parallel import sharded as sh
    from gpufhe_tpu_torch.parallel.bfv_sharded import make_sharded_bfv_mult

    params = preset(name)
    level = params.num_limbs
    comps = [torch.from_numpy(_rand(params.q_primes, range(level), params.n, s))
             for s in range(4)]
    ctx_cpu = make_context(params, device="cpu")
    chest = dkeys.keygen(params, np.random.default_rng(7), ctx=ctx_cpu)
    make = make_sharded_bfv_mult if name == "bfv_ci" else sh.make_sharded_mult
    outs = {}
    for device in ("cpu", cuda_device):
        mesh = sh.make_fhe_mesh(2, 4, devices=[device] * 8)
        run, prepare = make(params, level, mesh)
        rlk = type(chest.device_rlk)(*(k.to(device) for k in chest.device_rlk))
        counts = (ntt_cuda.KERNEL.launches, ntt_cuda.PASS_KERNEL.launches,
                  convert_cuda.KERNEL.launches, mac_cuda.KERNEL.launches)
        outs[str(device)] = run(*[sh.shard_ct_component(c, params, mesh) for c in comps],
                                prepare(rlk))
        after = (ntt_cuda.KERNEL.launches, ntt_cuda.PASS_KERNEL.launches,
                 convert_cuda.KERNEL.launches, mac_cuda.KERNEL.launches)
        if device != "cpu":
            d = [a - b for a, b in zip(after, counts)]
            assert d[0] == 0 and min(d[1:]) > 0, d
    _mesh_same(outs[str(cuda_device)], outs["cpu"])


@pytest.mark.parametrize("name", chip_smoke.MESH_CI_ITEMS)
def test_mesh_ci_item_on_card_equals_cpu(cuda_device, name):
    """chip_smoke.mesh_ci_run's item on eight shards of the card == on eight
    CPU shards (the sharded bootstrap also == the single-device one)."""
    got, want = chip_smoke.mesh_ci_run(cuda_device, (name,)), chip_smoke.mesh_ci_run("cpu", (name,))
    assert sorted(got) == sorted(want)
    for key in got:
        for g, w in zip(got[key], want[key], strict=True):
            assert torch.equal(g, w), key
    if name.startswith("bootstrap"):
        for g, w in zip(got[name], got[f"{name} single"], strict=True):
            assert torch.equal(g, w)


@pytest.mark.parametrize("name", chip_smoke.GOLDEN_VECTORS)
def test_golden_vector_on_card(cuda_device, name):
    """tests/vectors/<name>.npz, read by numpy, reproduced on the card from
    the seed and preset it stores (chip_smoke.golden_vector_run): every
    stored array that a device path computes == the card's output, with the
    card's kernels launched (K3 alone for config2_rns's conversion)."""
    kernels = (ntt_cuda.KERNEL, convert_cuda.KERNEL, mac_cuda.KERNEL)
    before = [k.launches for k in kernels]
    got = chip_smoke.golden_vector_run(name, cuda_device)
    assert got["arrays"] > 0 and got["limbs"] > 0
    launched = [k.launches - b for k, b in zip(kernels, before)]
    assert launched[1] > 0 if name == "config2_rns" else min(launched) > 0, launched


def _drop_input(params, level, limbs, seed):
    """int64[2, limbs, N], canonical: random, the largest residues (q - 1) in
    column 0, and in columns 1 and 2 the centred lift's tie of the dropped
    limb level-1 (q_l // 2 and q_l // 2 + 1; for BGV its value times
    [-t^-1])."""
    q = np.asarray(params.q_primes[:limbs], dtype=np.int64)[:, None]
    x = np.random.default_rng(seed).integers(0, q, size=(2, limbs, params.n), dtype=np.int64)
    x[..., 0] = q[:, 0] - 1
    t, q_l = params.plain_modulus, params.q_primes[level - 1]
    for col, want in ((1, q_l // 2), (2, q_l // 2 + 1)):
        x[:, level - 1, col] = want * (-t) % q_l if t else want
    return x


# the kernel's three instances: the double-word rescale at the mul8 cell's
# levels (48 .. 34, two limbs a launch); the one-limb CKKS rescale at the
# refresh's EvalMod levels (config5_boot_dw 38 .. 25, backend.rescale's one
# drop a word) and at config5_boot's multiply levels (30 .. 26); the BGV
# ModSwitch at the bgv_mul5 cell's (30 .. 26). Each on a leading-K view of
# more limbs, and at K = words + 1
@pytest.mark.parametrize("name,words,level,limbs", [
    *(("config5_boot_dw", 2, lv, lv) for lv in range(48, 33, -2)),
    ("config5_boot_dw", 2, 44, 46), ("config5_boot_dw", 2, 3, 3),
    *(("config5_boot_dw", 1, lv, lv) for lv in range(38, 24, -1)),
    ("config5_boot_dw", 1, 38, 48),
    *(("config5_boot", 1, lv, lv) for lv in range(30, 25, -1)),
    ("config5_boot", 1, 28, 30), ("config5_boot", 1, 2, 2),
    *(("bfv_n16", 1, lv, lv) for lv in range(30, 25, -1)),
    ("bfv_n16", 1, 28, 30), ("bfv_n16", 1, 2, 2),
])
def test_rescale_kernel_matches_plain(cuda_device, name, words, level, limbs):
    """The kernel == `words` calls of the plain version, one drop each
    (ModSwitch where the chain has a plaintext modulus), one launch a call."""
    params = preset(name)
    bgv = bool(params.plain_modulus)
    x = torch.from_numpy(_drop_input(params, level, limbs, level + limbs)).to(cuda_device)
    tabs = rescale_cuda.drop_tables(params.q_primes[:level], words, params.plain_modulus,
                                    x.device)
    want = x
    for d, tab in enumerate(tabs):
        want = rescale_cuda.drop_limbs_plain(want, level - d, [tab], bgv)
    before = rescale_cuda.KERNEL.launches
    got = rescale_cuda.drop_limbs(x, level, tabs, bgv)
    assert rescale_cuda.KERNEL.launches == before + 1
    assert torch.equal(got, want)
    lead = torch.stack([x, x, x])  # [3, 2, K, N]: the leading axes flattened
    assert torch.equal(rescale_cuda.drop_limbs(lead, level, tabs, bgv),
                       torch.stack([want, want, want]))


def test_rescale_kernel_refuses_bad_input(cuda_device):
    params = preset("ci_small")
    tab = rescale_cuda.make_drop_table(params.q_primes[:4], 0, cuda_device)
    x = torch.zeros((2, 4, params.n), dtype=torch.int64, device=cuda_device)
    for bad in (x.cpu(), x.int(), x.transpose(1, 2)):
        with pytest.raises(ValueError):
            rescale_cuda.drop_limbs(bad, 4, [tab], False)
    with pytest.raises(ValueError):  # a table of another level
        rescale_cuda.drop_limbs(x, 3, [tab], False)


def test_rescale_kernel_once_per_operation(cuda_device, monkeypatch):
    """One launch per ct_mul_full (two limbs at boot_dw_ci), per BGV ct_mul
    and per ct_modswitch; a CUDA tensor never reaches the plain versions."""
    from gpufhe_tpu_torch.ciphertext import bgv
    from gpufhe_tpu_torch.golden import bgv as gbgv

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain rescale")

    monkeypatch.setattr(rescale_cuda, "drop_limbs_plain", refuse)
    params = preset("boot_dw_ci")
    ctx = make_context(params, device=cuda_device)
    chest = dkeys.keygen(params, np.random.default_rng(2), ctx=ctx)
    z = np.random.default_rng(1).normal(size=params.slots)
    ca = dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx,
                     np.random.default_rng(3), params.scale)
    before = rescale_cuda.KERNEL.launches
    out = dct.ct_mul_full(ca, ca, params, ctx, chest.device_rlk)
    assert rescale_cuda.KERNEL.launches == before + 1 and out.level == ca.level - 2

    params = preset("bgv_ci")
    ctx = make_context(params, device=cuda_device)
    chest = bgv.keygen(params, np.random.default_rng(2), ctx=ctx)
    zi = np.random.default_rng(4).integers(0, params.plain_modulus, size=params.n)
    a = bgv.encrypt(gbgv.encode(zi, params), params, chest.device_pk, ctx,
                    np.random.default_rng(5))
    before = rescale_cuda.KERNEL.launches
    prod = bgv.ct_mul(a, a, params, ctx, chest.device_rlk)
    assert rescale_cuda.KERNEL.launches == before + 1
    down = bgv.ct_modswitch(prod, params, ctx)
    assert rescale_cuda.KERNEL.launches == before + 2
    want = zi * zi % params.plain_modulus
    assert (bgv.decrypt_decode(down, params, chest.device_sk, ctx) == want).all()


def _tensor_chain(name, basis, device):
    """(context, K) of a cell's tensor: the Q chain at its top level, or
    BFV's auxiliary basis at it."""
    params = preset(name)
    if basis == "aux":
        from gpufhe_tpu_torch.golden.bfv import bfv_aux_params

        params = bfv_aux_params(params)
    return make_context(params, device=device), params.num_limbs


def _tensor_operands(ctx, k_dim, seed):
    """Four canonical int64[K, N] operands on ctx's device, random but for
    their first 81 columns: every combination of 0, 1 and q - 1 over the
    four operands."""
    q = np.asarray(ctx.primes[:k_dim], dtype=np.int64)[:, None]
    x = np.random.default_rng(seed).integers(0, q, size=(4, k_dim, ctx.n), dtype=np.int64)
    edge = np.stack([np.zeros_like(q), np.ones_like(q), q - 1])[..., 0]
    for col in range(81):
        for op in range(4):
            x[op, :, col] = edge[col // 3**op % 3]
    return [torch.from_numpy(v).to(ctx.device) for v in x]


# the cells' tensors: config5_boot_dw's 48 Q limbs (mul8, the refresh),
# bfv_n16's 30 Q limbs (bgv_mul5, bfv_mul8) and its 34-limb auxiliary basis
# (bfv_mul8), N = 2^16
@pytest.mark.parametrize("name,basis", [("config5_boot_dw", "q"), ("bfv_n16", "q"),
                                        ("bfv_n16", "aux")])
def test_tensor_kernel_matches_plain(cuda_device, name, basis):
    """The kernel == tensor_plain limb for limb, one launch a call, on
    contiguous operands and on views with limb strides of their own."""
    ctx, k_dim = _tensor_chain(name, basis, cuda_device)
    a0, a1, b0, b1 = _tensor_operands(ctx, k_dim, k_dim)
    want = tensor_cuda.tensor_plain(a0, a1, b0, b1, ctx.col("q", range(k_dim)))
    before = tensor_cuda.KERNEL.launches
    got = tensor_cuda.tensor((a0, a1), (b0, b1), ctx, k_dim)
    assert tensor_cuda.KERNEL.launches == before + 1
    assert got.shape == (3, k_dim, ctx.n) and torch.equal(got, want)
    wide = torch.zeros((4, k_dim + 1, ctx.n + 2), dtype=torch.int64, device=cuda_device)
    for w, x in zip(wide, (a0, a1, b0, b1)):
        w[1:, 2:] = x
    views = [w[1:, 2:] for w in wide]  # limb stride N + 2, start 16 bytes past a row
    assert torch.equal(tensor_cuda.tensor(views[:2], views[2:], ctx, k_dim), want)


def test_tensor_kernel_once_per_multiply(cuda_device, monkeypatch):
    """One launch per CKKS ct_mul_full and BGV ct_mul, two per BFV ct_mul
    (over Q and over the auxiliary basis); each stack reaches its iNTT in
    place (the transform reads the stack's own pointer); a CUDA tensor never
    reaches tensor_plain; every product decrypts."""
    from gpufhe_tpu_torch.ciphertext import bfv, bgv
    from gpufhe_tpu_torch.golden import bfv as gbfv
    from gpufhe_tpu_torch.golden import bgv as gbgv
    from gpufhe_tpu_torch.ops import ntt as ntt_ops

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain tensor")

    stacks, inverse_reads = [], []
    launch, fourstep = tensor_cuda.tensor_cuda, ntt_ops.fourstep

    def record(*args):
        stacks.append(launch(*args))  # kept alive, so no pointer is reused
        return stacks[-1]

    def transform(x, idx, ctx, inverse):
        if inverse:
            inverse_reads.append(x.data_ptr())
        return fourstep(x, idx, ctx, inverse)

    monkeypatch.setattr(tensor_cuda, "tensor_plain", refuse)
    monkeypatch.setattr(tensor_cuda, "tensor_cuda", record)
    monkeypatch.setattr(ntt_ops, "fourstep", transform)

    params = preset("boot_dw_ci")
    ctx = make_context(params, device=cuda_device)
    chest = dkeys.keygen(params, np.random.default_rng(2), ctx=ctx)
    z = np.random.default_rng(1).normal(size=params.slots)
    ca = dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx,
                     np.random.default_rng(3), params.scale)
    before = tensor_cuda.KERNEL.launches
    out = dct.ct_mul_full(ca, ca, params, ctx, chest.device_rlk)
    assert tensor_cuda.KERNEL.launches == before + 1
    assert stacks[-1].data_ptr() in inverse_reads
    got = dct.decrypt_decode(out, params, chest.device_sk, ctx)
    assert np.abs(got - z * z).max() < 1e-2

    for scheme, mod, golden, launches in (("bgv_ci", bgv, gbgv, 1), ("bfv_ci", bfv, gbfv, 2)):
        params = preset(scheme)
        ctx = make_context(params, device=cuda_device)
        chest = mod.keygen(params, np.random.default_rng(2), ctx=ctx)
        zi = np.random.default_rng(4).integers(0, params.plain_modulus, size=params.n)
        a = mod.encrypt(golden.encode(zi, params), params, chest.device_pk, ctx,
                        np.random.default_rng(5))
        before, first = tensor_cuda.KERNEL.launches, len(stacks)
        prod = mod.ct_mul(a, a, params, ctx, chest.device_rlk)
        assert tensor_cuda.KERNEL.launches == before + launches
        assert all(s.data_ptr() in inverse_reads for s in stacks[first:])
        want = zi * zi % params.plain_modulus
        assert (mod.decrypt_decode(prod, params, chest.device_sk, ctx) == want).all()
