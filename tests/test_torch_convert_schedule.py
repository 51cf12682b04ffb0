"""A CPU model of kernel K3's 32-bit schedule (gpufhe_tpu_torch/csrc/convert.cu).

The kernel runs only on the card. This file emulates, in numpy uint64, what
each of its threads computes: v_i formed once per coefficient and source
limb by a 32-bit Shoup product against qhinv_shoup, the destination sums
of 32 x 32 -> 64-bit products over chunks of 4 s4 source limbs
(zero-padded), one Barrett step by dmu per 16 products and one at the end,
and a chunk's canonical partial sum carried through the output when there
are more than 32 source limbs; the blocks' destination groups and the
coefficients each thread owns. Every sum is checked to stay below 2^64 and
every Barrett remainder below 2p before its correction. The model is held
== the plain version `base_convert_plain` (which tests/test_torch_convert.py
holds == the reference) at the ModUp and ModDown tables of tiny2, ci_small,
config5_boot and config5_boot_dw, at the integer schemes' tables (BGV's
t-folded ModDown, BFV's conversions to and from the aux basis at bfv_n16:
33 source limbs, one destination), and at worst-case inputs: residues q - 1,
conv = p - 1, primes just below 2^30, and 16, 17 and 33 source limbs.
ModDown's epilogue (the kDown instances: the addend folded into the first
chunk's sum, the subtraction and the P^-1 product after the last) is held
== the plain mod_down and add_mod at each cell's ModDown shape, CKKS and
BGV's t-folded tables, on a synthetic chunked basis, and with the output
written over the addend. The
kernel's tables are checked against their definitions and against the
entry point's parameter order, and the refusal of a prime >= 2^30 where the
tables are built.
"""

import dataclasses
import math
import re

import numpy as np
import pytest
import torch

from gpufhe_tpu_torch.ops import convert_cuda
from gpufhe_tpu_torch.ops.convert_cuda import (
    K3Tables, base_convert_plain, k3_refusal, make_convert_tables,
)
from gpufhe_tpu_torch.golden.bfv import bfv_aux_params
from gpufhe_tpu_torch.ops.cuda_build import CSRC
from gpufhe_tpu_torch.params.params import gen_ntt_primes, is_prime, preset
from gpufhe_tpu_torch.primitives import rns as prns

M32 = (1 << 32) - 1
THREADS = 128  # csrc/convert.cu kThreads
UNREDUCED = 16  # kUnreduced
SMEM = 48 * 1024  # kDefaultSmem
N = 1024


def _u64(t: torch.Tensor) -> np.ndarray:
    """A table tensor's values as the kernel reads them (u32 or u64 words)."""
    a = t.numpy()
    return a.view(np.uint32).astype(np.uint64) if a.dtype == np.int32 else a.view(np.uint64)


# --- csrc/modarith.cuh ------------------------------------------------------

def shoup32(a, w, wp, q):
    """mul_mod_shoup32: a w - umulhi(a, w') q mod 2^32, then one subtract."""
    assert (a <= M32).all()
    r = (((a * w) & M32) + (1 << 32) - ((((a * wp) >> 32) * q) & M32)) & M32
    assert (r < 2 * q).all()
    return np.where(r >= q, r - q, r)


def mulhi64(a, b):
    """__umul64hi for uint64 arrays, from 32-bit halves."""
    a0, a1, b0, b1 = a & M32, a >> 32, b & M32, b >> 32
    p01, p10 = a0 * b1, a1 * b0
    mid = ((a0 * b0) >> 32) + (p01 & M32) + (p10 & M32)
    return a1 * b1 + (p01 >> 32) + (p10 >> 32) + (mid >> 32)


def barrett(t, p, mu):
    """barrett_reduce: t - umulhi(t, mu) p (mod 2^64) is in [0, 2p), exact."""
    r = t - mulhi64(t, mu) * p  # numpy uint64 wraps mod 2^64, as the kernel does
    assert (r < 2 * p).all(), "a Barrett quotient was short by more than one"
    return np.where(r >= p, r - p, r)


# --- the kernel -------------------------------------------------------------

def launch_shape(S, T, tg):
    """The entry point's chunk width, conv row stride and group size."""
    s4 = 8 if S >= 32 else (S + 3) // 4
    W = 4 * s4
    stride = W * -(-S // W)
    tg = min(tg, T, max(1, SMEM // (4 * stride)))
    return s4, stride, tg


def k3_model(x: np.ndarray, k3: K3Tables, tg: int, stats: dict | None = None,
             down: tuple | None = None) -> np.ndarray:
    """out[t, c] as the kernel computes it, for x uint64[S, n] (every
    coefficient at once: each is one thread's lane). With down = (acc_q
    uint64[T, n], add uint64[T, n] or None, tab uint64[4, T], alias), one
    batch row of ModDown's epilogue; with alias the addend is read from
    `out` (the kernel's out may be the addend's own buffer)."""
    S, n = x.shape
    sq, w, wp, conv, dq, dmu = (_u64(getattr(k3, f.name)) for f in dataclasses.fields(K3Tables))
    T = dq.size
    s4, stride, tg = launch_shape(S, T, tg)
    W = 4 * s4
    out = np.zeros((T, n), dtype=np.uint64)
    acc_q, add, tab, alias = down if down is not None else (None, None, None, False)
    if alias:
        out = add.copy()
    peak = 0
    for t0 in range(0, T, tg):  # blockIdx.y
        rows = min(tg, T - t0)
        conv_s = np.zeros((rows, stride), dtype=np.uint64)  # staged, zero past S
        conv_s[:, :S] = conv.reshape(T, S)[t0:t0 + rows]
        for i0 in range(0, S, W):  # chunks
            v = np.zeros((W, n), dtype=np.uint64)
            for i in range(min(W, S - i0)):
                v[i] = shoup32(x[i0 + i], w[i0 + i], wp[i0 + i], sq[i0 + i])
            for r in range(rows):
                t = t0 + r
                p, mu = dq[t], dmu[t]
                if i0 > 0:
                    acc = out[t].copy()
                elif add is not None:  # the addend, as add [-P]_{q_t}
                    acc = shoup32((out if alias else add)[t], tab[2, t], tab[3, t], p)
                else:
                    acc = np.zeros(n, dtype=np.uint64)
                for j in range(W):  # the unrolled uint4 broadcasts, term by term
                    prod = v[j] * conv_s[r, i0 + j]
                    assert (prod < 1 << 60).all()
                    new = acc + prod
                    assert (new >= acc).all(), "a sum passed 2^64"
                    acc = new
                    peak = max(peak, int(acc.max()))
                    if (j + 1) % UNREDUCED == 0 and j + 1 < W:
                        acc = barrett(acc, p, mu)
                res = barrett(acc, p, mu)
                if down is not None and i0 + W >= S:  # (acc_q - sum + q_t) [P^-1]_{q_t}
                    res = shoup32(acc_q[t] + p - res, tab[0, t], tab[1, t], p)
                out[t] = res
    if stats is not None:
        stats["peak"] = peak
    return out


def _check(x: np.ndarray, tabs, tg=convert_cuda.GROUP, stats=None):
    got = k3_model(x.astype(np.uint64), tabs.k3, tg, stats).astype(np.int64)
    want = base_convert_plain(torch.from_numpy(x), tabs).numpy()
    assert (got == want).all()


def _rand(primes, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, size=n, dtype=np.int64) for q in primes])


# --- the model against the plain version ------------------------------------

@pytest.mark.parametrize("name", ["tiny2", "ci_small", "config5_boot", "config5_boot_dw"])
def test_model_equals_plain_at_the_key_switch_tables(name):
    """Every ModUp group and the ModDown at the top level, with the preset's
    own primes, at N = 2^10 (the tables do not depend on N)."""
    params = preset(name)
    level = params.num_limbs
    ksc = prns.make_ks_context(params, level, device="cpu")
    for g, (d0, d1) in enumerate(prns.ks_groups(params, level)):
        _check(_rand(params.q_primes[d0:d1], N, g), ksc.modup[g])
    _check(_rand(params.p_primes, N, 99), ksc.p2q)


def test_model_equals_plain_at_the_integer_schemes_tables():
    """The BGV ModDown's t-folded tables (bgv_ci, and bfv_n16's chain read as
    BGV: P -> Q 15 -> 30) and the BFV multiply's conversions at bfv_n16:
    Q -> aux 30 -> 34, B -> Q 33 -> 30 (a chunk boundary above 32 source
    limbs) and B -> m_sk 33 -> 1 (one destination in a group of 16)."""
    for name in ("bgv_ci", "bfv_n16"):
        params = preset(name)
        ksc = prns.make_ks_context(params, params.num_limbs, device="cpu")
        _check(_rand(params.p_primes, N, 7), ksc.p2q)
    params = preset("bfv_n16")
    aux = bfv_aux_params(params).q_primes
    qs, b_primes = params.q_primes, aux[:-1]
    for i, (src, dst) in enumerate(((qs, aux), (b_primes, qs), (b_primes, aux[-1:]))):
        tabs = make_convert_tables(src, dst, "cpu")
        assert launch_shape(len(src), len(dst), convert_cuda.GROUP)[2] == min(16, len(dst))
        _check(_rand(src, N, 20 + i), tabs)
        q = np.asarray(src, dtype=np.int64)[:, None]
        _check(np.broadcast_to(q - 1, (len(src), 64)).copy(), tabs)


def test_folded_tables_against_their_definitions():
    """make_convert_tables from given qhinv and conv: the kernel's u32
    tables, qhinv_shoup included, are those values and their companions."""
    params = preset("bfv_n16")
    t, ps, qs = params.plain_modulus, params.p_primes, params.q_primes
    tabs = prns.make_ks_context(params, params.num_limbs, device="cpu").p2q
    big = math.prod(ps)
    qhinv = [pow(big // p, -1, p) * pow(t, -1, p) % p for p in ps]
    assert _u64(tabs.k3.qhinv).tolist() == qhinv == tabs.qhinv.tolist()
    assert _u64(tabs.k3.qhinv_shoup).tolist() == [(w << 32) // p for w, p in zip(qhinv, ps)]
    assert _u64(tabs.k3.conv).reshape(len(qs), len(ps)).tolist() == [
        [(big // p) * t % q for p in ps] for q in qs] == tabs.conv.tolist()


@pytest.mark.parametrize("tg", [1, 7, 16, 64])
def test_destination_groups_do_not_change_the_result(tg):
    params = preset("ci_small")
    ksc = prns.make_ks_context(params, params.num_limbs, device="cpu")
    _check(_rand(params.q_primes[:2], N, tg), ksc.modup[0], tg=tg)


def _worst_tables(S, T):
    """Primes just below 2^30 and conv = p - 1 everywhere."""
    primes = gen_ntt_primes(30, 2**11, S + T)
    tabs = make_convert_tables(primes[:S], primes[S:], "cpu")
    p = np.asarray(primes[S:], dtype=np.int64)[:, None]
    conv = np.broadcast_to(p - 1, (T, S))
    return primes[:S], dataclasses.replace(
        tabs, conv=torch.from_numpy(conv.copy()),
        k3=dataclasses.replace(tabs.k3, conv=torch.from_numpy(
            conv.astype(np.uint32).view(np.int32).copy())))


@pytest.mark.parametrize("s_dim", [1, 15, 16, 17, 32, 33])
@pytest.mark.parametrize("largest", ["x", "v"])
def test_model_at_worst_case_inputs(s_dim, largest):
    """x = q - 1, or x with v_i = q_i - 1 (the largest products), against
    conv = p - 1 and primes just below 2^30: 16 products and a carried
    residue come within 2^-3 of 2^64 and no sum passes it."""
    src, tabs = _worst_tables(s_dim, 5)
    q = np.asarray(src, dtype=np.int64)[:, None]
    if largest == "x":
        x = np.broadcast_to(q - 1, (s_dim, 64)).copy()
    else:  # x_i = -Qhat_i mod q_i gives v_i = x_i Qhat_i^-1 = q_i - 1
        big = math.prod(src)
        x = np.array([[(-(big // qi)) % qi] * 64 for qi in src], dtype=np.int64)
    stats = {}
    _check(x, tabs, stats=stats)
    if largest == "v":
        x_v = shoup32(x.astype(np.uint64), _u64(tabs.k3.qhinv)[:, None],
                      _u64(tabs.k3.qhinv_shoup)[:, None], q.astype(np.uint64))
        assert (x_v == q - 1).all()
        if s_dim >= UNREDUCED:
            assert stats["peak"] > 15 << 60  # the 16-term sum is near 2^64


# --- ModDown's epilogue ---------------------------------------------------------

def _synthetic_ks_context(alpha: int, k: int) -> prns.KSContext:
    """The ModDown tables of a basis of `alpha` special primes just below
    2^30 (above 32 of them: the chunked path) onto k primes below 2^30."""
    primes = gen_ntt_primes(30, 2**11, alpha + k)
    ps, qs = primes[:alpha], primes[alpha:]
    return prns.KSContext(
        modup=(), p2q=make_convert_tables(ps, qs, "cpu"),
        p2q_epilogue=convert_cuda.make_mod_down_table(ps, qs, "cpu"))


# each cell's ModDown: ckks_n16_dw 58 -> 48 (alpha 10); n16_int 45 -> 30
# (alpha 15) as BGV (t-folded tables) and as BFV (its CKKS view);
# ckks_n16_l30 at its lowest level, 21 -> 6; the chunked path at 33 and 40
def _down_case(case: str):
    if case.startswith("chunked"):
        alpha = int(case.split("_")[1])
        return _synthetic_ks_context(alpha, 5), alpha
    name, level = {"ckks_n16_dw": ("config5_boot_dw", 48), "n16_int_bgv": ("bfv_n16", 30),
                   "n16_int_bfv": ("bfv_n16", 30), "ckks_n16_l30": ("config5_boot", 6)}[case]
    params = preset(name)
    if case == "n16_int_bfv":
        params = dataclasses.replace(params, plain_modulus=0)
    return prns.make_ks_context(params, level, device="cpu"), len(params.p_primes)


@pytest.mark.parametrize("case", ["ckks_n16_dw", "n16_int_bgv", "n16_int_bfv", "ckks_n16_l30",
                                  "chunked_33", "chunked_40"])
@pytest.mark.parametrize("add_rows,alias", [(0, False), (1, False), (2, False), (1, True),
                                            (2, True)])
def test_mod_down_epilogue_model_equals_plain(case, add_rows, alias):
    """Both components of int64[2, K + alpha, N] in the model's epilogue (the
    first in the wrapper's one group of every destination, the second in
    groups of 16) == the plain mod_down (sub_mod, the P^-1 product) and
    add_mod of the addend's leading rows, with largest residues (q - 1) in
    column 0."""
    ksc, alpha = _down_case(case)
    qs = ksc.p2q.dq.tolist()
    k = len(qs)
    primes = qs + ksc.p2q.sq.tolist()
    x = np.stack([_rand(primes, N, 30 + b) for b in range(2)])
    x[..., 0] = np.asarray(primes)[None, :] - 1
    add = np.stack([_rand(qs, N, 40 + b) for b in range(add_rows)]) if add_rows else None
    want = prns.mod_down(torch.from_numpy(x), None, k, None, ksc,
                         addend=None if add is None else torch.from_numpy(add)).numpy()
    bare = prns.mod_down(torch.from_numpy(x), None, k, None, ksc).numpy()
    assert (want[add_rows:] == bare[add_rows:]).all()
    tab = _u64(ksc.p2q_epilogue).reshape(4, k)
    for b, tg in enumerate((convert_cuda.MOD_DOWN_GROUP, convert_cuda.GROUP)):
        a_b = add[b].astype(np.uint64) if b < add_rows else None
        got = k3_model(x[b, k:].astype(np.uint64), ksc.p2q.k3, tg,
                       down=(x[b, :k].astype(np.uint64), a_b, tab, alias and a_b is not None))
        assert (got.astype(np.int64) == want[b]).all(), (case, b)
    assert launch_shape(alpha, k, convert_cuda.GROUP)[0] == (8 if alpha >= 32 else -(-alpha // 4))


def test_mod_down_table_against_its_definition():
    params = preset("config5_boot_dw")
    ps, qs = params.p_primes, params.q_primes[:48]
    tab = _u64(convert_cuda.make_mod_down_table(ps, qs, "cpu")).reshape(4, 48).tolist()
    big = math.prod(ps)
    pinv, negp = [pow(big, -1, q) for q in qs], [-big % q for q in qs]
    assert tab == [pinv, [(w << 32) // q for w, q in zip(pinv, qs)],
                   negp, [(w << 32) // q for w, q in zip(negp, qs)]]
    ksc = prns.make_ks_context(params, 48, device="cpu")
    assert ksc.p2q_epilogue.dtype == torch.int32
    assert _u64(ksc.p2q_epilogue).reshape(4, 48).tolist() == tab


def test_thread_layout_covers_every_coefficient_once():
    """Block b, thread i, coefficient k of cpt: c = b THREADS cpt + k THREADS
    + i (warps coalesce along c), masked at c >= n; a ragged n included."""
    for n in (64, 1000, 2**16):
        for cpt in (1, 2):
            per = THREADS * cpt
            blocks = -(-n // per)
            c = (np.arange(blocks)[:, None, None] * per + np.arange(cpt)[None, :, None] * THREADS
                 + np.arange(THREADS)[None, None, :]).ravel()
            live = c[c < n]
            assert np.array_equal(np.sort(live), np.arange(n))


def test_shared_memory_and_grid_stay_within_limits():
    for S in (1, 10, 15, 31, 32, 33, 100, convert_cuda.K3_MAX_S):
        for T in (1, 45, 58, convert_cuda.K3_MAX_T):
            s4, stride, tg = launch_shape(S, T, convert_cuda.GROUP)
            assert stride % (4 * s4) == 0 and stride >= S and 4 * stride * tg <= SMEM
            assert -(-T // tg) <= 65535


# --- tables and refusals ------------------------------------------------------

def test_tables_against_their_definitions():
    params = preset("config5_boot")
    src, dst = params.p_primes, params.q_primes
    tabs = make_convert_tables(src, dst, "cpu")
    k3 = tabs.k3
    big = math.prod(src)
    qhinv = [pow(big // q, -1, q) for q in src]
    assert tabs.k3_refusal is None
    assert _u64(k3.sq).tolist() == list(src) and _u64(k3.dq).tolist() == list(dst)
    assert _u64(k3.qhinv).tolist() == qhinv == tabs.qhinv.tolist()
    assert _u64(k3.qhinv_shoup).tolist() == [(w << 32) // q for w, q in zip(qhinv, src)]
    assert _u64(k3.conv).reshape(len(dst), len(src)).tolist() == [
        [(big // q) % p for q in src] for p in dst] == tabs.conv.tolist()
    assert _u64(k3.dmu).tolist() == [(1 << 64) // p for p in dst]
    assert [getattr(k3, f.name).dtype for f in dataclasses.fields(K3Tables)] == [torch.int32] * 5 + [
        torch.int64]


def test_table_order_is_the_entry_points():
    """K3Tables' fields, and so the ctypes argtypes, follow base_convert's parameters."""
    src = (CSRC / "convert.cu").read_text()
    sig = re.search(r'extern "C" int base_convert\((.*?)\)', src, re.S).group(1)
    names = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    fields = [f.name for f in dataclasses.fields(K3Tables)]
    assert names == ["x", "out", "S", "T", "n", "tg", "cpt", "B", "x_bstride", "out_bstride",
                     "acc", "add", "b_add", "add_bstride", "down", *fields, "stream"]
    assert len(convert_cuda.KERNEL.argtypes) == len(names)


def test_refusals_are_set_where_the_tables_are_built():
    big = next(p for p in range((1 << 30) + 1, (1 << 30) + 10**4, 2) if is_prime(p))
    tabs = make_convert_tables((97, big), (193, 257), "cpu")
    assert "below 2^30" in tabs.k3_refusal
    assert "below 2^30" in make_convert_tables((97,), (big,), "cpu").k3_refusal
    assert make_convert_tables((97,), tuple(gen_ntt_primes(30, 2**11, 1)), "cpu").k3_refusal is None
    assert k3_refusal(tuple(range(3, 3 + convert_cuda.K3_MAX_S + 1)), (5,))
    assert k3_refusal((3,), tuple(range(5, 5 + convert_cuda.K3_MAX_T + 1)))
    assert k3_refusal((), (5,))
    before = convert_cuda.KERNEL.launches
    with pytest.raises(ValueError, match="below 2"):
        convert_cuda.base_convert_cuda(torch.zeros((2, 8), dtype=torch.int64), tabs)
    assert convert_cuda.KERNEL.launches == before
